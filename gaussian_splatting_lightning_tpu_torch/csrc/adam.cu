// Adam's update of every parameter group in one kernel: each float's
// parameter, gradient and two moments read once, the parameter and the two
// moments written once.
//
// No TPU kernel stands behind this file. The JAX package's adam_update
// (gaussian_splatting_lightning_tpu/training/optimizer.py) is jnp that XLA
// fuses into a pass per group; its port, training/optimizer.py `_adam_plain`,
// runs 14 PyTorch operations a group, 84 launches a step for the six groups,
// that read 19 and write 14 full-size tensors: 33 passes over the store
// where the update needs 7. That composition stays as this kernel's plain
// version. Wrapper, descriptor table and checks: ops/adam.py.
//
// What it computes. For each float of each group, with b1, b2, eps and the
// step's rates lr[group] and bias corrections bc1, bc2 (read from the
// device `scalars` array, so a captured step replays with each step's
// values):
//   m' = b1 m + (1 - b1) g,  v' = b2 v + (1 - b2) g g,
//   p' = p - lr (m' / bc1) / (sqrt(v' / bc2) + eps).
// With a row mask (`visible`, sparse Adam) a row off the mask keeps p, m
// and v, as torch.where does in the plain version. Inputs and outputs are
// separate pointers: the update in place passes the same ones.
//
// Rounding. Each operation rounds where the plain version's PyTorch CUDA
// operations round, in their order, so the two give the same bits: a Python
// scalar enters as the float of its double value, (1 - b2) g rounds before
// the second g, both divisions divide by a device value (true divisions,
// not multiplications by a reciprocal), and the square root is correctly
// rounded. The arithmetic uses the _rn intrinsics and the file is built with
// --fmad=false, so nothing contracts to an FMA.
//
// What bounds it on an H100. Bytes: 7 floats a parameter, 59 parameters a
// splat at SH degree 3, so 1,652 B a splat; the arithmetic is a dozen flops
// a float (two divisions and a square root among them), far below the
// card's rate. Times beside this bound: PERF.md section 6, row A.
//
// Design. One pass, one launch for all six groups. The wrapper passes a
// table of group descriptors by value; a block works inside one group,
// found from the groups' first blocks. A contiguous group whose seven
// arrays start on 16-byte boundaries moves 16 bytes a thread (float4) and
// finishes its ragged tail a float at a time; any other group (a gradient
// whose rows are strided, as the mesh's ZeRO-1 update passes them: column
// slices of one (rows, 59) table) takes a float a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 8;
constexpr int kDescFields = 12;  // ops/adam.py DESC_FIELDS

struct Group {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  long long rows;
  long long width;     // floats a row
  long long g_stride;  // floats from one gradient row to the next
  long long n;         // rows * width
  long long first;     // the group's first block
  int lr;              // index of the group's rate in `scalars`
  int vec;             // 1: 16 bytes a thread
};

struct Table {
  Group grp[kMaxGroups];
  int count;
  int bc;  // index of bc1 in `scalars`; bc2 follows it
};

struct Consts {
  float b1, c1, b2, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2, each rounded from double
};

__device__ __forceinline__ void adam_one(float p, float g, float m, float v, bool on,
                                         float lr, float bc1, float bc2, const Consts& k,
                                         float& po, float& mo, float& vo) {
  const float mn = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.c1, g));
  const float vn = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.c2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, bc2)), k.eps);
  const float upd = __fdiv_rn(__fdiv_rn(mn, bc1), den);
  const float pn = __fsub_rn(p, __fmul_rn(lr, upd));
  po = on ? pn : p;
  mo = on ? mn : m;
  vo = on ? vn : v;
}

// Element e of group G, a float at a time; row and col locate it.
__device__ __forceinline__ void scalar_one(const Group& G, long long e, long long row,
                                           long long col, const unsigned char* visible,
                                           float lr, float bc1, float bc2, const Consts& k) {
  const bool on = visible == nullptr || visible[row] != 0;
  float po, mo, vo;
  adam_one(G.p[e], G.g[row * G.g_stride + col], G.m[e], G.v[e], on, lr, bc1, bc2, k, po,
           mo, vo);
  G.p_out[e] = po;
  G.m_out[e] = mo;
  G.v_out[e] = vo;
}

__global__ void __launch_bounds__(kThreads) adam_update_kernel(
    const __grid_constant__ Table t, const float* __restrict__ scalars,
    const unsigned char* __restrict__ visible, const Consts k) {
  const long long b = blockIdx.x;
  int gi = 0;
  for (int q = 1; q < t.count; ++q) gi = b >= t.grp[q].first ? q : gi;
  const Group& G = t.grp[gi];
  const float lr = scalars[G.lr], bc1 = scalars[t.bc], bc2 = scalars[t.bc + 1];
  const long long unit = (b - G.first) * kThreads + threadIdx.x;
  if (!G.vec) {
    if (unit >= G.n) return;
    const long long row = unit / G.width;
    scalar_one(G, unit, row, unit - row * G.width, visible, lr, bc1, bc2, k);
    return;
  }
  const long long e0 = unit * 4;
  if (e0 >= G.n) return;
  long long row = e0 / G.width, col = e0 - row * G.width;
  if (e0 + 4 > G.n) {  // the ragged tail
    for (long long e = e0; e < G.n; ++e) {
      scalar_one(G, e, row, col, visible, lr, bc1, bc2, k);
      if (++col == G.width) col = 0, ++row;
    }
    return;
  }
  bool on[4] = {true, true, true, true};
  if (visible != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      on[j] = visible[row] != 0;
      if (++col == G.width) col = 0, ++row;
    }
  }
  const float4 p = reinterpret_cast<const float4*>(G.p)[unit];
  const float4 g = reinterpret_cast<const float4*>(G.g)[unit];
  const float4 m = reinterpret_cast<const float4*>(G.m)[unit];
  const float4 v = reinterpret_cast<const float4*>(G.v)[unit];
  float4 po, mo, vo;
  adam_one(p.x, g.x, m.x, v.x, on[0], lr, bc1, bc2, k, po.x, mo.x, vo.x);
  adam_one(p.y, g.y, m.y, v.y, on[1], lr, bc1, bc2, k, po.y, mo.y, vo.y);
  adam_one(p.z, g.z, m.z, v.z, on[2], lr, bc1, bc2, k, po.z, mo.z, vo.z);
  adam_one(p.w, g.w, m.w, v.w, on[3], lr, bc1, bc2, k, po.w, mo.w, vo.w);
  reinterpret_cast<float4*>(G.p_out)[unit] = po;
  reinterpret_cast<float4*>(G.m_out)[unit] = mo;
  reinterpret_cast<float4*>(G.v_out)[unit] = vo;
}

}  // namespace

// desc: `count` rows of kDescFields int64 on the host, each
// (p, g, m, v, p_out, m_out, v_out, rows, width, g_stride, lr, vec).
extern "C" int gs_adam_update(const void* desc, int count, const void* scalars, int bc,
                              const void* visible, float b1, float c1, float b2, float c2,
                              float eps, void* stream) {
  if (count < 0 || count > kMaxGroups) return (int)cudaErrorInvalidValue;
  Table t = {};
  t.count = count;
  t.bc = bc;
  long long blocks = 0;
  const long long* d = (const long long*)desc;
  for (int i = 0; i < count; ++i, d += kDescFields) {
    Group& G = t.grp[i];
    G.p = (const float*)d[0];
    G.g = (const float*)d[1];
    G.m = (const float*)d[2];
    G.v = (const float*)d[3];
    G.p_out = (float*)d[4];
    G.m_out = (float*)d[5];
    G.v_out = (float*)d[6];
    G.rows = d[7];
    G.width = d[8];
    G.g_stride = d[9];
    G.lr = (int)d[10];
    G.vec = (int)d[11];
    G.n = G.rows * G.width;
    G.first = blocks;
    const long long units = G.vec ? (G.n + 3) / 4 : G.n;
    blocks += (units + kThreads - 1) / kThreads;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    const Consts k = {b1, c1, b2, c2, eps};
    adam_update_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        t, (const float*)scalars, (const unsigned char*)visible, k);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
