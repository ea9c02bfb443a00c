// K3: per-pair gradients of the forward compositor (the backward rasterizer).
//
// Replaces the TPU kernel `_bwd_kernel` of
// gaussian_splatting_lightning_tpu/ops/rasterize_pallas.py (reached through
// `_bwd_call`). Wrapper, plain PyTorch version and launch counter:
// gaussian_splatting_lightning_tpu_torch/ops/rasterize.py.
//
// What it computes. For tile t, pair k of its depth-sorted range (splat
// gauss_s[k], feature row [px py ca cb cc op r g b 1/z x0 x1 y0 y1 - -]) and
// the cotangent G = dL/d[r g b invd] of K2's output at each pixel, it re-walks
// the tile front to back with K2's exact alpha chain and takes, per pixel,
//   E = G . (r, g, b, 1/z),  prefix += w E,  suffix = G . out - prefix,
//   d_alpha = [T > 1e-4] E T - suffix / (1 - alpha),
//   d_power = d_alpha alpha if alpha was not clamped at 0.99, else 0,
// where G . out already holds G . T_fin bg (the forward output has the
// background composited in), so suffix is the colour behind the pair. Killed
// and rect-masked alphas give no gradient at all. Each pair's ten gradients
// are pixel sums: five moments of d_power (1, dx, dy, dx dx, dx dy, dy dy)
// turn into the position and conic gradients, d_op = sum d_power / op, and
// d(r, g, b, 1/z) = sum G w. The row is written to dpair[slot_s[k]] (the
// pair's expansion slot), so K4 can sum each splat's slots as one range.
//
// What bounds it on an H100. Operations: about 20 f32 operations per
// (pair, pixel) evaluation up to the kill decision, as in K2, plus 38 for
// each evaluation that passes it (28 in the gradient chain, one add into
// each of the ten pixel sums), against ~120 bytes moved per canvas pixel.
//
// Design. One block per tile, one thread per pixel, as K2. Pairs are staged
// in shared memory 32 at a time; each thread walks them serially with K2's
// op-by-op rounding (__fmul_rn/__fadd_rn, expf), so every alpha, T and
// early-stop vote is bit-identical to K2's: the block votes only after each
// 256 pairs, where K2 voted, and ends the tile where K2 ended it. The prefix,
// suffix and d_alpha chain is rounded op by op too, so each pixel's ten
// terms equal the plain version's. The pixel sums are fixed-order: a warp
// butterfly (skipped when no lane of the warp passed the kill, whose terms
// are all zero), per-warp partials in shared memory, then a sum in warp
// order. No float atomics: the result is the same run after run. The TPU
// kernel's log-space cumsum, 128-lane windows, VMEM carry for shared
// boundary chunks and bf16 routing are answers to TPU limits and are not
// carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 256;  // K2's shared-memory batch: its early-stop vote
constexpr int kSub = 32;     // pairs staged in shared memory at a time
constexpr int kGrad = 10;    // d px py ca cb cc op r g b 1/z
constexpr int kMaxWarps = 32;
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same, order-fixed sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(1024) composite_bwd_kernel(
    const float4* __restrict__ gfeat, const int* __restrict__ gauss_s,
    const int* __restrict__ slot_s, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const float* __restrict__ out,
    const float* __restrict__ grad_out, float* __restrict__ dpair, int grid_x,
    int block, int tile_y_offset, int rect_mask, int early_stop) {
  __shared__ float4 rows[kSub][4];
  __shared__ int slots[kSub];
  // per-warp partial sums, one row per (pair, gradient); the +1 column keeps
  // the warp-order sums below free of bank conflicts
  __shared__ float part[kSub * kGrad][kMaxWarps + 1];
  __shared__ float msum[kSub][kGrad];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int pix = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarps = pix >> 5;
  const float px = (float)(p % block) + (float)((t % grid_x) * block);
  const float py = (float)(p / block) + (float)((t / grid_x + tile_y_offset) * block);
  const float sx = floorf(px * 0.0625f);
  const float sy = floorf(py * 0.0625f);
  const int start = tile_start[t];
  const int count = tile_count[t];

  const float* o = out + (size_t)t * 4 * pix + p;
  const float* g = grad_out + (size_t)t * 4 * pix + p;
  const float G0 = g[0], G1 = g[pix], G2 = g[2 * pix], G3 = g[3 * pix];
  const float g_total = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(G0, o[0]), __fmul_rn(G1, o[pix])),
                __fmul_rn(G2, o[2 * pix])),
      __fmul_rn(G3, o[3 * pix]));

  float T = 1.0f;
  float prefix = 0.0f;
  for (int base = 0; base < count; base += kSub) {
    const int n = min(kSub, count - base);
    __syncthreads();  // the previous sub-batch is consumed by every thread
    for (int j = p; j < 4 * n; j += pix) {
      const int gi = gauss_s[start + base + (j >> 2)];
      rows[j >> 2][j & 3] = gfeat[(size_t)gi * 4 + (j & 3)];
    }
    if (p < n) slots[p] = slot_s[start + base + p];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 f0 = rows[j][0];  // px py ca cb
      const float4 f1 = rows[j][1];  // cc op r g
      const float4 f2 = rows[j][2];  // b invz x0 x1
      const float dx = f0.x - px;
      const float dy = f0.y - py;
      const float qa = __fmul_rn(__fmul_rn(f0.z, dx), dx);
      const float qb = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, f0.w), dx), dy);
      const float qc = __fmul_rn(__fmul_rn(f1.x, dy), dy);
      const float power = __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(qa, qb), qc));
      const float raw = __fmul_rn(expf(power), f1.y);
      const float alpha = fminf(raw, kAlphaClamp);
      bool keep = alpha > kAlphaThreshold;
      if (rect_mask) {
        const float4 f3 = rows[j][3];  // y0 y1 - -
        keep = keep && sx >= f2.z && sx < f2.w && sy >= f3.x && sy < f3.y;
      }
      float v[kGrad];
#pragma unroll
      for (int k = 0; k < kGrad; ++k) v[k] = 0.0f;
      if (keep) {
        const bool live = T > kTransmittanceEps;
        const float w = live ? __fmul_rn(alpha, T) : 0.0f;
        const float E = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(G0, f1.z), __fmul_rn(G1, f1.w)),
                      __fmul_rn(G2, f2.x)),
            __fmul_rn(G3, f2.y));
        prefix = __fadd_rn(prefix, __fmul_rn(w, E));
        const float suffix = __fsub_rn(g_total, prefix);
        const float one_minus = __fsub_rn(1.0f, alpha);
        const float d_alpha = __fsub_rn(live ? __fmul_rn(E, T) : 0.0f,
                                        __fdiv_rn(suffix, one_minus));
        const float d_power = raw < kAlphaClamp ? __fmul_rn(d_alpha, alpha) : 0.0f;
        v[0] = d_power;
        v[1] = __fmul_rn(d_power, dx);
        v[2] = __fmul_rn(d_power, dy);
        v[3] = __fmul_rn(v[1], dx);
        v[4] = __fmul_rn(v[1], dy);
        v[5] = __fmul_rn(v[2], dy);
        v[6] = __fmul_rn(G0, w);
        v[7] = __fmul_rn(G1, w);
        v[8] = __fmul_rn(G2, w);
        v[9] = __fmul_rn(G3, w);
        T = __fmul_rn(T, one_minus);
      }
      if (__any_sync(kFull, keep)) {
#pragma unroll
        for (int k = 0; k < kGrad; ++k) v[k] = warp_sum(v[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kGrad; ++k) part[j * kGrad + k][warp] = v[k];
      }
    }
    __syncthreads();
    for (int i = p; i < n * kGrad; i += pix) {
      float s = 0.0f;
      for (int wi = 0; wi < nwarps; ++wi) s += part[i][wi];
      msum[i / kGrad][i % kGrad] = s;
    }
    __syncthreads();
    if (p < n) {
      const float4 f0 = rows[p][0];
      const float4 f1 = rows[p][1];
      const float* m = msum[p];
      float* d = dpair + (size_t)slots[p] * kGrad;
      d[0] = -(f0.z * m[1] + f0.w * m[2]);
      d[1] = -(f0.w * m[1] + f1.x * m[2]);
      d[2] = -0.5f * m[3];
      d[3] = -m[4];
      d[4] = -0.5f * m[5];
      d[5] = m[0] / fmaxf(f1.y, 1e-30f);
#pragma unroll
      for (int k = 6; k < kGrad; ++k) d[k] = m[k];
    }
    // K2 votes after each of its 256-pair batches: vote at the same places
    if (early_stop && (base + n) % kBatch == 0 &&
        !__syncthreads_or(T > kTransmittanceEps))
      break;
  }
}

}  // namespace

extern "C" int gs_composite_bwd(
    const void* gfeat, const void* gauss_s, const void* slot_s,
    const void* tile_start, const void* tile_count, const void* out,
    const void* grad_out, void* dpair, int n_tiles, int grid_x, int block,
    int tile_y_offset, int rect_mask, int early_stop, void* stream) {
  if (n_tiles > 0) {
    composite_bwd_kernel<<<n_tiles, block * block, 0, (cudaStream_t)stream>>>(
        (const float4*)gfeat, (const int*)gauss_s, (const int*)slot_s,
        (const int*)tile_start, (const int*)tile_count, (const float*)out,
        (const float*)grad_out, (float*)dpair, grid_x, block, tile_y_offset,
        rect_mask, early_stop);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
