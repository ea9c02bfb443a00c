// K5: VALID separable Gaussian blur of SSIM's stack, any odd window from 3
// to 15 taps.
//
// Replaces the TPU kernel `_blur_kernel` of
// gaussian_splatting_lightning_tpu/ops/ssim.py (reached through `_blur_call`;
// its custom VJP is the same kernel on the zero-embedded cotangent). Wrapper,
// plain PyTorch version, autograd function and launch counter:
// gaussian_splatting_lightning_tpu_torch/ops/ssim.py.
//
// What it computes. x is (C, Hp, Wp) f32, read as if embedded in `margin`
// zeros on every side (xe, (C, Hp + 2 margin, Wp + 2 margin)); with a
// window of w taps, y is (C, Hp + 2 margin - w + 1, Wp + 2 margin - w + 1)
// with
//   mid[c, i, q] = sum_k taps[k] xe[c, i + k, q]     (vertical taps first)
//   y[c, i, j]   = sum_k taps[k] mid[c, i, j + k]    (then horizontal)
// summed k = 0..w-1 in that order. The window is symmetric, so the adjoint
// of the map with margin 0 is the same blur of the cotangent with margin
// w - 1; the wrapper's autograd function launches this kernel for both, and
// the cotangent is never padded in memory.
//
// The window is a template parameter (one instance per odd w from 3 to 15;
// the entry returns kNoInstance for any other) and the taps are a launch
// argument, a struct passed by value: a captured CUDA graph records them
// with the launch, where a copy to a __constant__ symbol would be a host
// step the graph does not replay.
//
// What bounds it on an H100. Bytes: each input read once and each output
// written once (4w - 2 rounded operations per output are far below the
// card's f32 rate).
//
// Design. A block of 128 threads owns a strip of 512 input columns and
// kRowsOut = 6 w - (w - 1) output rows of one channel (56 at w = 11); thread
// t owns columns 4t..4t+3. Input rows arrive w at a time (a "cycle") through
// cp.async into one of two stages in dynamic shared memory (2 w x 512
// floats: 45 KB at w = 11, 61 KB at w = 15), zero-filled outside x: the next
// cycle's copy is in flight while this one is computed. The vertical pass
// keeps the last w input rows of the thread's four columns in registers (a
// ring whose slot is the row's index mod w; the cycle loop is unrolled by
// w, so every slot index is static), so each input element is loaded from
// shared memory once and from device memory once per strip (halo
// (kRowsOut + w - 1) / kRowsOut vertically, 512 / kStripOut horizontally,
// the re-read served mostly by L2). A thread writes its mid values over the
// stage slots it alone read, and after one barrier the horizontal pass
// reads the w + 3 mid values of its four outputs as whole float4 loads:
// about one shared load per output. The strip's output columns are the
// whole quads of 512 - (w - 1). Every product and sum is rounded op by op
// (__fmul_rn/__fadd_rn) in the plain version's order, so the two agree to
// the bit. The six cycles a block (56 rows at w = 11) were chosen by
// measurement on the card: at the bench shapes they give 1200 blocks, 1.8
// waves of five blocks per SM. The TPU kernel's look-ahead second input
// block and lane rolls answer TPU blocking limits and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWin = 15;
constexpr int kThreads = 128;
constexpr int kStripIn = 4 * kThreads;       // input columns staged per block
constexpr int kCycles = 6;                   // cycles of w input rows per block
constexpr int kLoads = kStripIn / kThreads;  // columns a thread copies per row
constexpr int kNoInstance = -1;              // the entry's code for a window without one

// the window's taps, passed by value as a launch argument
struct Taps {
  float v[kMaxWin + 1];
};

template <int kWin>
struct Shape {
  static_assert(kWin % 2 == 1 && kWin >= 3 && kWin <= kMaxWin, "odd windows 3..15");
  static constexpr int kHalo = kWin - 1;
  static constexpr int kQuadsOut = (kStripIn - kHalo) / 4;  // whole output quads a strip holds
  static constexpr int kStripOut = 4 * kQuadsOut;
  static constexpr int kMidQuads = (kWin + 3 + 3) / 4;  // float4 loads of a quad's w + 3 mids
  static constexpr int kRowsOut = kCycles * kWin - kHalo;
  static constexpr int kStage = kWin * kStripIn;  // floats per stage
  static constexpr int kSmemBytes = 2 * kStage * (int)sizeof(float);
  static_assert(kQuadsOut - 1 + kMidQuads <= kThreads, "the last quad's mids lie in the strip");
};

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));  // a source size of 0 writes a zero
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// sum_k taps[k] v[k], rounded op by op in tap order
template <int kWin>
__device__ __forceinline__ float taps_dot(const float* v, const Taps& taps) {
  float acc = __fmul_rn(v[0], taps.v[0]);
#pragma unroll
  for (int k = 1; k < kWin; ++k) acc = __fadd_rn(acc, __fmul_rn(v[k], taps.v[k]));
  return acc;
}

// four adjacent outputs at dst, of which `left` lie inside the row; rows of
// width w start 16-byte aligned when w % 4 == 0, 8-byte aligned when even
__device__ __forceinline__ void store4(float* dst, const float (&o)[4], int left, int w) {
  if (left >= 4 && (w & 3) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else if (left >= 4 && (w & 1) == 0) {
    reinterpret_cast<float2*>(dst)[0] = make_float2(o[0], o[1]);
    reinterpret_cast<float2*>(dst)[1] = make_float2(o[2], o[3]);
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (p < left) dst[p] = o[p];
  }
}

// Copy rows row0 .. row0 + w - 1 of x (one channel, rows outside [0, hp) and
// columns outside [0, wp) as zeros) into a stage: thread t copies the
// columns t + 128 u of the strip, u = 0..3, whose sources are src_col[u]
template <int kWin>
__device__ __forceinline__ void issue_cycle(float* dst, const float* xc, int row0, int hp,
                                            int wp, const int (&src_col)[kLoads],
                                            const bool (&col_ok)[kLoads]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int s = 0; s < kWin; ++s) {
    const int sr = row0 + s;
    const bool row_ok = sr >= 0 && sr < hp;
    const float* row = xc + (size_t)(row_ok ? sr : 0) * wp;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const bool ok = row_ok && col_ok[u];
      copy4(dst + s * kStripIn + t + u * kThreads, ok ? row + src_col[u] : xc, ok);
    }
  }
  commit();
}

template <int kWin>
__global__ void __launch_bounds__(kThreads) blur_valid_kernel(
    const float* __restrict__ x, float* __restrict__ y, int hp, int wp, int margin,
    int h, int w, const __grid_constant__ Taps taps) {
  using S = Shape<kWin>;
  extern __shared__ __align__(16) float stage[];  // two stages of S::kStage floats
  const int t = threadIdx.x;
  const int ox = blockIdx.x * S::kStripOut;  // first output (= input) column of xe
  const int oy = blockIdx.y * S::kRowsOut;   // first output (= input) row of xe
  const int c = blockIdx.z;
  const float* xc = x + (size_t)c * hp * wp;
  const int rows_out = min(S::kRowsOut, h - oy);
  const int cycles = (rows_out + S::kHalo + kWin - 1) / kWin;

  int src_col[kLoads];
  bool col_ok[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    src_col[u] = ox + t + u * kThreads - margin;
    col_ok[u] = src_col[u] >= 0 && src_col[u] < wp;
  }
  float4 ring[kWin];
  issue_cycle<kWin>(stage, xc, oy - margin, hp, wp, src_col, col_ok);
  for (int cyc = 0; cyc < cycles; ++cyc) {
    wait_all();
    // this cycle's rows have landed everywhere, and every thread is done
    // with the other stage (last cycle's horizontal pass)
    __syncthreads();
    if (cyc + 1 < cycles) {
      issue_cycle<kWin>(stage + ((cyc + 1) & 1) * S::kStage, xc,
                        oy + (cyc + 1) * kWin - margin, hp, wp, src_col, col_ok);
    }
    float* in = stage + (cyc & 1) * S::kStage;
#pragma unroll
    for (int s = 0; s < kWin; ++s) {
      float4* slot = reinterpret_cast<float4*>(in + s * kStripIn) + t;
      ring[s] = *slot;
      if (cyc > 0 || s == S::kHalo) {
        // mid row cyc * w + s - (w - 1) from rows in slots (s + 1 + k) % w
        float vx[kWin], vy[kWin], vz[kWin], vw[kWin];
#pragma unroll
        for (int k = 0; k < kWin; ++k) {
          const float4 r = ring[(s + 1 + k) % kWin];
          vx[k] = r.x;
          vy[k] = r.y;
          vz[k] = r.z;
          vw[k] = r.w;
        }
        *slot = make_float4(taps_dot<kWin>(vx, taps), taps_dot<kWin>(vy, taps),
                            taps_dot<kWin>(vz, taps), taps_dot<kWin>(vw, taps));
      }
    }
    __syncthreads();
    const int gx = ox + 4 * t;
    if (t < S::kQuadsOut && gx < w) {
      for (int s = 0; s < kWin; ++s) {
        const int i = cyc * kWin + s - S::kHalo;  // output row within the block
        if (i < 0 || i >= rows_out) continue;
        const float4* mrow = reinterpret_cast<const float4*>(in + s * kStripIn) + t;
        float v[4 * S::kMidQuads];
#pragma unroll
        for (int q = 0; q < S::kMidQuads; ++q) {
          const float4 m = mrow[q];
          v[4 * q] = m.x;
          v[4 * q + 1] = m.y;
          v[4 * q + 2] = m.z;
          v[4 * q + 3] = m.w;
        }
        float o[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) o[p] = taps_dot<kWin>(v + p, taps);
        store4(y + ((size_t)c * h + oy + i) * w + gx, o, w - gx, w);
      }
    }
  }
}

template <int kWin>
cudaError_t set_attributes() {
  const cudaError_t err = cudaFuncSetAttribute(
      blur_valid_kernel<kWin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Shape<kWin>::kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(blur_valid_kernel<kWin>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int kWin>
int launch(const float* x, float* y, int c, int hp, int wp, int margin, const float* taps_in,
           cudaStream_t stream) {
  using S = Shape<kWin>;
  const int h = hp + 2 * margin - S::kHalo;
  const int w = wp + 2 * margin - S::kHalo;
  if (c > 0 && h > 0 && w > 0) {
    static const cudaError_t attr = set_attributes<kWin>();
    if (attr != cudaSuccess) return (int)attr;
    Taps taps = {};
    for (int k = 0; k < kWin; ++k) taps.v[k] = taps_in[k];
    const dim3 grid((w + S::kStripOut - 1) / S::kStripOut, (h + S::kRowsOut - 1) / S::kRowsOut,
                    c);
    blur_valid_kernel<kWin><<<grid, kThreads, S::kSmemBytes, stream>>>(x, y, hp, wp, margin,
                                                                       h, w, taps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y = the VALID blur of x (read with a zero margin of `margin`) by the
// window of `win` taps at `taps` (host memory)
extern "C" int gs_blur_valid(const void* x, void* y, int c, int hp, int wp, int margin, int win,
                             const void* taps, void* stream) {
  const float* xf = (const float*)x;
  float* yf = (float*)y;
  const float* tf = (const float*)taps;
  cudaStream_t st = (cudaStream_t)stream;
  switch (win) {
    case 3: return launch<3>(xf, yf, c, hp, wp, margin, tf, st);
    case 5: return launch<5>(xf, yf, c, hp, wp, margin, tf, st);
    case 7: return launch<7>(xf, yf, c, hp, wp, margin, tf, st);
    case 9: return launch<9>(xf, yf, c, hp, wp, margin, tf, st);
    case 11: return launch<11>(xf, yf, c, hp, wp, margin, tf, st);
    case 13: return launch<13>(xf, yf, c, hp, wp, margin, tf, st);
    case 15: return launch<15>(xf, yf, c, hp, wp, margin, tf, st);
    default: return kNoInstance;
  }
}

extern "C" const char* gs_error_string(int code) {
  if (code == kNoInstance) return "no K5 instance for this window (odd windows 3 to 15)";
  return cudaGetErrorString((cudaError_t)code);
}
