// K5: VALID separable 11x11 Gaussian blur (sigma 1.5) of SSIM's stack.
//
// Replaces the TPU kernel `_blur_kernel` of
// gaussian_splatting_lightning_tpu/ops/ssim.py (reached through `_blur_call`;
// its custom VJP is the same kernel on the zero-embedded cotangent). Wrapper,
// plain PyTorch version, autograd function and launch counter:
// gaussian_splatting_lightning_tpu_torch/ops/ssim.py.
//
// What it computes. x is (C, Hp, Wp) f32, read as if embedded in `margin`
// zeros on every side (xe, (C, Hp + 2 margin, Wp + 2 margin)); y is
// (C, Hp + 2 margin - 10, Wp + 2 margin - 10) with
//   mid[c, i, q] = sum_k kTaps[k] xe[c, i + k, q]     (vertical taps first)
//   y[c, i, j]   = sum_k kTaps[k] mid[c, i, j + k]    (then horizontal)
// summed k = 0..10 in that order. The window is symmetric, so the adjoint
// of the map with margin 0 is the same blur of the cotangent with margin 10;
// the wrapper's autograd function launches this kernel for both, and the
// cotangent is never padded in memory.
//
// What bounds it on an H100. Bytes: each input read once and each output
// written once (42 rounded operations per output are far below the card's
// f32 rate).
//
// Design. A block of 128 threads owns a strip of 512 input columns (500
// output columns) and 56 output rows of one channel; thread t owns columns
// 4t..4t+3. Input rows arrive 11 at a time (a "cycle") through cp.async into
// one of two shared stages, zero-filled outside x: the next cycle's copy is
// in flight while this one is computed. The vertical pass keeps the last 11
// input rows of the thread's four columns in registers (a ring whose slot is
// the row's index mod 11; the cycle loop is unrolled by 11, so every slot
// index is static), so each input element is loaded from shared memory once
// and from device memory once per strip (halo (56 + 10) / 56 vertically,
// 512 / 500 horizontally, the re-read served mostly by L2). A thread writes
// its mid values over the stage slots it alone read, and after one barrier
// the horizontal pass reads the 14 mid values of its four outputs as four
// float4 loads: about one shared load per output. Every product and sum is
// rounded op by op (__fmul_rn/__fadd_rn) in the plain version's order, so
// the two agree to the bit. The strip's 56 rows were chosen by measurement
// on the card: at the bench shapes they give 1200 blocks, 1.8 waves of five
// blocks per SM (45 KB of shared memory each). The TPU kernel's look-ahead
// second input block and lane rolls answer TPU blocking limits and are not
// carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kWin = 11;
constexpr int kHalo = kWin - 1;
constexpr int kThreads = 128;
constexpr int kStripIn = 4 * kThreads;       // input columns staged per block
constexpr int kStripOut = kStripIn - 12;     // whole quads whose 14 mids lie in the strip
constexpr int kQuadsOut = kStripOut / 4;
constexpr int kCycles = 6;                   // cycles of kWin input rows per block
constexpr int kRowsOut = kCycles * kWin - kHalo;  // 56 output rows per block
constexpr int kStage = kWin * kStripIn;      // floats per stage
constexpr int kLoads = kStripIn / kThreads;  // columns a thread copies per row

// The normalised window exp(-x^2 / 4.5), x = -5..5, computed in float64 and
// rounded to f32 (ssim.py's gaussian_window; tests/test_torch_ssim.py holds
// these literals to it bit for bit).
__constant__ float kTaps[kWin] = {
    0x1.0d956cp-10f, 0x1.f1fe02p-8f, 0x1.26eb18p-5f, 0x1.bff0fep-4f,
    0x1.b43c40p-3f,  0x1.106560p-2f, 0x1.b43c40p-3f, 0x1.bff0fep-4f,
    0x1.26eb18p-5f,  0x1.f1fe02p-8f, 0x1.0d956cp-10f};

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));  // a source size of 0 writes a zero
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// sum_k kTaps[k] v[k], rounded op by op in tap order
__device__ __forceinline__ float taps_dot(const float* v) {
  float acc = __fmul_rn(v[0], kTaps[0]);
#pragma unroll
  for (int k = 1; k < kWin; ++k) acc = __fadd_rn(acc, __fmul_rn(v[k], kTaps[k]));
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

// Copy rows row0 .. row0 + 10 of x (one channel, rows outside [0, hp) and
// columns outside [0, wp) as zeros) into a stage: thread t copies the
// columns t + 128 u of the strip, u = 0..3, whose sources are src_col[u]
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

__global__ void __launch_bounds__(kThreads) blur_valid_kernel(
    const float* __restrict__ x, float* __restrict__ y, int hp, int wp, int margin,
    int h, int w) {
  __shared__ __align__(16) float stage[2][kStage];
  const int t = threadIdx.x;
  const int ox = blockIdx.x * kStripOut;  // first output (= input) column of xe
  const int oy = blockIdx.y * kRowsOut;   // first output (= input) row of xe
  const int c = blockIdx.z;
  const float* xc = x + (size_t)c * hp * wp;
  const int rows_out = min(kRowsOut, h - oy);
  const int cycles = (rows_out + kHalo + kWin - 1) / kWin;

  int src_col[kLoads];
  bool col_ok[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    src_col[u] = ox + t + u * kThreads - margin;
    col_ok[u] = src_col[u] >= 0 && src_col[u] < wp;
  }
  float4 ring[kWin];
  issue_cycle(stage[0], xc, oy - margin, hp, wp, src_col, col_ok);
  for (int cyc = 0; cyc < cycles; ++cyc) {
    wait_all();
    // this cycle's rows have landed everywhere, and every thread is done
    // with the other stage (last cycle's horizontal pass)
    __syncthreads();
    if (cyc + 1 < cycles) {
      issue_cycle(stage[(cyc + 1) & 1], xc, oy + (cyc + 1) * kWin - margin, hp, wp,
                  src_col, col_ok);
    }
    float* in = stage[cyc & 1];
#pragma unroll
    for (int s = 0; s < kWin; ++s) {
      float4* slot = reinterpret_cast<float4*>(in + s * kStripIn) + t;
      ring[s] = *slot;
      if (cyc > 0 || s == kHalo) {
        // mid row cyc * 11 + s - 10 from rows in slots (s + 1 + k) % 11
        float vx[kWin], vy[kWin], vz[kWin], vw[kWin];
#pragma unroll
        for (int k = 0; k < kWin; ++k) {
          const float4 r = ring[(s + 1 + k) % kWin];
          vx[k] = r.x;
          vy[k] = r.y;
          vz[k] = r.z;
          vw[k] = r.w;
        }
        *slot = make_float4(taps_dot(vx), taps_dot(vy), taps_dot(vz), taps_dot(vw));
      }
    }
    __syncthreads();
    const int gx = ox + 4 * t;
    if (t < kQuadsOut && gx < w) {
      for (int s = 0; s < kWin; ++s) {
        const int i = cyc * kWin + s - kHalo;  // output row within the block
        if (i < 0 || i >= rows_out) continue;
        const float4* mrow = reinterpret_cast<const float4*>(in + s * kStripIn) + t;
        float v[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 m = mrow[q];
          v[4 * q] = m.x;
          v[4 * q + 1] = m.y;
          v[4 * q + 2] = m.z;
          v[4 * q + 3] = m.w;
        }
        float o[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) o[p] = taps_dot(v + p);
        store4(y + ((size_t)c * h + oy + i) * w + gx, o, w - gx, w);
      }
    }
  }
}

}  // namespace

extern "C" int gs_blur_valid(const void* x, void* y, int c, int hp, int wp, int margin,
                             void* stream) {
  const int h = hp + 2 * margin - kHalo;
  const int w = wp + 2 * margin - kHalo;
  if (c > 0 && h > 0 && w > 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        blur_valid_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((w + kStripOut - 1) / kStripOut, (h + kRowsOut - 1) / kRowsOut, c);
    blur_valid_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, hp, wp, margin, h, w);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
