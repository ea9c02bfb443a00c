// K5: VALID separable 11x11 Gaussian blur (sigma 1.5) of SSIM's stack.
//
// Replaces the TPU kernel `_blur_kernel` of
// gaussian_splatting_lightning_tpu/ops/ssim.py (reached through `_blur_call`;
// its custom VJP is the same kernel on the zero-padded cotangent). Wrapper,
// plain PyTorch version, autograd function and launch counter:
// gaussian_splatting_lightning_tpu_torch/ops/ssim.py.
//
// What it computes. x is (C, Hp, Wp) f32; y (C, Hp - 10, Wp - 10) with
//   mid[c, i, q] = sum_k kTaps[k] x[c, i + k, q]     (vertical taps first)
//   y[c, i, j]   = sum_k kTaps[k] mid[c, i, j + k]   (then horizontal)
// summed k = 0..10 in that order. The window is symmetric, so the adjoint
// of this map is the same blur of the cotangent zero-padded by 10 on every
// side; the wrapper's autograd function launches this kernel for both.
//
// What bounds it on an H100. Bytes: each input read once and each output
// written once (22 multiply-adds per output is far below the card's rate).
//
// Design. One block per 32x32 output tile of one channel, 256 threads. The
// block loads its 42x42 input tile (10-pixel halo, zeros past the edge) into
// shared memory, runs the vertical taps into a 32x42 shared tile, then the
// horizontal taps, all f32. Every product and sum is rounded op by op
// (__fmul_rn/__fadd_rn) in the plain version's order, so the two agree to
// the bit. The TPU kernel's look-ahead second input block and lane rolls
// answer TPU blocking limits and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kWin = 11;
constexpr int kHalo = kWin - 1;
constexpr int kTile = 32;
constexpr int kIn = kTile + kHalo;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

// The normalised window exp(-x^2 / 4.5), x = -5..5, computed in float64 and
// rounded to f32 (ssim.py's gaussian_window; tests/test_torch_ssim.py holds
// these literals to it bit for bit).
__constant__ float kTaps[kWin] = {
    0x1.0d956cp-10f, 0x1.f1fe02p-8f, 0x1.26eb18p-5f, 0x1.bff0fep-4f,
    0x1.b43c40p-3f,  0x1.106560p-2f, 0x1.b43c40p-3f, 0x1.bff0fep-4f,
    0x1.26eb18p-5f,  0x1.f1fe02p-8f, 0x1.0d956cp-10f};

__global__ void __launch_bounds__(kThreadsX * kThreadsY) blur_valid_kernel(
    const float* __restrict__ x, float* __restrict__ y, int hp, int wp, int h, int w) {
  __shared__ float in[kIn][kIn + 1];
  __shared__ float mid[kTile][kIn + 1];
  const int c = blockIdx.z;
  const int ox = blockIdx.x * kTile;
  const int oy = blockIdx.y * kTile;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthr = kThreadsX * kThreadsY;
  const float* xc = x + (size_t)c * hp * wp;
  for (int i = tid; i < kIn * kIn; i += nthr) {
    const int r = i / kIn;
    const int q = i - r * kIn;
    const int gy = oy + r;
    const int gx = ox + q;
    in[r][q] = (gy < hp && gx < wp) ? xc[(size_t)gy * wp + gx] : 0.0f;
  }
  float tp[kWin];
#pragma unroll
  for (int k = 0; k < kWin; ++k) tp[k] = kTaps[k];
  __syncthreads();
  for (int i = tid; i < kTile * kIn; i += nthr) {
    const int r = i / kIn;
    const int q = i - r * kIn;
    float acc = __fmul_rn(in[r][q], tp[0]);
#pragma unroll
    for (int k = 1; k < kWin; ++k) acc = __fadd_rn(acc, __fmul_rn(in[r + k][q], tp[k]));
    mid[r][q] = acc;
  }
  __syncthreads();
  const int q = threadIdx.x;
  const int gx = ox + q;
  float* yc = y + (size_t)c * h * w;
  for (int r = threadIdx.y; r < kTile; r += kThreadsY) {
    const int gy = oy + r;
    if (gy < h && gx < w) {
      float acc = __fmul_rn(mid[r][q], tp[0]);
#pragma unroll
      for (int k = 1; k < kWin; ++k) acc = __fadd_rn(acc, __fmul_rn(mid[r][q + k], tp[k]));
      yc[(size_t)gy * w + gx] = acc;
    }
  }
}

}  // namespace

extern "C" int gs_blur_valid(const void* x, void* y, int c, int hp, int wp,
                             void* stream) {
  const int h = hp - kHalo;
  const int w = wp - kHalo;
  if (c > 0 && h > 0 && w > 0) {
    const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, c);
    const dim3 threads(kThreadsX, kThreadsY);
    blur_valid_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, hp, wp, h, w);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
