// K4: per-splat sums of the per-pair gradients (the backward's reduction).
//
// Replaces the TPU kernel `_segreduce_kernel` of
// gaussian_splatting_lightning_tpu/ops/rasterize_pallas.py (reached through
// `_segreduce_call`). Wrapper, plain PyTorch version and launch counter:
// gaussian_splatting_lightning_tpu_torch/ops/rasterize.py.
//
// What it computes. K3 writes each pair's ten gradients to row slot_s[k] of
// dpair (M, 10), the pair's expansion slot. The expansion slots of one splat
// are contiguous and grouped in depth-rank order, so depth rank j owns rows
// [offsets[j], min(offsets[j] + ntiles[order[j]], M)), and
//   out[order[j], 0:10] = sum of those rows,  out[order[j], 10:16] = 0.
// The min clip is the pair budget: slots past M were never generated.
// Culled and early-stopped pairs sit in their splat's range as zero rows.
//
// What bounds it on an H100. Bytes: every gradient row is read once and
// every output row written once; there is no arithmetic to speak of.
//
// Design. One warp per splat; lanes 0-29 are three groups of ten, group r
// sums the rows lo + r, lo + r + 3, ... of its column, and lanes 0-9 add the
// three group sums in a fixed order. Each output row is written by exactly
// one warp (order is a permutation), so the sum needs no atomics and is the
// same run after run. This one reduction over slot ranges stands in for
// the TPU's payload sort by splat id, its bf16 u32 packing, its one-hot MXU
// matmul and its inverse-permutation branch for dropped pairs.

#include <cuda_runtime.h>

namespace {

constexpr int kGrad = 10;
constexpr int kOut = 16;
constexpr int kGroups = 3;
constexpr unsigned kFull = 0xffffffffu;

__global__ void segment_sum_kernel(
    const float* __restrict__ dpair, const int* __restrict__ offsets,
    const int* __restrict__ ntiles, const int* __restrict__ order,
    float* __restrict__ out, int n, int max_pairs) {
  const int j = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= n) return;  // uniform over the warp
  const int g = order[j];
  const int lo = offsets[j];
  const int hi = min(lo + ntiles[g], max_pairs);
  const int grp = lane / kGrad;
  const int col = lane - grp * kGrad;
  float s = 0.0f;
  if (grp < kGroups) {
    for (int r = lo + grp; r < hi; r += kGroups) s += dpair[(size_t)r * kGrad + col];
  }
  const float s1 = __shfl_down_sync(kFull, s, kGrad);
  const float s2 = __shfl_down_sync(kFull, s, 2 * kGrad);
  float* o = out + (size_t)g * kOut;
  if (lane < kGrad) {
    o[lane] = (s + s1) + s2;
  } else if (lane < kOut) {
    o[lane] = 0.0f;
  }
}

}  // namespace

extern "C" int gs_segment_sum(const void* dpair, const void* offsets,
                              const void* ntiles, const void* order, void* out,
                              int n, int max_pairs, void* stream) {
  constexpr int kThreads = 256;
  if (n > 0) {
    const int blocks = (int)(((size_t)n * 32 + kThreads - 1) / kThreads);
    segment_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)dpair, (const int*)offsets, (const int*)ntiles,
        (const int*)order, (float*)out, n, max_pairs);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
