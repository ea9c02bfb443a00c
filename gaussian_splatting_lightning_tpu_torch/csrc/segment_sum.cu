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
// offsets is the exclusive cumsum of ntiles[order], so rank j's range ends
// where rank j + 1's starts; only the last rank reads ntiles.
//
// What bounds it on an H100. Bytes: every gradient row is read once and
// every output row written once; there is no arithmetic to speak of.
//
// Design. A block of 256 threads owns 256 consecutive depth ranks, whose
// rows form one contiguous run of dpair. It loads the ranks' ranges and
// splat ids once (coalesced), then walks the run in chunks of at most 409
// rows: each chunk is copied into shared memory with float4 loads (four per
// thread, all in flight together; the start rounded down to a 16-byte
// boundary, since rows are 40 bytes), and after one barrier sixteen threads
// per rank each sum one column of the rank's rows in slot order and write
// it, so a half warp stores one whole 64-byte output row (columns 10-15
// zero). A chunk holds whole ranks. A rank with more than 128 rows is summed
// by the whole block instead: 24 groups of ten lanes, group g taking the
// rows lo + g, lo + g + 24, ... through the same chunked copies, then the 24
// partial sums added in group order. Every sum runs in a fixed order and
// each output row is written by one block (order is a permutation), so K4
// needs no atomics and gives the same bits run after run. This one
// reduction over slot ranges stands in for the TPU's payload sort by splat
// id, its bf16 u32 packing, its one-hot MXU matmul and its
// inverse-permutation branch for dropped pairs. A stack of B views is one
// launch with a grid row per view (blockIdx.y), whose dpair (M, 10),
// offsets, ntiles, order and (N, 16) output lie B-major at per-view
// strides: each view's splats get that view's sums, and the sum over views
// is left to autograd (the broadcast of the shared parameters).

#include <cuda_runtime.h>

namespace {

constexpr int kGrad = 10;
constexpr int kOut = 16;
constexpr int kRanks = 256;                       // ranks per block = threads
constexpr int kWarps = kRanks / 32;
constexpr int kQuads = 1024;                      // float4s staged per chunk
constexpr int kChunkRows = (4 * kQuads - 3) / kGrad;  // 409 rows after rounding down
constexpr int kLong = 128;                        // longer ranks take the whole block
constexpr int kGroups = 3 * kWarps;               // ten-lane groups of the block
constexpr unsigned kFull = 0xffffffffu;

// Copy rows [r0, r1) of dpair (r1 - r0 <= kChunkRows) into buf from the
// 16-byte boundary at or below row r0; returns that boundary's float index.
// total = 10 M floats; a quad that runs past it is read float by float.
__device__ __forceinline__ int stage_rows(float4* buf, const float* __restrict__ dpair,
                                          int r0, int r1, int total) {
  const int f0 = (r0 * kGrad) & ~3;
  const int nq = (r1 * kGrad - f0 + 3) >> 2;
  float4 v[kQuads / kRanks];
#pragma unroll
  for (int u = 0; u < kQuads / kRanks; ++u) {
    const int q = threadIdx.x + u * kRanks;
    const int f = f0 + 4 * q;
    if (q < nq) {
      if (f + 4 <= total) {
        v[u] = __ldg(reinterpret_cast<const float4*>(dpair + f));
      } else {
        v[u].x = f < total ? dpair[f] : 0.0f;
        v[u].y = f + 1 < total ? dpair[f + 1] : 0.0f;
        v[u].z = f + 2 < total ? dpair[f + 2] : 0.0f;
        v[u].w = 0.0f;  // f + 3 >= total here
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kQuads / kRanks; ++u) {
    const int q = threadIdx.x + u * kRanks;
    if (q < nq) buf[q] = v[u];
  }
  return f0;
}

__global__ void __launch_bounds__(kRanks) segment_sum_kernel(
    const float* __restrict__ dpair, const int* __restrict__ offsets,
    const int* __restrict__ ntiles, const int* __restrict__ order,
    float* __restrict__ out, int n, int max_pairs) {
  {  // this grid row's view
    const size_t v = blockIdx.y;
    dpair += v * max_pairs * kGrad;
    offsets += v * n;
    ntiles += v * n;
    order += v * n;
    out += v * n * kOut;
  }
  __shared__ float4 buf4[kQuads];
  __shared__ int s_lo[kRanks], s_hi[kRanks], s_ord[kRanks], s_long[kRanks];
  __shared__ int s_warp_long[kWarps];
  __shared__ float s_part[kGroups * kGrad];
  const float* buf = reinterpret_cast<const float*>(buf4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = blockIdx.x * kRanks;
  const int nr = min(kRanks, n - j0);
  const int total = max_pairs * kGrad;

  bool is_long = false;
  if (tid < nr) {
    const int j = j0 + tid;
    const int lo = offsets[j];
    const int g = order[j];
    const int end = j + 1 < n ? offsets[j + 1] : lo + ntiles[g];
    s_lo[tid] = min(lo, max_pairs);
    s_hi[tid] = min(end, max_pairs);
    s_ord[tid] = g;
    is_long = min(end, max_pairs) - min(lo, max_pairs) > kLong;
  }
  // the block's long ranks, listed in rank order
  const unsigned ballot = __ballot_sync(kFull, is_long);
  if (lane == 0) s_warp_long[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, n_long = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    before += q < warp ? s_warp_long[q] : 0;
    n_long += s_warp_long[q];
  }
  if (is_long) s_long[before + __popc(ballot & ((1u << lane) - 1u))] = tid;
  __syncthreads();

  // ten-lane groups for long ranks
  const int grp = lane / kGrad;
  const int gcol = lane - grp * kGrad;
  const int gid = warp * 3 + grp;
  // sixteen threads per rank for short ones
  const int sub = tid / kOut;
  const int col = tid % kOut;

  int k = 0, p = 0;  // the same on every thread: the loop's barriers are uniform
  while (k < nr) {
    if (p < n_long && s_long[p] == k) {
      const int lo = s_lo[k], hi = s_hi[k];
      float acc = 0.0f;
      for (int cs = lo; cs < hi; cs += kChunkRows) {
        const int ce = min(cs + kChunkRows, hi);
        const int f0 = stage_rows(buf4, dpair, cs, ce, total);
        __syncthreads();
        if (grp < 3) {
          // the first row at or after cs with (row - lo) % kGroups == gid
          int r = cs + (gid - (cs - lo) % kGroups + kGroups) % kGroups;
          for (; r < ce; r += kGroups) acc += buf[r * kGrad + gcol - f0];
        }
        __syncthreads();
      }
      if (grp < 3) s_part[gid * kGrad + gcol] = acc;
      __syncthreads();
      if (tid < kOut) {
        float s = 0.0f;
        if (tid < kGrad) {
          for (int q = 0; q < kGroups; ++q) s += s_part[q * kGrad + tid];
        }
        out[(size_t)s_ord[k] * kOut + tid] = s;
      }
      ++k;
      ++p;
      continue;
    }
    // the longest run of short ranks from k that fits one chunk
    const int lim = p < n_long ? s_long[p] : nr;
    int a = k + 1, b = lim;
    while (a < b) {
      const int m = (a + b + 1) >> 1;
      if (s_hi[m - 1] - s_lo[k] <= kChunkRows) a = m; else b = m - 1;
    }
    const int k2 = a;
    const int f0 = stage_rows(buf4, dpair, s_lo[k], s_hi[k2 - 1], total);
    __syncthreads();
    for (int j = k + sub; j < k2; j += kRanks / kOut) {
      float s = 0.0f;
      if (col < kGrad) {
        const int hi = s_hi[j];
        for (int r = s_lo[j]; r < hi; ++r) s += buf[r * kGrad + col - f0];
      }
      out[(size_t)s_ord[j] * kOut + col] = s;
    }
    __syncthreads();
    k = k2;
  }
}

}  // namespace

extern "C" int gs_segment_sum(const void* dpair, const void* offsets,
                              const void* ntiles, const void* order, void* out,
                              int n, int max_pairs, int views, void* stream) {
  if (n > 0 && views > 0) {
    const dim3 blocks((n + kRanks - 1) / kRanks, views);
    segment_sum_kernel<<<blocks, kRanks, 0, (cudaStream_t)stream>>>(
        (const float*)dpair, (const int*)offsets, (const int*)ntiles,
        (const int*)order, (float*)out, n, max_pairs);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
