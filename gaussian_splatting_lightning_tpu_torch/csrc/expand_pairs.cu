// K1: run-length (splat, tile) pair expansion with the exact per-tile cull.
//
// Replaces the TPU kernel `_expand_kernel` of
// gaussian_splatting_lightning_tpu/ops/binning.py (reached through
// `expand_pairs_pallas`). Wrapper, plain PyTorch version and launch counter:
// gaussian_splatting_lightning_tpu_torch/ops/binning.py.
//
// What it computes. Splats are sorted by depth; the splat of depth rank g is
// splat order[g] and owns the slots [offsets[g], offsets[g] + ntiles) of the
// pair stream, one per tile of its (band-clipped) tile rect, row-major. Its
// fields sit in original splat order: a 16-byte row of x0, nx (the rect's
// width), y0 and the bits of the cull radius squared r2 (binning.X0 ...
// CULL_R2), and the pixel-space mean p, 8 bytes. For each
// slot s the kernel finds the owner (upper bound - 1 over the exclusive
// `offsets`, which never decrease; splats with no tile sort last with
// offsets == total), then the tile (tile_x, tile_y), then applies the exact
// cull: the squared distance from the splat mean to the tile's pixel-centre
// rect must be <= r2. It writes key = tile_y * grid_x + tile_x, or n_tiles
// for a culled slot or a slot past `total`, and gauss = order[g], the splat's
// original id (0 past `total`).
//
// What bounds it on an H100. Bytes: each slot writes 8 bytes, each splat's
// offset, order entry, row and mean (4 + 4 + 16 + 8 bytes) are read once.
// The work is a few dozen integer ops per slot, far below the card's rate:
// memory bound. A binary search per slot over all of `offsets` would wait on
// ~20 dependent loads per slot, so latency, not bytes, would set the pace:
// the design searches once per block. The row and the mean of an owner are
// read through `order`, at random: each is one DRAM burst, so the fields sit
// in two arrays and not in five.
//
// Design. A block of kThreads threads owns a run of kRun consecutive slots,
// kPerThread consecutive slots per thread.
//  - A run wholly at or past min(total, max_pairs) writes padding and exits.
//  - Otherwise two warps find the owners g0 and g1 of the run's first and
//    last pair slot together, each by a 32-ary search over `offsets` (32
//    probes and a ballot per round: 4 dependent rounds at N = 1M).
//  - Every splat of the live prefix owns at least one slot, so the window
//    g0 .. g1 holds at most kRun splats (the invariant the TPU kernel's
//    static windows rest on). The block stages the window's offsets, its
//    `order` entries and, through them, its owners' rows and means in shared
//    memory with cp.async copies: the gather by depth order happens here,
//    once per owner, and never as a pass of its own.
//  - Each thread binary-searches its first slot's owner in shared memory and
//    walks forward from there: the owner moves by at most one per slot, and
//    a search skips any zero-tile splats in between. It writes its keys and
//    gauss ids with 16-byte stores.
//  - A window wider than the stage (zero-tile splats inside the live prefix,
//    which binning.expand_inputs never makes) takes the same search and walk
//    over global memory, rows through `order`: slower, just as exact.
//    Correctness does not rest on the invariant.
// A stack of B views (the view-batched train step) is one launch: grid row
// v = blockIdx.y expands view v, whose inputs and outputs lie B-major at
// per-view strides (n splats, max_pairs slots, one total), so each view
// keeps its own budget and its farthest splats drop first within it.
// Integer arithmetic for `local`, `row` and the key (the TPU kernel's f32
// arithmetic is exact in the range its caller allows). The cull test is
// computed with __fmul_rn/__fadd_rn and the file is built with --fmad=false,
// so no FMA contraction can flip a borderline pair: the output is identical
// to the plain version's, slot by slot.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                // consecutive slots a thread owns, a multiple of 4
constexpr int kRun = kThreads * kPerThread;  // slots per block, and owners it can stage
constexpr int kSmem = kRun * (16 + 8 + 2 * 4);  // per owner: row, p, id, offset
static_assert(kSmem <= 48 * 1024, "more dynamic shared memory needs an opt-in attribute");
constexpr unsigned kFull = 0xffffffffu;

// One owner's fields, as the slot arithmetic uses them.
struct Owner {
  int x0, nx, y0, id;
  float px, py, r2;
};

// First index in [0, n) whose offset exceeds v (n if none), found by a whole
// warp: each round probes 32 evenly spaced offsets, and the ballot of those
// <= v (a prefix of the lanes, since offsets never decrease) narrows the
// range to the stretch between the last of them and the next probe.
__device__ __forceinline__ int warp_upper_bound(const int* __restrict__ offsets, int n,
                                                int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const int below = __popc(__ballot_sync(kFull, p < hi && __ldg(offsets + p) <= v));
    if (below == 0) {
      hi = lo;
    } else {
      hi = min(hi, lo + below * step);
      lo += (below - 1) * step + 1;
    }
  }
  return lo;
}

// The last index in [lo, hi] whose offset is <= s, given off[lo] <= s.
__device__ __forceinline__ int last_at_most(const int* off, int lo, int hi, int s) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= s) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Key and gauss id of the thread's slots first .. first + kPerThread - 1;
// slots at or past s_end are padding. The window's owner i has its offset
// at off[i], and owner_of(i) reads its fields; `last` is the window's last
// owner, the owner of slot s_end - 1.
template <typename OwnerOf>
__device__ __forceinline__ void expand_thread(
    const int* off, OwnerOf owner_of, int last, int first, int s_end, int grid_x,
    int n_tiles, int block, int tile_y_offset, int (&key)[kPerThread],
    int (&gauss)[kPerThread]) {
  const float span = (float)(block - 1);
  int i = first < s_end ? last_at_most(off, 0, last, first) : 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int s = first + k;
    key[k] = n_tiles;
    gauss[k] = 0;
    if (s >= s_end) continue;
    if (i < last && off[i + 1] <= s) {  // the next owner, or zero-tile splats first
      ++i;
      if (i < last && off[i + 1] <= s) i = last_at_most(off, i + 1, last, s);
    }
    const Owner o = owner_of(i);  // an owner has a tile, so o.nx >= 1
    const int local = s - off[i];
    const int row = local / o.nx;
    const int tx = o.x0 + local - row * o.nx;
    const int ty = o.y0 + row;

    // tile's pixel-centre rect in global pixel coordinates (exact integers)
    const float gx0 = (float)(tx * block);
    const float gy0 = (float)((ty + tile_y_offset) * block);
    const float dx = fmaxf(fmaxf(gx0 - o.px, o.px - (gx0 + span)), 0.0f);
    const float dy = fmaxf(fmaxf(gy0 - o.py, o.py - (gy0 + span)), 0.0f);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    key[k] = d2 <= o.r2 ? ty * grid_x + tx : n_tiles;
    gauss[k] = o.id;
  }
}

// Slots first .. first + kPerThread - 1 of out, clipped at max_pairs.
__device__ __forceinline__ void store_slots(int* __restrict__ out, int first, int max_pairs,
                                            const int (&v)[kPerThread]) {
  if (first + kPerThread <= max_pairs) {
#pragma unroll
    for (int c = 0; c < kPerThread / 4; ++c) {
      reinterpret_cast<int4*>(out + first)[c] =
          make_int4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (first + k < max_pairs) out[first + k] = v[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads) expand_pairs_kernel(
    const int* __restrict__ offsets, const int* __restrict__ order,
    const int4* __restrict__ rows, const float2* __restrict__ p_pix,
    const int* __restrict__ total_ptr, int n, int max_pairs, int grid_x, int n_tiles,
    int block, int tile_y_offset, int* __restrict__ key, int* __restrict__ gauss) {
  {  // this grid row's view
    const size_t v = blockIdx.y;
    offsets += v * n;
    order += v * n;
    rows += v * n;
    p_pix += v * n;
    total_ptr += v;
    key += v * max_pairs;
    gauss += v * max_pairs;
  }
  extern __shared__ int4 smem[];  // the window's owners, one array per field
  int4* s_row = smem;
  float2* s_p = reinterpret_cast<float2*>(smem + kRun);
  int* s_id = reinterpret_cast<int*>(s_p + kRun);
  int* s_off = s_id + kRun;
  __shared__ int s_win[2];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kRun;
  const int first = s0 + tid * kPerThread;
  const int s_end = min(min(*total_ptr, max_pairs), s0 + kRun);  // pairs below, padding from
  int k_out[kPerThread], g_out[kPerThread];

  if (s0 >= s_end) {  // the whole run is padding
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      k_out[k] = n_tiles;
      g_out[k] = 0;
    }
  } else {
    const int warp = tid >> 5;
    if (warp < 2) {
      const int g = warp_upper_bound(offsets, n, warp == 0 ? s0 : s_end - 1) - 1;
      if ((tid & 31) == 0) s_win[warp] = g;
    }
    __syncthreads();
    const int g0 = s_win[0];
    const int last = s_win[1] - g0;
    if (last < kRun) {
      // stage the window: owner q's offset, its id order[g0 + q] and that
      // splat's row and mean; the ids first (all loads in flight together),
      // then every copy in flight at once
      int id[kRun / kThreads];
#pragma unroll
      for (int u = 0; u < kRun / kThreads; ++u) {
        const int q = tid + u * kThreads;
        if (q <= last) id[u] = __ldg(order + g0 + q);
      }
#pragma unroll
      for (int u = 0; u < kRun / kThreads; ++u) {
        const int q = tid + u * kThreads;
        if (q <= last) {
          const int j = id[u];
          s_id[q] = j;
          __pipeline_memcpy_async(s_row + q, rows + j, sizeof(int4));
          __pipeline_memcpy_async(s_p + q, p_pix + j, sizeof(float2));
          __pipeline_memcpy_async(s_off + q, offsets + g0 + q, sizeof(int));
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      expand_thread(
          s_off,
          [&](int i) {
            const int4 r = s_row[i];
            const float2 p = s_p[i];
            return Owner{r.x, r.y, r.z, s_id[i], p.x, p.y, __int_as_float(r.w)};
          },
          last, first, s_end, grid_x, n_tiles, block, tile_y_offset, k_out, g_out);
    } else {
      const int* ord = order + g0;
      expand_thread(
          offsets + g0,
          [&](int i) {
            const int j = __ldg(ord + i);
            const int4 r = __ldg(rows + j);
            const float2 p = __ldg(p_pix + j);
            return Owner{r.x, r.y, r.z, j, p.x, p.y, __int_as_float(r.w)};
          },
          last, first, s_end, grid_x, n_tiles, block, tile_y_offset, k_out, g_out);
    }
  }
  store_slots(key, first, max_pairs, k_out);
  store_slots(gauss, first, max_pairs, g_out);
}

}  // namespace

extern "C" int gs_expand_pairs(const void* offsets, const void* order, const void* rows,
                               const void* p_pix, const void* total, int n, int views,
                               int max_pairs, int grid_x, int n_tiles, int block,
                               int tile_y_offset, void* key, void* gauss, void* stream) {
  if (max_pairs > 0 && views > 0) {
    const dim3 blocks((max_pairs + kRun - 1) / kRun, views);
    expand_pairs_kernel<<<blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
        (const int*)offsets, (const int*)order, (const int4*)rows, (const float2*)p_pix,
        (const int*)total, n, max_pairs, grid_x, n_tiles, block, tile_y_offset, (int*)key,
        (int*)gauss);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
