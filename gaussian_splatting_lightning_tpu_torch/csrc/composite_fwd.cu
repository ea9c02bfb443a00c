// K2: per-tile front-to-back alpha compositing (the forward rasterizer).
//
// Replaces the TPU kernel `_fwd_kernel` of
// gaussian_splatting_lightning_tpu/ops/rasterize_pallas.py (reached through
// `_fwd_call`). Wrapper, plain PyTorch version and launch counter:
// gaussian_splatting_lightning_tpu_torch/ops/rasterize.py.
//
// What it computes. Tile t owns the depth-sorted pairs
// [tile_start[t], tile_start[t] + tile_count[t]) of the tile-sorted stream;
// pair k is splat gauss_s[k], whose 16-float feature row is
// gfeat[gauss_s[k]] = [px py ca cb cc op r g b 1/z x0 x1 y0 y1 - -]. Pixel p
// of the tile sits at the integer coordinates (ox + p % B, oy + p / B), no
// +0.5. For each pair, front to back:
//   power = -0.5 (ca dx^2 + 2 cb dx dy + cc dy^2),  alpha = min(op e^power, 0.99)
// the pair counts only if alpha > 1/255 and, at B != 16, the pixel's 16 px
// subtile lies in the pair's rect [x0, x1) x [y0, y1); its weight is
// w = alpha T while T > 1e-4 (else 0), and T *= (1 - alpha). Output, channel
// first per tile: out[t] = [sum w rgb + T_fin bg, sum w / z] (4, B*B).
//
// What bounds it on an H100. Operations: about 30 f32 operations per
// (pair, pixel) evaluation against ~16 bytes of features per pair that a
// whole tile shares, so the card's f32 rate bounds it, not memory. The
// operations up to the kill decision are issued unfused (below), so they run
// at the card's non-FMA rate, half its FMA peak; most evaluations end there.
//
// Design. One block per tile, a quarter as many threads as pixels (256 at
// 32 px tiles, 64 at 16 px): each thread owns a 2x2 pixel quad and keeps
// four independent T chains, and each warp owns a 16x8 pixel patch, which
// lies inside one 16 px subtile. Pairs are staged in shared memory 32 at a
// time in a two-slot ring: the first warp copies the next 32 feature rows
// (by gauss_s, indices read a sub-batch ahead) with cp.async while every
// warp composites the current ones; then each copying thread waits for its
// own row and replaces the row's fourth float4 by the pair's cull box
// (below), so one barrier per 32 pairs remains and no thread holds a row in
// registers (staging through registers cost 16 of them, and with them a
// block per SM). A warp skips a pair whose box misses its
// patch: `cull_box` bounds the set alpha > 1/255 by the ellipse
// q <= 2 ln(255 op) with a margin that covers the rounding of the kill
// chain, so a skipped evaluation is one the plain version kills, and at
// B != 16 it also folds in the 16 px rect, exact on integers. The block
// votes (__syncthreads_or) only after each 256 pairs and ends the tile once
// every pixel has T <= 1e-4. power, alpha and T are rounded op by op in the
// plain version's order (__fmul_rn/__fadd_rn, expf not __expf), so every
// alpha and T is bit-identical to the plain version's and a borderline pair
// cannot cross the 1/255 kill or the T > 1e-4 rule in one and not the
// other. The colour and depth sums may contract to FMA: they differ from the
// plain version's by a few ulp and decide nothing. The TPU kernel's 128-lane
// aligned windows with phase masks, its log-space triangular-matmul cumsum
// and its DMA overhang pad are answers to TPU limits and are not carried
// over. A stack of B views is one launch on a (tiles, B) grid: block
// (t, v) composites tile t of view v, whose feature rows, pair stream, tile
// ranges, background and canvas lie B-major at per-view strides (the TPU
// kernel's batch grid axis under vmap).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBatch = 256;  // early-stop vote granularity, as the plain version
constexpr int kSub = 32;     // pairs per ring slot
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
// cull margin, the same as rasterize.pair_cull_box: the threshold 2 ln(255 op)
// of q = ca dx^2 + 2 cb dx dy + cc dy^2 is widened by 2% and 1e-3, the
// half-extents by 1e-5 of themselves, 0.02 px and 1e-6 of the centre, and no
// box is drawn for a conic with ca cc > 1e4 det (its rounding is not bounded)
constexpr float kTauRel = 1.02f, kTauAbs = 1e-3f, kMaxAspect = 1e4f;
constexpr float kPadRel = 1.00001f, kPadAbs = 0.02f, kPadPos = 1e-6f;

// The pixel range (x_lo, x_hi, y_lo, y_hi) outside which the pair's alpha is
// at most 1/255 under the kill chain's rounding; at B != 16 cut to the pixels
// of its 16 px rect. A patch that misses it holds no pixel the pair keeps.
__device__ __forceinline__ float4 cull_box(float4 f0, float4 f1, float4 f2,
                                           float4 f3, bool rect) {
  const float mx = f0.x, my = f0.y, a = f0.z, b = f0.w, c = f1.x, op = f1.y;
  const float det = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, b));
  float4 box = make_float4(-CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F);
  if (a > 0.0f && c > 0.0f && det > 0.0f &&
      __fmul_rn(a, c) <= __fmul_rn(kMaxAspect, det)) {
    const float tau = __fadd_rn(
        __fmul_rn(__fmul_rn(2.0f, logf(__fmul_rn(255.0f, op))), kTauRel), kTauAbs);
    if (tau <= 0.0f) {  // op below 1/255: nothing passes anywhere
      box = make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
    } else if (tau > 0.0f) {  // not NaN
      const float hx = __fadd_rn(__fmul_rn(sqrtf(__fdiv_rn(__fmul_rn(tau, c), det)), kPadRel),
                                 __fadd_rn(kPadAbs, __fmul_rn(kPadPos, fabsf(mx))));
      const float hy = __fadd_rn(__fmul_rn(sqrtf(__fdiv_rn(__fmul_rn(tau, a), det)), kPadRel),
                                 __fadd_rn(kPadAbs, __fmul_rn(kPadPos, fabsf(my))));
      box = make_float4(__fsub_rn(mx, hx), __fadd_rn(mx, hx), __fsub_rn(my, hy),
                        __fadd_rn(my, hy));
    }
  }
  if (rect) {  // fmaxf/fminf drop a NaN bound: the rect alone then decides
    box.x = fmaxf(box.x, 16.0f * f2.z);
    box.y = fminf(box.y, 16.0f * f2.w - 1.0f);
    box.z = fmaxf(box.z, 16.0f * f3.x);
    box.w = fminf(box.w, 16.0f * f3.y - 1.0f);
  }
  return box;
}

// Copy feature row `gi` (four float4) into the shared-memory row `dst`
// without passing through registers; finish_row completes it.
__device__ __forceinline__ void fetch_row(float4* dst, const float4* __restrict__ gfeat,
                                          int gi) {
  const float4* src = gfeat + (size_t)gi * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) __pipeline_memcpy_async(dst + i, src + i, sizeof(float4));
  __pipeline_commit();
}

// Once the thread's own copy has landed: the row's fourth float4 (y0 y1 - -)
// becomes its cull box.
__device__ __forceinline__ void finish_row(float4* row, bool rect) {
  __pipeline_wait_prior(0);
  row[3] = cull_box(row[0], row[1], row[2], row[3], rect);
}

// four blocks per SM at 32 px tiles: at most 64 registers a thread
template <int B>
__global__ void __launch_bounds__(B * B / 4, 4) composite_fwd_kernel(
    const float4* __restrict__ gfeat, const int* __restrict__ gauss_s,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    const float* __restrict__ bg, float* __restrict__ out, int n_splats, int n_pairs,
    int grid_x, int tile_y_offset, int rect_mask, int early_stop) {
  constexpr int kPix = B * B;
  constexpr int kPatchCols = B / 16;
  // per pair: f0 = px py ca cb, f1 = cc op r g, f2 = b 1/z - -, the cull box
  __shared__ float4 rows[2][kSub][4];
  {  // this grid column's view
    const size_t v = blockIdx.y, n_tiles = gridDim.x;
    gfeat += v * n_splats * 4;
    gauss_s += v * n_pairs;
    tile_start += v * n_tiles;
    tile_count += v * n_tiles;
    bg += v * 3;
    out += v * n_tiles * 4 * kPix;
  }
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int ox = (t % grid_x) * B;
  const int oy = (t / grid_x + tile_y_offset) * B;
  const int patch_x = 16 * (warp % kPatchCols), patch_y = 8 * (warp / kPatchCols);
  const int xl = patch_x + 2 * (lane & 7), yl = patch_y + 2 * (lane >> 3);
  const float px[2] = {(float)(ox + xl), (float)(ox + xl + 1)};
  const float py[2] = {(float)(oy + yl), (float)(oy + yl + 1)};
  const float patch_x0 = (float)(ox + patch_x), patch_x1 = patch_x0 + 15.0f;
  const float patch_y0 = (float)(oy + patch_y), patch_y1 = patch_y0 + 7.0f;
  const int start = tile_start[t];
  const int count = tile_count[t];

  // staging: thread p < kSub carries pair p of the next sub-batch
  const bool stager = p < kSub;
  int gi_next = 0;
  if (stager) {
    if (p < count) {
      fetch_row(rows[0][p], gfeat, gauss_s[start + p]);
      finish_row(rows[0][p], rect_mask);
    }
    if (kSub + p < count) gi_next = gauss_s[start + kSub + p];
  }
  __syncthreads();

  float T[4] = {1.0f, 1.0f, 1.0f, 1.0f};  // quad pixel q = 2 * iy + ix
  float acc[4][4] = {};                   // [q][r g b invd]
  int slot = 0;
  for (int base = 0; base < count; base += kSub, slot ^= 1) {
    const int n = min(kSub, count - base);
    const bool more = stager && base + kSub + p < count;
    if (more) {  // the next sub-batch's row lands while this one composites
      fetch_row(rows[slot ^ 1][p], gfeat, gi_next);
      const int k2 = base + 2 * kSub + p;
      gi_next = k2 < count ? gauss_s[start + k2] : 0;
    }
    for (int j = 0; j < n; ++j) {
      const float4 box = rows[slot][j][3];
      if (patch_x1 < box.x || patch_x0 > box.y || patch_y1 < box.z || patch_y0 > box.w)
        continue;  // warp-uniform: the pair keeps no pixel of this patch
      const float4 f0 = rows[slot][j][0];
      const float4 f1 = rows[slot][j][1];
      const float4 f2 = rows[slot][j][2];
      const float dx[2] = {f0.x - px[0], f0.x - px[1]};
      const float dy[2] = {f0.y - py[0], f0.y - py[1]};
      const float cb2 = __fmul_rn(2.0f, f0.w);
      float qa[2], qc[2], bx[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qa[i] = __fmul_rn(__fmul_rn(f0.z, dx[i]), dx[i]);
        qc[i] = __fmul_rn(__fmul_rn(f1.x, dy[i]), dy[i]);
        bx[i] = __fmul_rn(cb2, dx[i]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ix = q & 1, iy = q >> 1;
        const float qb = __fmul_rn(bx[ix], dy[iy]);
        const float power = __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(qa[ix], qb), qc[iy]));
        const float alpha = fminf(__fmul_rn(expf(power), f1.y), kAlphaClamp);
        if (alpha > kAlphaThreshold) {
          const float w = T[q] > kTransmittanceEps ? __fmul_rn(alpha, T[q]) : 0.0f;
          acc[q][0] = acc[q][0] + w * f1.z;
          acc[q][1] = acc[q][1] + w * f1.w;
          acc[q][2] = acc[q][2] + w * f2.x;
          acc[q][3] = acc[q][3] + w * f2.y;
          T[q] = __fmul_rn(T[q], __fsub_rn(1.0f, alpha));
        }
      }
    }
    if (more) finish_row(rows[slot ^ 1][p], rect_mask);
    if (early_stop && (base + n) % kBatch == 0) {  // block-uniform
      const bool lit = T[0] > kTransmittanceEps || T[1] > kTransmittanceEps ||
                       T[2] > kTransmittanceEps || T[3] > kTransmittanceEps;
      if (!__syncthreads_or(lit)) break;
    } else {
      __syncthreads();
    }
  }
  float* o = out + (size_t)t * 4 * kPix + yl * B + xl;
  const float bgc[3] = {bg[0], bg[1], bg[2]};
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = 2 * iy;
      float2 v = make_float2(acc[q][c], acc[q + 1][c]);
      if (c < 3) {
        v.x = v.x + T[q] * bgc[c];
        v.y = v.y + T[q + 1] * bgc[c];
      }
      *reinterpret_cast<float2*>(o + c * kPix + iy * B) = v;
    }
  }
}

}  // namespace

extern "C" int gs_composite_fwd(
    const void* gfeat, const void* gauss_s, const void* tile_start,
    const void* tile_count, const void* bg, void* out, int n_tiles, int views,
    int n_splats, int n_pairs, int grid_x, int block, int tile_y_offset, int rect_mask,
    int early_stop, void* stream) {
  if (n_tiles > 0 && views > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const auto launch = [&](auto kernel, int threads) {
      kernel<<<dim3(n_tiles, views), threads, 0, s>>>(
          (const float4*)gfeat, (const int*)gauss_s, (const int*)tile_start,
          (const int*)tile_count, (const float*)bg, (float*)out, n_splats, n_pairs,
          grid_x, tile_y_offset, rect_mask, early_stop);
    };
    if (block == 32) {
      launch(composite_fwd_kernel<32>, 256);
    } else if (block == 16) {
      launch(composite_fwd_kernel<16>, 64);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
