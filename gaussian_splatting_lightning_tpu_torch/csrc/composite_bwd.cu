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
// Design. K2's layout: one block per tile, a thread per 2x2 pixel quad (256
// threads at 32 px tiles, 64 at 16 px), a warp per 16x8 patch inside one
// 16 px subtile, and K2's cull box, so a warp skips exactly the pairs K2's
// warps skip, each of which the plain version kills. Each thread walks the
// pairs serially with K2's op-by-op rounding (__fmul_rn/__fadd_rn, expf), so
// every alpha, T and early-stop vote is bit-identical to K2's: the block
// votes only after each 256 pairs, where K2 voted, and ends the tile where
// K2 ended it. The prefix, suffix and d_alpha chain is rounded op by op too,
// so each pixel's ten terms equal the plain version's; it runs for all four
// pixels of a quad and selects (w, d_power, prefix and T stay put where the
// pixel is killed), because four divergent branches with a divide in each
// would run one after another. The pixel sums are
// fixed-order and use no float atomics, so the result is the same run after
// run: a thread folds its four pixels in registers, a warp with any kept
// pixel reduce-scatters the ten sums (12 shuffles, where ten butterflies
// take 50), per-warp partials go to shared memory and a second pass sums
// them in warp order and writes the pair's row. Pairs are staged 32 at a
// time with cp.async, a sub-batch ahead of their use, into a three-slot
// ring (K2's scheme: the slot the copy fills was last read two barriers
// ago), and the partials are double-buffered, so the rows and sums of
// sub-batch b-1 are written while b is composited and one barrier per 32
// pairs remains. Nothing staged is held in registers, which lets three
// blocks (24 warps) share an SM. The TPU kernel's log-space cumsum,
// 128-lane windows, VMEM carry for shared boundary chunks and bf16 routing
// are answers to TPU limits and are not carried over. A stack of B views is
// one launch on a (tiles, B) grid, K2's: block (t, v) re-walks tile t of
// view v, whose inputs and pair-gradient rows lie B-major at per-view
// strides.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBatch = 256;  // K2's early-stop vote granularity
constexpr int kSub = 32;     // pairs per ring slot
constexpr int kGrad = 10;    // d px py ca cb cc op r g b 1/z
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;
// K2's cull margin (composite_fwd.cu, rasterize.pair_cull_box)
constexpr float kTauRel = 1.02f, kTauAbs = 1e-3f, kMaxAspect = 1e4f;
constexpr float kPadRel = 1.00001f, kPadAbs = 0.02f, kPadPos = 1e-6f;

// K2's cull_box, the same text: the pixel range outside which the pair's
// alpha is at most 1/255 under the kill chain's rounding, cut at B != 16 to
// the pixels of its 16 px rect.
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

// Once the thread's own copy has landed: the row's third float4 becomes
// (b, 1/z, the pair's slot, -) and its fourth the pair's cull box.
__device__ __forceinline__ void finish_row(float4* row, int slot, bool rect) {
  __pipeline_wait_prior(0);
  const float4 f2 = row[2];
  row[3] = cull_box(row[0], row[1], f2, row[3], rect);
  row[2] = make_float4(f2.x, f2.y, __int_as_float(slot), 0.0f);
}

// Sum each of v[0..9] over the warp. Halving steps over lane bits 4..1 leave
// lane l (and l ^ 1) with the sum of gradient 5 b4 + 3 b3 + 2 b2 + b1, where
// b_i is bit i of l; `scatter_owner` says which lanes hold a real gradient.
__device__ __forceinline__ float warp_reduce_scatter(const float (&v)[kGrad], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a[6], c[4], d[2];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    a[k] = (b4 ? v[k + 5] : v[k]) + __shfl_xor_sync(kFull, b4 ? v[k] : v[k + 5], 16);
  a[5] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    c[k] = (b3 ? a[k + 3] : a[k]) + __shfl_xor_sync(kFull, b3 ? a[k] : a[k + 3], 8);
  c[3] = 0.0f;
#pragma unroll
  for (int k = 0; k < 2; ++k)
    d[k] = (b2 ? c[k + 2] : c[k]) + __shfl_xor_sync(kFull, b2 ? c[k] : c[k + 2], 4);
  const float e = (b1 ? d[1] : d[0]) + __shfl_xor_sync(kFull, b1 ? d[0] : d[1], 2);
  return e + __shfl_xor_sync(kFull, e, 1);
}

// The gradient index lane `lane` holds after warp_reduce_scatter, or -1 for
// the lanes that hold padding and for the odd lane of each pair.
__device__ __forceinline__ int scatter_owner(int lane) {
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1,
            b1 = (lane >> 1) & 1;
  const bool real = b3 ? !b2 : !(b2 && b1);
  return real && !(lane & 1) ? 5 * b4 + 3 * b3 + 2 * b2 + b1 : -1;
}

// three blocks per SM at 32 px tiles: at most 85 registers a thread
template <int B>
__global__ void __launch_bounds__(B * B / 4, 3) composite_bwd_kernel(
    const float4* __restrict__ gfeat, const int* __restrict__ gauss_s,
    const int* __restrict__ slot_s, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const float* __restrict__ out,
    const float* __restrict__ grad_out, float* __restrict__ dpair, int n_splats,
    int n_pairs, int max_pairs, int grid_x, int tile_y_offset, int rect_mask,
    int early_stop) {
  constexpr int kPix = B * B;
  constexpr int kThreads = kPix / 4;
  constexpr int kWarps = kThreads / 32;
  constexpr int kPatchCols = B / 16;
  // per pair: f0 = px py ca cb, f1 = cc op r g, f2 = b 1/z slot -, the cull
  // box; three slots: sub-batch b is composited, b - 1 is being summed, b + 1
  // is being copied
  __shared__ float4 rows[3][kSub][4];
  // per-warp partial sums [buffer][pair][gradient][warp]; the +1 keeps the
  // warp-order sums free of bank conflicts
  __shared__ float part[2][kSub][kGrad][kWarps + 1];
  {  // this grid column's view
    const size_t v = blockIdx.y, n_tiles = gridDim.x;
    gfeat += v * n_splats * 4;
    gauss_s += v * n_pairs;
    slot_s += v * n_pairs;
    tile_start += v * n_tiles;
    tile_count += v * n_tiles;
    out += v * n_tiles * 4 * kPix;
    grad_out += v * n_tiles * 4 * kPix;
    dpair += v * max_pairs * kGrad;
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
  const int owner = scatter_owner(lane);

  // the quad's cotangents and G . out (quad pixel q = 2 * iy + ix)
  float G[4][4], g_total[4];
  {
    const size_t at = (size_t)t * 4 * kPix + yl * B + xl;
#pragma unroll
    for (int iy = 0; iy < 2; ++iy) {
      float2 go[4], oo[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        go[c] = *reinterpret_cast<const float2*>(grad_out + at + c * kPix + iy * B);
        oo[c] = *reinterpret_cast<const float2*>(out + at + c * kPix + iy * B);
      }
#pragma unroll
      for (int ix = 0; ix < 2; ++ix) {
        const int q = 2 * iy + ix;
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          G[q][c] = ix ? go[c].y : go[c].x;
          o[c] = ix ? oo[c].y : oo[c].x;
        }
        g_total[q] = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(G[q][0], o[0]), __fmul_rn(G[q][1], o[1])),
                      __fmul_rn(G[q][2], o[2])),
            __fmul_rn(G[q][3], o[3]));
      }
    }
  }

  // staging: thread p < kSub carries pair p of the next sub-batch
  const bool stager = p < kSub;
  int s_slot = 0, gi_next = 0;
  if (stager) {
    if (p < count) {
      fetch_row(rows[0][p], gfeat, gauss_s[start + p]);
      finish_row(rows[0][p], slot_s[start + p], rect_mask);
    }
    if (kSub + p < count) gi_next = gauss_s[start + kSub + p];
  }
  __syncthreads();

  // the rows of a summed sub-batch: warp-order sums of its partials, turned
  // into the feature gradients, five (pair, gradient pair) items per pair
  const auto finish = [&](int ring, int buf, int n) {
    for (int i = p; i < 5 * n; i += kThreads) {
      const int j = i / 5, g = i % 5;
      const int ka = g < 3 ? 2 * g + 1 : 2 * g;
      const int kb = g == 2 ? 0 : ka + 1;
      float ma = 0.0f, mb = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        ma += part[buf][j][ka][w];
        mb += part[buf][j][kb][w];
      }
      const float4 f0 = rows[ring][j][0];
      const float4 f1 = rows[ring][j][1];
      float2 d;
      if (g == 0) {
        d = make_float2(-(f0.z * ma + f0.w * mb), -(f0.w * ma + f1.x * mb));
      } else if (g == 1) {
        d = make_float2(-0.5f * ma, -mb);
      } else if (g == 2) {
        d = make_float2(-0.5f * ma, mb / fmaxf(f1.y, 1e-30f));
      } else {
        d = make_float2(ma, mb);
      }
      const int slot = __float_as_int(rows[ring][j][2].z);
      *reinterpret_cast<float2*>(dpair + (size_t)slot * kGrad + 2 * g) = d;
    }
  };

  float T[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  float prefix[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int b = 0, last_n = 0;
  for (int base = 0; base < count; base += kSub, ++b) {
    const int n = min(kSub, count - base);
    const int ring = b % 3, buf = b & 1;
    const bool more = stager && base + kSub + p < count;
    if (more) {  // the next sub-batch's row lands while this one composites
      fetch_row(rows[(b + 1) % 3][p], gfeat, gi_next);
      s_slot = slot_s[start + base + kSub + p];
      const int k2 = base + 2 * kSub + p;
      gi_next = k2 < count ? gauss_s[start + k2] : 0;
    }
    if (b > 0) finish((b + 2) % 3, buf ^ 1, kSub);  // sub-batch b - 1 was full
    for (int j = 0; j < n; ++j) {
      float* pw = &part[buf][j][0][warp];
      const float4 box = rows[ring][j][3];
      if (patch_x1 < box.x || patch_x0 > box.y || patch_y1 < box.z || patch_y0 > box.w) {
        if (lane < kGrad) pw[lane * (kWarps + 1)] = 0.0f;  // warp-uniform skip
        continue;
      }
      const float4 f0 = rows[ring][j][0];
      const float4 f1 = rows[ring][j][1];
      const float4 f2 = rows[ring][j][2];
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
      float v[kGrad];
#pragma unroll
      for (int k = 0; k < kGrad; ++k) v[k] = 0.0f;
      bool kept = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ix = q & 1, iy = q >> 1;
        const float qb = __fmul_rn(bx[ix], dy[iy]);
        const float power = __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(qa[ix], qb), qc[iy]));
        const float raw = __fmul_rn(expf(power), f1.y);
        const float alpha = fminf(raw, kAlphaClamp);
        // no branch: the four pixels' chains interleave; a killed pixel adds zeros
        const bool keep = alpha > kAlphaThreshold;
        kept = kept || keep;
        const bool live = T[q] > kTransmittanceEps;
        const float w = keep && live ? __fmul_rn(alpha, T[q]) : 0.0f;
        const float E = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(G[q][0], f1.z), __fmul_rn(G[q][1], f1.w)),
                      __fmul_rn(G[q][2], f2.x)),
            __fmul_rn(G[q][3], f2.y));
        const float pre = __fadd_rn(prefix[q], __fmul_rn(w, E));
        prefix[q] = keep ? pre : prefix[q];
        const float suffix = __fsub_rn(g_total[q], prefix[q]);
        const float one_minus = __fsub_rn(1.0f, alpha);
        const float d_alpha = __fsub_rn(live ? __fmul_rn(E, T[q]) : 0.0f,
                                        __fdiv_rn(suffix, one_minus));
        const float d_power = keep && raw < kAlphaClamp ? __fmul_rn(d_alpha, alpha) : 0.0f;
        const float m1x = __fmul_rn(d_power, dx[ix]);
        const float m1y = __fmul_rn(d_power, dy[iy]);
        v[0] += d_power;
        v[1] += m1x;
        v[2] += m1y;
        v[3] += __fmul_rn(m1x, dx[ix]);
        v[4] += __fmul_rn(m1x, dy[iy]);
        v[5] += __fmul_rn(m1y, dy[iy]);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[6 + c] += __fmul_rn(G[q][c], w);
        T[q] = keep ? __fmul_rn(T[q], one_minus) : T[q];
      }
      if (__any_sync(kFull, kept)) {
        const float s = warp_reduce_scatter(v, lane);
        if (owner >= 0) pw[owner * (kWarps + 1)] = s;
      } else if (lane < kGrad) {
        pw[lane * (kWarps + 1)] = 0.0f;
      }
    }
    if (more) finish_row(rows[(b + 1) % 3][p], s_slot, rect_mask);
    last_n = n;
    if (early_stop && (base + n) % kBatch == 0) {  // block-uniform, K2's vote
      const bool lit = T[0] > kTransmittanceEps || T[1] > kTransmittanceEps ||
                       T[2] > kTransmittanceEps || T[3] > kTransmittanceEps;
      if (!__syncthreads_or(lit)) {
        ++b;
        break;
      }
    } else {
      __syncthreads();
    }
  }
  if (b > 0) finish((b + 2) % 3, (b - 1) & 1, last_n);  // the last sub-batch
}

}  // namespace

extern "C" int gs_composite_bwd(
    const void* gfeat, const void* gauss_s, const void* slot_s,
    const void* tile_start, const void* tile_count, const void* out,
    const void* grad_out, void* dpair, int n_tiles, int views, int n_splats,
    int n_pairs, int max_pairs, int grid_x, int block, int tile_y_offset, int rect_mask,
    int early_stop, void* stream) {
  if (n_tiles > 0 && views > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const auto launch = [&](auto kernel, int threads) {
      kernel<<<dim3(n_tiles, views), threads, 0, s>>>(
          (const float4*)gfeat, (const int*)gauss_s, (const int*)slot_s,
          (const int*)tile_start, (const int*)tile_count, (const float*)out,
          (const float*)grad_out, (float*)dpair, n_splats, n_pairs, max_pairs, grid_x,
          tile_y_offset, rect_mask, early_stop);
    };
    if (block == 32) {
      launch(composite_bwd_kernel<32>, 256);
    } else if (block == 16) {
      launch(composite_bwd_kernel<16>, 64);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
