// The train step's photometric loss, (1 - w) L1 + w (1 - SSIM), its logs
// (L1, 1 - SSIM, PSNR) and its gradient with respect to the rendered image,
// in four kernels: photometric_moments_kernel, photometric_fwd_kernel and
// photometric_reduce_kernel forward, photometric_bwd_kernel backward.
//
// No TPU kernel stands behind this file. The JAX package's loss
// (gaussian_splatting_lightning_tpu/training/loss.py, ops/ssim.py) is jnp
// around the blur kernel, which XLA fuses; its port, training/loss.py
// `photometric_loss` over ops/ssim.py `ssim_stack`, `ssim_from_blurred` and
// K5 (csrc/blur.cu), runs about 50 PyTorch operations forward and 60 under
// autograd backward, each reading and writing whole image-sized maps: the
// 15-channel stack of centred moments and its blurred copy go through
// memory, and K5's VJP blurs all 15 cotangent channels where 9 reach a
// gradient. That composition stays as this file's plain version. Wrapper,
// checks, launch geometry and autograd function: ops/photometric.py.
//
// What it computes. pred and target are (V, C, H, W) f32, V views. Per view
// (or over all views at once, `joint`, for a stack given to the single-view
// loss), with n its element count and w the SSIM weight:
//   c1, c2 = the means of pred and target (each view centred on its own, as
//            ssim_stack does); y1 = pred - c1, y2 = target - c2, and outside
//            the image pred and target read as 0, so y as -c;
//   the five moments y1, y2, y1^2, y2^2, y1 y2 blurred by the 11-tap window
//            (zero padding, separable: vertical taps, then horizontal);
//   map = ((2 mu1 mu2 + C1)(2 s12 + C2)) / ((mu1^2 + mu2^2 + C1)(s1 + s2 + C2))
//            with mu = blurred y + c, s1 = b(y1^2) - b(y1)^2 and so on;
//   recon = sum |pred - target| / n, ssim = 1 - sum map / n,
//   loss = (1 - w) recon + w ssim, psnr = 10 log10(1 / max(mse, 1e-12)).
// The backward gives d/dpred of <g_loss, loss> + <g_recon, recon> +
// <g_ssim, ssim> + <g_psnr, psnr> (c1 and c2 held fixed, as the composition
// detaches them). The map's cotangent is one number per view, gs = -(w
// g_loss + g_ssim) / n, so the forward writes the map's derivatives by the
// three blurred moments of pred (t1 by b(y1), t11 by b(y1^2), t12 by
// b(y1 y2), each through mu1, s1 and s12), and the backward is
//   dpred = gs (B(t1) + 2 y1 B(t11) + y2 B(t12)) + a sign(pred - target)
//           + b (pred - target)
// inside the image, B the same blur (the window is symmetric, so the blur's
// adjoint is itself with zero padding), a the L1 term's and b the PSNR
// term's coefficient. sign(0) is 0, as torch.abs's gradient gives it.
//
// What bounds it on an H100. Bytes, per 1080p RGB view (one image 24.9 MB):
// forward, pred and target read twice (moments, then the blur pass) and the
// three derivative maps of each channel written, 174 MB; backward, the maps,
// pred and target read and the gradient written, 149 MB; 0.097 ms at 3.35
// TB/s. Operations: 15 blurred channels forward and 9 backward at 22 taps,
// about 1.4 GFLOP with the per-pixel arithmetic, 0.02 ms at 67 TFLOP/s.
// Times beside this bound: PERF.md section 6, row L.
//
// Design. The composition's stack and blurred stack never reach memory:
// the blur passes form the moments from pred and target as they load them
// and use the blurred moments where they are made. Saving the three
// derivative maps (75 MB) in the forward costs less than recomputing the
// five blurred moments in the backward (pred and target read again, 50 MB,
// and the 15-channel blur's arithmetic), and leaves the backward one pass.
// Both blur passes follow K5's strip design without its cp.async stages: a
// block of 256 threads owns a strip of 256 input columns (244 output
// columns, whole quads) and 34 output rows of one (view, channel); thread t
// owns input column t for the vertical taps, keeping the last 11 input rows
// of its inputs in a register ring (the cycle loop is unrolled by 11, so
// every slot index is static) and writing the blurred rows of each moment
// to shared memory; after a barrier the horizontal taps read 14 mid values
// a quad as four float4 loads, and the epilogue runs on the quad. The three
// kernels that reduce sum in a fixed order with no atomics, so a replayed
// graph gives the eager call's bits: the moments kernel into 256 partials a
// view, the blur pass into one SSIM partial a block, the reduce kernel
// (one block) each view's partials in order; the blur pass's blocks and the
// reduce kernel sum the moment partials with one device function, so the
// centres are the same bits in both. Products and sums may contract to FMA:
// nothing here decides a threshold, and the card tests hold the kernels to
// the composition within 1e-6 (values) and 1e-5 of the largest gradient.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 11;  // ops/ssim.py WINDOW: the only window with an instance
constexpr int kHalo = kWin - 1;
constexpr int kPad = kHalo / 2;
constexpr int kThreads = 256;                      // blur passes and the reduce kernel
constexpr int kStripIn = kThreads;                 // input columns a strip, one a thread
constexpr int kQuadsOut = (kStripIn - kHalo) / 4;  // whole output quads a strip holds
constexpr int kStripOut = 4 * kQuadsOut;           // ops/photometric.py STRIP_OUT
constexpr int kCycles = 4;                         // cycles of 11 input rows a block
constexpr int kRowsOut = kCycles * kWin - kHalo;   // ops/photometric.py ROWS_OUT
constexpr int kMomentBlocks = kThreads;            // partials a view: one a reduce thread
constexpr int kMomentThreads = 512;
constexpr int kMaps = 3;     // derivative maps a channel: by b(y1), b(y1^2), b(y1 y2)
constexpr float kC1 = 1e-4f;  // ops/ssim.py C1 = 0.01^2, C2 = 0.03^2, as f32
constexpr float kC2 = 9e-4f;
constexpr int kBadGrid = -2;  // the entries' code for a grid that misses the image

static_assert(4 * (kQuadsOut - 1) + 16 <= kStripIn, "a quad's four float4 loads stay in the row");

struct Taps {
  float v[kWin];
};

// the backward's cotangents of loss, recon, ssim and psnr: a null pointer
// reads as 0; view v's at g[k][v * stride[k]] (stride 0 for one number)
struct Cotangents {
  const float* g[4];
  int stride[4];
};

// sum_k taps[k] v[k]
__device__ __forceinline__ float taps_dot(const float* v, const Taps& taps) {
  float acc = v[0] * taps.v[0];
#pragma unroll
  for (int k = 1; k < kWin; ++k) acc = fmaf(v[k], taps.v[k], acc);
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

// the sums of kN values over the block, in a fixed order, in every thread;
// scratch holds kN * (kBlock / 32) floats
template <int kN, int kBlock>
__device__ __forceinline__ void block_sum(float (&v)[kN], float* scratch) {
  constexpr int kWarps = kBlock / 32;
  // a butterfly: both lanes of each pair add the same two numbers
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  const int warp = threadIdx.x / 32;
  __syncthreads();  // the scratch is free
  if (threadIdx.x % 32 == 0)
#pragma unroll
    for (int k = 0; k < kN; ++k) scratch[k * kWarps + warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    float acc = scratch[k * kWarps];
    for (int i = 1; i < kWarps; ++i) acc += scratch[k * kWarps + i];
    v[k] = acc;
  }
}

// view v's sums of pred, target, |d| and d^2 from its moment partials, in
// every thread of a kThreads block: the blur pass's blocks and the reduce
// kernel call this alone for them, so their centres are the same bits
__device__ __forceinline__ void view_sums(const float* __restrict__ moments, int v,
                                          float (&s)[4], float* scratch) {
  const float4 m = reinterpret_cast<const float4*>(moments)[v * kMomentBlocks + threadIdx.x];
  s[0] = m.x;
  s[1] = m.y;
  s[2] = m.z;
  s[3] = m.w;
  block_sum<4, kThreads>(s, scratch);
}

__device__ __forceinline__ void add_moments(float p, float t, float (&s)[4]) {
  const float d = p - t;
  s[0] += p;
  s[1] += t;
  s[2] += fabsf(d);
  s[3] = fmaf(d, d, s[3]);
}

// Stage 1: per view, 256 block partials of sum pred, sum target, sum |d|
// and sum d^2 (n floats a view; float4 loads when `vec`)
__global__ void __launch_bounds__(kMomentThreads) photometric_moments_kernel(
    const float* __restrict__ pred, const float* __restrict__ target,
    float* __restrict__ moments, int64_t n, int vec) {
  __shared__ float scratch[4 * kMomentThreads / 32];
  const int v = blockIdx.y;
  const float* p = pred + (size_t)v * n;
  const float* t = target + (size_t)v * n;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  const int64_t first = (int64_t)blockIdx.x * kMomentThreads + threadIdx.x;
  const int64_t stride = (int64_t)kMomentBlocks * kMomentThreads;
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* t4 = reinterpret_cast<const float4*>(t);
#pragma unroll 4
    for (int64_t i = first; i < n / 4; i += stride) {
      const float4 a = __ldg(p4 + i), b = __ldg(t4 + i);
      add_moments(a.x, b.x, s);
      add_moments(a.y, b.y, s);
      add_moments(a.z, b.z, s);
      add_moments(a.w, b.w, s);
    }
  } else {
#pragma unroll 4
    for (int64_t i = first; i < n; i += stride) add_moments(__ldg(p + i), __ldg(t + i), s);
  }
  block_sum<4, kMomentThreads>(s, scratch);
  if (threadIdx.x == 0)
    reinterpret_cast<float4*>(moments)[v * kMomentBlocks + blockIdx.x] =
        make_float4(s[0], s[1], s[2], s[3]);
}

// One block's pass over its strip of one (view, channel) plane: kIn input
// planes read with a zero margin of kPad, shifted by `shift` (the centres,
// or 0), turned by `quant` into kQ moments an element, blurred by the
// window vertically into shared memory (`mid`, kQ x kWin rows of kStripIn)
// and horizontally into the four outputs of a quad, which go to
// epi(row, column, out[kQ][4]).
template <int kIn, int kQ, class Quant, class Epi>
__device__ __forceinline__ void strip_pass(const float* const (&in)[kIn],
                                           const float (&shift)[kIn], int h, int w,
                                           const Taps& taps, float* mid, Quant quant, Epi epi) {
  const int t = threadIdx.x;
  const int ox = blockIdx.x * kStripOut;  // first output column
  const int oy = blockIdx.y * kRowsOut;   // first output row
  const int rows_out = min(kRowsOut, h - oy);
  const int cycles = (rows_out + kHalo + kWin - 1) / kWin;
  const int col = ox - kPad + t;
  const bool col_ok = col >= 0 && col < w;
  float ring[kWin][kIn];
  for (int cyc = 0; cyc < cycles; ++cyc) {
#pragma unroll
    for (int s = 0; s < kWin; ++s) {
      const int r = oy - kPad + cyc * kWin + s;  // input row into slot s
      const bool ok = col_ok && r >= 0 && r < h;
      const size_t off = ok ? (size_t)r * w + col : 0;
#pragma unroll
      for (int i = 0; i < kIn; ++i) ring[s][i] = (ok ? __ldg(in[i] + off) : 0.f) - shift[i];
      if (cyc > 0 || s == kHalo) {
        // mid row cyc * kWin + s - kHalo from the rows in slots (s + 1 + k) % kWin
        float acc[kQ];
#pragma unroll
        for (int k = 0; k < kWin; ++k) {
          float q[kQ];
          quant(ring[(s + 1 + k) % kWin], q);
#pragma unroll
          for (int j = 0; j < kQ; ++j)
            acc[j] = k == 0 ? q[j] * taps.v[0] : fmaf(q[j], taps.v[k], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < kQ; ++j) mid[(j * kWin + s) * kStripIn + t] = acc[j];
      }
    }
    __syncthreads();
    const int s0 = cyc == 0 ? kHalo : 0;  // the cycle's slots that made a mid row
    for (int item = t; item < (kWin - s0) * kQuadsOut; item += kThreads) {
      const int s = s0 + item / kQuadsOut;
      const int quad = item % kQuadsOut;
      const int i = cyc * kWin + s - kHalo;  // output row within the block
      const int gx = ox + 4 * quad;
      if (i >= rows_out || gx >= w) continue;
      float out[kQ][4];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const float4* m = reinterpret_cast<const float4*>(mid + (j * kWin + s) * kStripIn) + quad;
        float v[16];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 f = m[u];
          v[4 * u] = f.x;
          v[4 * u + 1] = f.y;
          v[4 * u + 2] = f.z;
          v[4 * u + 3] = f.w;
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) out[j][p] = taps_dot(v + p, taps);
      }
      epi(oy + i, gx, out);
    }
    __syncthreads();  // every thread is done with `mid` before the next cycle's rows
  }
}

// Stage 2: the blurred moments of one (view, channel) strip, each pixel's
// SSIM and, with kWithMaps, its three derivative maps; one SSIM partial a
// block at ssim_part[plane][blockIdx.y][blockIdx.x]
template <bool kWithMaps>
__global__ void __launch_bounds__(kThreads, 3) photometric_fwd_kernel(
    const float* __restrict__ pred, const float* __restrict__ target,
    const float* __restrict__ moments, float* __restrict__ ssim_part, float* __restrict__ maps,
    int channels, int h, int w, float n_view, const __grid_constant__ Taps taps) {
  extern __shared__ __align__(16) float mid[];  // 5 x kWin x kStripIn
  __shared__ float scratch[4 * kThreads / 32];
  const int plane = blockIdx.z;
  const size_t area = (size_t)h * w;
  float s[4];
  view_sums(moments, plane / channels, s, scratch);
  const float c1 = s[0] / n_view, c2 = s[1] / n_view;
  const float* const in[2] = {pred + plane * area, target + plane * area};
  const float shift[2] = {c1, c2};
  float* const map_out = kWithMaps ? maps + (size_t)plane * kMaps * area : nullptr;
  float ssim_sum = 0.f;
  auto quant = [](const float (&y)[2], float (&q)[5]) {
    q[0] = y[0];
    q[1] = y[1];
    q[2] = y[0] * y[0];
    q[3] = y[1] * y[1];
    q[4] = y[0] * y[1];
  };
  auto epi = [&](int row, int gx, const float (&o)[5][4]) {
    float t1[4], t11[4], t12[4];
    const int left = w - gx;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float by1 = o[0][p], by2 = o[1][p];
      const float mu1 = by1 + c1, mu2 = by2 + c2;
      const float s1 = o[2][p] - by1 * by1, s2 = o[3][p] - by2 * by2;
      const float s12 = o[4][p] - by1 * by2;
      const float a1 = 2.f * (mu1 * mu2) + kC1, a2 = 2.f * s12 + kC2;
      const float d1 = mu1 * mu1 + mu2 * mu2 + kC1, d2 = s1 + s2 + kC2;
      const float den = d1 * d2;
      const float map = (a1 * a2) / den;
      if (p < left) ssim_sum += map;
      if (kWithMaps) {
        // the map's derivatives by mu1, s1 and s12, then by the blurred
        // moments of pred through them
        const float g_mu1 = (2.f * mu2 * a2 - map * (2.f * mu1 * d2)) / den;
        const float g_s1 = -map / d2;
        const float g_s12 = 2.f * a1 / den;
        t1[p] = g_mu1 - 2.f * by1 * g_s1 - by2 * g_s12;
        t11[p] = g_s1;
        t12[p] = g_s12;
      }
    }
    if (kWithMaps) {
      const size_t at = (size_t)row * w + gx;
      store4(map_out + at, t1, left, w);
      store4(map_out + area + at, t11, left, w);
      store4(map_out + 2 * area + at, t12, left, w);
    }
  };
  strip_pass<2, 5>(in, shift, h, w, taps, mid, quant, epi);
  float sum[1] = {ssim_sum};
  block_sum<1, kThreads>(sum, scratch);
  if (threadIdx.x == 0)
    ssim_part[((size_t)plane * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = sum[0];
}

// Stage 3, one block: each output's loss, recon, ssim and psnr from the
// partials, and each view's (c1, c2, the output's mse) for the backward.
// Per view (joint 0) output v is view v; joint, one output over all views.
__global__ void __launch_bounds__(kThreads) photometric_reduce_kernel(
    const float* __restrict__ moments, const float* __restrict__ ssim_part,
    float* __restrict__ loss, float* __restrict__ recon, float* __restrict__ ssim,
    float* __restrict__ psnr, float* __restrict__ stats, int views, int ssim_parts,
    int joint, float n_view, float n_out, float w_ssim, float w_l1) {
  __shared__ float scratch[4 * kThreads / 32];
  float tot_abs = 0.f, tot_sq = 0.f, tot_ssim = 0.f;
  for (int v = 0; v < views; ++v) {
    float s[4];
    view_sums(moments, v, s, scratch);
    float m[1] = {0.f};
    for (int i = threadIdx.x; i < ssim_parts; i += kThreads)
      m[0] += ssim_part[(size_t)v * ssim_parts + i];
    block_sum<1, kThreads>(m, scratch);
    tot_abs = joint ? tot_abs + s[2] : s[2];
    tot_sq = joint ? tot_sq + s[3] : s[3];
    tot_ssim = joint ? tot_ssim + m[0] : m[0];
    if (threadIdx.x == 0) {
      stats[4 * v] = s[0] / n_view;
      stats[4 * v + 1] = s[1] / n_view;
      stats[4 * v + 3] = 0.f;
    }
    if (!joint || v == views - 1) {
      const float r = tot_abs / n_out;
      const float l_ssim = 1.f - tot_ssim / n_out;
      const float mse = tot_sq / n_out;
      if (threadIdx.x == 0) {
        const int o = joint ? 0 : v;
        recon[o] = r;
        ssim[o] = l_ssim;
        loss[o] = r * w_l1 + l_ssim * w_ssim;
        psnr[o] = 10.f * log10f(1.f / (mse < 1e-12f ? 1e-12f : mse));
        for (int u = joint ? 0 : v; u <= v; ++u) stats[4 * u + 2] = mse;
      }
    }
  }
}

// The backward: the blur of the three derivative maps of each channel, and
// the gradient of pred at each pixel
__global__ void __launch_bounds__(kThreads, 3) photometric_bwd_kernel(
    const float* __restrict__ pred, const float* __restrict__ target,
    const float* __restrict__ maps, const float* __restrict__ stats, const Cotangents cot,
    float* __restrict__ dpred, int channels, int h, int w, float n_out, float w_ssim,
    float w_l1, const __grid_constant__ Taps taps) {
  extern __shared__ __align__(16) float mid[];  // kMaps x kWin x kStripIn
  const int plane = blockIdx.z;
  const int v = plane / channels;
  const size_t area = (size_t)h * w;
  float g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) g[k] = cot.g[k] ? cot.g[k][(size_t)v * cot.stride[k]] : 0.f;
  const float c1 = stats[4 * v], c2 = stats[4 * v + 1], mse = stats[4 * v + 2];
  const float gs = -(g[0] * w_ssim + g[2]) / n_out;  // the map's cotangent
  const float ga = (g[0] * w_l1 + g[1]) / n_out;     // sign(d)'s
  // d psnr / d mse = -10 / (ln 10 mse) where mse >= 1e-12 (clamp_min's gate)
  const float gb = mse >= 1e-12f ? g[3] * (-10.f / (2.302585093f * mse)) * (2.f / n_out) : 0.f;
  const float* const p_in = pred + plane * area;
  const float* const t_in = target + plane * area;
  const float* const m_in = maps + (size_t)plane * kMaps * area;
  const float* const in[kMaps] = {m_in, m_in + area, m_in + 2 * area};
  const float shift[kMaps] = {0.f, 0.f, 0.f};
  auto quant = [](const float (&x)[kMaps], float (&q)[kMaps]) {
#pragma unroll
    for (int j = 0; j < kMaps; ++j) q[j] = x[j];
  };
  auto epi = [&](int row, int gx, const float (&o)[kMaps][4]) {
    const int left = w - gx;
    const size_t at = (size_t)row * w + gx;
    float out[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float pv = p < left ? __ldg(p_in + at + p) : 0.f;
      const float tv = p < left ? __ldg(t_in + at + p) : 0.f;
      const float d = pv - tv;
      const float sgn = (d > 0.f) - (d < 0.f);
      const float ssim_term = o[0][p] + 2.f * (pv - c1) * o[1][p] + (tv - c2) * o[2][p];
      out[p] = gs * ssim_term + ga * sgn + gb * d;
    }
    store4(dpred + plane * area + at, out, left, w);
  };
  strip_pass<kMaps, kMaps>(in, shift, h, w, taps, mid, quant, epi);
}

constexpr int kFwdSmem = 5 * kWin * kStripIn * (int)sizeof(float);
constexpr int kBwdSmem = kMaps * kWin * kStripIn * (int)sizeof(float);

template <class Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

bool grid_covers(int h, int w, int strips, int row_blocks) {
  return strips > 0 && row_blocks > 0 && (int64_t)strips * kStripOut >= w &&
         (int64_t)(strips - 1) * kStripOut < w && (int64_t)row_blocks * kRowsOut >= h &&
         (int64_t)(row_blocks - 1) * kRowsOut < h;
}

Taps taps_of(const void* taps_in) {
  Taps taps = {};
  for (int k = 0; k < kWin; ++k) taps.v[k] = ((const float*)taps_in)[k];
  return taps;
}

}  // namespace

// The forward's three launches. moments: views x 256 float4; ssim_part:
// views x channels x row_blocks x strips; maps: views x channels x 3 x h x
// w, or null (no gradient wanted); loss, recon, ssim, psnr: one float an
// output (views of them, or 1 when joint); stats: views x 4
extern "C" int gs_photometric_fwd(const void* pred, const void* target, void* moments,
                                  void* ssim_part, void* maps, void* loss, void* recon,
                                  void* ssim, void* psnr, void* stats, int views, int channels,
                                  int h, int w, int strips, int row_blocks, int joint, int vec,
                                  float w_ssim, float w_l1, const void* taps_in, void* stream) {
  if (!grid_covers(h, w, strips, row_blocks)) return kBadGrid;
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pred;
  const float* t = (const float*)target;
  float* mom = (float*)moments;
  float* part = (float*)ssim_part;
  const int64_t n = (int64_t)channels * h * w;
  const float n_view = (float)n;
  const float n_out = (float)((double)n * (joint ? views : 1));
  const Taps taps = taps_of(taps_in);
  photometric_moments_kernel<<<dim3(kMomentBlocks, views), kMomentThreads, 0, st>>>(p, t, mom, n,
                                                                                   vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(strips, row_blocks, views * channels);
  if (maps) {
    static const cudaError_t attr = set_smem(photometric_fwd_kernel<true>, kFwdSmem);
    if (attr != cudaSuccess) return (int)attr;
    photometric_fwd_kernel<true><<<grid, kThreads, kFwdSmem, st>>>(
        p, t, mom, part, (float*)maps, channels, h, w, n_view, taps);
  } else {
    static const cudaError_t attr = set_smem(photometric_fwd_kernel<false>, kFwdSmem);
    if (attr != cudaSuccess) return (int)attr;
    photometric_fwd_kernel<false><<<grid, kThreads, kFwdSmem, st>>>(
        p, t, mom, part, nullptr, channels, h, w, n_view, taps);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  photometric_reduce_kernel<<<1, kThreads, 0, st>>>(
      mom, part, (float*)loss, (float*)recon, (float*)ssim, (float*)psnr, (float*)stats, views,
      channels * row_blocks * strips, joint, n_view, n_out, w_ssim, w_l1);
  return (int)cudaGetLastError();
}

// The backward's launch: dpred (views x channels x h x w) from the forward's
// maps and stats and the four cotangents (null: zero; `s_*` their strides)
extern "C" int gs_photometric_bwd(const void* pred, const void* target, const void* maps,
                                  const void* stats, const void* g_loss, const void* g_recon,
                                  const void* g_ssim, const void* g_psnr, int s_loss,
                                  int s_recon, int s_ssim, int s_psnr, void* dpred, int views,
                                  int channels, int h, int w, int strips, int row_blocks,
                                  int joint, float w_ssim, float w_l1, const void* taps_in,
                                  void* stream) {
  if (!grid_covers(h, w, strips, row_blocks)) return kBadGrid;
  const Cotangents cot = {{(const float*)g_loss, (const float*)g_recon, (const float*)g_ssim,
                           (const float*)g_psnr},
                          {s_loss, s_recon, s_ssim, s_psnr}};
  const float n_out = (float)((double)channels * h * w * (joint ? views : 1));
  static const cudaError_t attr = set_smem(photometric_bwd_kernel, kBwdSmem);
  if (attr != cudaSuccess) return (int)attr;
  photometric_bwd_kernel<<<dim3(strips, row_blocks, views * channels), kThreads, kBwdSmem,
                           (cudaStream_t)stream>>>(
      (const float*)pred, (const float*)target, (const float*)maps, (const float*)stats, cot,
      (float*)dpred, channels, h, w, n_out, w_ssim, w_l1, taps_of(taps_in));
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  if (code == kBadGrid) return "the launch grid does not cover the image exactly";
  return cudaGetErrorString((cudaError_t)code);
}
