// Preprocess: the splats' activations, projection, EWA covariance, SH
// colour and the compositor's feature table in one kernel, and the gradient
// of every raw parameter in another.
//
// No TPU kernel stands behind this file. The JAX package's preprocess
// (gaussian_splatting_lightning_tpu/ops/common.py `preprocess`, core/sh.py,
// core/transforms.py, the activations of models/gaussians.py and the table of
// ops/rasterize_pallas.py) is plain jnp that XLA fuses; its port, the
// composition in ops/common.py and ops/rasterize.py under autograd, ran as
// some 750 PyTorch launches a step. That composition stays as these kernels'
// plain version (ops/preprocess.py `preprocess_scene_plain`). Wrapper, autograd
// function and launch counters: gaussian_splatting_lightning_tpu_torch/ops/preprocess.py.
//
// What it computes. preprocess_fwd_kernel, one thread per (view, splat),
// reads the raw leaves (xyz, features_dc, features_rest, the opacity logit,
// the log-scales, the unnormalised quaternions) and writes the splat's
// (NFEAT = 16) feature row — px, py, the conic, the opacity, rgb, 1/z and,
// at tile sizes other than 16, the 16 px rect — and the fields the binning
// reads: the pixel mean, depth, radius, radius_bin, visible and cull_r2.
// preprocess_bwd_kernel, one thread per splat, takes the table's gradient
// (K4's output), recomputes the forward in registers and writes the gradient
// of every raw leaf and of the NDC offset (the densification signal). With
// B views it walks them in view order, so each sum over views is made in
// one order by one thread: no atomics.
//
// Rounding. Every operation rounds where the plain version's separate
// PyTorch kernels round, in their order (this file is built with
// --fmad=false), so that the thresholds that decide pairs (the ceil of the
// radii, the trunc of the rect, z > 0.2, det != 0) fall where the plain
// version's do. Where PyTorch itself fuses (cuBLAS's multiply-add chain in
// [p, 1] @ M) the kernel fuses the same way, with __fmaf_rn. Division by a
// Python scalar, which PyTorch's CUDA kernels turn into a multiplication by
// its reciprocal, is such a multiplication here too. The backward follows
// autograd's conventions at every clamp (the gradient passes where the
// input equals the bound), torch.where, minimum and maximum (a tie passes
// half) and ceil (no gradient).
//
// What bounds it on an H100. Bytes: a splat's 59 parameters (236 B) are read
// once; the forward writes a 64 B row and 25 B of binning fields, the
// backward reads the table's gradient (40 of its 64 B) and writes 236 B of
// gradients and 8 B of offset gradient a view. Each thread's arithmetic is a
// few hundred flops, far below the card's rate: memory bound. Times at the
// bench's size beside these bounds: PERF.md §6.
//
// Design. All intermediates stay in registers; f32 throughout. A splat's
// features_rest row (180 B at SH degree 3) read by its own thread would make
// 32 scattered requests a warp; instead a block stages its 128 rows through
// shared memory with coalesced 16-byte loads (odd row stride: no bank
// conflicts when a thread walks its row), and the backward writes the rows'
// gradients back out the same way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kFeat = 16;  // ops/rasterize.NFEAT

// The SH constants (core/sh.py), rounded to f32 as PyTorch rounds a Python
// scalar operand; the bands' in constant memory (every index is a literal).
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1a = -0.4886025119029199f, kC1b = 0.4886025119029199f,
                kC1c = -0.4886025119029199f;
__constant__ float kC2[5] = {1.0925484305920792f, -1.0925484305920792f, 0.31539156525252005f,
                          -1.0925484305920792f, 0.5462742152960396f};
__constant__ float kC3[7] = {-0.5900435899266435f, 2.890611442640554f, -0.4570457994644658f,
                          0.3731763325901154f, -0.4570457994644658f, 1.445305721320277f,
                          -0.5900435899266435f};
__constant__ float kC4[9] = {2.5033429417967046f, -1.7701307697799304f, 0.9461746957575601f,
                          -0.6690465435572892f, 0.10578554691520431f, -0.6690465435572892f,
                          0.47308734787878004f, -1.7701307697799304f, 0.6258357354491761f};

struct Args {
  // raw leaves (contiguous f32): xyz (N, 3), features_dc (N, 1, 3),
  // features_rest (N, K - 1, 3), opacity (N, 1), scales (N, 3), quats (N, 4)
  const float* xyz;
  const float* dc;
  const float* rest;
  const float* opacity;
  const float* scales;
  const float* quats;
  const float* offset;         // (B, N, 2) NDC offset, or null
  const uint8_t* alive;        // (N,) bool, or null
  const float* view;           // (B, 4, 4) row-vector world -> camera
  const float* proj;           // (B, 4, 4) full projection
  const float* campos;         // (B, 3)
  const float* tanx;           // (B,)
  const float* tany;           // (B,)
  // forward outputs, (B, N, ...)
  float* table;                // (B, N, 16)
  float* p_pix;                // (B, N, 2)
  float* depth;
  float* radius;
  float* radius_bin;
  uint8_t* visible;
  float* cull_r2;
  // backward: the table's gradient in, the leaves' gradients out
  const float* dtable;         // (B, N, 16)
  float* d_xyz;
  float* d_dc;
  float* d_rest;
  float* d_opacity;
  float* d_scales;
  float* d_quats;
  float* d_offset;             // (B, N, 2), or null
  int n, views, width, height;
  int degree;                  // active SH degree
  int rest_floats;             // (K - 1) * 3: a splat's features_rest row
  int antialias;
  int rect;                    // write the 16 px rect (tile size != 16)
  int grid16x, grid16y;
  float scale_modifier;
  float inv_alpha;             // f32(1 / f32(1/255)): PyTorch's scalar division
};

// ---- PyTorch's elementwise semantics -------------------------------------

__device__ __forceinline__ float t_clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float t_clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float t_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float t_maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float recip(float x) { return 1.0f / x; }

// [p, 1] @ M, column j of a row-major (4, 4) M, summed as cuBLAS's GEMM
// sums it: a fused multiply-add chain over k.
__device__ __forceinline__ float hom_dot(float p0, float p1, float p2, const float* M, int j) {
  float acc = __fmul_rn(p0, M[j]);
  acc = __fmaf_rn(p1, M[4 + j], acc);
  acc = __fmaf_rn(p2, M[8 + j], acc);
  return __fmaf_rn(1.0f, M[12 + j], acc);
}

// torch.linalg.vector_norm over a last axis of 3 or 4, as PyTorch's CUDA
// reduction sums the rounded squares: two interleaved partial sums
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + z * z) + y * y);
}
__device__ __forceinline__ float norm4(float x, float y, float z, float w) {
  return sqrtf((x * x + z * z) + (y * y + w * w));
}

// (basis[:, None] * coeffs).sum(-2) for one channel: the products p[0..n)
// summed as PyTorch's CUDA reduction over that axis sums them, into four
// interleaved partial sums added in order
template <int kN>
__device__ __forceinline__ float band_sum(const float* p) {
  float acc[4];
#pragma unroll
  for (int j = 0; j < 4 && j < kN; ++j) acc[j] = p[j];
#pragma unroll
  for (int k = 4; k < kN; ++k) acc[k % 4] = acc[k % 4] + p[k];
  float s = acc[0];
#pragma unroll
  for (int j = 1; j < 4 && j < kN; ++j) s = s + acc[j];
  return s;
}

// ---- the view-independent part -------------------------------------------

struct Splat {
  float m[3];
  float opa;        // sigmoid(logit)
  float s[3];       // exp(log-scale)
  float sm[3];      // s * scale_modifier
  float q[4];       // raw quaternion
  float nq, den;    // |q|, max(|q|, 1e-12)
  float qn[4];      // q / den
  float r[9];       // rotation entries, row-major
  float cov[6];     // xx xy xz yy yz zz
};

__device__ __forceinline__ void splat_forward(const Args& a, int i, Splat& S) {
  S.m[0] = a.xyz[3 * i];
  S.m[1] = a.xyz[3 * i + 1];
  S.m[2] = a.xyz[3 * i + 2];
  S.opa = 1.0f / (1.0f + expf(-a.opacity[i]));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    S.s[k] = expf(a.scales[3 * i + k]);
    S.sm[k] = S.s[k] * a.scale_modifier;
  }
  const float4 q = reinterpret_cast<const float4*>(a.quats)[i];
  S.q[0] = q.x; S.q[1] = q.y; S.q[2] = q.z; S.q[3] = q.w;
  S.nq = norm4(q.x, q.y, q.z, q.w);
  S.den = t_clamp_min(S.nq, 1e-12f);
#pragma unroll
  for (int k = 0; k < 4; ++k) S.qn[k] = S.q[k] / S.den;
  const float w = S.qn[0], x = S.qn[1], y = S.qn[2], z = S.qn[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  S.r[0] = 1.0f - 2.0f * (yy + zz);
  S.r[1] = 2.0f * (xy - wz);
  S.r[2] = 2.0f * (xz + wy);
  S.r[3] = 2.0f * (xy + wz);
  S.r[4] = 1.0f - 2.0f * (xx + zz);
  S.r[5] = 2.0f * (yz - wx);
  S.r[6] = 2.0f * (xz - wy);
  S.r[7] = 2.0f * (yz + wx);
  S.r[8] = 1.0f - 2.0f * (xx + yy);
  const float s2x = S.sm[0] * S.sm[0], s2y = S.sm[1] * S.sm[1], s2z = S.sm[2] * S.sm[2];
  const float* r = S.r;
  // Sigma_ij = sum_k s2_k R_ik R_jk, in build_cov3d's order
  const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const float* ri = r + 3 * I[e];
    const float* rj = r + 3 * J[e];
    S.cov[e] = (s2x * ri[0] * rj[0] + s2y * ri[1] * rj[1]) + s2z * ri[2] * rj[2];
  }
}

// ---- one view -------------------------------------------------------------

struct Cam {
  const float* V;
  const float* P;
  float c[3];
  float fx, fy, limx, limy;
};

__device__ __forceinline__ Cam load_cam(const Args& a, int v) {
  Cam c;
  c.V = a.view + 16 * v;
  c.P = a.proj + 16 * v;
  c.c[0] = a.campos[3 * v];
  c.c[1] = a.campos[3 * v + 1];
  c.c[2] = a.campos[3 * v + 2];
  const float tx = a.tanx[v], ty = a.tany[v];
  // (width * 0.5) / tanx is Tensor.__rtruediv__: reciprocal, then the product
  c.fx = recip(tx) * (float)(a.width * 0.5);
  c.fy = recip(ty) * (float)(a.height * 0.5);
  c.limx = tx * 1.3f;
  c.limy = ty * 1.3f;
  return c;
}

// The view-dependent geometry of one splat, in transforms.py's order.
struct Geo {
  float pv[3];          // view point
  float ph[4];          // homogeneous projected point (ph[2] unused)
  float pw;             // 1 / (ph3 + 1e-7)
  float ndc[2];         // with the offset
  float z;              // the nudged view z
  float r0, r1;         // x/z, y/z before the clip
  float c0, c1;         // after the clip
  float X, Y;           // clipped x, y
  float iz, iz2;
  float j00, j02, j11, j12, a02, a12;
  float t0[3], t1[3];
  float cov2[3];        // undilated (a, b, d)
  float a, b, d;        // clamped
  float ah, dh, det, det_raw, os, ratio, detc, det_inv;
  float conic[3];
  float lam;
  bool valid;
};

__device__ __forceinline__ float quad(const float* cov, const float* u, const float* v) {
  return (((((cov[0] * u[0] * v[0] + cov[3] * u[1] * v[1]) + cov[5] * u[2] * v[2])
            + cov[1] * (u[0] * v[1] + u[1] * v[0]))
           + cov[2] * (u[0] * v[2] + u[2] * v[0]))
          + cov[4] * (u[1] * v[2] + u[2] * v[1]));
}

__device__ __forceinline__ void geo_forward(const Args& a, const Splat& S, const Cam& C,
                                            float2 off, bool has_off, bool aa, Geo& G) {
  const float* V = C.V;
  const float* P = C.P;
#pragma unroll
  for (int j = 0; j < 3; ++j) G.pv[j] = hom_dot(S.m[0], S.m[1], S.m[2], V, j);
  G.ph[0] = hom_dot(S.m[0], S.m[1], S.m[2], P, 0);
  G.ph[1] = hom_dot(S.m[0], S.m[1], S.m[2], P, 1);
  G.ph[3] = hom_dot(S.m[0], S.m[1], S.m[2], P, 3);
  G.pw = recip(G.ph[3] + 1e-7f);
  G.ndc[0] = G.ph[0] * G.pw;
  G.ndc[1] = G.ph[1] * G.pw;
  if (has_off) {
    G.ndc[0] = G.ndc[0] + off.x;
    G.ndc[1] = G.ndc[1] + off.y;
  }
  // project_cov3d_ewa
  const float pz = G.pv[2];
  G.z = fabsf(pz) > 1e-12f ? pz : 1e-12f;
  G.r0 = G.pv[0] / G.z;
  G.r1 = G.pv[1] / G.z;
  G.c0 = t_minimum(t_maximum(G.r0, -C.limx), C.limx);
  G.c1 = t_minimum(t_maximum(G.r1, -C.limy), C.limy);
  G.X = G.c0 * G.z;
  G.Y = G.c1 * G.z;
  G.iz = recip(G.z);
  G.iz2 = G.iz * G.iz;
  G.j00 = C.fx * G.iz;
  G.a02 = -C.fx * G.X;
  G.j02 = G.a02 * G.iz2;
  G.j11 = C.fy * G.iz;
  G.a12 = -C.fy * G.Y;
  G.j12 = G.a12 * G.iz2;
  // W = view[:3, :3]^T: w0 = column 0 of the view matrix, ...
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    G.t0[k] = G.j00 * V[4 * k] + G.j02 * V[4 * k + 2];
    G.t1[k] = G.j11 * V[4 * k + 1] + G.j12 * V[4 * k + 2];
  }
  G.cov2[0] = quad(S.cov, G.t0, G.t0);
  G.cov2[1] = quad(S.cov, G.t0, G.t1);
  G.cov2[2] = quad(S.cov, G.t1, G.t1);
  // conic_and_radius
  G.a = t_clamp(G.cov2[0], -1e18f, 1e18f);
  G.b = t_clamp(G.cov2[1], -1e18f, 1e18f);
  G.d = t_clamp(G.cov2[2], -1e18f, 1e18f);
  G.det_raw = G.a * G.d - G.b * G.b;
  G.ah = G.a + 0.3f;
  G.dh = G.d + 0.3f;
  G.det = G.ah * G.dh - G.b * G.b;
  if (aa) {
    G.ratio = G.det_raw / G.det;
    G.os = sqrtf(t_clamp_min(G.ratio, 0.000025f));
  } else {
    G.ratio = 0.0f;
    G.os = 1.0f;
  }
  G.valid = G.det != 0.0f;
  G.detc = t_clamp_min(G.det, 1e-5f);
  G.det_inv = recip(G.detc);
  G.conic[0] = G.dh * G.det_inv;
  G.conic[1] = -G.b * G.det_inv;
  G.conic[2] = G.ah * G.det_inv;
  const float mid = 0.5f * (G.ah + G.dh);
  const float st = sqrtf(t_clamp_min(mid * mid - G.det, 0.1f));
  G.lam = mid + st;
}

// ---- SH ---------------------------------------------------------------------

// The basis of every band up to `degree`, in core/sh.py's order and rounding:
// out[0..2] band 1, out[3..7] band 2, out[8..14] band 3, out[15..23] band 4.
__device__ __forceinline__ void sh_basis(float x, float y, float z, int degree, float* out) {
  out[0] = kC1a * y;
  out[1] = kC1b * z;
  out[2] = kC1c * x;
  if (degree < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, zx = z * x;
  out[3] = kC2[0] * xy;
  out[4] = kC2[1] * yz;
  out[5] = kC2[2] * ((2.0f * zz - xx) - yy);
  out[6] = kC2[3] * zx;
  out[7] = kC2[4] * (xx - yy);
  if (degree < 3) return;
  out[8] = kC3[0] * y * (3.0f * xx - yy);
  out[9] = kC3[1] * xy * z;
  out[10] = kC3[2] * y * ((4.0f * zz - xx) - yy);
  out[11] = kC3[3] * z * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
  out[12] = kC3[4] * x * ((4.0f * zz - xx) - yy);
  out[13] = kC3[5] * z * (xx - yy);
  out[14] = kC3[6] * x * (xx - 3.0f * yy);
  if (degree < 4) return;
  out[15] = kC4[0] * xy * (xx - yy);
  out[16] = kC4[1] * yz * (3.0f * xx - yy);
  out[17] = kC4[2] * xy * (7.0f * zz - 1.0f);
  out[18] = kC4[3] * yz * (7.0f * zz - 3.0f);
  out[19] = kC4[4] * (zz * (35.0f * zz - 30.0f) + 3.0f);
  out[20] = kC4[5] * zx * (7.0f * zz - 3.0f);
  out[21] = kC4[6] * (xx - yy) * (7.0f * zz - 1.0f);
  out[22] = kC4[7] * zx * (xx - 3.0f * yy);
  out[23] = kC4[8] * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
}

// The gradient of the direction (x, y, z) from the basis' gradient gb,
// through the same expression tree as sh_basis (autograd's products).
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z, int degree,
                                             const float* gb, float* gd) {
  float gx = kC1c * gb[2], gy = kC1a * gb[0], gz = kC1b * gb[1];
  if (degree >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, zx = z * x;
    float gxx = 0.0f, gyy = 0.0f, gzz = 0.0f, gxy = 0.0f, gyz = 0.0f, gzx = 0.0f;
    gxy += kC2[0] * gb[3];
    gyz += kC2[1] * gb[4];
    {
      const float g = kC2[2] * gb[5];
      gzz += 2.0f * g;
      gxx -= g;
      gyy -= g;
    }
    gzx += kC2[3] * gb[6];
    {
      const float g = kC2[4] * gb[7];
      gxx += g;
      gyy -= g;
    }
    if (degree >= 3) {
      {
        const float u = 3.0f * xx - yy;
        gy += kC3[0] * (gb[8] * u);
        const float g = gb[8] * (kC3[0] * y);
        gxx += 3.0f * g;
        gyy -= g;
      }
      gxy += kC3[1] * (gb[9] * z);
      gz += gb[9] * (kC3[1] * xy);
      {
        const float u = (4.0f * zz - xx) - yy;
        gy += kC3[2] * (gb[10] * u);
        const float g = gb[10] * (kC3[2] * y);
        gzz += 4.0f * g;
        gxx -= g;
        gyy -= g;
      }
      {
        const float u = (2.0f * zz - 3.0f * xx) - 3.0f * yy;
        gz += kC3[3] * (gb[11] * u);
        const float g = gb[11] * (kC3[3] * z);
        gzz += 2.0f * g;
        gxx -= 3.0f * g;
        gyy -= 3.0f * g;
      }
      {
        const float u = (4.0f * zz - xx) - yy;
        gx += kC3[4] * (gb[12] * u);
        const float g = gb[12] * (kC3[4] * x);
        gzz += 4.0f * g;
        gxx -= g;
        gyy -= g;
      }
      {
        const float u = xx - yy;
        gz += kC3[5] * (gb[13] * u);
        const float g = gb[13] * (kC3[5] * z);
        gxx += g;
        gyy -= g;
      }
      {
        const float u = xx - 3.0f * yy;
        gx += kC3[6] * (gb[14] * u);
        const float g = gb[14] * (kC3[6] * x);
        gxx += g;
        gyy -= 3.0f * g;
      }
    }
    if (degree >= 4) {
      {
        const float u = xx - yy;
        gxy += kC4[0] * (gb[15] * u);
        const float g = gb[15] * (kC4[0] * xy);
        gxx += g;
        gyy -= g;
      }
      {
        const float u = 3.0f * xx - yy;
        gyz += kC4[1] * (gb[16] * u);
        const float g = gb[16] * (kC4[1] * yz);
        gxx += 3.0f * g;
        gyy -= g;
      }
      {
        const float u = 7.0f * zz - 1.0f;
        gxy += kC4[2] * (gb[17] * u);
        gzz += 7.0f * (gb[17] * (kC4[2] * xy));
      }
      {
        const float u = 7.0f * zz - 3.0f;
        gyz += kC4[3] * (gb[18] * u);
        gzz += 7.0f * (gb[18] * (kC4[3] * yz));
      }
      {
        const float g = kC4[4] * gb[19];
        const float w = 35.0f * zz - 30.0f;
        gzz += g * w;
        gzz += 35.0f * (g * zz);
      }
      {
        const float u = 7.0f * zz - 3.0f;
        gzx += kC4[5] * (gb[20] * u);
        gzz += 7.0f * (gb[20] * (kC4[5] * zx));
      }
      {
        const float u = 7.0f * zz - 1.0f;
        const float g = kC4[6] * (gb[21] * u);
        gxx += g;
        gyy -= g;
        gzz += 7.0f * (gb[21] * (kC4[6] * (xx - yy)));
      }
      {
        const float u = xx - 3.0f * yy;
        gzx += kC4[7] * (gb[22] * u);
        const float g = gb[22] * (kC4[7] * zx);
        gxx += g;
        gyy -= 3.0f * g;
      }
      {
        const float g = kC4[8] * gb[23];
        const float p = xx - 3.0f * yy, q = 3.0f * xx - yy;
        gxx += g * p;
        const float gp = g * xx;
        gxx += gp;
        gyy -= 3.0f * gp;
        gyy -= g * q;
        const float gq = -(g * yy);
        gxx += 3.0f * gq;
        gyy -= gq;
      }
    }
    gx += 2.0f * (gxx * x) + gxy * y + gzx * z;
    gy += 2.0f * (gyy * y) + gxy * x + gyz * z;
    gz += 2.0f * (gzz * z) + gyz * y + gzx * x;
  }
  gd[0] = gx;
  gd[1] = gy;
  gd[2] = gz;
}

// res[c] = C0 * dc[c] + sum over bands (in band order) of that band's sum
__device__ __forceinline__ void sh_eval(const float* dc, const float* rest, const float* basis,
                                        int degree, float* res) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float r = kC0 * dc[c];
    float p[9];
    if (degree >= 1) {
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = basis[k] * rest[3 * k + c];
      r = r + band_sum<3>(p);
    }
    if (degree >= 2) {
#pragma unroll
      for (int k = 0; k < 5; ++k) p[k] = basis[3 + k] * rest[3 * (3 + k) + c];
      r = r + band_sum<5>(p);
    }
    if (degree >= 3) {
#pragma unroll
      for (int k = 0; k < 7; ++k) p[k] = basis[8 + k] * rest[3 * (8 + k) + c];
      r = r + band_sum<7>(p);
    }
    if (degree >= 4) {
#pragma unroll
      for (int k = 0; k < 9; ++k) p[k] = basis[15 + k] * rest[3 * (15 + k) + c];
      r = r + band_sum<9>(p);
    }
    res[c] = r;
  }
}

// the SH direction: normalize(m - campos)
__device__ __forceinline__ float sh_dir(const Splat& S, const Cam& C, float* d, float* dir) {
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = S.m[k] - C.c[k];
  const float nrm = norm3(d[0], d[1], d[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = d[k] / nrm;
  return nrm;
}

// The block's features_rest rows staged in shared memory at an odd stride:
// `rows` rows of `len` floats starting at row `first`, coalesced 16-byte
// loads where the source allows them.
__host__ __device__ __forceinline__ int row_stride(int len) { return len | 1; }

__device__ void stage_rows(const float* src, int first, int rows, int len, float* smem) {
  const int stride = row_stride(len);
  const int total = rows * len;
  const float* base = src + (size_t)first * len;
  if ((reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    const float4* b4 = reinterpret_cast<const float4*>(base);
    for (int f4 = threadIdx.x; f4 < total / 4; f4 += blockDim.x) {
      const float4 v = b4[f4];
      const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = 4 * f4 + u;
        smem[(f / len) * stride + f % len] = vals[u];
      }
    }
    for (int f = (total / 4) * 4 + threadIdx.x; f < total; f += blockDim.x)
      smem[(f / len) * stride + f % len] = base[f];
  } else {
    for (int f = threadIdx.x; f < total; f += blockDim.x)
      smem[(f / len) * stride + f % len] = base[f];
  }
}

__device__ void unstage_rows(const float* smem, int first, int rows, int len, float* dst) {
  const int stride = row_stride(len);
  const int total = rows * len;
  float* base = dst + (size_t)first * len;
  if ((reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    float4* b4 = reinterpret_cast<float4*>(base);
    for (int f4 = threadIdx.x; f4 < total / 4; f4 += blockDim.x) {
      float vals[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = 4 * f4 + u;
        vals[u] = smem[(f / len) * stride + f % len];
      }
      b4[f4] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    }
    for (int f = (total / 4) * 4 + threadIdx.x; f < total; f += blockDim.x)
      base[f] = smem[(f / len) * stride + f % len];
  } else {
    for (int f = threadIdx.x; f < total; f += blockDim.x)
      base[f] = smem[(f / len) * stride + f % len];
  }
}

// the binning's tile-rect cell: clamp(trunc(v / 16), 0, hi) as int32, as f32
__device__ __forceinline__ float rect_cell(float v, int hi) {
  return (float)(int)t_clamp(truncf(v * 0.0625f), 0.0f, (float)hi);
}

// ---- the kernels ----------------------------------------------------------

__global__ void __launch_bounds__(kThreads) preprocess_fwd_kernel(const Args a) {
  extern __shared__ float rest_smem[];
  const int first = blockIdx.x * kThreads;
  const int rows = min(kThreads, a.n - first);
  const int v = blockIdx.y;
  const int len = a.rest_floats;
  if (a.degree > 0 && len > 0) {
    stage_rows(a.rest, first, rows, len, rest_smem);
    __syncthreads();
  }
  const int i = first + threadIdx.x;
  if (i >= a.n) return;

  Splat S;
  splat_forward(a, i, S);
  const Cam C = load_cam(a, v);
  const size_t vi = (size_t)v * a.n + i;
  const bool has_off = a.offset != nullptr;
  const float2 off = has_off ? reinterpret_cast<const float2*>(a.offset)[vi]
                             : make_float2(0.0f, 0.0f);
  Geo G;
  geo_forward(a, S, C, off, has_off, a.antialias != 0, G);

  bool visible = G.pv[2] > 0.2f;
  if (a.alive != nullptr) visible = visible && a.alive[i] != 0;
  visible = visible && G.valid;
  float radius = ceilf(3.0f * sqrtf(G.lam));
  radius = visible ? radius : 0.0f;
  const float opacity = S.opa * G.os;
  const float lr = logf(t_clamp_min(opacity * a.inv_alpha, 1.0f));
  const float lam_s = t_clamp_max(G.lam, 1e12f);
  const float tight = ceilf(sqrtf(2.0f * lr * lam_s)) + 1.0f;
  const float rbin = t_minimum(radius, tight);
  const float cull = 2.0f * lr * lam_s * 1.001f + 0.25f;

  float rgb[3];
  const float dc[3] = {a.dc[3 * i], a.dc[3 * i + 1], a.dc[3 * i + 2]};
  if (a.degree > 0) {
    float d[3], dir[3], basis[24];
    sh_dir(S, C, d, dir);
    sh_basis(dir[0], dir[1], dir[2], a.degree, basis);
    sh_eval(dc, rest_smem + threadIdx.x * row_stride(len), basis, a.degree, rgb);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = kC0 * dc[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = t_clamp_min(rgb[c] + 0.5f, 0.0f);

  const float px = ((G.ndc[0] + 1.0f) * (float)a.width - 1.0f) * 0.5f;
  const float py = ((G.ndc[1] + 1.0f) * (float)a.height - 1.0f) * 0.5f;
  const float depth = G.pv[2];
  const float safe_z = fabsf(depth) > 1e-9f ? depth : 1.0f;
  float rect[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (a.rect) {
    rect[0] = rect_cell(px - rbin, a.grid16x);
    rect[1] = rect_cell(px + rbin + 15.0f, a.grid16x);
    rect[2] = rect_cell(py - rbin, a.grid16y);
    rect[3] = rect_cell(py + rbin + 15.0f, a.grid16y);
  }
  float4* row = reinterpret_cast<float4*>(a.table + vi * kFeat);
  row[0] = make_float4(px, py, G.conic[0], G.conic[1]);
  row[1] = make_float4(G.conic[2], opacity, rgb[0], rgb[1]);
  row[2] = make_float4(rgb[2], recip(safe_z), rect[0], rect[1]);
  row[3] = make_float4(rect[2], rect[3], 0.0f, 0.0f);
  reinterpret_cast<float2*>(a.p_pix)[vi] = make_float2(px, py);
  a.depth[vi] = depth;
  a.radius[vi] = radius;
  a.radius_bin[vi] = rbin;
  a.visible[vi] = visible ? 1 : 0;
  a.cull_r2[vi] = cull;
}

// at most 128 registers a thread (ptxas spills 128 bytes), so that four
// blocks fit an SM where 156 registers fit three: 9% faster at the bench's
// size, the same bits
__global__ void __launch_bounds__(kThreads, 4) preprocess_bwd_kernel(const Args a) {
  extern __shared__ float smem[];
  const int first = blockIdx.x * kThreads;
  const int rows = min(kThreads, a.n - first);
  const int len = a.rest_floats;
  const int stride = row_stride(len);
  float* rest_s = smem;                       // the rows, then
  float* grad_s = smem + kThreads * stride;   // their gradients
  const bool sh = a.degree > 0 && len > 0;
  if (len > 0) {
    if (sh) stage_rows(a.rest, first, rows, len, rest_s);
    for (int f = threadIdx.x; f < kThreads * stride; f += blockDim.x) grad_s[f] = 0.0f;
    __syncthreads();
  }
  const int i = first + threadIdx.x;
  if (i < a.n) {
    Splat S;
    splat_forward(a, i, S);
    const float dc[3] = {a.dc[3 * i], a.dc[3 * i + 1], a.dc[3 * i + 2]};
    const float* rest = rest_s + threadIdx.x * stride;
    float* grest = grad_s + threadIdx.x * stride;
    const bool aa = a.antialias != 0;

    float g_m[3] = {0.0f, 0.0f, 0.0f};
    float g_cov[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float g_opa = 0.0f;
    float g_res0[3] = {0.0f, 0.0f, 0.0f};  // the SH result's gradient, summed over views

#pragma unroll 1
    for (int v = 0; v < a.views; ++v) {
      const Cam C = load_cam(a, v);
      const size_t vi = (size_t)v * a.n + i;
      const float2 off = a.offset != nullptr
                             ? reinterpret_cast<const float2*>(a.offset)[vi]
                             : make_float2(0.0f, 0.0f);
      Geo G;
      geo_forward(a, S, C, off, a.offset != nullptr, aa, G);
      const float4* grow = reinterpret_cast<const float4*>(a.dtable + vi * kFeat);
      const float4 g0 = grow[0], g1 = grow[1], g2 = grow[2];
      const float g_px = g0.x, g_py = g0.y;
      const float g_ca = g0.z, g_cb = g0.w, g_cc = g1.x, g_op = g1.y;
      const float g_rgb[3] = {g1.z, g1.w, g2.x};
      const float g_iz = g2.y;

      // pixel mean <- NDC <- homogeneous point
      const float g_n0 = (g_px * 0.5f) * (float)a.width;
      const float g_n1 = (g_py * 0.5f) * (float)a.height;
      if (a.d_offset != nullptr)
        reinterpret_cast<float2*>(a.d_offset)[vi] = make_float2(g_n0, g_n1);
      const float g_ph0 = g_n0 * G.pw, g_ph1 = g_n1 * G.pw;
      const float g_pw = g_n0 * G.ph[0] + g_n1 * G.ph[1];
      const float g_ph3 = -g_pw * (G.pw * G.pw);
      // 1 / safe_z <- depth
      const float depth = G.pv[2];
      float g_pv[3] = {0.0f, 0.0f, 0.0f};
      if (fabsf(depth) > 1e-9f) {
        const float iz = recip(depth);
        g_pv[2] += -g_iz * (iz * iz);
      }
      // opacity * opacity_scale
      g_opa += g_op * G.os;
      float g_det = 0.0f, g_dr = 0.0f;
      if (aa) {
        const float g_os = g_op * S.opa;
        const float g_ratio = G.ratio >= 0.000025f ? g_os / (2.0f * G.os) : 0.0f;
        g_dr = g_ratio / G.det;
        g_det += -g_ratio * G.det_raw / (G.det * G.det);
      }
      // conic <- det_inv, a_h, d_h, b
      float g_dh = g_ca * G.det_inv;
      float g_ah = g_cc * G.det_inv;
      float g_b = -(g_cb * G.det_inv);
      const float g_di = (g_ca * G.dh + g_cb * (-G.b)) + g_cc * G.ah;
      if (G.det >= 1e-5f) g_det += -g_di * (G.det_inv * G.det_inv);
      g_ah += g_det * G.dh;
      g_dh += g_det * G.ah;
      g_b -= g_det * G.b + g_det * G.b;
      float g_a = g_ah, g_d = g_dh;
      if (aa) {
        g_a += g_dr * G.d;
        g_d += g_dr * G.a;
        g_b -= g_dr * G.b + g_dr * G.b;
      }
      const float gc0 = (G.cov2[0] >= -1e18f && G.cov2[0] <= 1e18f) ? g_a : 0.0f;
      const float gc1 = (G.cov2[1] >= -1e18f && G.cov2[1] <= 1e18f) ? g_b : 0.0f;
      const float gc2 = (G.cov2[2] >= -1e18f && G.cov2[2] <= 1e18f) ? g_d : 0.0f;
      // quad(t0, t0), quad(t0, t1), quad(t1, t1) <- cov6, t0, t1
      const float* t0 = G.t0;
      const float* t1 = G.t1;
      const float* cv = S.cov;
      const float Sm[9] = {cv[0], cv[1], cv[2], cv[1], cv[3], cv[4], cv[2], cv[4], cv[5]};
      float St0[3], St1[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        St0[r] = Sm[3 * r] * t0[0] + Sm[3 * r + 1] * t0[1] + Sm[3 * r + 2] * t0[2];
        St1[r] = Sm[3 * r] * t1[0] + Sm[3 * r + 1] * t1[1] + Sm[3 * r + 2] * t1[2];
      }
      float g_t0[3], g_t1[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        g_t0[r] = gc0 * (St0[r] + St0[r]) + gc1 * St1[r];
        g_t1[r] = gc1 * St0[r] + gc2 * (St1[r] + St1[r]);
      }
      const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        const int p = I[e], q = J[e];
        if (p == q) {
          g_cov[e] += (gc0 * t0[p] * t0[p] + gc1 * t0[p] * t1[p]) + gc2 * t1[p] * t1[p];
        } else {
          g_cov[e] += (gc0 * (t0[p] * t0[q] + t0[q] * t0[p])
                       + gc1 * (t0[p] * t1[q] + t0[q] * t1[p]))
                      + gc2 * (t1[p] * t1[q] + t1[q] * t1[p]);
        }
      }
      // t0 = j00 w0 + j02 w2, t1 = j11 w1 + j12 w2
      const float* V = C.V;
      float g_j00 = 0.0f, g_j02 = 0.0f, g_j11 = 0.0f, g_j12 = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g_j00 += g_t0[k] * V[4 * k];
        g_j02 += g_t0[k] * V[4 * k + 2];
        g_j11 += g_t1[k] * V[4 * k + 1];
        g_j12 += g_t1[k] * V[4 * k + 2];
      }
      float g_iz2 = g_j02 * G.a02 + g_j12 * G.a12;
      const float g_X = (g_j02 * G.iz2) * -C.fx;
      const float g_Y = (g_j12 * G.iz2) * -C.fy;
      float g_izz = g_j00 * C.fx + g_j11 * C.fy;
      g_izz += g_iz2 * G.iz + g_iz2 * G.iz;
      float g_z = -g_izz * (G.iz * G.iz);
      // X = clip(x / z) * z
      const float g_c0 = g_X * G.z, g_c1 = g_Y * G.z;
      g_z += g_X * G.c0 + g_Y * G.c1;
      float g_r0, g_r1;
      {
        // minimum(maximum(r, -lim), lim): a tie passes half
        const float mx = t_maximum(G.r0, -C.limx);
        const float gm = mx == C.limx ? g_c0 * 0.5f : (mx < C.limx ? g_c0 : 0.0f);
        g_r0 = G.r0 == -C.limx ? gm * 0.5f : (G.r0 > -C.limx ? gm : 0.0f);
        const float my = t_maximum(G.r1, -C.limy);
        const float gn = my == C.limy ? g_c1 * 0.5f : (my < C.limy ? g_c1 : 0.0f);
        g_r1 = G.r1 == -C.limy ? gn * 0.5f : (G.r1 > -C.limy ? gn : 0.0f);
      }
      g_pv[0] += g_r0 / G.z;
      g_pv[1] += g_r1 / G.z;
      g_z += -g_r0 * G.pv[0] / (G.z * G.z) + -g_r1 * G.pv[1] / (G.z * G.z);
      if (fabsf(G.pv[2]) > 1e-12f) g_pv[2] += g_z;
      // [m, 1] @ view, [m, 1] @ proj
      const float* P = C.P;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g_m[k] += (g_pv[0] * V[4 * k] + g_pv[1] * V[4 * k + 1]) + g_pv[2] * V[4 * k + 2];
        g_m[k] += (g_ph0 * P[4 * k] + g_ph1 * P[4 * k + 1]) + g_ph3 * P[4 * k + 3];
      }
      // SH colour: clamp_min(res + 0.5, 0) <- res <- coefficients, direction
      if (a.degree > 0) {
        float d[3], dir[3], basis[24], res[3];
        const float nrm = sh_dir(S, C, d, dir);
        sh_basis(dir[0], dir[1], dir[2], a.degree, basis);
        sh_eval(dc, rest, basis, a.degree, res);
        float g_res[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          g_res[c] = res[c] + 0.5f >= 0.0f ? g_rgb[c] : 0.0f;
          g_res0[c] += g_res[c];
        }
        const int nb = (a.degree + 1) * (a.degree + 1) - 1;
        float gb[24];
#pragma unroll
        for (int k = 0; k < 24; ++k) {  // unrolled: gb and basis stay in registers
          if (k >= nb) break;
          gb[k] = (g_res[0] * rest[3 * k] + g_res[1] * rest[3 * k + 1])
                  + g_res[2] * rest[3 * k + 2];
#pragma unroll
          for (int c = 0; c < 3; ++c) grest[3 * k + c] += basis[k] * g_res[c];
        }
        float g_dir[3];
        sh_basis_vjp(dir[0], dir[1], dir[2], a.degree, gb, g_dir);
        // dir = d / |d|
        const float g_n = (-g_dir[0] * d[0] / (nrm * nrm) + -g_dir[1] * d[1] / (nrm * nrm))
                          + -g_dir[2] * d[2] / (nrm * nrm);
        const float gn = nrm == 0.0f ? 0.0f : g_n / nrm;
#pragma unroll
        for (int k = 0; k < 3; ++k) g_m[k] += g_dir[k] / nrm + d[k] * gn;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float res = kC0 * dc[c];
          g_res0[c] += res + 0.5f >= 0.0f ? g_rgb[c] : 0.0f;
        }
      }
    }

    // features_dc, opacity
#pragma unroll
    for (int c = 0; c < 3; ++c) a.d_dc[3 * i + c] = g_res0[c] * kC0;
    a.d_opacity[i] = g_opa * (1.0f - S.opa) * S.opa;
    // cov6 = build_cov3d(scales * modifier, qn) <- s2, rotation entries
    float g_s2[3] = {0.0f, 0.0f, 0.0f};
    float g_r[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const float s2[3] = {S.sm[0] * S.sm[0], S.sm[1] * S.sm[1], S.sm[2] * S.sm[2]};
    const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int p = I[e], q = J[e];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float rp = S.r[3 * p + k], rq = S.r[3 * q + k];
        g_s2[k] += g_cov[e] * rp * rq;
        g_r[3 * p + k] += g_cov[e] * s2[k] * rq;
        g_r[3 * q + k] += g_cov[e] * s2[k] * rp;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float g_sm = g_s2[k] * S.sm[k] + g_s2[k] * S.sm[k];
      a.d_scales[3 * i + k] = (g_sm * a.scale_modifier) * S.s[k];
    }
    // rotation entries <- normalized quaternion
    const float w = S.qn[0], x = S.qn[1], y = S.qn[2], z = S.qn[3];
    const float gxx = -2.0f * g_r[4] - 2.0f * g_r[8];
    const float gyy = -2.0f * g_r[0] - 2.0f * g_r[8];
    const float gzz = -2.0f * g_r[0] - 2.0f * g_r[4];
    const float gxy = 2.0f * g_r[1] + 2.0f * g_r[3];
    const float gxz = 2.0f * g_r[2] + 2.0f * g_r[6];
    const float gyz = 2.0f * g_r[5] + 2.0f * g_r[7];
    const float gwx = 2.0f * g_r[7] - 2.0f * g_r[5];
    const float gwy = 2.0f * g_r[2] - 2.0f * g_r[6];
    const float gwz = 2.0f * g_r[3] - 2.0f * g_r[1];
    float g_qn[4];
    g_qn[0] = gwx * x + gwy * y + gwz * z;
    g_qn[1] = 2.0f * (gxx * x) + gxy * y + gxz * z + gwx * w;
    g_qn[2] = 2.0f * (gyy * y) + gxy * x + gyz * z + gwy * w;
    g_qn[3] = 2.0f * (gzz * z) + gxz * x + gyz * y + gwz * w;
    // q / max(|q|, 1e-12)
    float g_den = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) g_den += -g_qn[k] * S.q[k] / (S.den * S.den);
    const float g_nq = S.nq >= 1e-12f ? g_den : 0.0f;
    const float gn = S.nq == 0.0f ? 0.0f : g_nq / S.nq;
    float gq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) gq[k] = g_qn[k] / S.den + S.q[k] * gn;
    reinterpret_cast<float4*>(a.d_quats)[i] = make_float4(gq[0], gq[1], gq[2], gq[3]);
#pragma unroll
    for (int k = 0; k < 3; ++k) a.d_xyz[3 * i + k] = g_m[k];
  }
  if (len > 0) {
    __syncthreads();
    unstage_rows(grad_s, first, rows, len, a.d_rest);
  }
}

size_t fwd_smem(const Args& a) {
  return a.degree > 0 && a.rest_floats > 0 ? sizeof(float) * kThreads * row_stride(a.rest_floats)
                                           : 0;
}

size_t bwd_smem(const Args& a) {
  return a.rest_floats > 0 ? 2 * sizeof(float) * kThreads * row_stride(a.rest_floats) : 0;
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Args make_args(const void* xyz, const void* dc, const void* rest, const void* opacity,
               const void* scales, const void* quats, const void* offset, const void* view,
               const void* proj, const void* campos, const void* tanx, const void* tany, int n,
               int views, int width, int height, int degree, int rest_floats, int antialias,
               float scale_modifier) {
  Args a = {};
  a.xyz = (const float*)xyz;
  a.dc = (const float*)dc;
  a.rest = (const float*)rest;
  a.opacity = (const float*)opacity;
  a.scales = (const float*)scales;
  a.quats = (const float*)quats;
  a.offset = (const float*)offset;
  a.view = (const float*)view;
  a.proj = (const float*)proj;
  a.campos = (const float*)campos;
  a.tanx = (const float*)tanx;
  a.tany = (const float*)tany;
  a.n = n;
  a.views = views;
  a.width = width;
  a.height = height;
  a.degree = degree;
  a.rest_floats = rest_floats;
  a.antialias = antialias;
  a.scale_modifier = scale_modifier;
  return a;
}

}  // namespace

// The table and the binning's fields of B views from the raw leaves.
// `offset` and `alive` may be null; the rest is contiguous f32 (alive bool).
extern "C" int gs_preprocess_fwd(const void* xyz, const void* dc, const void* rest,
                                 const void* opacity, const void* scales, const void* quats,
                                 const void* offset, const void* alive, const void* view,
                                 const void* proj, const void* campos, const void* tanx,
                                 const void* tany, void* table, void* p_pix, void* depth,
                                 void* radius, void* radius_bin, void* visible, void* cull_r2,
                                 int n, int views, int width, int height, int degree,
                                 int rest_floats, int antialias, int rect, int grid16x,
                                 int grid16y, float scale_modifier, float inv_alpha,
                                 void* stream) {
  Args a = make_args(xyz, dc, rest, opacity, scales, quats, offset, view, proj, campos, tanx,
                     tany, n, views, width, height, degree, rest_floats, antialias,
                     scale_modifier);
  a.alive = (const uint8_t*)alive;
  a.table = (float*)table;
  a.p_pix = (float*)p_pix;
  a.depth = (float*)depth;
  a.radius = (float*)radius;
  a.radius_bin = (float*)radius_bin;
  a.visible = (uint8_t*)visible;
  a.cull_r2 = (float*)cull_r2;
  a.rect = rect;
  a.grid16x = grid16x;
  a.grid16y = grid16y;
  a.inv_alpha = inv_alpha;
  if (n > 0 && views > 0) {
    const size_t smem = fwd_smem(a);
    const cudaError_t err = allow_smem((const void*)preprocess_fwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + kThreads - 1) / kThreads, views);
    preprocess_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The gradient of every raw leaf, and of the NDC offset (d_offset may be
// null), from the table's gradient `dtable` (B, N, 16).
extern "C" int gs_preprocess_bwd(const void* xyz, const void* dc, const void* rest,
                                 const void* opacity, const void* scales, const void* quats,
                                 const void* offset, const void* view, const void* proj,
                                 const void* campos, const void* tanx, const void* tany,
                                 const void* dtable, void* d_xyz, void* d_dc, void* d_rest,
                                 void* d_opacity, void* d_scales, void* d_quats,
                                 void* d_offset, int n, int views, int width, int height,
                                 int degree, int rest_floats, int antialias,
                                 float scale_modifier, void* stream) {
  Args a = make_args(xyz, dc, rest, opacity, scales, quats, offset, view, proj, campos, tanx,
                     tany, n, views, width, height, degree, rest_floats, antialias,
                     scale_modifier);
  a.dtable = (const float*)dtable;
  a.d_xyz = (float*)d_xyz;
  a.d_dc = (float*)d_dc;
  a.d_rest = (float*)d_rest;
  a.d_opacity = (float*)d_opacity;
  a.d_scales = (float*)d_scales;
  a.d_quats = (float*)d_quats;
  a.d_offset = (float*)d_offset;
  if (n > 0) {
    const size_t smem = bwd_smem(a);
    const cudaError_t err = allow_smem((const void*)preprocess_bwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + kThreads - 1) / kThreads);
    preprocess_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
