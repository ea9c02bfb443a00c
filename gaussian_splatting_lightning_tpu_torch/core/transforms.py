"""Splatting geometry: quaternions, 3D/2D covariances (EWA), conics, radii.

Counterpart of ``gaussian_splatting_lightning_tpu/core/transforms.py``, op for
op in the same order so float32 results agree to the last few ulp. Behavioral
spec: the reference's pure-Python rasterizer math
(``gs_lightning/rasterize/render_tools.py`` and ``camera_tools.py``).

Conventions (load-bearing, easy to get silently wrong):
- Row-vector matrices: points transform as ``p_hom @ M``; ``viewmatrix``
  stores translation in its last *row*.
- Projection maps z to [0, 1] with z_sign=+1.
- 2D covariance is dilated by +0.3 px *before* both inversion and radius.
"""

from __future__ import annotations

import torch

COV_DILATION = 0.3  # reference render_tools.py:73 (h_var)
RADIUS_FACTOR = 3.0
FRUSTUM_NEAR_Z = 0.2  # reference camera_tools.py:7


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize wxyz quaternions, (..., 4)."""
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), eps)


def _rot_entries(q: torch.Tensor):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """wxyz unit quaternion -> rotation matrix. (..., 4) -> (..., 3, 3)."""
    return torch.stack(_rot_entries(q), dim=-1).reshape(q.shape[:-1] + (3, 3))


def build_cov3d(
    scales: torch.Tensor, quats: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """Sigma = R S S^T R^T, upper triangle (xx, xy, xz, yy, yz, zz).

    Spec: reference ``render_tools.py:56-70``. ``quats`` are assumed
    normalized. (..., 3), (..., 4) -> (..., 6). Elementwise over the rotation
    entries (Sigma_ij = sum_k s_k^2 R_ik R_jk), the JAX package's op order.
    """
    s = scales * scale_modifier
    s2 = s * s
    s2x, s2y, s2z = s2[..., 0], s2[..., 1], s2[..., 2]
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rot_entries(quats)
    c_xx = s2x * r00 * r00 + s2y * r01 * r01 + s2z * r02 * r02
    c_xy = s2x * r00 * r10 + s2y * r01 * r11 + s2z * r02 * r12
    c_xz = s2x * r00 * r20 + s2y * r01 * r21 + s2z * r02 * r22
    c_yy = s2x * r10 * r10 + s2y * r11 * r11 + s2z * r12 * r12
    c_yz = s2x * r10 * r20 + s2y * r11 * r21 + s2z * r12 * r22
    c_zz = s2x * r20 * r20 + s2y * r21 * r21 + s2z * r22 * r22
    return torch.stack([c_xx, c_xy, c_xz, c_yy, c_yz, c_zz], dim=-1)


def cov3d_to_matrix(cov6: torch.Tensor) -> torch.Tensor:
    """(..., 6) upper triangle -> (..., 3, 3) symmetric."""
    idx = torch.tensor([0, 1, 2, 1, 3, 4, 2, 4, 5], device=cov6.device)
    return cov6.index_select(-1, idx).reshape(cov6.shape[:-1] + (3, 3))


def apply_extrinsic(points: torch.Tensor, viewmatrix: torch.Tensor) -> torch.Tensor:
    """[p, 1] @ view -> (..., 4). Spec: camera_tools.py:21-27."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype, device=points.device)
    return torch.cat([points, ones], dim=-1) @ viewmatrix


def apply_projection(
    points: torch.Tensor, projmatrix: torch.Tensor, eps: float = 1e-7
) -> torch.Tensor:
    """Homogeneous projection -> NDC xy, (..., 2). Spec: camera_tools.py:10-19."""
    p_hom = apply_extrinsic(points, projmatrix)
    p_w = 1.0 / (p_hom[..., -1:] + eps)
    return (p_hom * p_w)[..., :2]


def in_frustum(p_view: torch.Tensor) -> torch.Tensor:
    """Visibility = view-space z > 0.2 only (reference camera_tools.py:5-8)."""
    return p_view[..., 2] > FRUSTUM_NEAR_Z


def ndc_to_pix(ndc_xy: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """NDC -> pixel coords. Spec: camera_tools.py:29-32."""
    x = ((ndc_xy[..., 0] + 1.0) * width - 1.0) * 0.5
    y = ((ndc_xy[..., 1] + 1.0) * height - 1.0) * 0.5
    return torch.stack([x, y], dim=-1)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def project_cov3d_ewa(
    means3d: torch.Tensor,
    cov6: torch.Tensor,
    viewmatrix: torch.Tensor,
    focal_x,
    focal_y,
    tan_fovx,
    tan_fovy,
) -> torch.Tensor:
    """EWA projection of 3D covariance to screen space.

    Spec: reference ``render_tools.py:13-52``. Returns the *undilated* 2x2
    covariance as (..., 3) = (a, b, d) for [[a, b], [b, d]]. With a (B, 4, 4)
    ``viewmatrix`` the focals and tangents are (B, 1) and the result (B, N, 3).
    """
    p_view = apply_extrinsic(means3d, viewmatrix)
    z = p_view[..., 2]
    # a splat exactly AT the camera plane would make 0 * inf = NaN in the
    # Jacobian; nudge only the exact-degenerate case (JAX package, same guard)
    z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    lim_x = torch.as_tensor(1.3 * tan_fovx, dtype=z.dtype, device=z.device)
    lim_y = torch.as_tensor(1.3 * tan_fovy, dtype=z.dtype, device=z.device)
    x = _clip(p_view[..., 0] / z, -lim_x, lim_x) * z
    y = _clip(p_view[..., 1] / z, -lim_y, lim_y) * z

    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    # J rows: [fx/z, 0, -fx*x/z^2], [0, fy/z, -fy*y/z^2] (3rd row unused).
    j00 = focal_x * inv_z
    j02 = -focal_x * x * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * y * inv_z2

    # Row-vector viewmatrix => world->cam rotation (column form) is view[:3,:3]^T;
    # a (B, 4, 4) stack of views broadcasts its rows over the splats
    W = viewmatrix[..., :3, :3].transpose(-1, -2)
    w0, w1, w2 = (W[..., None, i, :] for i in range(3))
    t0 = j00[..., None] * w0 + j02[..., None] * w2
    t1 = j11[..., None] * w1 + j12[..., None] * w2

    v_xx, v_xy, v_xz = cov6[..., 0], cov6[..., 1], cov6[..., 2]
    v_yy, v_yz, v_zz = cov6[..., 3], cov6[..., 4], cov6[..., 5]

    def quad(u, v):
        return (
            v_xx * u[..., 0] * v[..., 0]
            + v_yy * u[..., 1] * v[..., 1]
            + v_zz * u[..., 2] * v[..., 2]
            + v_xy * (u[..., 0] * v[..., 1] + u[..., 1] * v[..., 0])
            + v_xz * (u[..., 0] * v[..., 2] + u[..., 2] * v[..., 0])
            + v_yz * (u[..., 1] * v[..., 2] + u[..., 2] * v[..., 1])
        )

    return torch.stack([quad(t0, t0), quad(t0, t1), quad(t1, t1)], dim=-1)


def conic_and_radius(cov2d: torch.Tensor, antialias: bool = False):
    """Dilate cov2d, invert to a conic, compute the 3-sigma pixel radius.

    Spec: reference ``render_tools.py:73-116``. Returns (conic (..., 3),
    radius (...,), valid (...,), opacity_scale (...,), lam_max (...,)).
    """
    # near-camera-plane splats can reach |cov| ~ 1e26 and overflow the det
    # products to inf - inf = NaN; clamp magnitudes (JAX package, same guard)
    lim = 1e18
    a = torch.clamp(cov2d[..., 0], -lim, lim)
    b = torch.clamp(cov2d[..., 1], -lim, lim)
    d = torch.clamp(cov2d[..., 2], -lim, lim)
    det_raw = a * d - b * b
    a_h, d_h = a + COV_DILATION, d + COV_DILATION
    det = a_h * d_h - b * b

    if antialias:
        opacity_scale = torch.sqrt(torch.clamp_min(det_raw / det, 0.000025))
    else:
        opacity_scale = torch.ones_like(det_raw)

    valid = det != 0.0
    det_inv = 1.0 / torch.clamp_min(det, 1e-5)
    conic = torch.stack([d_h * det_inv, -b * det_inv, a_h * det_inv], dim=-1)

    mid = 0.5 * (a_h + d_h)
    sqrt_term = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lam_max = mid + sqrt_term
    radius = torch.ceil(RADIUS_FACTOR * torch.sqrt(lam_max))
    return conic, radius, valid, opacity_scale, lam_max


def tight_radius(
    opacity: torch.Tensor, lam_max: torch.Tensor, alpha_threshold: float
) -> torch.Tensor:
    """Exact support radius of a splat's rendered contribution.

    Pixels farther than sqrt(2 ln(op/threshold) * lam_max) have alpha below
    the kill threshold, so binning with min(this, 3-sigma) drops only
    all-zero pairs. The +1 margin covers ``tile_rect``'s trunc arithmetic.
    ``lam_max`` is capped at 1e12: near-camera-plane splats overflow it to
    inf, and 0 * inf = NaN would poison gradients.
    """
    log_ratio = torch.log(torch.clamp_min(opacity / alpha_threshold, 1.0))
    lam_safe = torch.clamp_max(lam_max, 1e12)
    return torch.ceil(torch.sqrt(2.0 * log_ratio * lam_safe)) + 1.0


def tile_rect(
    p_pix: torch.Tensor,
    radius: torch.Tensor,
    grid_x: int,
    grid_y: int,
    block_x: int = 16,
    block_y: int = 16,
):
    """Tile-index bounding rect covered by each splat.

    Spec: reference ``render_tools.py:134-139`` — truncation toward zero of
    the pre-clamp quotient. Returns (x_min, y_min, x_max, y_max), each (...,)
    int32, half-open ranges.
    """
    px, py = p_pix[..., 0], p_pix[..., 1]

    def cell(v, blk, hi):
        # clamp before the cast: an out-of-range float -> int32 cast is
        # undefined in C++, where XLA saturates
        return torch.clamp(torch.trunc(v / blk), 0, hi).to(torch.int32)

    x_min = cell(px - radius, block_x, grid_x)
    y_min = cell(py - radius, block_y, grid_y)
    x_max = cell(px + radius + block_x - 1, block_x, grid_x)
    y_max = cell(py + radius + block_y - 1, block_y, grid_y)
    return x_min, y_min, x_max, y_max


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))
