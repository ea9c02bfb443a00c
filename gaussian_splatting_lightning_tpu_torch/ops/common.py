"""Shared rasterizer definitions: constants, preprocess stage, output records.

Counterpart of ``gaussian_splatting_lightning_tpu/ops/common.py`` plus
``TilingConfig`` from ``ops/rasterize_tiled.py``. The per-Gaussian preprocess
(frustum cull -> cov3D -> EWA cov2D -> conic + radius -> SH color ->
pixel-space mean) is plain elementwise PyTorch. Spec: reference
``gs_lightning/rasterize/rasterize.py:49-94``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gaussian_splatting_lightning_tpu_torch.core import sh as sh_lib
from gaussian_splatting_lightning_tpu_torch.core import transforms as tf
from gaussian_splatting_lightning_tpu_torch.core.camera import Camera

BLOCK_X = 16  # reference tile size, rasterize.py:19-20
BLOCK_Y = 16
ALPHA_CLAMP = 0.99  # reference rasterize.py:197/245
ALPHA_THRESHOLD = 1.0 / 255.0  # reference rasterize.py:193/223
TRANSMITTANCE_EPS = 1e-4  # reference rasterize.py:204/254


@dataclasses.dataclass(frozen=True)
class TilingConfig:
    """Static budgets and tile edge of one render."""

    max_pairs: int = 1 << 18  # (splat, tile) pair budget; rounded up to 128
    # the tiled route's (ops/rasterize_tiled.py) per-tile member table: the
    # deepest members beyond this many are dropped and counted as overflow
    tile_capacity: int = 1024
    chunk: int = 64  # members the tiled route composites per scan step
    # tile edge in px; None = the route's default (``resolve_block``)
    block: int | None = None

    def resolve_block(self, route: str) -> int:
        """The tile edge a route renders with: 32 px on the kernel routes
        ("cuda", "plain"), 16 px (the reference's CUDA block) on the tiled
        route ("xla") and the oracle, as the JAX package picks 32 for its
        Pallas path and 16 elsewhere."""
        return self.block or (32 if route in ("cuda", "plain") else 16)


@dataclasses.dataclass(frozen=True)
class Preprocessed:
    """Per-Gaussian screen-space quantities (all (N, ...), or (B, N, ...) for
    a stack of B views)."""

    p_pix: torch.Tensor  # (N, 2) pixel-space means
    depth: torch.Tensor  # (N,) view-space z
    conic: torch.Tensor  # (N, 3) inverse of dilated 2D covariance (a, b, d)
    rgb: torch.Tensor  # (N, 3)
    opacity: torch.Tensor  # (N,) post antialias-scaling
    radius: torch.Tensor  # (N,) 3-sigma pixel radius; 0 where not visible
    visible: torch.Tensor  # (N,) bool: in frustum & invertible cov & alive
    radius_bin: torch.Tensor  # (N,) min(radius, exact opacity-aware support)
    cull_r2: torch.Tensor  # (N,) squared pixel distance beyond which every
    # pixel's alpha is provably below the kill threshold (per-tile cull)


def preprocess(
    means3d: torch.Tensor,  # (N, 3)
    opacities: torch.Tensor,  # (N,) or (N, 1) post-activation
    scales: torch.Tensor,  # (N, 3) post-activation
    quats: torch.Tensor,  # (N, 4) normalized
    sh: torch.Tensor,  # (N, K, 3)
    camera: Camera,
    width: int,
    height: int,
    sh_degree,
    max_sh_degree: Optional[int] = None,
    antialias: bool = False,
    alive: Optional[torch.Tensor] = None,  # (N,) bool padded-capacity mask
    means2d_ndc_offset: Optional[torch.Tensor] = None,  # (N, 2) zeros whose
    # gradient is the densification screen-space signal (NDC units)
    scale_modifier: float = 1.0,  # scales the splats' extent (not with cov3d_precomp)
    colors_precomp: Optional[torch.Tensor] = None,  # (N, 3) RGB replacing the SH
    cov3d_precomp: Optional[torch.Tensor] = None,  # (N, 6) upper-triangle 3D
    # covariance, in build_cov3d's order, replacing scales and quats
) -> Preprocessed:
    """One pass of broadcast ops. A stacked ``camera`` (B views,
    ``stack_cameras``) with a (B, N, 2) offset gives every field a leading B:
    the splats are shared, the view-dependent quantities are per view.

    ``colors_precomp``, ``cov3d_precomp`` and ``scale_modifier`` are the N1
    rasterizer's inputs of those names (JAX ``ops/common.py``): a precomputed
    input replaces what would be derived from the SH or from scales and
    quats, which then get no gradient."""
    opacities = opacities.reshape(-1)
    tanx, tany = camera.tanfovx, camera.tanfovy
    if camera.views is not None:  # (B, ...) views broadcast over (N, ...) splats
        tanx, tany = tanx[:, None], tany[:, None]
    p_view = tf.apply_extrinsic(means3d, camera.viewmatrix)
    p_ndc = tf.apply_projection(means3d, camera.projmatrix)
    if means2d_ndc_offset is not None:
        p_ndc = p_ndc + means2d_ndc_offset
    visible = tf.in_frustum(p_view)
    if alive is not None:
        visible = visible & alive

    focal_x = (width * 0.5) / tanx
    focal_y = (height * 0.5) / tany
    if cov3d_precomp is not None:
        cov6 = cov3d_precomp
    else:
        cov6 = tf.build_cov3d(scales, quats, scale_modifier)
    cov2d = tf.project_cov3d_ewa(
        means3d, cov6, camera.viewmatrix, focal_x, focal_y, tanx, tany,
    )
    conic, radius, valid, opacity_scale, lam_max = tf.conic_and_radius(
        cov2d, antialias
    )
    visible = visible & valid
    radius = torch.where(visible, radius, torch.zeros_like(radius))
    opacity = opacities * opacity_scale
    radius_bin = torch.minimum(
        radius, tf.tight_radius(opacity, lam_max, ALPHA_THRESHOLD)
    )
    # per-tile cull bound (ops/binning.py expansion kernel): pixels at squared
    # distance > cull_r2 have alpha = op*exp(-q/2) < 1/255 since
    # q >= d^2/lam_max; the margin swallows f32 noise in the kill test.
    # Formula identical to the JAX package's (common.py:102-105).
    log_ratio = torch.log(torch.clamp_min(opacity / ALPHA_THRESHOLD, 1.0))
    cull_r2 = 2.0 * log_ratio * torch.clamp_max(lam_max, 1e12) * 1.001 + 0.25

    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        rgb = sh_lib.sh_to_rgb(sh, means3d, camera.campos, sh_degree, max_sh_degree)
    p_pix = tf.ndc_to_pix(p_ndc, width, height)
    if camera.views is not None:  # SH degree 0 and colors_precomp have no view axis
        rgb = rgb.expand(p_pix.shape[:-1] + (3,))
    return Preprocessed(
        p_pix=p_pix,
        depth=p_view[..., 2],
        conic=conic,
        rgb=rgb,
        opacity=opacity,
        radius=radius,
        visible=visible,
        radius_bin=radius_bin,
        cull_r2=cull_r2,
    )


@dataclasses.dataclass(frozen=True)
class RenderOutput:
    """Mirrors the reference rasterizer's return tuple
    (rendered_image, radii, depth_image)."""

    image: torch.Tensor  # (3, H, W); (B, 3, H, W) for a stack of views
    radii: torch.Tensor  # (N,) float, 0 for culled splats; (B, N)
    depth: torch.Tensor  # (1, H, W) inverse-depth-weighted (sum w/z); (B, 1, H, W)
