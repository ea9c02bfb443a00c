"""The readable oracle rasterizer: slow, dense, differentiable, any device.

Counterpart of ``gaussian_splatting_lightning_tpu/ops/rasterize_reference.py``,
the executable specification the fast routes are checked against. Every tile
composites every splat: membership is a dense (tiles, splats) mask, and a
non-member's alpha is zeroed, which contributes a factor of 1 to the
transmittance product, the same values as gathering the members. Autograd
gives its gradients. Tiles are the reference's 16 px blocks, composited a
batch of tiles at a time so that no Python loop runs per tile.

Semantics note (``reference_quirks``): the reference zeroes the radius of
culled splats (rasterize.py:80) but then computes tile membership from that
zeroed radius (rasterize.py:94, 129-152), and a radius-0 rect still covers
one tile, so culled splats *do* composite in the reference. The CUDA
rasterizer excludes them. The default is the CUDA semantics (membership
requires visibility); ``reference_quirks=True`` reproduces the quirk.
"""

from __future__ import annotations

from typing import Optional

import torch

from gaussian_splatting_lightning_tpu_torch.core import transforms as tf
from gaussian_splatting_lightning_tpu_torch.core.camera import Camera
from gaussian_splatting_lightning_tpu_torch.ops.common import (
    ALPHA_CLAMP,
    ALPHA_THRESHOLD,
    BLOCK_X,
    BLOCK_Y,
    TRANSMITTANCE_EPS,
    Preprocessed,
    RenderOutput,
    preprocess,
)

# (pixel, splat) evaluations per batch of tiles: bounds the memory of one
# batch's intermediates (and of what autograd keeps of them)
BATCH_EVALS = 1 << 24


def mark_visible(means3d: torch.Tensor, viewmatrix: torch.Tensor,
                 projmatrix: torch.Tensor) -> torch.Tensor:
    """Parity with reference ``rasterize.py:23-26`` / CUDA ``markVisible``."""
    del projmatrix  # the reference computes but ignores the projection
    return tf.in_frustum(tf.apply_extrinsic(means3d, viewmatrix))


def composite_tiles_dense(
    prep: Preprocessed,
    member: torch.Tensor,  # (T, N) bool tile membership
    order: torch.Tensor,  # (N,) depth-ascending permutation
    width: int,
    height: int,
    background: torch.Tensor,  # (3,)
    grid_x: int,
    grid_y: int,
):
    """Front-to-back alpha compositing of every tile over every splat.

    Spec: reference ``rasterize.py:210-261`` (render_tile_noloop). Returns
    the (H, W, 3) colour and the (H, W) inverse depth.
    """
    p_pix = prep.p_pix[order]
    conic = prep.conic[order]
    rgb = prep.rgb[order]
    opacity = prep.opacity[order]
    inv_depth = 1.0 / prep.depth[order]
    member = member[:, order]
    n = p_pix.shape[0]
    dev, dtype = p_pix.device, p_pix.dtype

    ys = torch.arange(BLOCK_Y, dtype=dtype, device=dev)
    xs = torch.arange(BLOCK_X, dtype=dtype, device=dev)
    tile_dy, tile_dx = torch.meshgrid(ys, xs, indexing="ij")
    tile_dxy = torch.stack([tile_dx, tile_dy], -1).reshape(-1, 2)  # (P, 2) x, y
    n_tiles, pix = grid_x * grid_y, BLOCK_X * BLOCK_Y
    tx = torch.arange(grid_x, dtype=dtype, device=dev).repeat(grid_y)
    ty = torch.arange(grid_y, dtype=dtype, device=dev).repeat_interleave(grid_x)
    origin = torch.stack([tx * BLOCK_X, ty * BLOCK_Y], -1)  # (T, 2)

    batch = max(1, BATCH_EVALS // (pix * max(n, 1)))
    colors, invds = [], []
    for t0 in range(0, n_tiles, batch):
        coords = origin[t0:t0 + batch, None, :] + tile_dxy[None]  # (B, P, 2)
        d = p_pix[None, None] - coords[:, :, None]  # (B, P, N, 2)
        dx, dy = d[..., 0], d[..., 1]
        power = -0.5 * (conic[:, 0] * dx * dx + 2.0 * conic[:, 1] * dx * dy
                        + conic[:, 2] * dy * dy)
        alpha = torch.clamp_max(torch.exp(power) * opacity, ALPHA_CLAMP)
        keep = member[t0:t0 + batch, None, :] & (alpha > ALPHA_THRESHOLD)
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        # exclusive transmittance along the depth-sorted axis; alpha <= 0.99,
        # so 1 - alpha >= 0.01 never divides by zero
        t_excl = torch.cumprod(1.0 - alpha, dim=-1) / (1.0 - alpha)
        w = torch.where(t_excl > TRANSMITTANCE_EPS, alpha * t_excl,
                        torch.zeros_like(alpha))
        t_final = t_excl[..., -1] * (1.0 - alpha[..., -1])
        colors.append(w @ rgb + t_final[..., None] * background)  # (B, P, 3)
        invds.append(w @ inv_depth)  # (B, P)

    canvas = torch.cat(colors).reshape(grid_y, grid_x, BLOCK_Y, BLOCK_X, 3)
    canvas = canvas.permute(0, 2, 1, 3, 4).reshape(
        grid_y * BLOCK_Y, grid_x * BLOCK_X, 3)[:height, :width]
    dcanvas = torch.cat(invds).reshape(grid_y, grid_x, BLOCK_Y, BLOCK_X)
    dcanvas = dcanvas.permute(0, 2, 1, 3).reshape(
        grid_y * BLOCK_Y, grid_x * BLOCK_X)[:height, :width]
    return canvas, dcanvas


def rasterize_reference(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    sh: torch.Tensor,
    camera: Camera,
    width: int,
    height: int,
    background,
    sh_degree,
    max_sh_degree: Optional[int] = None,
    antialias: bool = False,
    alive: Optional[torch.Tensor] = None,
    means2d_ndc_offset: Optional[torch.Tensor] = None,
    reference_quirks: bool = False,
    scale_modifier: float = 1.0,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Full forward rasterization; the signature mirrors the reference's
    ``rasterize_gaussian`` (rasterize.py:28-46), its ``scale_modifier``,
    ``colors_precomp`` and ``cov3D_precomp`` included."""
    prep = preprocess(
        means3d, opacities, scales, quats, sh, camera, width, height,
        sh_degree, max_sh_degree, antialias, alive, means2d_ndc_offset,
        scale_modifier=scale_modifier, colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
    )
    grid_x = (width + BLOCK_X - 1) // BLOCK_X
    grid_y = (height + BLOCK_Y - 1) // BLOCK_Y

    x_min, y_min, x_max, y_max = tf.tile_rect(prep.p_pix, prep.radius, grid_x, grid_y)
    dev = prep.p_pix.device
    tx = torch.arange(grid_x, dtype=torch.int32, device=dev).repeat(grid_y)  # (T,)
    ty = torch.arange(grid_y, dtype=torch.int32, device=dev).repeat_interleave(grid_x)
    member = (
        (tx[:, None] >= x_min[None, :])
        & (tx[:, None] < x_max[None, :])
        & (ty[:, None] >= y_min[None, :])
        & (ty[:, None] < y_max[None, :])
    )  # (T, N)
    if not reference_quirks:
        member = member & prep.visible[None, :]

    order = torch.argsort(prep.depth.detach(), stable=True)
    bg = torch.as_tensor(background, dtype=prep.p_pix.dtype).to(dev).reshape(3)
    color, invd = composite_tiles_dense(prep, member, order, width, height, bg,
                                        grid_x, grid_y)
    return RenderOutput(image=color.permute(2, 0, 1), radii=prep.radius,
                        depth=invd[None])
