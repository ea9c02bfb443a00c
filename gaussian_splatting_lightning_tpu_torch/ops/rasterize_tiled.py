"""The tiled rasterizer: plain PyTorch compositing over a per-tile member table.

Counterpart of ``gaussian_splatting_lightning_tpu/ops/rasterize_tiled.py``,
the JAX package's XLA route (``train.rasterizer: xla``). Preprocess
(``ops/common.py``) -> tile binning (``binning.build_tile_bins``, 16 px
tiles) -> a (tiles, ``tile_capacity``) table of each tile's members in depth
order -> front-to-back compositing of all tiles at once, ``chunk`` members
per step. Each step runs under ``torch.utils.checkpoint``, as ``jax.checkpoint``
wraps it, so autograd keeps only the (tiles, pixels) carry between steps and
memory stays O(tiles x pixels x chunk) while the backward recomputes each
step.

It launches no kernel of the port: it is the route the JAX package runs off
the TPU, kept here as the member-table alternative to the kernel route
(``ops/rasterize.py``), which it must match. A tile with more members than
``tile_capacity`` drops its deepest ones and reports the excess as
``num_tile_overflow``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from gaussian_splatting_lightning_tpu_torch.core.camera import Camera
from gaussian_splatting_lightning_tpu_torch.ops import binning
from gaussian_splatting_lightning_tpu_torch.ops.common import (
    ALPHA_CLAMP,
    ALPHA_THRESHOLD,
    BLOCK_X,
    BLOCK_Y,
    TRANSMITTANCE_EPS,
    Preprocessed,
    RenderOutput,
    TilingConfig,
    preprocess,
)


def _chunk_step(color, invd, trans, idx, valid, coords, p_pix, conic, rgb, opacity,
                inv_depth):
    """Composite one chunk of each tile's members: (T, C) member ids and
    validity against the (T, P, 2) pixel centres, onto the (T, P, 3) colour,
    (T, P) inverse depth and (T, P) transmittance carry."""
    pos = p_pix[idx]  # (T, C, 2)
    con = conic[idx]  # (T, C, 3)
    d = pos[:, None, :, :] - coords[:, :, None, :]  # (T, P, C, 2)
    dx, dy = d[..., 0], d[..., 1]
    power = -0.5 * (con[:, None, :, 0] * dx * dx + 2.0 * con[:, None, :, 1] * dx * dy
                    + con[:, None, :, 2] * dy * dy)
    alpha = torch.clamp_max(torch.exp(power) * opacity[idx][:, None, :], ALPHA_CLAMP)
    keep = valid[:, None, :] & (alpha > ALPHA_THRESHOLD)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))  # (T, P, C)
    one_minus = 1.0 - alpha
    cp = torch.cumprod(one_minus, dim=-1)
    t_in = trans[..., None] * (cp / one_minus)  # exclusive; alpha <= 0.99
    w = torch.where(t_in > TRANSMITTANCE_EPS, alpha * t_in, torch.zeros_like(alpha))
    color = color + torch.einsum("tpc,tcr->tpr", w, rgb[idx])
    invd = invd + torch.einsum("tpc,tc->tp", w, inv_depth[idx])
    return color, invd, trans * cp[..., -1]


def composite_tiles_tabled(
    prep: Preprocessed,
    table: torch.Tensor,  # (T, K) pair indices, -1 padded
    pair_gaussian: torch.Tensor,  # (M,)
    grid_x: int,
    grid_y: int,
    background: torch.Tensor,  # (3,)
    chunk: int,
    tile_y_offset: int = 0,
):
    """The (T, P, 3) colour and (T, P) inverse depth of every tile's pixels;
    ``tile_y_offset`` puts a band's tiles at their rows of the full image."""
    n_tiles, capacity = table.shape
    dev, dtype = prep.p_pix.device, prep.p_pix.dtype
    if capacity % chunk:
        raise ValueError(f"tile_capacity {capacity} is not a multiple of chunk {chunk}")

    # member splat per table slot (-1 padding -> splat 0, masked out)
    slot_valid = table >= 0
    gidx = torch.where(slot_valid, pair_gaussian[torch.clamp_min(table, 0)],
                       torch.zeros_like(table))

    # pixel centres per tile, (T, P, 2) as (x, y)
    tx = torch.arange(grid_x, dtype=dtype, device=dev) * BLOCK_X
    ty = (torch.arange(grid_y, dtype=dtype, device=dev) + tile_y_offset) * BLOCK_Y
    origin = torch.stack([tx.repeat(grid_y), ty.repeat_interleave(grid_x)], -1)
    dy, dx = torch.meshgrid(torch.arange(BLOCK_Y, dtype=dtype, device=dev),
                            torch.arange(BLOCK_X, dtype=dtype, device=dev), indexing="ij")
    offs = torch.stack([dx, dy], -1).reshape(-1, 2)
    coords = origin[:, None, :] + offs[None, :, :]

    pix = BLOCK_X * BLOCK_Y
    color = torch.zeros((n_tiles, pix, 3), dtype=dtype, device=dev)
    invd = torch.zeros((n_tiles, pix), dtype=dtype, device=dev)
    trans = torch.ones((n_tiles, pix), dtype=dtype, device=dev)
    feats = (coords, prep.p_pix, prep.conic, prep.rgb, prep.opacity, 1.0 / prep.depth)
    for c0 in range(0, capacity, chunk):
        color, invd, trans = checkpoint(
            _chunk_step, color, invd, trans, gidx[:, c0:c0 + chunk],
            slot_valid[:, c0:c0 + chunk], *feats, use_reentrant=False)
    return color + trans[..., None] * background, invd


def _assemble(canvas_tiles, grid_x, grid_y, width, height, channels=None,
              block_x=BLOCK_X, block_y=BLOCK_Y):
    """(T, P[, C]) tile canvas -> (H, W[, C]) image."""
    if channels is None:
        t = canvas_tiles.reshape(grid_y, grid_x, block_y, block_x)
        t = t.permute(0, 2, 1, 3).reshape(grid_y * block_y, grid_x * block_x)
        return t[:height, :width]
    t = canvas_tiles.reshape(grid_y, grid_x, block_y, block_x, channels)
    t = t.permute(0, 2, 1, 3, 4).reshape(grid_y * block_y, grid_x * block_x, channels)
    return t[:height, :width]


def rasterize_tiled(
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
    config: Optional[TilingConfig] = None,
    max_sh_degree: Optional[int] = None,
    antialias: bool = False,
    alive: Optional[torch.Tensor] = None,
    means2d_ndc_offset: Optional[torch.Tensor] = None,
    tile_y_offset: int = 0,
    grid_y_local: Optional[int] = None,
    prep: Optional[Preprocessed] = None,
    scale_modifier: float = 1.0,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
):
    """Render one view: (RenderOutput, stats), the semantics of
    ``rasterize_reference`` without ``reference_quirks`` (the CUDA
    visibility rules), differentiable in every float input. Tiles are 16 px
    whatever ``config.block`` says, as in the JAX package.

    ``tile_y_offset`` + ``grid_y_local`` render only a band of tile rows; the
    image then has height ``grid_y_local * 16``. ``prep`` accepts an
    externally computed ``Preprocessed``; ``scale_modifier``,
    ``colors_precomp`` and ``cov3d_precomp`` go to ``preprocess``.
    """
    config = config or TilingConfig()
    if prep is None:
        prep = preprocess(
            means3d, opacities, scales, quats, sh, camera, width, height,
            sh_degree, max_sh_degree, antialias, alive, means2d_ndc_offset,
            scale_modifier=scale_modifier, colors_precomp=colors_precomp,
            cov3d_precomp=cov3d_precomp,
        )
    grid_x, grid_y = binning.grid_shape(width, height)
    banded = grid_y_local is not None
    gy = grid_y_local if banded else grid_y
    n_tiles = grid_x * gy

    bins = binning.build_tile_bins(prep, grid_x, grid_y, config.max_pairs,
                                   tile_y_offset, gy)
    table = binning.build_tile_table(bins, n_tiles, config.tile_capacity)
    max_tile_count = torch.max(bins.tile_count)

    bg = torch.as_tensor(background, dtype=prep.p_pix.dtype).to(prep.p_pix.device)
    color, invd = composite_tiles_tabled(prep, table, bins.pair_gaussian, grid_x, gy,
                                         bg.reshape(3), config.chunk, tile_y_offset)
    out_h = gy * BLOCK_Y if banded else height
    image = _assemble(color, grid_x, gy, width, out_h, 3)
    depth = _assemble(invd, grid_x, gy, width, out_h)
    out = RenderOutput(image=image.permute(2, 0, 1), radii=prep.radius, depth=depth[None])
    stats = {
        "num_pairs": bins.num_pairs,
        "num_dropped_pairs": bins.num_dropped,
        "max_tile_count": max_tile_count,
        "num_tile_overflow": torch.clamp_min(max_tile_count - config.tile_capacity, 0),
        "num_visible": torch.sum(prep.visible.to(torch.int32)),
    }
    return out, stats
