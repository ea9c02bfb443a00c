"""Rasterizer: feature table, binning, compositing and its backward
(kernels K2, K3, K4).

Counterpart of ``gaussian_splatting_lightning_tpu/ops/rasterize_pallas.py``:
the ``gfeat_t`` feature table with its 16 px rect rows, the pair gather,
``make_pair_pipeline`` (here ``PairComposite``), ``_assemble_cf`` and
``rasterize_pallas``, here ``rasterize``, with the same
``(RenderOutput, stats)`` contract.

The compositor is K2 (``csrc/composite_fwd.cu``): one block per tile walks
the tile's depth-sorted pairs and gathers each pair's feature row by splat id
itself. The JAX kernel's value spec is kept: the 0.99 clamp, the 1/255
kill, the ``T > 1e-4`` weight rule, the 16 px membership rect at tile sizes
other than 16 (rendered values stay tile-size-invariant), the safe ``1/z``
divisor, and the drop of the farthest splats on a full budget. Its early
stop ends a tile once every pixel has T <= 1e-4, checked every 256 pairs
(the JAX kernel checks every 128): the two differ in ``T_fin * bg`` by less
than 1e-4 |bg|.

The backward is K3 (``csrc/composite_bwd.cu``), which re-walks each tile
with K2's alpha chain and writes one 10-float gradient row per pair to the
pair's expansion slot, then K4 (``csrc/segment_sum.cu``), which sums each
splat's contiguous slot range into the (N, 16) gradient of the feature
table. Autograd carries that gradient on through ``feature_table`` and
``preprocess`` to the parameters, or, where ``ops/preprocess.py``'s kernel
pair wrote the table (``rasterize_prepared``, the trainer's ``cuda`` route
on the card), into that pair's backward. Pair gradients stay f32: the JAX package's
bf16 routing was an answer to its sort payload and has no switch here.

A stack of B views (a stacked ``Camera``, the view-batched train step) runs
the same path once for all views, as ``vmap`` gives the JAX kernels a batch
grid axis: ``preprocess`` and the feature table carry a leading B, the
binning sorts along the last axis, and K1-K4 each take one launch with a
grid axis per view. The kernels' wrappers take one view's arrays or a
stack's, and their plain versions walk a stack one view at a time.
"""

from __future__ import annotations

import dataclasses

import torch

from gaussian_splatting_lightning_tpu_torch.core import transforms as tf
from gaussian_splatting_lightning_tpu_torch.ops import _build, binning
from gaussian_splatting_lightning_tpu_torch.ops.common import (
    ALPHA_CLAMP,
    ALPHA_THRESHOLD,
    TRANSMITTANCE_EPS,
    RenderOutput,
    TilingConfig,
    preprocess,
)
from gaussian_splatting_lightning_tpu_torch.utils import runtime

NFEAT = 16  # px py ca cb cc op r g b invz x0 x1 y0 y1 (2 pad)
NOUT = 4  # r g b invd, channel first per tile
BATCH = 256  # pairs per shared-memory batch in K2; early-stop granularity
NGRAD = 10  # gradient rows per pair: d px py ca cb cc op r g b invz
F_PX, F_PY, F_CA, F_CB, F_CC, F_OP, F_R, F_G, F_B, F_IZ = range(10)
# At tile sizes other than the reference's 16 px, rows 10-13 carry the
# splat's 16 px-granular tile rect (x0, x1, y0, y1): the reference applies
# its support cut at 16 px-tile granularity, and a tail pixel can still have
# alpha > 1/255, so membership is part of the value spec.
F_X0, F_X1, F_Y0, F_Y1 = 10, 11, 12, 13


def feature_table(prep, width: int, height: int, block: int) -> torch.Tensor:
    """(N, NFEAT) f32 per-splat feature rows in original splat order
    ((B, N, NFEAT) for a stack of views)."""
    zeros = torch.zeros_like(prep.depth)
    if block != 16:
        g16x, g16y = binning.grid_shape(width, height, 16, 16)
        x0, y0, x1, y1 = tf.tile_rect(prep.p_pix.detach(), prep.radius_bin.detach(),
                                      g16x, g16y, 16, 16)
        rect = [r.to(prep.depth.dtype) for r in (x0, x1, y0, y1)]
    else:
        rect = [zeros] * 4
    # safe divisor: a splat exactly at the camera plane (culled, never
    # paired) would otherwise put inf into the table
    safe_z = torch.where(torch.abs(prep.depth) > 1e-9, prep.depth,
                         torch.ones_like(prep.depth))
    return torch.stack(
        [
            prep.p_pix[..., 0], prep.p_pix[..., 1],
            prep.conic[..., 0], prep.conic[..., 1], prep.conic[..., 2],
            prep.opacity,
            prep.rgb[..., 0], prep.rgb[..., 1], prep.rgb[..., 2],
            1.0 / safe_z,
            *rect, zeros, zeros,
        ],
        dim=-1,
    ).contiguous()


def _pixel_grid(n_tiles: int, grid_x: int, block: int, tile_y_offset: int, dev):
    """(T, pix) f32 pixel coordinates (no +0.5) and 16 px subtile indices."""
    pix = block * block
    t = torch.arange(n_tiles, dtype=torch.int32, device=dev)[:, None]
    p = torch.arange(pix, dtype=torch.int32, device=dev)[None, :]
    px = (p % block).to(torch.float32) + ((t % grid_x) * block).to(torch.float32)
    py = (p // block).to(torch.float32) + (
        (t // grid_x + tile_y_offset) * block).to(torch.float32)
    return px, py, torch.floor(px * 0.0625), torch.floor(py * 0.0625)


def _pair_alpha(f, px, py, sx, sy, on, block):
    """K2's alpha chain for one pair per tile, f (T, NFEAT) against (T, pix)
    pixels, in the kernels' order: (dx, dy, raw = op e^power, alpha, keep)."""
    dx = f[:, F_PX:F_PX + 1] - px
    dy = f[:, F_PY:F_PY + 1] - py
    power = -0.5 * (
        f[:, F_CA:F_CA + 1] * dx * dx
        + 2.0 * f[:, F_CB:F_CB + 1] * dx * dy
        + f[:, F_CC:F_CC + 1] * dy * dy
    )
    raw = torch.exp(power) * f[:, F_OP:F_OP + 1]
    alpha = torch.clamp_max(raw, ALPHA_CLAMP)
    keep = (alpha > ALPHA_THRESHOLD) & on[:, None]
    if block != 16:
        keep = (
            keep
            & (sx >= f[:, F_X0:F_X0 + 1]) & (sx < f[:, F_X1:F_X1 + 1])
            & (sy >= f[:, F_Y0:F_Y0 + 1]) & (sy < f[:, F_Y1:F_Y1 + 1])
        )
    return dx, dy, raw, alpha, keep


# The margin of K2's and K3's cull (``cull_box`` in csrc/composite_fwd.cu and
# csrc/composite_bwd.cu). A pixel is kept only where q = ca dx^2 + 2 cb dx dy
# + cc dy^2 < 2 ln(255 op); the rounded q of ``_pair_alpha`` is within
# 9.6e-7 ca cc / det of q relatively, so the threshold is widened by 2% and
# 1e-3, the box's half-extents sqrt(tau cc / det), sqrt(tau ca / det) by
# 1e-5 of themselves, 0.02 px and 1e-6 of the centre (the rounding of
# dx, dy and of the box's own arithmetic), and a conic with ca cc > 1e4 det
# gets no box.
CULL_TAU_REL, CULL_TAU_ABS, CULL_MAX_ASPECT = 1.02, 1e-3, 1e4
CULL_PAD_REL, CULL_PAD_ABS, CULL_PAD_POS = 1.00001, 0.02, 1e-6
PATCH_W, PATCH_H = 16, 8  # the pixels a warp of K2 or K3 owns


def pair_cull_box(f: torch.Tensor, block: int) -> torch.Tensor:
    """Plain version of the kernels' ``cull_box``: (N, 4) f32 pixel ranges
    (x_lo, x_hi, y_lo, y_hi) of the feature rows ``f`` (N, NFEAT), outside
    which ``_pair_alpha`` keeps no pixel; at block != 16 cut to the pixels of
    the row's 16 px rect, so that a patch inside one subtile misses the range
    exactly when its subtile is outside the rect. (-inf, inf) ranges where no
    box is drawn; an empty range where op is below 1/255."""
    mx, my, a, b, c, op = (f[:, i] for i in (F_PX, F_PY, F_CA, F_CB, F_CC, F_OP))
    det = a * c - b * b
    drawn = (a > 0) & (c > 0) & (det > 0) & (a * c <= CULL_MAX_ASPECT * det)
    tau = 2.0 * torch.log(255.0 * op) * CULL_TAU_REL + CULL_TAU_ABS
    hx = torch.sqrt(tau * c / det) * CULL_PAD_REL + (CULL_PAD_ABS + CULL_PAD_POS * mx.abs())
    hy = torch.sqrt(tau * a / det) * CULL_PAD_REL + (CULL_PAD_ABS + CULL_PAD_POS * my.abs())
    inf = torch.full_like(mx, float("inf"))
    whole = torch.stack([-inf, inf, -inf, inf], dim=1)
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], dim=1)
    box = torch.where((drawn & (tau > 0))[:, None], box, whole)
    box = torch.where((drawn & (tau <= 0))[:, None], -whole, box)
    if block != 16:  # fmax/fmin drop a NaN bound: the rect alone then decides
        lo = torch.fmax(box[:, 0::2], 16.0 * f[:, [F_X0, F_Y0]])
        hi = torch.fmin(box[:, 1::2], 16.0 * f[:, [F_X1, F_Y1]] - 1.0)
        box = torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], dim=1)
    return box


def patch_culled(box: torch.Tensor, x0, y0) -> torch.Tensor:
    """The test a warp of K2 or K3 makes: whether its patch of pixels
    [x0, x0 + PATCH_W) x [y0, y0 + PATCH_H) misses ``box`` (..., 4)."""
    x1, y1 = x0 + (PATCH_W - 1), y0 + (PATCH_H - 1)
    return ((x1 < box[..., 0]) | (x0 > box[..., 1])
            | (y1 < box[..., 2]) | (y0 > box[..., 3]))


def composite_fwd_plain(
    gfeat: torch.Tensor, gauss_s: torch.Tensor, tile_start: torch.Tensor,
    tile_count: torch.Tensor, bg: torch.Tensor, grid_x: int, block: int,
    tile_y_offset: int = 0, early_stop: bool = True,
    return_work: bool = False,
):
    """Plain PyTorch version of K2: (T, NOUT, block*block) f32.

    Walks the k-th pair of every tile at once, k = 0, 1, ..., with K2's
    arithmetic in K2's order (serial transmittance, early stop every BATCH
    pairs), so its alphas are bit-identical to the kernel's. With
    ``return_work`` it also returns, per tile, the number of pairs
    composited before the early stop and the number of (pair, pixel)
    evaluations among them that pass the kill and the rect (the work K2's
    bound counts). A stack of views (gfeat (B, N, NFEAT), bins and ``bg``
    with a leading B) is walked one view at a time.
    """
    if gfeat.dim() == 3:
        per_view = [composite_fwd_plain(*(x[v] for x in (gfeat, gauss_s, tile_start,
                                                          tile_count, bg)),
                                        grid_x, block, tile_y_offset, early_stop,
                                        return_work)
                    for v in range(gfeat.shape[0])]
        if return_work:
            return tuple(torch.stack(x) for x in zip(*per_view))
        return torch.stack(per_view)
    dev = gfeat.device
    n_tiles, pix = tile_start.shape[0], block * block
    px, py, sx, sy = _pixel_grid(n_tiles, grid_x, block, tile_y_offset, dev)
    trans = torch.ones(n_tiles, pix, dtype=torch.float32, device=dev)
    acc = [torch.zeros_like(trans) for _ in range(NOUT)]
    live = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    evaluated = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    kept = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    last = max(gauss_s.shape[0] - 1, 0)
    max_count = int(tile_count.max()) if n_tiles else 0
    for k in range(max_count):
        if early_stop and k > 0 and k % BATCH == 0:
            live = live & (trans > TRANSMITTANCE_EPS).any(dim=1)
            if not bool(live.any()):
                break
        f = gfeat[gauss_s[torch.clamp(tile_start + k, max=last)].long()]
        on = live & (k < tile_count)
        evaluated += on
        _, _, _, alpha, keep = _pair_alpha(f, px, py, sx, sy, on, block)
        if return_work:
            kept += keep.sum(dim=1)
        alpha = torch.where(keep, alpha, 0.0)
        w = torch.where(trans > TRANSMITTANCE_EPS, alpha * trans, 0.0)
        for c in range(NOUT):
            acc[c] = acc[c] + w * f[:, F_R + c:F_R + c + 1]
        trans = trans * (1.0 - alpha)
    color = [acc[c] + trans * bg[c] for c in range(3)]
    out = torch.stack(color + [acc[3]], dim=1)
    return (out, evaluated, kept) if return_work else out


def composite_fwd(
    gfeat: torch.Tensor, gauss_s: torch.Tensor, tile_start: torch.Tensor,
    tile_count: torch.Tensor, bg: torch.Tensor, grid_x: int, block: int,
    tile_y_offset: int = 0, early_stop: bool = True,
) -> torch.Tensor:
    """K2 wrapper: launches ``csrc/composite_fwd.cu`` on CUDA tensors, runs the
    plain version on CPU tensors. Returns (T, NOUT, block*block) f32, or
    (B, T, NOUT, block*block) for a stack of B views (every input with a
    leading B), one launch for all of them."""
    if gfeat.device.type == "cpu":
        return composite_fwd_plain(gfeat, gauss_s, tile_start, tile_count, bg,
                                   grid_x, block, tile_y_offset, early_stop)
    if block not in (16, 32):
        raise ValueError(f"K2 takes 16 or 32 px tiles, got {block}")
    single = gfeat.dim() == 2
    if single:
        gfeat, gauss_s, tile_start, tile_count, bg = (
            x[None] for x in (gfeat, gauss_s, tile_start, tile_count, bg))
    dev = gfeat.device
    views, n_splats = gfeat.shape[:2]
    n_tiles = tile_start.shape[-1]
    _build.check_tensor(gfeat, "gfeat", torch.float32, dev)
    if gfeat.dim() != 3 or gfeat.shape[2] != NFEAT or gfeat.data_ptr() % 16:
        raise ValueError(f"gfeat must be a 16-byte aligned ([B,] N, {NFEAT}) table")
    _build.check_tensor(gauss_s, "gauss_s", torch.int32, dev)
    _build.check_tensor(tile_start, "tile_start", torch.int32, dev)
    _build.check_tensor(tile_count, "tile_count", torch.int32, dev)
    _build.check_tensor(bg, "bg", torch.float32, dev)
    if (gauss_s.dim() != 2 or gauss_s.shape[0] != views
            or tile_start.shape != (views, n_tiles) or tile_count.shape != (views, n_tiles)
            or bg.shape != (views, 3)):
        raise ValueError("gauss_s must be ([B,] M), tile_start and tile_count ([B,] T) "
                         "and bg ([B,] 3)")
    out = torch.empty(views, n_tiles, NOUT, block * block, dtype=torch.float32, device=dev)
    lib = _build.load("composite_fwd")
    p = _build.ptr
    rc = lib.gs_composite_fwd(
        p(gfeat), p(gauss_s), p(tile_start), p(tile_count), p(bg), p(out),
        n_tiles, views, n_splats, gauss_s.shape[1], grid_x, block, tile_y_offset,
        int(block != 16), int(early_stop), _build.stream_of(out),
    )
    _build.check(lib, "composite_fwd", rc)
    return out[0] if single else out


def composite_bwd_plain(
    gfeat: torch.Tensor, gauss_s: torch.Tensor, slot_s: torch.Tensor,
    tile_start: torch.Tensor, tile_count: torch.Tensor, out: torch.Tensor,
    grad_out: torch.Tensor, grid_x: int, block: int, max_pairs: int,
    tile_y_offset: int = 0, early_stop: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of K3: (max_pairs, NGRAD) f32 pair gradients,
    row ``slot_s[k]`` for sorted pair k, zero where no pair was composited.

    Walks the k-th pair of every tile at once with K2's alpha chain and
    stop, and rounds the prefix/suffix chain op by op in K3's order, so each
    pixel's terms equal the kernel's; only the pixel sums differ in order. A
    stack of views gives (B, max_pairs, NGRAD), one view at a time.
    """
    if gfeat.dim() == 3:
        return torch.stack([composite_bwd_plain(
            *(x[v] for x in (gfeat, gauss_s, slot_s, tile_start, tile_count, out,
                             grad_out)),
            grid_x, block, max_pairs, tile_y_offset, early_stop)
            for v in range(gfeat.shape[0])])
    dev = gfeat.device
    n_tiles, pix = tile_start.shape[0], block * block
    px, py, sx, sy = _pixel_grid(n_tiles, grid_x, block, tile_y_offset, dev)
    g = [grad_out[:, c] for c in range(NOUT)]
    # G . out: the forward output already holds T_fin * bg
    g_total = g[0] * out[:, 0] + g[1] * out[:, 1] + g[2] * out[:, 2] + g[3] * out[:, 3]
    trans = torch.ones(n_tiles, pix, dtype=torch.float32, device=dev)
    prefix = torch.zeros_like(trans)
    live = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    dpair = torch.zeros(max_pairs, NGRAD, dtype=torch.float32, device=dev)
    last = max(gauss_s.shape[0] - 1, 0)
    max_count = int(tile_count.max()) if n_tiles else 0
    for k in range(max_count):
        if early_stop and k > 0 and k % BATCH == 0:
            live = live & (trans > TRANSMITTANCE_EPS).any(dim=1)
            if not bool(live.any()):
                break
        idx = torch.clamp(tile_start + k, max=last)
        f = gfeat[gauss_s[idx].long()]
        on = live & (k < tile_count)
        dx, dy, raw, alpha, keep = _pair_alpha(f, px, py, sx, sy, on, block)
        alpha = torch.where(keep, alpha, 0.0)
        lit = trans > TRANSMITTANCE_EPS
        w = torch.where(lit, alpha * trans, 0.0)
        e = (g[0] * f[:, F_R:F_R + 1] + g[1] * f[:, F_G:F_G + 1]
             + g[2] * f[:, F_B:F_B + 1] + g[3] * f[:, F_IZ:F_IZ + 1])
        prefix = torch.where(keep, prefix + w * e, prefix)
        one_minus = 1.0 - alpha
        d_alpha = torch.where(lit, e * trans, 0.0) - (g_total - prefix) / one_minus
        d_power = torch.where(keep & (raw < ALPHA_CLAMP), d_alpha * alpha, 0.0)
        m1x, m1y = d_power * dx, d_power * dy
        terms = [d_power, m1x, m1y, m1x * dx, m1x * dy, m1y * dy] + [gc * w for gc in g]
        m = [x.sum(dim=1) for x in terms]  # (T,) pixel sums
        ca, cb, cc, op = (f[:, i] for i in (F_CA, F_CB, F_CC, F_OP))
        rows = torch.stack([
            -(ca * m[1] + cb * m[2]), -(cb * m[1] + cc * m[2]),
            -0.5 * m[3], -m[4], -0.5 * m[5],
            m[0] / torch.clamp_min(op, 1e-30), *m[6:],
        ], dim=1)
        dpair[slot_s[idx][on].long()] = rows[on]
        trans = trans * one_minus
    return dpair


def composite_bwd(
    gfeat: torch.Tensor, gauss_s: torch.Tensor, slot_s: torch.Tensor,
    tile_start: torch.Tensor, tile_count: torch.Tensor, out: torch.Tensor,
    grad_out: torch.Tensor, grid_x: int, block: int, max_pairs: int,
    tile_y_offset: int = 0, early_stop: bool = True,
) -> torch.Tensor:
    """K3 wrapper: launches ``csrc/composite_bwd.cu`` on CUDA tensors, runs
    the plain version on CPU tensors. Returns (max_pairs, NGRAD) f32, or
    (B, max_pairs, NGRAD) for a stack of B views, one launch for all."""
    args = (gfeat, gauss_s, slot_s, tile_start, tile_count, out, grad_out,
            grid_x, block, max_pairs, tile_y_offset, early_stop)
    if gfeat.device.type == "cpu":
        return composite_bwd_plain(*args)
    if block not in (16, 32):
        raise ValueError(f"K3 takes 16 or 32 px tiles, got {block}")
    single = gfeat.dim() == 2
    if single:
        gfeat, gauss_s, slot_s, tile_start, tile_count, out, grad_out = (
            x[None] for x in (gfeat, gauss_s, slot_s, tile_start, tile_count, out,
                              grad_out))
    dev = gfeat.device
    views, n_splats = gfeat.shape[:2]
    n_tiles = tile_start.shape[-1]
    _build.check_tensor(gfeat, "gfeat", torch.float32, dev)
    if gfeat.dim() != 3 or gfeat.shape[2] != NFEAT or gfeat.data_ptr() % 16:
        raise ValueError(f"gfeat must be a 16-byte aligned ([B,] N, {NFEAT}) table")
    for name, t in (("gauss_s", gauss_s), ("slot_s", slot_s),
                    ("tile_start", tile_start), ("tile_count", tile_count)):
        _build.check_tensor(t, name, torch.int32, dev)
        if t.dim() != 2 or t.shape[0] != views:
            raise ValueError(f"{name} must have the views' leading axis ({views})")
    canvas = (views, n_tiles, NOUT, block * block)
    for name, t in (("out", out), ("grad_out", grad_out)):
        _build.check_tensor(t, name, torch.float32, dev)
        if tuple(t.shape) != canvas:
            raise ValueError(f"{name} must be {canvas[int(single):]}, got "
                             f"{tuple(t.shape)[int(single):]}")
    if slot_s.shape != gauss_s.shape or int(slot_s.shape[1]) > max_pairs:
        raise ValueError("slot_s must match gauss_s and index max_pairs rows")
    dpair = torch.zeros(views, max_pairs, NGRAD, dtype=torch.float32, device=dev)
    lib = _build.load("composite_bwd")
    p = _build.ptr
    rc = lib.gs_composite_bwd(
        p(gfeat), p(gauss_s), p(slot_s), p(tile_start), p(tile_count), p(out),
        p(grad_out), p(dpair), n_tiles, views, n_splats, gauss_s.shape[1], max_pairs,
        grid_x, block, tile_y_offset, int(block != 16), int(early_stop),
        _build.stream_of(dpair),
    )
    _build.check(lib, "composite_bwd", rc)
    return dpair[0] if single else dpair


def segment_sum_plain(dpair: torch.Tensor, offsets: torch.Tensor,
                      ntiles: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: (N, NFEAT) f32 per-splat gradient table.

    Depth rank j owns the slots [offsets[j], min(offsets[j] + ntiles[order[j]],
    M)) of ``dpair`` (M, NGRAD); their sum lands in row ``order[j]``. A stack
    of views gives (B, N, NFEAT), one view at a time."""
    if dpair.dim() == 3:
        return torch.stack([segment_sum_plain(dpair[v], offsets[v], ntiles[v], order[v])
                            for v in range(dpair.shape[0])])
    n, max_pairs = offsets.shape[0], dpair.shape[0]
    slot = torch.arange(max_pairs, dtype=torch.int32, device=dpair.device)
    rank = torch.clamp(torch.searchsorted(offsets, slot, right=True) - 1, 0, n - 1)
    owned = slot < offsets[rank] + ntiles[order.long()][rank]
    out = torch.zeros(n, NFEAT, dtype=torch.float32, device=dpair.device)
    out[:, :NGRAD].index_add_(0, order[rank].long(),
                              torch.where(owned[:, None], dpair, 0.0))
    return out


def segment_sum(dpair: torch.Tensor, offsets: torch.Tensor,
                ntiles: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """K4 wrapper: launches ``csrc/segment_sum.cu`` on CUDA tensors, runs the
    plain version on CPU tensors. Returns (N, NFEAT) f32.

    The kernel takes ``offsets`` to be the exclusive cumsum of
    ``ntiles[order]`` (as ``binning.build_sorted_bins`` makes it): rank j's
    range ends where rank j + 1's starts, and only the last rank reads
    ``ntiles``. A stack of B views (dpair (B, M, NGRAD), the rest (B, N))
    takes one launch and gives (B, N, NFEAT): each view's own sums."""
    if dpair.device.type == "cpu":
        return segment_sum_plain(dpair, offsets, ntiles, order)
    single = dpair.dim() == 2
    if single:
        dpair, offsets, ntiles, order = (x[None] for x in (dpair, offsets, ntiles, order))
    dev = dpair.device
    _build.check_tensor(dpair, "dpair", torch.float32, dev)
    if dpair.dim() != 3 or dpair.shape[2] != NGRAD or dpair.data_ptr() % 16:
        raise ValueError(f"dpair must be a 16-byte aligned ([B,] M, {NGRAD}) table, "
                         f"got {tuple(dpair.shape)[int(single):]}")
    views, n = dpair.shape[0], offsets.shape[-1]
    for name, t in (("offsets", offsets), ("ntiles", ntiles), ("order", order)):
        _build.check_tensor(t, name, torch.int32, dev)
        if t.shape != (views, n):
            raise ValueError(f"{name} must be {(views, n)[int(single):]}, got "
                             f"{tuple(t.shape)[int(single):]}")
    out = torch.empty(views, n, NFEAT, dtype=torch.float32, device=dev)
    lib = _build.load("segment_sum")
    p = _build.ptr
    rc = lib.gs_segment_sum(p(dpair), p(offsets), p(ntiles), p(order), p(out),
                            n, dpair.shape[1], views, _build.stream_of(out))
    _build.check(lib, "segment_sum", rc)
    return out[0] if single else out


class PairComposite(torch.autograd.Function):
    """The compositor as one autograd function, the counterpart of
    ``make_pair_pipeline``: forward K2 on the (N, NFEAT) feature table,
    backward K3 then K4, returning the table's gradient (rows 10-15 zero)
    and no gradient for the bins or the background. ``plain`` runs the
    three plain versions on any device. A stack of views flows through as
    one launch of each kernel."""

    @staticmethod
    def forward(ctx, gfeat, bins, bg, grid_x, block, max_pairs, tile_y_offset,
                early_stop, plain):
        composite = composite_fwd_plain if plain else composite_fwd
        out = composite(gfeat, bins.gauss_s, bins.tile_start, bins.tile_count,
                        bg, grid_x, block, tile_y_offset, early_stop)
        ctx.save_for_backward(gfeat, out, bins.gauss_s, bins.slot_s,
                              bins.tile_start, bins.tile_count, bins.offsets,
                              bins.ntiles, bins.order)
        ctx.static = (grid_x, block, max_pairs, tile_y_offset, early_stop, plain)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        (gfeat, out, gauss_s, slot_s, tile_start, tile_count, offsets, ntiles,
         order) = ctx.saved_tensors
        grid_x, block, max_pairs, tile_y_offset, early_stop, plain = ctx.static
        bwd = composite_bwd_plain if plain else composite_bwd
        dpair = bwd(gfeat, gauss_s, slot_s, tile_start, tile_count, out,
                    grad_out.contiguous(), grid_x, block, max_pairs,
                    tile_y_offset, early_stop)
        reduce = segment_sum_plain if plain else segment_sum
        return (reduce(dpair, offsets, ntiles, order),) + (None,) * 8


def _assemble_cf(out_t, grid_x, grid_y, width, height, block):
    """([B,] T, C, pix) channel-first tile canvas -> ([B,] C, H, W) image."""
    lead, c = out_t.shape[:-3], out_t.shape[-2]
    t = out_t.reshape(*lead, grid_y, grid_x, c, block, block)
    b = len(lead)
    t = t.permute(*range(b), b + 2, b, b + 3, b + 1, b + 4)
    t = t.reshape(*lead, c, grid_y * block, grid_x * block)
    return t[..., :height, :width]


def rasterize(
    means3d, opacities, scales, quats, sh, camera, width, height,
    background, sh_degree, config=None, max_sh_degree=None,
    antialias: bool = False, alive=None, means2d_ndc_offset=None,
    tile_y_offset: int = 0, grid_y_local=None, early_stop: bool = True,
    prep=None, plain: bool = False, scale_modifier: float = 1.0,
    colors_precomp=None, cov3d_precomp=None,
):
    """Render one view: (RenderOutput, stats), the ``rasterize_pallas``
    contract, differentiable in every float input. ``plain`` runs the
    kernels' plain versions on any device; otherwise CUDA tensors go through
    the kernels and CPU tensors through the plain versions. ``prep`` accepts
    an externally computed ``Preprocessed``; ``scale_modifier``,
    ``colors_precomp`` and ``cov3d_precomp`` go to ``preprocess``.

    A stacked ``camera`` (B views, ``core.camera.stack_cameras``) with a
    (3,) or (B, 3) ``background`` and a (B, N, 2) offset renders all B in
    one pass: image (B, 3, H, W), depth (B, 1, H, W), radii (B, N), and
    stats reduced as the JAX batched step reduces them (dropped pairs
    summed, pairs and overflow maxed; the other counts summed or maxed
    alike; ``num_on_screen`` counts the splats with a pair in any view), with
    the per-view ``num_pairs_per_view`` and ``num_dropped_pairs_per_view``
    (B,) beside them."""
    config = config or TilingConfig()
    if prep is None:
        prep = preprocess(
            means3d, opacities, scales, quats, sh, camera, width, height,
            sh_degree, max_sh_degree, antialias, alive, means2d_ndc_offset,
            scale_modifier=scale_modifier, colors_precomp=colors_precomp,
            cov3d_precomp=cov3d_precomp,
        )
    return rasterize_prepared(prep, None, width, height, background, config,
                              tile_y_offset, grid_y_local, early_stop, plain)


def rasterize_prepared(prep, gfeat, width, height, background, config=None,
                       tile_y_offset: int = 0, grid_y_local=None,
                       early_stop: bool = True, plain: bool = False):
    """``rasterize`` from its preprocess on: the binning, the feature table
    (built from ``prep`` when ``gfeat`` is None; ``ops/preprocess`` writes it
    itself), K2 and the image, with ``rasterize``'s return contract."""
    config = config or TilingConfig()
    blk = config.resolve_block("cuda")
    views = prep.depth.shape[0] if prep.depth.dim() == 2 else None
    grid_x, grid_y = binning.grid_shape(width, height, blk, blk)
    banded = grid_y_local is not None
    gy = grid_y_local if banded else grid_y

    max_pairs = -(-config.max_pairs // binning.CHUNK) * binning.CHUNK
    runtime.mark("binning", prep.depth)
    bins = binning.build_sorted_bins(
        prep, grid_x, grid_y, max_pairs, tile_y_offset, gy, block=blk,
        plain=plain,
    )
    runtime.mark("composite", prep.depth)
    # with spans on, the backward marks "preprocess_bwd" once the table's
    # gradient has reached every input of it: K3, K4 and their glue are done
    if gfeat is None:
        fields = ("p_pix", "depth", "conic", "rgb", "opacity")
        table_in = dataclasses.replace(prep, **dict(zip(fields, runtime.mark_backward(
            "preprocess_bwd", *(getattr(prep, f) for f in fields)))))
        gfeat = feature_table(table_in, width, height, blk)
    else:
        gfeat, = runtime.mark_backward("preprocess_bwd", gfeat)
    bg = torch.as_tensor(background, dtype=torch.float32).to(gfeat.device)
    if views is None:
        bg = bg.reshape(3)
    else:
        bg = bg.reshape(-1, 3).expand(views, 3).contiguous()
    out = PairComposite.apply(gfeat, bins, bg, grid_x, blk, max_pairs,
                              tile_y_offset, early_stop, plain)

    out_h = gy * blk if banded else height
    imgd = _assemble_cf(out, grid_x, gy, width, out_h, blk)  # ([B,] NOUT, H, W)
    # K1's input: a splat's pairs (its most over the views of a stack)
    ntiles = bins.ntiles if views is None else torch.amax(bins.ntiles, dim=0)
    stats = {
        "num_pairs": bins.num_pairs,
        "num_dropped_pairs": bins.num_dropped,
        "max_tile_count": torch.max(bins.tile_count),
        "num_tile_overflow": torch.zeros((), dtype=torch.int32, device=gfeat.device),
        "num_visible": torch.sum(prep.visible.to(torch.int32)),
        # pairs left after the exact per-tile cull (what K2 composites)
        "num_binned_pairs": torch.sum(bins.tile_count),
        # splats with a pair in any of the views (in the band, when banded)
        "num_on_screen": torch.count_nonzero(ntiles),
    }
    if views is not None:
        stats.update(num_pairs=torch.max(bins.num_pairs),
                     num_dropped_pairs=torch.sum(bins.num_dropped),
                     num_pairs_per_view=bins.num_pairs,
                     num_dropped_pairs_per_view=bins.num_dropped)
    render = RenderOutput(image=imgd[..., 0:3, :, :], radii=prep.radius,
                          depth=imgd[..., 3:4, :, :])
    return render, stats
