"""Tile binning: depth sort, pair expansion (kernel K1), one stable tile sort.

Counterpart of ``gaussian_splatting_lightning_tpu/ops/binning.py``
(``_expand_keys``, ``expand_pairs_pallas``, ``build_sorted_bins``,
``grid_shape``, and the tiled route's ``owner_of_slot``, ``TileBins``,
``build_tile_bins`` and ``build_tile_table``). The design is the JAX
package's:

1. Sort splats by view depth once (stable); splats with no tile sort last.
   Per-tile depth order is then a subsequence of the global order.
2. Expand (splat, tile) pairs into a static budget of ``max_pairs`` slots
   (kernel K1, ``csrc/expand_pairs.cu``), each slot independently, with the
   exact per-tile ellipse cull. Slots past the budget are never generated,
   so on overflow the *farthest* splats drop first. K1 gathers each
   owner's fields by the depth order itself, once per owner.
3. One stable sort by tile key groups pairs per tile in depth order.
4. Tile ranges come from T+1 searchsorted queries over the sorted keys.

Only step 2 is a kernel; the sorts and searches are PyTorch on the device,
as they were XLA outside any kernel in the JAX package. ``expand_inputs``,
``expand_pairs`` and ``build_sorted_bins`` also take a stack of B views
(``Preprocessed`` fields (B, N, ...)): every stage then runs once for all
views along the last axis, K1 in one launch, and each view keeps its own
``max_pairs`` budget and drops its own farthest splats, as ``vmap`` of the
JAX function does. ``build_tile_bins``
is the tiled route's binning (``ops/rasterize_tiled.py``): the same stages
in plain PyTorch with no cull, its pairs then laid out per tile by
``build_tile_table``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_splatting_lightning_tpu_torch.core import transforms as tf
from gaussian_splatting_lightning_tpu_torch.ops import _build
from gaussian_splatting_lightning_tpu_torch.ops.common import (
    BLOCK_X,
    BLOCK_Y,
    Preprocessed,
)

CHUNK = 128  # the JAX compositor's window alignment; kept for astart/phase


# columns of K1's per-splat row, (N, ROW) int32 in original splat order;
# CULL_R2 holds the bits of an f32 (``.view(torch.float32)`` reads it back)
X0, NX, Y0, CULL_R2 = range(4)
ROW = 4


class ExpandInputs(NamedTuple):
    """K1's inputs: the slot starts, the depth order and the per-splat fields
    K1 reads, in original splat order. Depth rank g's fields are those of
    splat ``order[g]``. For a stack of B views every field has a leading B
    (``total`` is then (B,))."""

    offsets: torch.Tensor  # (N,) int32 exclusive prefix sum of ntiles[order]
    order: torch.Tensor  # (N,) int32 depth permutation (original splat ids)
    rows: torch.Tensor  # (N, ROW) int32: first tile column, rect width in
    #   tiles, first tile row (band-local), the bits of the exact-cull
    #   squared radius
    p_pix: torch.Tensor  # (N, 2) f32 pixel-space mean
    total: torch.Tensor  # () int32 rect pair count over all splats


class SortedBins(NamedTuple):
    """The tile-sorted pair stream, field for field the tuple the JAX
    ``build_sorted_bins`` returns (all int32); a leading B on every field for
    a stack of B views."""

    gauss_s: torch.Tensor  # (M,) original splat id per sorted pair
    slot_s: torch.Tensor  # (M,) expansion slot per sorted pair
    astart: torch.Tensor  # (T,) tile_start rounded down to 128
    phase: torch.Tensor  # (T,) tile_start - astart
    tile_count: torch.Tensor  # (T,) pairs in the tile after the cull
    nchunk: torch.Tensor  # (T,) 128-chunks covering [astart, start+count)
    num_pairs: torch.Tensor  # () rect pairs before the budget cap
    num_dropped: torch.Tensor  # () pairs cut by the budget
    ntiles: torch.Tensor  # (N,) rect pair count, original order
    offsets: torch.Tensor  # (N,) depth-grouped slot starts
    order: torch.Tensor  # (N,) depth permutation

    @property
    def tile_start(self) -> torch.Tensor:
        return self.astart + self.phase


def grid_shape(width: int, height: int, block_x: int = BLOCK_X,
               block_y: int = BLOCK_Y):
    return -(-width // block_x), -(-height // block_y)


def owner_of_slot(starts: torch.Tensor, n_slots: int) -> torch.Tensor:
    """For ascending ``starts`` (K,), map each slot in [0, n_slots) to the
    largest k with starts[k] <= slot, -1 before ``starts[0]``; zero-width
    runs (duplicate starts) resolve to the last owner. (The JAX function
    gets the same answer from a scatter-max and a cumulative max.)"""
    slots = torch.arange(n_slots, dtype=starts.dtype, device=starts.device)
    return torch.searchsorted(starts, slots, right=True, out_int32=True) - 1


class TileBins(NamedTuple):
    """Depth-then-tile ordered (splat, tile) pairs with per-tile ranges."""

    pair_gaussian: torch.Tensor  # (M,) int32 index into the original arrays
    pair_tile: torch.Tensor  # (M,) int32 tile id; == n_tiles for padding
    pair_valid: torch.Tensor  # (M,) bool
    tile_start: torch.Tensor  # (T,) int32 offset into pair arrays
    tile_count: torch.Tensor  # (T,) int32
    num_pairs: torch.Tensor  # () int32: total pairs before the budget cap
    num_dropped: torch.Tensor  # () int32 pairs dropped by the budget


def build_tile_bins(
    prep: Preprocessed,
    grid_x: int,
    grid_y: int,
    max_pairs: int,
    tile_y_offset: int = 0,
    grid_y_local: int | None = None,
) -> TileBins:
    """Every (splat, tile) pair of the splats' 16 px rects, depth order within
    each tile, in a static budget of ``max_pairs`` slots: a full budget
    drops the farthest splats' pairs. ``tile_y_offset``/``grid_y_local``
    restrict binning to a band of tile rows (tile ids local to the band)."""
    n = prep.depth.shape[0]
    if grid_y_local is None:
        grid_y_local = grid_y
    n_tiles = grid_x * grid_y_local
    dev = prep.depth.device

    x0, y0g, x1, y1g = tf.tile_rect(prep.p_pix.detach(), prep.radius_bin.detach(),
                                    grid_x, grid_y)
    y0 = torch.clamp(y0g - tile_y_offset, 0, grid_y_local)
    y1 = torch.clamp(y1g - tile_y_offset, 0, grid_y_local)
    nx = torch.clamp_min(x1 - x0, 0)
    ny = torch.clamp_min(y1 - y0, 0)
    ntiles = torch.where(prep.visible, nx * ny, torch.zeros_like(nx))

    # (1) global depth sort; culled splats last
    depth_key = torch.where(prep.visible, prep.depth.detach(),
                            torch.full_like(prep.depth, float("inf")))
    order = torch.argsort(depth_key, stable=True)
    ntiles_s = ntiles[order]

    # (2) static-budget pair expansion
    offsets = torch.cumsum(ntiles_s, 0, dtype=torch.int32) - ntiles_s
    total = offsets[-1] + ntiles_s[-1]
    slot = torch.arange(max_pairs, dtype=torch.int32, device=dev)
    g_s = torch.clamp(owner_of_slot(offsets, max_pairs), 0, n - 1)
    src = order[g_s]
    local = slot - offsets[g_s]
    w = torch.clamp_min(nx[src], 1)
    row = torch.div(local, w, rounding_mode="floor")
    tile_x = x0[src] + local - row * w
    tile_y = y0[src] + row
    valid = slot < torch.clamp_max(total, max_pairs)
    tile_id = torch.where(valid, tile_y * grid_x + tile_x,
                          torch.full_like(slot, n_tiles))

    # (3) the stable tile sort keeps depth order within each tile
    pair_tile, perm = torch.sort(tile_id, stable=True)
    pair_gaussian = src[perm].to(torch.int32)

    # (4) per-tile ranges from a histogram of the tile ids
    counts = torch.bincount(tile_id, minlength=n_tiles + 1).to(torch.int32)
    tile_count = counts[:n_tiles]
    tile_start = torch.cumsum(tile_count, 0, dtype=torch.int32) - tile_count
    return TileBins(
        pair_gaussian=pair_gaussian,
        pair_tile=pair_tile,
        pair_valid=valid[perm],
        tile_start=tile_start,
        tile_count=tile_count,
        num_pairs=total,
        num_dropped=torch.clamp_min(total - max_pairs, 0),
    )


def build_tile_table(bins: TileBins, n_tiles: int, capacity: int) -> torch.Tensor:
    """(T, K) table of pair indices, -1 padded: entry k of a row is the k-th
    nearest member of that tile; members past ``capacity`` are dropped.

    The rows of padding pairs and the columns of dropped members land in a
    last row and column of a one-larger buffer, cut off on return, so the
    table is built without reading a count back to the host."""
    m = bins.pair_tile.shape[0]
    dev = bins.pair_tile.device
    ids = torch.arange(m, dtype=torch.int32, device=dev)
    pos = ids - bins.tile_start[torch.clamp(bins.pair_tile, 0, n_tiles - 1)]
    row = torch.where(bins.pair_valid, bins.pair_tile, torch.full_like(ids, n_tiles))
    col = torch.clamp(pos, 0, capacity)
    table = torch.full((n_tiles + 1, capacity + 1), -1, dtype=torch.int32, device=dev)
    table[row.long(), col.long()] = ids
    return table[:n_tiles, :capacity]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the last axis, per view for (B, N) arrays."""
    return x[idx] if idx.dim() == 1 else torch.gather(x, -1, idx.long())


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive int32 prefix sum along the last axis. A (B, N) stack is
    scanned as one flat array and each view's start subtracted: PyTorch's
    scan along the last axis of a 2-D int tensor took 1.4-1.5 ms on the
    H100 at N = 1M, the flat scan what a 1-D one takes."""
    if x.dim() == 1:
        return torch.cumsum(x, 0, dtype=torch.int32) - x
    flat = torch.cumsum(x.reshape(-1), 0, dtype=torch.int32).reshape(x.shape)
    start = torch.cat([flat.new_zeros(1), flat[:-1, -1]])  # the views before each
    return flat - x - start[:, None]


def expand_inputs(
    prep: Preprocessed, grid_x: int, grid_y: int, tile_y_offset: int,
    grid_y_local: int, block: int,
) -> tuple[ExpandInputs, torch.Tensor]:
    """K1's inputs from ``prep``, plus ``ntiles`` in original order; for a
    stack of views (fields (B, N, ...)) each view's, from one pass of ops
    along the last axis (a per-view depth sort and exclusive cumsum).

    The JAX package's ``_expand_keys`` stacks K1's fields into one table and
    gathers its rows by ``order``. Here nx and y0 are written into their
    column of one (N, ROW) row table by the op that computes them, x0 and
    the cull radius by one copy each (a ``stack`` of the columns took longer
    than K1 on the H100; ``PERF.md`` §6), and K1 gathers each owner's row
    and mean by ``order`` itself as it stages a block's owners: only
    ``ntiles`` is gathered here, for the slot starts.
    """
    p_pix = prep.p_pix.detach()
    x0, y0g, x1, y1g = tf.tile_rect(
        p_pix, prep.radius_bin.detach(), grid_x, grid_y, block, block
    )
    rows = torch.empty(x0.shape + (ROW,), dtype=torch.int32, device=x0.device)
    rows[..., X0] = x0
    rows[..., CULL_R2] = prep.cull_r2.detach().view(torch.int32)
    y0 = torch.clamp(y0g - tile_y_offset, 0, grid_y_local, out=rows[..., Y0])
    y1 = torch.clamp(y1g - tile_y_offset, 0, grid_y_local)
    nx = torch.clamp_min(x1 - x0, 0, out=rows[..., NX])
    ny = torch.clamp_min(y1 - y0, 0)
    ntiles = torch.where(prep.visible, nx * ny, torch.zeros_like(nx)).to(torch.int32)

    # live prefix = visible splats with at least one (band-clipped) tile
    live = prep.visible & (ntiles > 0)
    depth_key = torch.where(live, prep.depth.detach(),
                            torch.full_like(prep.depth, float("inf")))
    order = torch.argsort(depth_key, dim=-1, stable=True).to(torch.int32)
    ntiles_s = _take(ntiles, order)
    offsets = _exclusive_cumsum(ntiles_s)
    total = offsets[..., -1] + ntiles_s[..., -1]
    return ExpandInputs(offsets, order, rows, p_pix, total), ntiles


def expand_pairs_plain(
    inp: ExpandInputs, max_pairs: int, grid_x: int, n_tiles: int,
    tile_y_offset: int = 0, block: int = BLOCK_X,
):
    """Plain PyTorch version of K1: (key, gauss), each (max_pairs,) int32, or
    (B, max_pairs) for a stack of views, which it expands one at a time."""
    if inp.offsets.dim() == 2:
        per_view = [expand_pairs_plain(ExpandInputs(*(t[v] for t in inp)), max_pairs,
                                       grid_x, n_tiles, tile_y_offset, block)
                    for v in range(inp.offsets.shape[0])]
        return tuple(torch.stack(x) for x in zip(*per_view))
    n = inp.offsets.shape[0]
    slot = torch.arange(max_pairs, dtype=torch.int32, device=inp.offsets.device)
    g = torch.clamp(torch.searchsorted(inp.offsets, slot, right=True) - 1, 0, n - 1)
    src = inp.order[g]
    row_g = inp.rows[src]
    local = slot - inp.offsets[g]
    # a slot's owner has a tile, so nx >= 1; the clamp only keeps the
    # division defined for the padding past ``total``
    w = torch.clamp_min(row_g[:, NX], 1)
    row = torch.div(local, w, rounding_mode="floor")
    tx = row_g[:, X0] + local - row * w
    ty = row_g[:, Y0] + row
    gx0 = (tx * block).to(torch.float32)
    gy0 = ((ty + tile_y_offset) * block).to(torch.float32)
    p = inp.p_pix[src]
    mx, my = p[:, 0], p[:, 1]
    dx = torch.clamp_min(torch.maximum(gx0 - mx, mx - (gx0 + (block - 1))), 0.0)
    dy = torch.clamp_min(torch.maximum(gy0 - my, my - (gy0 + (block - 1))), 0.0)
    keep = dx * dx + dy * dy <= row_g[:, CULL_R2].view(torch.float32)
    valid = slot < inp.total
    n_tiles_t = torch.full_like(slot, n_tiles)
    key = torch.where(valid & keep, ty * grid_x + tx, n_tiles_t)
    gauss = torch.where(valid, src, torch.zeros_like(slot))
    return key, gauss


def expand_pairs(
    inp: ExpandInputs, max_pairs: int, grid_x: int, n_tiles: int,
    tile_y_offset: int = 0, block: int = BLOCK_X,
):
    """K1 wrapper: launches ``csrc/expand_pairs.cu`` on CUDA tensors, runs the
    plain version on CPU tensors. A stack of B views (every field with a
    leading B) takes one launch with a grid row per view and gives
    (B, max_pairs) keys and ids.

    Precondition, as ``expand_inputs`` makes it: ``offsets`` is the exclusive
    cumsum of ``ntiles[order]`` (so it never decreases), ``total`` its sum,
    ``order`` a permutation of the splats, and a splat with a tile has a
    rect width ``rows[:, NX] >= 1``. The kernel stages each block's owner
    window in shared memory; a window too wide for that (zero-tile splats
    inside the live prefix, which ``expand_inputs`` never makes) takes a
    slower path in the kernel that is just as exact.
    """
    if inp.offsets.device.type == "cpu":
        return expand_pairs_plain(inp, max_pairs, grid_x, n_tiles,
                                  tile_y_offset, block)
    dev = inp.offsets.device
    for name in ExpandInputs._fields:
        dtype = torch.float32 if name == "p_pix" else torch.int32
        _build.check_tensor(getattr(inp, name), name, dtype, dev)
    lead = tuple(inp.offsets.shape[:-1])
    n = inp.offsets.shape[-1]
    shapes = tuple(tuple(t.shape) for t in inp)
    want = tuple(lead + s for s in ((n,), (n,), (n, ROW), (n, 2), ()))
    if n == 0 or len(lead) > 1 or shapes != want:
        raise ValueError(f"expand_pairs: need offsets, order ([B,] N), rows ([B,] N, {ROW}), "
                         f"p_pix ([B,] N, 2) and total ([B]) with N > 0, got {shapes}")
    if inp.rows.data_ptr() % 16 or inp.p_pix.data_ptr() % 8:
        raise ValueError("expand_pairs: rows and p_pix must start on a 16- and an "
                         "8-byte boundary")
    key = torch.empty(lead + (max_pairs,), dtype=torch.int32, device=dev)
    gauss = torch.empty_like(key)
    lib = _build.load("expand_pairs")
    p = _build.ptr
    views = lead[0] if lead else 1
    rc = lib.gs_expand_pairs(
        *(p(t) for t in inp), n, views, max_pairs, grid_x, n_tiles, block, tile_y_offset,
        p(key), p(gauss), _build.stream_of(key),
    )
    _build.check(lib, "expand_pairs", rc)
    return key, gauss


def build_sorted_bins(
    prep: Preprocessed,
    grid_x: int,
    grid_y: int,
    max_pairs: int,
    tile_y_offset: int = 0,
    grid_y_local: int | None = None,
    block: int = BLOCK_X,
    plain: bool = False,
) -> SortedBins:
    """The tile-sorted pair stream for the compositor.

    ``tile_y_offset``/``grid_y_local`` restrict binning to a band of tile rows
    (tile ids local to the band). ``plain`` runs K1's plain version on any
    device. Outputs match the JAX function's eleven, in its order; for a
    stack of views (``prep`` fields (B, N, ...)) each has a leading B, from
    one stable sort and one ``searchsorted`` along the last axis.
    """
    if grid_y_local is None:
        grid_y_local = grid_y
    n_tiles = grid_x * grid_y_local
    inp, ntiles = expand_inputs(prep, grid_x, grid_y, tile_y_offset,
                                grid_y_local, block)
    expand = expand_pairs_plain if plain else expand_pairs
    key, gauss = expand(inp, max_pairs, grid_x, n_tiles, tile_y_offset, block)

    # ONE stable sort groups pairs by tile while preserving depth order
    keys_s, perm = torch.sort(key, dim=-1, stable=True)
    gauss_s = _take(gauss, perm)
    slot_s = perm.to(torch.int32)

    t_ids = torch.arange(n_tiles + 1, dtype=torch.int32, device=key.device)
    t_ids = t_ids.expand(key.shape[:-1] + t_ids.shape).contiguous()
    bounds = torch.searchsorted(keys_s, t_ids, out_int32=True)
    tile_start = bounds[..., :-1].contiguous()
    tile_count = bounds[..., 1:] - bounds[..., :-1]
    astart = torch.div(tile_start, CHUNK, rounding_mode="floor") * CHUNK
    phase = tile_start - astart
    nchunk = torch.div(phase + tile_count + CHUNK - 1, CHUNK, rounding_mode="floor")
    return SortedBins(
        gauss_s=gauss_s,
        slot_s=slot_s,
        astart=astart,
        phase=phase,
        tile_count=tile_count,
        nchunk=nchunk,
        num_pairs=inp.total,
        num_dropped=torch.clamp_min(inp.total - max_pairs, 0),
        ntiles=ntiles,
        offsets=inp.offsets,
        order=inp.order,
    )
