"""The port's ``build_sorted_bins`` (K1's plain version on the CPU) against the
JAX package's (its Pallas expansion kernel in interpret mode).

Both sides get the SAME ``Preprocessed`` numbers; all eleven outputs must be
identical, for 16 and 32 px tiles, an overflowing pair budget and a band of
tile rows. K1's per-splat rows and means, gathered by the port's depth order,
must be the JAX side's fields gathered by the JAX depth order, and K1's plain version
must give the JAX expansion kernel's output on the synthetic layouts the card
tests hold K1 to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_lightning_tpu.core import transforms as jtf
from gaussian_splatting_lightning_tpu.ops import binning as jbin
from gaussian_splatting_lightning_tpu_torch.ops import binning as tbin
from tests.torch_expand_layouts import EXPAND_LAYOUTS, GX, GY, expand_case
from tests.torch_parity import cameras, jax_prep, jax_scene, torch_prep_from_jax

W, H = 128, 96


@pytest.fixture(scope="module")
def preps():
    js = jax_scene(1000, 1000, seed=2, aniso=True, dead_every=9)
    jc, _ = cameras(W, H)
    jp = jax_prep(js, jc, W, H)
    return jp, torch_prep_from_jax(jp)


CASES = {
    # name: (block, max_pairs, tile_y_offset, grid_y_local)
    "block16": (16, 1 << 14, 0, None),
    "block32": (32, 1 << 14, 0, None),
    "overflow": (32, 1024, 0, None),
    "band": (16, 1 << 14, 1, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_bins_identical(preps, case):
    jp, tp = preps
    blk, max_pairs, tyoff, gyl = CASES[case]
    gx, gy = jbin.grid_shape(W, H, blk, blk)
    j = jbin.build_sorted_bins(jp, gx, gy, max_pairs, tyoff, gyl,
                               interpret=True, block=blk)
    t = tbin.build_sorted_bins(tp, gx, gy, max_pairs, tyoff, gyl, block=blk)
    assert len(t) == len(j) == 11
    for name, a, b in zip(t._fields, j, t):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    n_tiles = gx * (gyl or gy)
    assert int(t.tile_count.sum()) > 0
    assert int((t.tile_start + t.tile_count).max()) <= max_pairs
    assert t.tile_start.shape == (n_tiles,)

    total = int(t.num_pairs)
    if case == "overflow":
        assert total > max_pairs and int(t.num_dropped) == total - max_pairs
        # the farthest splats drop first: every splat whose first slot is
        # past the budget lies behind every splat that kept a slot
        order, offsets = t.order.long(), t.offsets
        live = t.ntiles[order] > 0
        depth = tp.depth[order]
        kept = live & (offsets < max_pairs)
        dropped = live & (offsets >= max_pairs)
        assert bool(dropped.any()) and bool(kept.any())
        assert float(depth[kept].max()) <= float(depth[dropped].min())
    else:
        assert int(t.num_dropped) == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_inputs_match_jax_fields(preps, case):
    """K1's inputs against the JAX package: each column of K1's rows and the
    means, gathered by the port's ``order`` (as K1 stages a block's owners),
    is the JAX side's field gathered by the ``order`` the JAX
    ``build_sorted_bins`` returns (floats bit for bit); ``order``,
    ``offsets`` and ``total`` are the JAX ones."""
    jp, tp = preps
    blk, max_pairs, tyoff, gyl = CASES[case]
    gx, gy = jbin.grid_shape(W, H, blk, blk)
    gyl = gyl or gy
    j = jbin.build_sorted_bins(jp, gx, gy, max_pairs, tyoff, gyl, interpret=True, block=blk)
    order = np.asarray(j[10])

    x0, y0g, x1, y1g = (np.asarray(a) for a in jtf.tile_rect(
        jp.p_pix, jp.radius_bin, gx, gy, blk, blk))
    y0 = np.clip(y0g - tyoff, 0, gyl)
    p_pix = np.asarray(jp.p_pix)
    want = {tbin.X0: x0, tbin.NX: np.maximum(x1 - x0, 0), tbin.Y0: y0,
            tbin.CULL_R2: np.asarray(jp.cull_r2).view(np.int32)}  # bits
    assert sorted(want) == list(range(tbin.ROW))

    inp, _ = tbin.expand_inputs(tp, gx, gy, tyoff, gyl, blk)
    assert inp.order.dtype == torch.int32 and inp.rows.dtype == torch.int32
    np.testing.assert_array_equal(inp.order.numpy(), order)
    rows = inp.rows[inp.order.long()].numpy()
    for col, field in want.items():
        np.testing.assert_array_equal(rows[:, col], field[order], err_msg=str(col))
    np.testing.assert_array_equal(  # bit for bit
        inp.p_pix[inp.order.long()].numpy().view(np.int32), p_pix[order].view(np.int32))
    np.testing.assert_array_equal(inp.offsets.numpy(), np.asarray(j[9]))
    assert int(inp.total) == int(j[6])


# the synthetic layouts of the card tests that the JAX kernel takes in
# interpret mode: it needs the live-prefix invariant, and the bench budget
# would take minutes there
JAX_LAYOUTS = [c for c in EXPAND_LAYOUTS if c not in ("zero_tiles_inside", "budget_bench")]


@pytest.mark.parametrize("case", JAX_LAYOUTS)
def test_expand_pairs_plain_matches_the_jax_kernel(case):
    """K1's plain version (the card tests' reference) against the JAX
    expansion kernel in interpret mode, on the card tests' synthetic
    layouts: block-edge runs, budgets below and above the pair total."""
    *arrays, max_pairs = expand_case(case)
    inp = tbin.ExpandInputs(*(torch.from_numpy(a) for a in arrays))
    o = inp.order.long()  # the JAX kernel takes its fields in depth order
    ntiles_s = torch.diff(inp.offsets, append=inp.total.reshape(1))
    r = inp.rows[o]
    fields_s = torch.stack([r[:, tbin.X0], torch.clamp_min(r[:, tbin.NX], 1), r[:, tbin.Y0],
                            inp.p_pix[o, 0], inp.p_pix[o, 1],
                            r[:, tbin.CULL_R2].view(torch.float32), inp.order],
                           1).to(torch.float32).numpy()
    key_j, gauss_j = jbin.expand_pairs_pallas(
        jnp.asarray(arrays[0]), jnp.asarray(ntiles_s.numpy()), jnp.asarray(fields_s),
        max_pairs, jnp.asarray(arrays[-1]), GX, GX * GY, 0, interpret=True, block=32)
    key, gauss = tbin.expand_pairs(inp, max_pairs, GX, GX * GY, 0, 32)
    np.testing.assert_array_equal(np.asarray(key_j), key.numpy())
    np.testing.assert_array_equal(np.asarray(gauss_j), gauss.numpy())
    assert int((key < GX * GY).sum()) > 0 or int(inp.total) == 0


def test_expand_pairs_plain_is_the_wrapper_on_cpu(preps):
    _, tp = preps
    gx, gy = tbin.grid_shape(W, H, 32, 32)
    inp, ntiles = tbin.expand_inputs(tp, gx, gy, 0, gy, 32)
    a = tbin.expand_pairs(inp, 4096, gx, gx * gy, 0, 32)
    b = tbin.expand_pairs_plain(inp, 4096, gx, gx * gy, 0, 32)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # slots past the rect pair total are padding: key n_tiles, gauss 0
    total = int(inp.total)
    assert bool((a[0][total:] == gx * gy).all()) and bool((a[1][total:] == 0).all())
    assert total == int(ntiles.sum())
    # K1's precondition: order a permutation, offsets the exclusive cumsum of
    # ntiles[order], and every splat with a tile at least one tile wide
    n = len(ntiles)
    assert torch.equal(torch.sort(inp.order).values, torch.arange(n, dtype=torch.int32))
    ntiles_s = ntiles[inp.order.long()]
    assert torch.equal(inp.offsets, torch.cumsum(ntiles_s, 0, dtype=torch.int32) - ntiles_s)
    assert bool((inp.rows[ntiles > 0, tbin.NX] >= 1).all())
