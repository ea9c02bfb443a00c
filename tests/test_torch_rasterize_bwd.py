"""The port's rasterizer backward (K3 and K4's plain versions on the CPU)
against the JAX package's ``rasterize_pallas`` run in interpret mode with
f32 pair gradients (``pair_grad_bf16=False``).

The same ``Preprocessed`` goes in on both sides and the same random
cotangent on image and depth comes back; the gradient of every
``Preprocessed`` field that carries one (p_pix, depth, conic, rgb, opacity)
must agree. Tolerances are a share of the gradient's largest magnitude:

- no early stop, 2e-5: the port keeps T as a serial product and the suffix
  as total - prefix in a serial sum, the JAX kernel as a log-space cumsum
  through a triangular matmul; the two differ by a few ulp per pixel, and
  the suffix term divides by (1 - alpha) >= 0.01 (measured: <= 1.9e-6);
- early stop, 1e-4: on top of that the port stops every 256 pairs and the
  JAX kernel every 128, which moves T_fin * bg (part of every suffix) by
  less than 1e-4 |bg| (measured: <= 1.4e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from gaussian_splatting_lightning_tpu.ops.rasterize_pallas import rasterize_pallas
from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import TilingConfig as JaxTiling
from gaussian_splatting_lightning_tpu.training import trainer as jtrainer
from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
from gaussian_splatting_lightning_tpu_torch.ops import binning
from gaussian_splatting_lightning_tpu_torch.ops import rasterize as trast
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.ops.rasterize import rasterize
from gaussian_splatting_lightning_tpu_torch.training import trainer as ttrainer
from tests.test_torch_cuda_kernels import segment_layout
from tests.torch_parity import (
    BG,
    cameras,
    jax_prep,
    jax_scene,
    port_scene,
    torch_prep_from_jax,
)

W, H = 96, 64
MAX_PAIRS = 1 << 14
FIELDS = ("p_pix", "depth", "conic", "rgb", "opacity")
TOL_NO_STOP = 2e-5
TOL_STOP = 1e-4
NONE = (None,) * 5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain kernels are loops of small ops: threads only add overhead,
    # and the test workers already share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    # anisotropic splats, every 11th dead
    return jax_scene(1000, 1000, seed=7, scale=0.08, aniso=True, dead_every=11)


@pytest.fixture(scope="module")
def dense():
    # large opaque splats: tiles saturate, so the early stop cuts work
    return graft._synthetic_scene(1000, 1000, seed=8, scale=0.5, opacity=3.0)


def cotangents(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, H, W)).astype(np.float32),
            rng.normal(size=(1, H, W)).astype(np.float32))


def rel_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def prep_grads(js, block, early_stop, max_pairs):
    """Gradients of <cotangent, render> w.r.t. the Preprocessed fields:
    (JAX dict, port dict, JAX dropped pairs, port dropped pairs)."""
    jc, _ = cameras(W, H)
    jp = jax_prep(js, jc, W, H)
    cti, ctd = cotangents()

    def jax_loss(fields):
        out, st = rasterize_pallas(
            *NONE, jc, W, H, jnp.asarray(BG), None,
            config=JaxTiling(max_pairs=max_pairs, block=block, pair_grad_bf16=False),
            interpret=True, early_stop=early_stop,
            prep=dataclasses.replace(jp, **fields),
        )
        return jnp.sum(out.image * cti) + jnp.sum(out.depth * ctd), st["num_dropped_pairs"]

    jg, jdrop = jax.grad(jax_loss, has_aux=True)({k: getattr(jp, k) for k in FIELDS})
    tp = torch_prep_from_jax(jp)
    leaves = {k: getattr(tp, k).clone().requires_grad_() for k in FIELDS}
    out, st = rasterize(
        *NONE, None, W, H, torch.from_numpy(BG), None,
        config=TilingConfig(max_pairs=max_pairs, block=block),
        early_stop=early_stop, prep=dataclasses.replace(tp, **leaves),
    )
    loss = (out.image * torch.from_numpy(cti)).sum() + (out.depth * torch.from_numpy(ctd)).sum()
    loss.backward()
    tg = {k: leaves[k].grad.numpy() for k in FIELDS}
    return {k: np.asarray(v) for k, v in jg.items()}, tg, int(jdrop), int(st["num_dropped_pairs"])


@pytest.mark.parametrize("block", [16, 32])
def test_prep_gradients_match_pallas_interpret(scene, block):
    jg, tg, jdrop, tdrop = prep_grads(scene, block, False, MAX_PAIRS)
    assert jdrop == tdrop == 0
    for k in FIELDS:
        assert np.abs(jg[k]).max() > 0, k
        assert rel_err(jg[k], tg[k]) <= TOL_NO_STOP, k


@pytest.mark.parametrize("block", [16, 32])
def test_prep_gradients_with_early_stop_match_pallas_interpret(dense, block):
    jg, tg, _, _ = prep_grads(dense, block, True, MAX_PAIRS)
    for k in FIELDS:
        assert rel_err(jg[k], tg[k]) <= TOL_STOP, k


def test_prep_gradients_with_dropped_pairs_match_pallas_interpret(scene):
    """A pair budget far below the scene's pairs: both drop the same
    farthest slots, and K4's clipped ranges give the JAX counts."""
    jg, tg, jdrop, tdrop = prep_grads(scene, 32, False, 1024)
    assert jdrop == tdrop > 0
    for k in FIELDS:
        assert rel_err(jg[k], tg[k]) <= TOL_NO_STOP, k


def test_parameter_and_offset_gradients_through_render_scene(scene):
    """The whole path from the parameters, with the NDC mean offset whose
    gradient drives densification (early stop on, 32 px tiles)."""
    js = scene
    jc, tc = cameras(W, H)
    ts = port_scene(js)
    cti, ctd = cotangents(4)
    jtiling = JaxTiling(max_pairs=MAX_PAIRS, block=32, pair_grad_bf16=False)
    raster = jtrainer.resolve_rasterizer("pallas_interpret")

    def jax_loss(params, offset):
        live = dataclasses.replace(js, params=params)
        out, _ = jtrainer.render_scene(live, jc, W, H, jnp.asarray(BG), jtiling,
                                       means2d_ndc_offset=offset, rasterize_fn=raster)
        return jnp.sum(out.image * cti) + jnp.sum(out.depth * ctd)

    joff = jnp.zeros((js.capacity, 2), jnp.float32)
    jpg, jog = jax.grad(jax_loss, argnums=(0, 1))(js.params, joff)

    leaves = {k: getattr(ts.params, k).clone().requires_grad_() for k in PARAM_NAMES}
    offset = torch.zeros(ts.capacity, 2, requires_grad=True)
    live = dataclasses.replace(ts, params=type(ts.params)(**leaves))
    out, _ = ttrainer.render_scene(live, tc, W, H, torch.from_numpy(BG),
                                   TilingConfig(max_pairs=MAX_PAIRS, block=32),
                                   means2d_ndc_offset=offset,
                                   rasterize_fn=ttrainer.resolve_rasterizer("plain"))
    ((out.image * torch.from_numpy(cti)).sum() + (out.depth * torch.from_numpy(ctd)).sum()).backward()

    assert np.abs(np.asarray(jog)).max() > 0
    assert rel_err(jog, offset.grad.numpy()) <= TOL_STOP
    for k in PARAM_NAMES:
        a = np.asarray(getattr(jpg, k))
        if np.abs(a).max() == 0:  # SH bands above the active degree
            assert not leaves[k].grad.abs().any(), k
            continue
        assert rel_err(a, leaves[k].grad.numpy()) <= TOL_STOP, k


def test_gradients_finite_with_a_splat_at_the_camera_plane():
    """Splat 0 sits exactly at view depth 0, off the camera centre (culled,
    never paired): the near-plane guards and the safe 1/z divisor keep inf
    and NaN out of every gradient."""
    js = graft._synthetic_scene(300, 300, seed=2, scale=0.1)
    ts = port_scene(js)
    _, tc = cameras(W, H)
    with torch.no_grad():
        ts.params.xyz[0] = torch.tensor([0.5, 0.3, -4.0])  # the camera sits at z = -4
    cfg = ttrainer.TrainConfig(rasterizer="plain",
                               tiling=TilingConfig(max_pairs=MAX_PAIRS, block=32))
    target = torch.from_numpy(np.random.default_rng(1).uniform(size=(3, H, W)).astype(np.float32))
    grads, screen, _, radii, logs, _ = ttrainer.step_gradients(
        cfg, ts, tc, W, H, target, torch.from_numpy(BG))
    assert float(radii[0]) == 0.0
    assert bool(torch.isfinite(logs["loss"]))
    for k in PARAM_NAMES:
        assert bool(torch.isfinite(getattr(grads, k)).all()), k
    assert bool(torch.isfinite(screen).all()) and float(screen.abs().max()) > 0


@pytest.mark.parametrize("block,early_stop", [(16, False), (32, True)])
def test_pair_composite_backward_matches_autograd_of_the_plain_forward(dense, block, early_stop):
    """Independent of the JAX package: autograd through ``composite_fwd_plain``
    (plain differentiable torch) against ``PairComposite``'s K3 + K4
    backward, on the feature table. Same math, other summation order:
    within 1e-5 of the largest gradient."""
    jc, _ = cameras(W, H)
    prep = torch_prep_from_jax(jax_prep(dense, jc, W, H))
    gx, gy = binning.grid_shape(W, H, block, block)
    bins = binning.build_sorted_bins(prep, gx, gy, MAX_PAIRS, block=block)
    gfeat = trast.feature_table(prep, W, H, block)
    bg = torch.from_numpy(BG)
    ct = torch.from_numpy(np.random.default_rng(5).normal(
        size=(gx * gy, trast.NOUT, block * block)).astype(np.float32))

    a = gfeat.clone().requires_grad_()
    out_a = trast.composite_fwd_plain(a, bins.gauss_s, bins.tile_start, bins.tile_count,
                                      bg, gx, block, early_stop=early_stop)
    (out_a * ct).sum().backward()
    b = gfeat.clone().requires_grad_()
    out_b = trast.PairComposite.apply(b, bins, bg, gx, block, MAX_PAIRS, 0, early_stop, False)
    (out_b * ct).sum().backward()

    assert torch.equal(out_a.detach(), out_b.detach())
    ga, gb = a.grad[:, :trast.NGRAD].numpy(), b.grad[:, :trast.NGRAD].numpy()
    assert not b.grad[:, trast.NGRAD:].any()
    for col in range(trast.NGRAD):
        assert np.abs(ga[:, col]).max() > 0, col
        assert rel_err(ga[:, col], gb[:, col]) <= 1e-5, col


def test_segment_sum_plain_sums_each_splats_slot_range():
    """K4's plain version on hand-made ranges: splat order [2, 0, 1] by
    depth, two slots dropped by the budget."""
    dpair = torch.arange(1, 61, dtype=torch.float32).reshape(6, trast.NGRAD)
    offsets = torch.tensor([0, 3, 3], dtype=torch.int32)  # depth ranks 0, 1, 2
    ntiles = torch.tensor([0, 5, 3], dtype=torch.int32)  # original order
    order = torch.tensor([2, 0, 1], dtype=torch.int32)
    out = trast.segment_sum(dpair, offsets, ntiles, order)
    assert out.shape == (3, trast.NFEAT)
    assert torch.equal(out[2, :10], dpair[0:3].sum(0))
    assert not out[0].any()
    assert torch.equal(out[1, :10], dpair[3:6].sum(0))  # 5 slots, 3 inside the budget
    assert not out[:, 10:].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_sum_plain_matches_a_loop_over_segments(seed):
    """K4's plain version on the synthetic layout the card tests give K4 (a
    5000-row rank, runs of empty ranks, a rank cut by the budget, ranks past
    it) against a numpy loop over the ranks in float64: the same zero rows,
    and within 1e-5 of each column's largest sum (f32 sums of up to 5000
    rows)."""
    dpair, offsets, ntiles, order = segment_layout(n=1500 + 7 * seed, seed=seed)
    n, max_pairs = offsets.shape[0], dpair.shape[0]
    want = np.zeros((n, trast.NFEAT))
    for j in range(n):
        lo = offsets[j]
        hi = min(lo + ntiles[order[j]], max_pairs)
        want[order[j], :trast.NGRAD] = dpair[lo:hi].astype(np.float64).sum(0)
    got = trast.segment_sum_plain(*(torch.from_numpy(a) for a in
                                    (dpair, offsets, ntiles, order))).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got == 0, want == 0)
    assert (np.abs(want).sum(1) == 0).sum() > 100
    scale = np.abs(want[:, :trast.NGRAD]).max(0)
    assert (np.abs(got - want)[:, :trast.NGRAD].max(0) / scale).max() <= 1e-5
