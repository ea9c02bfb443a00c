"""The port's tiled route (``train.rasterizer: xla``) against the JAX package.

- ``owner_of_slot``, ``build_tile_bins`` and ``build_tile_table`` match the
  JAX functions bit for bit on the same ``Preprocessed`` numbers, with an
  ample budget, a budget that drops pairs, a tile capacity that drops
  members, and a band of tile rows.
- ``rasterize_tiled`` matches JAX's: image and inverse depth within 1e-5 and
  every stat exact, also at a ``tile_capacity`` small enough to overflow;
  every parameter gradient within 1e-4 of its largest |value|; a banded
  render equals the matching rows of the full render; with an ample
  capacity it matches the port's kernel route (plain versions) within 2e-4
  (the two round the transmittance that the ``T > 1e-4`` rule tests
  differently, so one term of at most 1e-4 may flip).
- A coupled ``Trainer`` run on ``rasterizer: xla`` with a tiny
  ``tile_capacity`` grows the capacity at the same steps, to the same
  values, with the same log lines as the JAX ``Trainer`` (whose lines add
  " (recompile)"), and logs the same losses within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussian_splatting_lightning_tpu.ops import binning as jbinning
from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import (
    TilingConfig as JaxTiling,
    rasterize_tiled as jax_tiled,
)
from gaussian_splatting_lightning_tpu.training import densify as jdensify
from gaussian_splatting_lightning_tpu.training import trainer as jtrainer
from gaussian_splatting_lightning_tpu_torch.ops import binning
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.ops.rasterize import rasterize
from gaussian_splatting_lightning_tpu_torch.ops.rasterize_tiled import rasterize_tiled
from gaussian_splatting_lightning_tpu_torch.training.trainer import TrainConfig, Trainer
from tests.test_torch_trainer import NO_DENSIFY, gt_views, init_jax_scene
from tests.torch_parity import (
    BG,
    activated,
    assert_grads_close,
    cameras,
    jax_prep,
    jax_scene,
    port_scene,
    torch_prep_from_jax,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_owner_of_slot_matches_jax(seed):
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, 4, size=50)  # zero-width runs included
    starts = (np.cumsum(widths) - widths + rng.integers(0, 3)).astype(np.int32)
    n_slots = int(starts[-1]) + 7
    want = np.asarray(jbinning.owner_of_slot(jnp.asarray(starts), n_slots))
    got = binning.owner_of_slot(torch.from_numpy(starts), n_slots)
    np.testing.assert_array_equal(got.numpy(), want)


# (max_pairs, tile_capacity, tile_y_offset, grid_y_local): ample budget;
# a budget that drops the farthest pairs; a capacity that drops members; a
# band of tile rows
BIN_CASES = [(1 << 13, 256, 0, None), (700, 256, 0, None), (1 << 13, 8, 0, None),
             (1 << 13, 64, 2, 3)]


@pytest.mark.parametrize("max_pairs,capacity,offset,gy_local", BIN_CASES)
def test_tile_bins_and_table_match_jax(max_pairs, capacity, offset, gy_local):
    w, h = 128, 96
    js = jax_scene(800, 1000, seed=0, dead_every=7)
    jc, _ = cameras(w, h)
    jprep = jax_prep(js, jc, w, h)
    gx, gy = binning.grid_shape(w, h)
    want = jbinning.build_tile_bins(jprep, gx, gy, max_pairs, offset, gy_local)
    got = binning.build_tile_bins(torch_prep_from_jax(jprep), gx, gy, max_pairs, offset,
                                  gy_local)
    for name in binning.TileBins._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    n_tiles = gx * (gy_local or gy)
    np.testing.assert_array_equal(
        binning.build_tile_table(got, n_tiles, capacity).numpy(),
        np.asarray(jbinning.build_tile_table(want, n_tiles, capacity)))
    if max_pairs == 700:
        assert int(got.num_dropped) > 0


def render_pair(w, h, tiling, **kw):
    js = jax_scene(800, 1000, seed=1, dead_every=7)
    ts = port_scene(js)
    jc, tc = cameras(w, h)
    jcfg = JaxTiling(max_pairs=tiling.max_pairs, tile_capacity=tiling.tile_capacity,
                     chunk=tiling.chunk)
    want = jax_tiled(*activated(js, "jax"), jc, w, h, jnp.asarray(BG), js.active_sh_degree,
                     jcfg, js.max_sh_degree, alive=js.alive, **kw)
    got = rasterize_tiled(*activated(ts, "torch"), tc, w, h, torch.from_numpy(BG),
                          ts.active_sh_degree, tiling, ts.max_sh_degree, alive=ts.alive, **kw)
    return want, got, ts, tc


@pytest.mark.parametrize("capacity,chunk", [(1024, 64), (32, 16)])
def test_tiled_matches_jax(capacity, chunk):
    w, h = 128, 96
    (jout, jstats), (tout, tstats), _, _ = render_pair(
        w, h, TilingConfig(max_pairs=1 << 13, tile_capacity=capacity, chunk=chunk))
    np.testing.assert_allclose(tout.image.numpy(), np.asarray(jout.image), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tout.depth.numpy(), np.asarray(jout.depth), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tout.radii.numpy(), np.asarray(jout.radii))
    assert {k: int(v) for k, v in tstats.items()} == {k: int(v) for k, v in jstats.items()}
    assert (int(tstats["num_tile_overflow"]) > 0) == (capacity == 32)


def test_tiled_gradients_match_jax():
    w, h = 64, 48
    tiling = TilingConfig(max_pairs=1 << 12, tile_capacity=128, chunk=32)
    js = jax_scene(400, 500, seed=3, dead_every=9)
    ts = port_scene(js)
    jc, tc = cameras(w, h)
    rng = np.random.default_rng(1)
    ct_img = rng.normal(size=(3, h, w)).astype(np.float32)
    ct_dep = rng.normal(size=(1, h, w)).astype(np.float32)
    jcfg = JaxTiling(max_pairs=tiling.max_pairs, tile_capacity=tiling.tile_capacity,
                     chunk=tiling.chunk)

    def jax_loss(*x):
        out, _ = jax_tiled(*x, jc, w, h, jnp.asarray(BG), js.active_sh_degree, jcfg,
                           js.max_sh_degree, alive=js.alive)
        return jnp.sum(out.image * ct_img) + jnp.sum(out.depth * ct_dep)

    want = jax.jit(jax.grad(jax_loss, argnums=tuple(range(5))))(*activated(js, "jax"))
    xs = [t.requires_grad_() for t in activated(ts, "torch")]
    out, _ = rasterize_tiled(*xs, tc, w, h, torch.from_numpy(BG), ts.active_sh_degree,
                             tiling, ts.max_sh_degree, alive=ts.alive)
    loss = torch.sum(out.image * torch.from_numpy(ct_img)) + torch.sum(
        out.depth * torch.from_numpy(ct_dep))
    got = torch.autograd.grad(loss, xs)
    assert_grads_close(got, want)


@pytest.mark.parametrize("offset,gy_local", [(0, 2), (2, 3), (4, 2)])
def test_banded_render_equals_rows_of_full(offset, gy_local):
    w, h = 96, 96  # 6 tile rows
    tiling = TilingConfig(max_pairs=1 << 13, tile_capacity=256, chunk=64)
    (_, _), (full, _), ts, tc = render_pair(w, h, tiling)
    band, _ = rasterize_tiled(*activated(ts, "torch"), tc, w, h, torch.from_numpy(BG),
                              ts.active_sh_degree, tiling, ts.max_sh_degree, alive=ts.alive,
                              tile_y_offset=offset, grid_y_local=gy_local)
    rows = slice(offset * 16, (offset + gy_local) * 16)
    assert band.image.shape == (3, gy_local * 16, w)
    assert torch.equal(band.image, full.image[:, rows])
    assert torch.equal(band.depth, full.depth[:, rows])


def test_tiled_matches_kernel_route():
    w, h = 96, 80
    tiling = TilingConfig(max_pairs=1 << 14, tile_capacity=1024, chunk=64)
    ts = port_scene(jax_scene(600, 700, seed=4, dead_every=5))
    _, tc = cameras(w, h)
    common = (tc, w, h, torch.from_numpy(BG), ts.active_sh_degree)
    want, _ = rasterize(*activated(ts, "torch"), *common, config=tiling,
                        max_sh_degree=ts.max_sh_degree, alive=ts.alive, plain=True)
    got, stats = rasterize_tiled(*activated(ts, "torch"), *common, config=tiling,
                                 max_sh_degree=ts.max_sh_degree, alive=ts.alive)
    assert int(stats["num_tile_overflow"]) == 0 and int(stats["num_dropped_pairs"]) == 0
    assert float(torch.abs(got.image - want.image).max()) <= 2e-4
    assert float(torch.abs(got.depth - want.depth).max()) <= 2e-4


def test_xla_route_trains_and_grows_tile_capacity_as_jax():
    xyz, views = gt_views(n_views=4, w=48, h=32, n_gt=40, seed=5)
    js = init_jax_scene(xyz)
    ts = port_scene(js)
    common = dict(num_iters=8, capacity=64, log_interval=2, overflow_check_interval=2,
                  valid_interval=4, checkpoint_interval=10_000, seed=3)
    jcfg = jtrainer.TrainConfig(
        rasterizer="xla", tiling=JaxTiling(max_pairs=1 << 13, tile_capacity=4, chunk=4),
        densify=jdensify.DensifyConfig(densify_since=100, densify_until=0), **common)
    tcfg = TrainConfig(rasterizer="xla", densify=NO_DENSIFY,
                       tiling=TilingConfig(max_pairs=1 << 13, tile_capacity=4, chunk=4),
                       **common)
    logs = {"jax": [], "port": []}
    train, valid = views[1:], views[:1]
    jtr = jtrainer.Trainer(jcfg, js, 4.0, train, valid, log_fn=logs["jax"].append)
    ttr = Trainer(tcfg, ts, 4.0, train, valid, log_fn=logs["port"].append)
    jtr.train()
    ttr.train()
    jlines = [m.replace(" (recompile)", "") for m in logs["jax"]]
    growths = [m for m in logs["port"] if "tile_capacity" in m]
    assert growths and any("growing tile_capacity" in m for m in growths), logs["port"]
    assert [m for m in jlines if "tile_capacity" in m] == growths
    assert ttr.cfg.tiling.tile_capacity == jtr.cfg.tiling.tile_capacity > 4
    jh, th = jtr.history, ttr.history
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(0, 8, 2))
    rel = [abs(a["loss"] - b["loss"]) / a["loss"] for a, b in zip(jh, th)]
    assert max(rel) <= 1e-5, rel
