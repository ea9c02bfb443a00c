"""The port's view-batched training step (``batch_views > 1``) against the
JAX package's ``vmap``-ed step, and its parts.

Cameras are views on a ring around the scene (``core.camera.make_camera``,
as ``scripts/bench_batched.py`` builds them); images, targets and noise come
from numpy seeds and go to both sides. The JAX side runs its Pallas kernels
in interpret mode with f32 pair gradients; the port runs route "plain".

Bounds, and why:
- the batched render equals B single-view renders within 1e-6 (measured:
  bit for bit): the same ops per view, run along a leading axis;
- ``accumulate_stats`` and ``exposure_update`` within the single-view
  tests' bounds (1e-6 relative): they are a few f32 ops;
- the batched loss within 1e-5 relative and its gradient within 1e-4 of
  the largest |JAX| (``test_photometric_loss_value_and_gradient_match_jax``'s
  bounds);
- the coupled steps: ``test_twenty_coupled_steps_match_jax``'s bounds (loss
  within 1e-5 relative, parameters within 2e-3 / 2e-4 of their largest move,
  radii and view counts exact, ``grad_accum`` within 1e-4 of its maximum);
- the tiled route: the same bounds over its fewer steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussian_splatting_lightning_tpu.core.camera import make_camera as jax_make_camera
from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import TilingConfig as JaxTiling
from gaussian_splatting_lightning_tpu.training import densify as jdensify
from gaussian_splatting_lightning_tpu.training import exposure as jexposure
from gaussian_splatting_lightning_tpu.training import loss as jloss
from gaussian_splatting_lightning_tpu.training import optimizer as jopt
from gaussian_splatting_lightning_tpu.training import trainer as jtrainer
from gaussian_splatting_lightning_tpu_torch import interop
from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera, stack_cameras
from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.scripts.bench_batched import ring_pose
from gaussian_splatting_lightning_tpu_torch.training import densify as tdensify
from gaussian_splatting_lightning_tpu_torch.training import exposure as texposure
from gaussian_splatting_lightning_tpu_torch.training import loss as tloss
from gaussian_splatting_lightning_tpu_torch.training import trainer as ttrainer
from tests.torch_parity import jax_scene, port_scene

W, H, N, CAP = 64, 48, 400, 448


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain kernels are loops of small ops: threads only add overhead,
    # and the test workers already share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ring_cameras(b, total=5):
    """The first ``b`` of ``total`` ring views: the JAX cameras stacked as
    the JAX batched step takes them, and the port's stack."""
    poses = [ring_pose(i, total) for i in range(b)]
    jcams = [jax_make_camera(p, W * 0.7, W * 0.7, W, H) for p in poses]
    tcams = [make_camera(p, W * 0.7, W * 0.7, W, H, device="cpu") for p in poses]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *jcams), stack_cameras(tcams), tcams


def adam_to_port(jadam):
    return interop.adam_from_numpy(
        int(jadam.count), {k: np.asarray(getattr(jadam.mu, k)) for k in PARAM_NAMES},
        {k: np.asarray(getattr(jadam.nu, k)) for k in PARAM_NAMES}, device="cpu")


# ---- the batched render ---------------------------------------------------

@pytest.mark.parametrize("block", [16, 32])
def test_batched_render_matches_per_view_renders(block):
    """Route "plain": one batched render of three views (one nearly empty)
    against three single-view renders, outputs, stats and gradients."""
    js = jax_scene(N, CAP, seed=3, scale=0.08, aniso=True)
    ts = port_scene(js)
    poses = [ring_pose(i, 5) for i in range(2)] + [
        np.concatenate([np.eye(3), [[0.0], [0.0], [-4.0]]], 1)]  # looks away
    cams = [make_camera(p, W * 0.7, W * 0.7, W, H, device="cpu") for p in poses]
    bgs = torch.tensor([[0.1, 0.2, 0.3], [0.0, 0.0, 0.0], [1.0, 0.5, 0.25]])
    tiling = TilingConfig(max_pairs=3000, block=block)
    fn = ttrainer.resolve_rasterizer("plain")
    xyz = ts.params.xyz.detach().clone().requires_grad_()
    live = dataclasses.replace(ts, params=dataclasses.replace(ts.params, xyz=xyz))
    out, stats = ttrainer.render_scene(live, stack_cameras(cams), W, H, bgs, tiling,
                                       rasterize_fn=fn)
    assert out.image.shape == (3, 3, H, W) and out.depth.shape == (3, 1, H, W)
    assert out.radii.shape == (3, CAP)
    (gb,) = torch.autograd.grad((out.image * torch.arange(3.0)[:, None, None, None]).sum()
                                + out.depth.sum(), xyz)
    gsum = torch.zeros_like(gb)
    for v, cam in enumerate(cams):
        xv = ts.params.xyz.detach().clone().requires_grad_()
        lv = dataclasses.replace(ts, params=dataclasses.replace(ts.params, xyz=xv))
        o, s = ttrainer.render_scene(lv, cam, W, H, bgs[v], tiling, rasterize_fn=fn)
        assert (out.image[v] - o.image).abs().max() <= 1e-6
        assert (out.depth[v] - o.depth).abs().max() <= 1e-6
        assert torch.equal(out.radii[v], o.radii)
        assert int(stats["num_pairs_per_view"][v]) == int(s["num_pairs"])
        assert int(stats["num_dropped_pairs_per_view"][v]) == int(s["num_dropped_pairs"]) == 0
        (g,) = torch.autograd.grad(o.image.sum() * v + o.depth.sum(), xv)
        gsum += g
    assert int(stats["num_pairs_per_view"][2]) == 0  # the view that sees nothing
    assert torch.equal(out.image[2], bgs[2][:, None, None].expand(3, H, W))
    assert int(stats["num_pairs"]) == int(stats["num_pairs_per_view"].max())
    assert int(stats["num_dropped_pairs"]) == 0
    assert (gb - gsum).abs().max() <= 1e-6 * gsum.abs().max()


def test_batched_budget_is_per_view():
    """Each view keeps its own pair budget: a budget below one view's pairs
    drops that view's farthest pairs only, and the batched counts equal the
    single-view ones."""
    ts = port_scene(jax_scene(N, CAP, seed=3, scale=0.08, aniso=True))
    _, stacked, cams = ring_cameras(2)
    fn = ttrainer.resolve_rasterizer("plain")
    single = [ttrainer.render_scene(ts, c, W, H, torch.zeros(3), TilingConfig(
        max_pairs=1 << 14, block=32), rasterize_fn=fn)[1]["num_pairs"] for c in cams]
    budget = int(min(single)) // 2 + 128
    tiling = TilingConfig(max_pairs=budget, block=32)
    out, stats = ttrainer.render_scene(ts, stacked, W, H, torch.zeros(3), tiling,
                                       rasterize_fn=fn)
    m = -(-budget // 128) * 128
    for v, cam in enumerate(cams):
        o, s = ttrainer.render_scene(ts, cam, W, H, torch.zeros(3), tiling, rasterize_fn=fn)
        assert int(stats["num_dropped_pairs_per_view"][v]) == int(s["num_dropped_pairs"])
        assert int(s["num_dropped_pairs"]) == int(single[v]) - m > 0
        assert torch.equal(out.image[v], o.image)
    assert int(stats["num_dropped_pairs"]) == sum(int(n) - m for n in single)


# ---- the step's parts -----------------------------------------------------

def test_accumulate_stats_batched_matches_jax():
    rng = np.random.default_rng(8)
    js = jax_scene(60, 64, seed=1)
    js = dataclasses.replace(js, max_radii2d=jnp.asarray(
        rng.uniform(0, 5, size=64).astype(np.float32)))
    ts = port_scene(js)
    ts.max_radii2d = torch.from_numpy(np.asarray(js.max_radii2d).copy())
    for b in (2, 3):
        radii = np.where(rng.uniform(size=(b, 64)) > 0.4,
                         rng.uniform(0, 9, size=(b, 64)), 0).astype(np.float32)
        grads = rng.normal(size=(b, 64, 2)).astype(np.float32)
        js = jdensify.accumulate_stats(js, jnp.asarray(radii), jnp.asarray(grads))
        ts = tdensify.accumulate_stats(ts, torch.from_numpy(radii), torch.from_numpy(grads))
    for k in ("max_radii2d", "grad_accum", "grad_count"):
        np.testing.assert_allclose(np.asarray(getattr(js, k)), getattr(ts, k).numpy(),
                                   rtol=1e-6, atol=0, err_msg=k)
    assert float(ts.grad_count.max()) == 5.0


def test_exposure_update_with_a_repeated_view_matches_jax():
    """A batch that straddles two epochs may hold one view twice: JAX adds
    both updates to its matrix (``.at[].add``) and keeps the later view's
    moments (``.at[].set``)."""
    rng = np.random.default_rng(9)
    js, ts = jexposure.init_exposure(4), texposure.init_exposure(4, device="cpu")
    for idx in ([1, 2, 1], [3, 0, 2], [0, 0, 0], [2, 1, 3]):
        g = rng.normal(size=(len(idx), 3, 4)).astype(np.float32)
        js = jexposure.exposure_update(js, jnp.asarray(idx), jnp.asarray(g), 0.01)
        ts = texposure.exposure_update(ts, torch.tensor(idx), torch.from_numpy(g), 0.01)
    assert ts.count == int(js.count) == 4
    for k in ("params", "mu", "nu"):
        np.testing.assert_allclose(np.asarray(getattr(js, k)), getattr(ts, k).numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    img = rng.uniform(size=(3, 3, 8, 10)).astype(np.float32)
    want = jax.vmap(jexposure.apply_exposure)(js.params[:3], jnp.asarray(img))
    got = texposure.apply_exposure(ts.params[:3], torch.from_numpy(img))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-6, atol=1e-6)


def test_batched_photometric_loss_matches_jax_vmap():
    """Each view's SSIM is centred on its own mean, as under ``vmap``."""
    rng = np.random.default_rng(12)
    pred = rng.uniform(size=(3, 3, 40, 52)).astype(np.float32)
    pred[1] *= 0.3  # views of different means
    tgt = rng.uniform(size=(3, 3, 40, 52)).astype(np.float32)

    def jax_batched(p, t):
        losses, logs = jax.vmap(lambda a, b: jloss.photometric_loss(a, b, 0.2))(p, t)
        return jnp.mean(losses), jax.tree.map(jnp.mean, logs)

    (jl, jlogs), jg = jax.value_and_grad(jax_batched, has_aux=True)(
        jnp.asarray(pred), jnp.asarray(tgt))
    tp = torch.from_numpy(pred).requires_grad_()
    losses, tlogs = tloss.photometric_losses(tp, torch.from_numpy(tgt), 0.2)
    assert losses.shape == (3,)
    losses.mean().backward()
    assert set(tlogs) == set(jlogs)
    assert float(losses.mean().detach()) == pytest.approx(float(jl), rel=1e-5)
    for k in jlogs:
        assert float(tlogs[k].mean().detach()) == pytest.approx(float(jlogs[k]), rel=1e-5), k
    jg = np.asarray(jg)
    assert np.abs(jg - tp.grad.numpy()).max() <= 1e-4 * np.abs(jg).max()


# ---- coupled steps --------------------------------------------------------

def coupled_batched_steps(b, steps, exposure_and_depth=False, sparse=False,
                          jax_route="pallas_interpret", port_route="plain"):
    """``steps`` batched steps on both sides from the same scene, each step
    on the next ``b`` of five ring views (ids wrap, so a batch may hold one
    view twice). Returns both final states, exposures and the losses."""
    js = jax_scene(N, CAP, seed=3, scale=0.08, aniso=True)
    ts = port_scene(js)
    rng = np.random.default_rng(11)
    jall, tall, _ = ring_cameras(5)
    imgs = rng.uniform(size=(5, 3, H, W)).astype(np.float32)
    depths = rng.uniform(0.0, 0.3, size=(5, 1, H, W)).astype(np.float32)
    bgs = rng.uniform(size=(5, 3)).astype(np.float32)
    w_depth = 0.5 if exposure_and_depth else 0.0
    jtiling = JaxTiling(max_pairs=1 << 13, block=32, pair_grad_bf16=False,
                        tile_capacity=256)
    jcfg = jtrainer.TrainConfig(w_depth=w_depth, sparse_adam=sparse, batch_views=b,
                                rasterizer=jax_route, tiling=jtiling)
    tcfg = ttrainer.TrainConfig(w_depth=w_depth, sparse_adam=sparse, batch_views=b,
                                rasterizer=port_route,
                                tiling=TilingConfig(max_pairs=1 << 13, block=32,
                                                    tile_capacity=256))
    jstep = jtrainer.make_train_step(jcfg, 1.0, W, H)
    tstep = ttrainer.make_train_step(tcfg, 1.0, W, H)
    jadam = jopt.init_adam(js.params)
    tadam = adam_to_port(jadam)
    jexp, texp = jexposure.init_exposure(5), texposure.init_exposure(5, device="cpu")
    losses = []
    for step in range(steps):
        idx = [(step * b + k) % 5 for k in range(b)]
        if step % 3 == 2:
            idx[-1] = idx[0]  # one view twice in the batch
        ji = jnp.asarray(idx)
        ti = torch.tensor(idx)
        jcam = jax.tree.map(lambda x: x[ji], jall)
        tcam = type(tall)(*(getattr(tall, f.name)[ti] for f in dataclasses.fields(tall)))
        jargs = (jcam, jnp.asarray(imgs[idx]), jnp.asarray(bgs[idx]))
        targs = (tcam, torch.from_numpy(imgs[idx]), torch.from_numpy(bgs[idx]))
        if exposure_and_depth:
            js, jadam, jlogs, jeg = jstep(js, jadam, step, *jargs, jexp.params[ji],
                                          depth_target=jnp.asarray(depths[idx]))
            jexp = jexposure.exposure_update(jexp, ji, jeg, 0.001)
            ts, tadam, tlogs, teg = tstep(ts, tadam, step, *targs, texp.params[ti],
                                          depth_target=torch.from_numpy(depths[idx]))
            texp = texposure.exposure_update(texp, ti, teg, 0.001)
        else:
            js, jadam, jlogs = jstep(js, jadam, step, *jargs)
            ts, tadam, tlogs = tstep(ts, tadam, step, *targs)
        assert set(tlogs) - {"num_on_screen"} == set(jlogs)
        assert ("num_on_screen" in tlogs) == (port_route != "xla")
        assert int(tlogs["num_dropped_pairs"]) == int(jlogs["num_dropped_pairs"]) == 0
        assert int(tlogs["num_pairs"]) == int(jlogs["num_pairs"])
        losses.append((float(jlogs["loss"]), float(tlogs["loss"])))
    return js, ts, jexp, texp, np.array(losses)


def assert_coupled(js, ts, losses):
    jl, tl = losses[:, 0], losses[:, 1]
    assert np.all(np.isfinite(tl))
    assert np.max(np.abs(jl - tl) / jl) <= 1e-5
    start = jax_scene(N, CAP, seed=3, scale=0.08, aniso=True).params
    for k in PARAM_NAMES:
        a, b = np.asarray(getattr(js.params, k)), getattr(ts.params, k).numpy()
        moved = np.abs(a - np.asarray(getattr(start, k))).max()
        assert moved > 0, k
        d = np.abs(a - b)
        assert d.max() <= 2e-3 * moved, k
        assert np.quantile(d, 0.99) <= 2e-4 * moved, k
    np.testing.assert_array_equal(np.asarray(js.max_radii2d), ts.max_radii2d.numpy())
    np.testing.assert_array_equal(np.asarray(js.grad_count), ts.grad_count.numpy())
    acc = np.asarray(js.grad_accum)
    assert np.abs(acc - ts.grad_accum.numpy()).max() <= 1e-4 * np.abs(acc).max()


@pytest.mark.parametrize("b,exposure_and_depth,sparse",
                         [(2, True, False), (3, False, True)],
                         ids=["B2-exposure-depth", "B3-sparse-adam"])
def test_ten_coupled_batched_steps_match_jax(b, exposure_and_depth, sparse):
    js, ts, jexp, texp, losses = coupled_batched_steps(b, 10, exposure_and_depth, sparse)
    assert_coupled(js, ts, losses)
    assert float(ts.grad_count.max()) > 10  # several views per step counted
    if exposure_and_depth:
        np.testing.assert_allclose(np.asarray(jexp.params), texp.params.numpy(),
                                   atol=1e-6, rtol=0)


def test_batched_step_on_the_tiled_route_matches_jax():
    """``rasterizer: xla`` with two views per step: the port renders the
    views one at a time on its tiled route, JAX ``vmap``s its XLA path."""
    js, ts, _, _, losses = coupled_batched_steps(2, 4, jax_route="xla", port_route="xla")
    assert_coupled(js, ts, losses)
