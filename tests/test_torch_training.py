"""The port's training step and its parts against the JAX package.

Parts: the learning-rate schedules, ``adam_update`` (with and without the
sparse ``visible`` mask), ``accumulate_stats``, exposure, and
``photometric_loss``'s value and gradient. Then 20 coupled steps of the
port's ``make_train_step`` (``rasterizer="plain"``) against the JAX
``make_train_step`` (``rasterizer="pallas_interpret"``, f32 pair gradients)
from the same scene, Adam state and target, at 64x48 with 500 splats.

Bounds of the coupled steps, and why:
- loss at every step within 1e-5 relative (measured <= 6.4e-7): the
  renders agree to a few ulp and the L1/SSIM sums to a few more;
- every parameter group moved, and its largest |port - JAX| after 20 steps
  is within 2e-3 of its largest move over the run (measured <= 4.6e-4),
  its 99th percentile within 2e-4 of it (measured <= 3.6e-5): Adam divides
  each gradient by its own running magnitude, so a splat whose gradient is
  near zero turns ulp-level gradient differences into update differences of
  the order of its learning rate;
- radii and view counts identical, ``grad_accum`` within 1e-4 of its largest
  value (measured <= 6e-6), exposure within 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussian_splatting_lightning_tpu.models.gaussians import GaussianParams as JaxParams
from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import TilingConfig as JaxTiling
from gaussian_splatting_lightning_tpu.training import densify as jdensify
from gaussian_splatting_lightning_tpu.training import exposure as jexposure
from gaussian_splatting_lightning_tpu.training import loss as jloss
from gaussian_splatting_lightning_tpu.training import optimizer as jopt
from gaussian_splatting_lightning_tpu.training import schedule as jsched
from gaussian_splatting_lightning_tpu.training import trainer as jtrainer
from gaussian_splatting_lightning_tpu_torch import interop
from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES, GaussianParams
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.training import densify as tdensify
from gaussian_splatting_lightning_tpu_torch.training import exposure as texposure
from gaussian_splatting_lightning_tpu_torch.training import loss as tloss
from gaussian_splatting_lightning_tpu_torch.training import optimizer as topt
from gaussian_splatting_lightning_tpu_torch.training import schedule as tsched
from gaussian_splatting_lightning_tpu_torch.training import trainer as ttrainer
from tests.torch_parity import BG, cameras, jax_scene, port_scene

W, H, N, CAP, STEPS = 64, 48, 500, 512, 20
SHAPES = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3),
          "opacity": (1,), "scales": (3,), "quats": (4,)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain kernels are loops of small ops: threads only add overhead,
    # and the test workers already share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(rng, n=40):
    return {k: rng.normal(size=(n,) + s).astype(np.float32) for k, s in SHAPES.items()}


def to_jax(d):
    return JaxParams(**{k: jnp.asarray(v) for k, v in d.items()})


def to_port(d):
    return GaussianParams(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def adam_to_port(jadam):
    return interop.adam_from_numpy(
        int(jadam.count), {k: np.asarray(getattr(jadam.mu, k)) for k in PARAM_NAMES},
        {k: np.asarray(getattr(jadam.nu, k)) for k in PARAM_NAMES}, device="cpu")


def test_schedules_match_jax():
    cases = [
        (jsched.warmup_exp_decay_schedule(1.6e-4, 1.6e-6, 30_000),
         tsched.warmup_exp_decay_schedule(1.6e-4, 1.6e-6, 30_000)),
        (jsched.warmup_exp_decay_schedule(5e-3, 5e-5, 1000, 100, 0.01),
         tsched.warmup_exp_decay_schedule(5e-3, 5e-5, 1000, 100, 0.01)),
        (jsched.constant_schedule(0.0025), tsched.constant_schedule(0.0025)),
    ]
    for jfn, tfn in cases:
        for step in (0, 1, 7, 50, 99, 100, 500, 999, 1000, 20_000, 40_000):
            want, got = float(jfn(step)), tfn(step)
            assert got == pytest.approx(want, rel=2.5e-7, abs=0), step  # 2 ulp of f32


@pytest.mark.parametrize("sparse", [False, True])
def test_adam_update_matches_jax(sparse):
    rng = np.random.default_rng(21)
    params = random_params(rng)
    cfg_j, cfg_t = jopt.OptimizerConfig(), topt.OptimizerConfig()
    sched_j, sched_t = jopt.make_lr_schedules(cfg_j, 2.5), topt.make_lr_schedules(cfg_t, 2.5)
    jp, tp = to_jax(params), to_port(params)
    jadam = jopt.init_adam(jp)
    tadam = adam_to_port(jadam)
    for step in range(3):
        grads = random_params(rng)
        vis = rng.uniform(size=40) > 0.3 if sparse else None
        jp, jadam = jopt.adam_update(jp, to_jax(grads), jadam, sched_j, cfg_j, step,
                                     visible=None if vis is None else jnp.asarray(vis))
        tp, tadam = topt.adam_update(tp, to_port(grads), tadam, sched_t, cfg_t, step,
                                     visible=None if vis is None else torch.from_numpy(vis))
    assert tadam.count == int(jadam.count) == 3
    for k in PARAM_NAMES:
        for a, b in ((jp, tp), (jadam.mu, tadam.mu), (jadam.nu, tadam.nu)):
            np.testing.assert_allclose(np.asarray(getattr(a, k)), getattr(b, k).numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_adam_visible_mask_freezes_hidden_rows():
    rng = np.random.default_rng(4)
    params = random_params(rng, n=6)
    tp = to_port(params)
    tadam = topt.init_adam(tp)
    vis = torch.tensor([True, False, True, False, True, True])
    new, state = topt.adam_update(tp, to_port(random_params(rng, n=6)), tadam,
                                  topt.make_lr_schedules(topt.OptimizerConfig(), 1.0),
                                  topt.OptimizerConfig(), 0, visible=vis)
    for k in PARAM_NAMES:
        assert torch.equal(getattr(new, k)[~vis], getattr(tp, k)[~vis]), k
        assert not getattr(state.mu, k)[~vis].any(), k
        assert not torch.equal(getattr(new, k)[vis], getattr(tp, k)[vis]), k


def test_accumulate_stats_matches_jax():
    rng = np.random.default_rng(8)
    js = jax_scene(60, 64, seed=1)
    js = dataclasses.replace(js, max_radii2d=jnp.asarray(rng.uniform(0, 5, size=64).astype(np.float32)))
    ts = port_scene(js)
    ts.max_radii2d = torch.from_numpy(np.asarray(js.max_radii2d).copy())
    radii = np.where(rng.uniform(size=64) > 0.4, rng.uniform(0, 9, size=64), 0).astype(np.float32)
    grads = rng.normal(size=(64, 2)).astype(np.float32)
    for _ in range(2):
        js = jdensify.accumulate_stats(js, jnp.asarray(radii), jnp.asarray(grads))
        ts = tdensify.accumulate_stats(ts, torch.from_numpy(radii), torch.from_numpy(grads))
    for k in ("max_radii2d", "grad_accum", "grad_count"):
        np.testing.assert_allclose(np.asarray(getattr(js, k)), getattr(ts, k).numpy(),
                                   rtol=1e-6, atol=0, err_msg=k)


def test_exposure_matches_jax():
    rng = np.random.default_rng(9)
    js, ts = jexposure.init_exposure(3), texposure.init_exposure(3, device="cpu")
    np.testing.assert_array_equal(np.asarray(js.params), ts.params.numpy())
    img = rng.uniform(size=(3, 8, 10)).astype(np.float32)
    for idx in (1, 2, 1):
        g = rng.normal(size=(3, 4)).astype(np.float32)
        js = jexposure.exposure_update(js, idx, jnp.asarray(g), 0.01)
        ts = texposure.exposure_update(ts, idx, torch.from_numpy(g), 0.01)
    assert ts.count == int(js.count) == 3
    for k in ("params", "mu", "nu"):
        np.testing.assert_allclose(np.asarray(getattr(js, k)), getattr(ts, k).numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(
        np.asarray(jexposure.apply_exposure(js.params[1], jnp.asarray(img))),
        texposure.apply_exposure(ts.params[1], torch.from_numpy(img)).numpy(),
        rtol=1e-6, atol=1e-6)


def test_photometric_loss_value_and_gradient_match_jax():
    rng = np.random.default_rng(12)
    pred = rng.uniform(size=(3, 40, 52)).astype(np.float32)
    tgt = rng.uniform(size=(3, 40, 52)).astype(np.float32)
    (jl, jlogs), jg = jax.value_and_grad(jloss.photometric_loss, has_aux=True)(
        jnp.asarray(pred), jnp.asarray(tgt), 0.2)
    tp = torch.from_numpy(pred).requires_grad_()
    tl, tlogs = tloss.photometric_loss(tp, torch.from_numpy(tgt), 0.2)
    tl.backward()
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert float(tlogs[k].detach()) == pytest.approx(float(jlogs[k]), rel=1e-5), k
    jg = np.asarray(jg)
    assert np.abs(jg - tp.grad.numpy()).max() <= 1e-4 * np.abs(jg).max()


def coupled_steps(block, depth_and_exposure):
    """STEPS steps on both sides; returns both final states and losses."""
    js = jax_scene(N, CAP, seed=3, scale=0.08, aniso=True)
    ts = port_scene(js)
    jc, tc = cameras(W, H)
    rng = np.random.default_rng(11)
    img = rng.uniform(size=(3, H, W)).astype(np.float32)
    depth = rng.uniform(0.0, 0.3, size=(1, H, W)).astype(np.float32)
    w_depth = 0.5 if depth_and_exposure else 0.0
    jcfg = jtrainer.TrainConfig(
        w_depth=w_depth, rasterizer="pallas_interpret",
        tiling=JaxTiling(max_pairs=1 << 13, block=block, pair_grad_bf16=False))
    tcfg = ttrainer.TrainConfig(w_depth=w_depth, rasterizer="plain",
                                tiling=TilingConfig(max_pairs=1 << 13, block=block))
    jstep = jtrainer.make_train_step(jcfg, 1.0, W, H)
    tstep = ttrainer.make_train_step(tcfg, 1.0, W, H)
    jadam = jopt.init_adam(js.params)
    tadam = adam_to_port(jadam)
    jexp, texp = jexposure.init_exposure(2), texposure.init_exposure(2, device="cpu")
    jkw = {"depth_target": jnp.asarray(depth)} if depth_and_exposure else {}
    tkw = {"depth_target": torch.from_numpy(depth)} if depth_and_exposure else {}
    jbg, tbg = jnp.asarray(BG), torch.from_numpy(BG)
    losses = []
    for step in range(STEPS):
        if depth_and_exposure:
            js, jadam, jlogs, jeg = jstep(js, jadam, step, jc, jnp.asarray(img), jbg,
                                          jexp.params[1], **jkw)
            jexp = jexposure.exposure_update(jexp, 1, jeg, 0.001)
            ts, tadam, tlogs, teg = tstep(ts, tadam, step, tc, torch.from_numpy(img), tbg,
                                          texp.params[1], **tkw)
            texp = texposure.exposure_update(texp, 1, teg, 0.001)
        else:
            js, jadam, jlogs = jstep(js, jadam, step, jc, jnp.asarray(img), jbg)
            ts, tadam, tlogs = tstep(ts, tadam, step, tc, torch.from_numpy(img), tbg)
        assert set(tlogs) == set(jlogs) | {"num_on_screen"}
        assert 0 < int(tlogs["num_on_screen"]) <= int(tlogs["n_gaussians"])
        assert int(tlogs["num_dropped_pairs"]) == int(jlogs["num_dropped_pairs"]) == 0
        assert int(tlogs["num_pairs"]) == int(jlogs["num_pairs"])
        losses.append((float(jlogs["loss"]), float(tlogs["loss"])))
    return js, ts, jexp, texp, np.array(losses)


@pytest.mark.parametrize("block,depth_and_exposure",
                         [(16, False), (32, False), (32, True)],
                         ids=["block16", "block32", "block32-depth-exposure"])
def test_twenty_coupled_steps_match_jax(block, depth_and_exposure):
    js, ts, jexp, texp, losses = coupled_steps(block, depth_and_exposure)
    jl, tl = losses[:, 0], losses[:, 1]
    assert np.all(np.isfinite(tl))
    assert np.max(np.abs(jl - tl) / jl) <= 1e-5
    assert tl[-1] < tl[0]  # the steps train
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
    if depth_and_exposure:
        np.testing.assert_allclose(np.asarray(jexp.params), texp.params.numpy(), atol=1e-6, rtol=0)


def test_eval_step_matches_jax():
    js = jax_scene(N, CAP, seed=3, scale=0.08, aniso=True)
    ts = port_scene(js)
    jc, tc = cameras(W, H)
    img = np.random.default_rng(2).uniform(size=(3, H, W)).astype(np.float32)
    jeval = jtrainer.make_eval_step(jtrainer.TrainConfig(
        rasterizer="pallas_interpret",
        tiling=JaxTiling(max_pairs=1 << 13, block=32, pair_grad_bf16=False)), W, H)
    teval = ttrainer.make_eval_step(ttrainer.TrainConfig(
        rasterizer="plain", tiling=TilingConfig(max_pairs=1 << 13, block=32)), W, H)
    jimg, jdepth, jlogs = jeval(js, jc, jnp.asarray(img), jnp.asarray(BG))
    timg, tdepth, tlogs = teval(ts, tc, torch.from_numpy(img), torch.from_numpy(BG))
    np.testing.assert_allclose(np.asarray(jimg), timg.numpy(), atol=2e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(jdepth), tdepth.numpy(), atol=2e-4, rtol=0)
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert float(tlogs[k]) == pytest.approx(float(jlogs[k]), rel=1e-5, abs=1e-6), k


def test_unknown_rasterizer_is_refused():
    with pytest.raises(ValueError):
        ttrainer.make_train_step(ttrainer.TrainConfig(rasterizer="pallas"), 1.0, W, H)
