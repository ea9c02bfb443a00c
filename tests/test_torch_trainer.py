"""The port's training loop against the JAX package.

- ``ViewSampler``: the JAX index sequence and state round trip.
- ``load_config``: each ``configs/*.yaml`` to the JAX loader's values, with ``--set`` overrides, apart from the mapped fields.
- A coupled loop: the port ``Trainer`` (route "plain") and the JAX
  ``Trainer`` (``rasterizer="pallas_interpret"``, f32 pair gradients) on the
  same views, scene and seed, the port's split noise replaying JAX's
  ``jax.random.split`` sequence; 60 steps at 64x48 with three densify
  events, an opacity reset, SH steps and two validations. Bounds: the loss
  at every logged step within 1e-5 relative (the bound of
  ``test_twenty_coupled_steps_match_jax``), the alive count at every logged
  step and every event's eight stats exactly, validation PSNR within 1e-4
  dB.
- Port-side counterparts of the JAX loop tests in ``tests/test_training.py``,
  and save -> restore -> continue equal to an uninterrupted run bit for bit.
"""

import dataclasses
import json
import math
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussian_splatting_lightning_tpu.data.dataset import ViewSampler as JaxSampler
from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import TilingConfig as JaxTiling
from gaussian_splatting_lightning_tpu.training import config as jconfig
from gaussian_splatting_lightning_tpu.training import densify as jdensify
from gaussian_splatting_lightning_tpu.training import optimizer as jopt
from gaussian_splatting_lightning_tpu.training import trainer as jtrainer
from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera
from gaussian_splatting_lightning_tpu_torch.data.dataset import ViewItem, ViewSampler
from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES, from_points
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.training import config as tconfig
from gaussian_splatting_lightning_tpu_torch.training import trainer as ttrainer
from gaussian_splatting_lightning_tpu_torch.training.densify import DensifyConfig
from gaussian_splatting_lightning_tpu_torch.training.optimizer import OptimizerConfig
from gaussian_splatting_lightning_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    find_resume_checkpoint,
    render_scene,
)
from tests.torch_parity import port_scene

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
QUIET = dict(log_fn=lambda *a: None)
NO_DENSIFY = DensifyConfig(densify_since=100, densify_until=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain kernels are loops of small ops: threads only add overhead,
    # and the test workers already share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gt_views(n_views=4, w=48, h=32, n_gt=40, seed=0):
    """Chunky opaque GT splats seen by a ring of cameras, rendered by the
    port (the JAX loop tests' ``_synthetic_views``)."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n_gt, 3)).astype(np.float32) * 0.8
    rgb = rng.uniform(0.2, 0.9, size=(n_gt, 3)).astype(np.float32)
    gt = from_points(xyz, rgb, capacity=n_gt, sh_degree=1, device="cpu")
    gt.params.scales = torch.full_like(gt.params.scales, float(np.log(0.12)))
    gt.params.opacity = torch.full_like(gt.params.opacity, 2.0)
    views = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        fwd = -np.array([np.cos(ang), 0.2, np.sin(ang)])
        fwd /= np.linalg.norm(fwd)
        pos = -4.0 * fwd
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], 0)
        cam = make_camera(np.concatenate([R, (-R @ pos)[:, None]], 1), 60.0, 60.0, w, h,
                          device="cpu")
        out, _ = render_scene(gt, cam, w, h, torch.zeros(3), TilingConfig(max_pairs=1 << 14))
        views.append(ViewItem(
            image=out.image.numpy(), viewmatrix=cam.viewmatrix.numpy(),
            projmatrix=cam.projmatrix.numpy(), campos=cam.campos.numpy(),
            tanfovx=float(cam.tanfovx), tanfovy=float(cam.tanfovy),
            background=np.zeros(3, np.float32), depth=out.depth.numpy()))
    return xyz, views


def init_scene(xyz, capacity=64, jitter=0.0, seed=1):
    xyz = xyz + np.random.default_rng(seed).normal(size=xyz.shape).astype(np.float32) * jitter
    return from_points(xyz, np.full((len(xyz), 3), 0.5, np.float32), capacity, 1, device="cpu")


def init_jax_scene(xyz, capacity=64):
    from gaussian_splatting_lightning_tpu.models import from_points as jax_from_points

    return jax_from_points(xyz, np.full((len(xyz), 3), 0.5, np.float32), capacity, 1)


def small_cfg(**kw):
    base = dict(num_iters=6, capacity=64, log_interval=100, valid_interval=10_000,
                checkpoint_interval=10_000, rasterizer="plain",
                tiling=TilingConfig(max_pairs=1 << 14), densify=NO_DENSIFY)
    return TrainConfig(**dict(base, **kw))


# ---- ViewSampler ----------------------------------------------------------

def test_view_sampler_matches_jax():
    js, ts = JaxSampler(7, seed=11), ViewSampler(7, seed=11)
    assert [ts.next_index() for _ in range(10)] == [js.next_index() for _ in range(10)]
    state = json.loads(json.dumps(ts.state()))
    assert state == json.loads(json.dumps(js.state()))
    resumed = ViewSampler(7, seed=0)
    resumed.set_state(state)
    want = js.next_batch(25)
    assert resumed.next_batch(25) == want == ts.next_batch(25)


# ---- config ---------------------------------------------------------------

def compare_config(port, jax_cfg, path="cfg"):
    """Every field of the port's dataclass against the JAX one's; the JAX
    fields the port lacks must be the ignored ones."""
    pfields = {f.name for f in dataclasses.fields(port)}
    jfields = {f.name for f in dataclasses.fields(jax_cfg)}
    assert jfields - pfields == tconfig.IGNORED.get(type(port).__name__, set()), path
    assert pfields <= jfields, path
    for name in pfields:
        a, b = getattr(port, name), getattr(jax_cfg, name)
        if dataclasses.is_dataclass(a):
            compare_config(a, b, f"{path}.{name}")
        elif name == "rasterizer":
            assert a == tconfig.RASTERIZERS[b], path
        else:
            assert a == b and type(a) is type(b), (f"{path}.{name}", a, b)


OVERRIDES = ["train.num_iters=77", "data.mask_folder=null", "train.optimizer.feature_lr=5e-5",
             "train.tiling.max_pairs=1048576", "train.densify.use_screensize_threshold=false",
             "run_name=override"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_matches_jax(path):
    want = jconfig.load_config(str(path), OVERRIDES)
    got = tconfig.load_config(str(path), OVERRIDES)
    compare_config(got, want)
    assert got.train.num_iters == 77 and got.train.optimizer.feature_lr == 5e-5


def test_load_config_refuses_unported_fields():
    """``train.rasterizer: xla`` loads to the tiled route, which reads
    ``tile_capacity`` and ``chunk`` (as JAX does), ``mesh_view`` and
    ``mesh_tile`` load as the JAX loader's (the mesh is ported), and an
    unknown route name is refused."""
    src = CONFIGS[0]
    cfg = tconfig.load_config(str(src), ["train.rasterizer=xla", "train.tiling.chunk=32",
                                         "train.tiling.tile_capacity=2048"])
    want = jconfig.load_config(str(src), ["train.rasterizer=xla", "train.tiling.chunk=32",
                                          "train.tiling.tile_capacity=2048"])
    assert cfg.train.rasterizer == want.train.rasterizer == "xla"
    assert (cfg.train.tiling.chunk, cfg.train.tiling.tile_capacity) == (32, 2048)
    compare_config(cfg, want)
    with pytest.raises(ValueError, match="rasterizer"):
        tconfig.load_config(str(src), ["train.rasterizer=triton"])
    for sets in (["mesh_view=2"], ["mesh_tile=4"]):
        got = tconfig.load_config(str(src), sets)
        compare_config(got, jconfig.load_config(str(src), sets))
        assert (got.mesh_view, got.mesh_tile) in ((2, None), (1, 4))
    with pytest.raises(KeyError, match="nonsense"):
        tconfig.load_config(str(src), ["train.nonsense=1"])
    cfg = tconfig.load_config(str(src), ["train.rasterizer=plain", "use_pallas=false",
                                         "train.tiling.chunk=64"])
    assert cfg.train.rasterizer == "plain"


# ---- the coupled loop -----------------------------------------------------

COUPLED_DENSIFY = dict(densify_since=10, densify_interval=10, densify_until=45,
                       densify_grad_threshold=5e-5, clone_size_threshold=0.1,
                       prune_opacity_threshold=0.005, prune_size_threshold=0.6,
                       prune_screensize_threshold=40.0, opacity_reset_interval=35,
                       sh_degree_step_interval=15)


def coupled_run(steps=60, batch_views=1):
    w, h = 64, 48
    xyz, views = gt_views(n_views=5, w=w, h=h, n_gt=60, seed=3)
    xyz0 = xyz + np.random.default_rng(4).normal(size=xyz.shape).astype(np.float32) * 0.05
    from gaussian_splatting_lightning_tpu.models import from_points as jax_from_points

    js = jax_from_points(xyz0, np.full((len(xyz0), 3), 0.5, np.float32), 256, 3)
    ts = port_scene(js)
    common = dict(num_iters=steps, capacity=256, log_interval=5, overflow_check_interval=5,
                  valid_interval=25, checkpoint_interval=10_000, seed=7,
                  batch_views=batch_views)
    jcfg = jtrainer.TrainConfig(
        rasterizer="pallas_interpret", densify=jdensify.DensifyConfig(**COUPLED_DENSIFY),
        tiling=JaxTiling(max_pairs=1 << 14, block=32, pair_grad_bf16=False),
        optimizer=jopt.OptimizerConfig(xyz_lr_max_steps=steps), **common)
    tcfg = TrainConfig(rasterizer="plain", densify=DensifyConfig(**COUPLED_DENSIFY),
                       tiling=TilingConfig(max_pairs=1 << 14, block=32),
                       optimizer=OptimizerConfig(xyz_lr_max_steps=steps), **common)
    train, valid = views[1:], views[:1]
    events = {"jax": [], "port": []}

    def recorder(side, fn):
        def wrapped(*a, **k):
            scene, adam, stats = fn(*a, **k)
            events[side].append({key: int(v) for key, v in stats.items()})
            return scene, adam, stats
        return wrapped

    valids = {"jax": [], "port": []}
    jtr = jtrainer.Trainer(jcfg, js, 4.0, train, valid, **QUIET)
    ttr = Trainer(tcfg, ts, 4.0, train, valid, **QUIET)
    key = [jax.random.PRNGKey(tcfg.seed)]

    def jax_noise():  # JAX's maybe_densify: key, sub = split(key); normal(sub)
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.array(jax.random.normal(sub, (256, 3), jnp.float32)))

    ttr.densify_noise = jax_noise
    for side, tr in (("jax", jtr), ("port", ttr)):
        orig = tr.validate
        tr.validate = lambda orig=orig, side=side: valids[side].append(orig()) or valids[side][-1]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrainer, "densify_step", recorder("jax", jtrainer.densify_step))
        mp.setattr(ttrainer, "densify_step", recorder("port", ttrainer.densify_step))
        jtr.train()
        ttr.train()
    finally:
        mp.undo()
    return jtr, ttr, events, valids


def test_coupled_loop_matches_jax():
    jtr, ttr, events, valids = coupled_run()
    jh, th = jtr.history, ttr.history
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(0, 60, 5))
    rel = [abs(a["loss"] - b["loss"]) / a["loss"] for a, b in zip(jh, th)]
    assert max(rel) <= 1e-5, rel
    assert [h["n_gaussians"] for h in th] == [h["n_gaussians"] for h in jh]
    assert len(events["port"]) == len(events["jax"]) == 3  # steps 20, 30, 40
    assert events["port"] == events["jax"]
    assert sum(e["n_cloned"] for e in events["port"]) > 0
    assert sum(e["n_split"] for e in events["port"]) > 0
    assert sum(e["n_pruned"] for e in events["port"]) > 0
    assert th[-1]["n_gaussians"] != th[0]["n_gaussians"]
    assert ttr.scene.active_sh_degree == int(jtr.scene.active_sh_degree) == 3
    assert len(valids["port"]) == len(valids["jax"]) == 2  # steps 25 and 50
    for a, b in zip(valids["jax"], valids["port"]):
        assert abs(a["valid_psnr"] - b["valid_psnr"]) <= 1e-4
    np.testing.assert_array_equal(np.asarray(jtr.scene.alive), ttr.scene.alive.numpy())
    assert th[-1]["loss"] < th[0]["loss"]


# ---- port-side counterparts of the JAX loop tests -------------------------

def test_coupled_batched_loop_matches_jax():
    """``batch_views=2``: 40 steps of two views each, densify events at 20
    and 30, an SH step, a validation; the bounds of
    ``test_coupled_loop_matches_jax``."""
    jtr, ttr, events, valids = coupled_run(steps=40, batch_views=2)
    jh, th = jtr.history, ttr.history
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(0, 40, 5))
    rel = [abs(a["loss"] - b["loss"]) / a["loss"] for a, b in zip(jh, th)]
    assert max(rel) <= 1e-5, rel
    assert [h["n_gaussians"] for h in th] == [h["n_gaussians"] for h in jh]
    assert len(events["port"]) == len(events["jax"]) == 2  # steps 20, 30
    assert events["port"] == events["jax"]
    assert sum(e["n_cloned"] + e["n_split"] for e in events["port"]) > 0
    assert len(valids["port"]) == len(valids["jax"]) == 1  # step 25
    assert abs(valids["jax"][0]["valid_psnr"] - valids["port"][0]["valid_psnr"]) <= 1e-4
    np.testing.assert_array_equal(np.asarray(jtr.scene.alive), ttr.scene.alive.numpy())
    np.testing.assert_array_equal(np.asarray(jtr.scene.grad_count),
                                  ttr.scene.grad_count.numpy())
    # two views per step: 80 draws of the sampler on both sides
    assert ttr._sampler.state() == jtr._sampler.state()
    assert th[-1]["loss"] < th[0]["loss"]


def test_trainer_refuses_unported_modes():
    """A ``mesh`` that is not a ``parallel.Mesh`` is refused (the mesh
    itself is ported: ``tests/test_torch_parallel.py``)."""
    xyz, views = gt_views(n_views=2)
    with pytest.raises(TypeError, match="mesh"):
        Trainer(small_cfg(), init_scene(xyz), 4.0, views, mesh=object(), **QUIET)


def test_tile_overflow_branch_raises():
    """A checked step's tile overflow grows ``tile_capacity`` as the JAX
    loop does: doubled until it holds the deepest tile seen, beside a pair
    budget growth when pairs dropped too, with the JAX log lines (without
    JAX's " (recompile)")."""
    xyz, views = gt_views(n_views=2)
    for dropped, overflow in [(0, 3), (5, 3), (0, 200), (4, 0)]:
        logged = {"jax": [], "port": []}
        tr = Trainer(small_cfg(rasterizer="xla", tiling=TilingConfig(
            max_pairs=1 << 14, tile_capacity=64)), init_scene(xyz), 4.0, views,
            log_fn=logged["port"].append)
        jcfg = jtrainer.TrainConfig(rasterizer="xla", capacity=64, tiling=JaxTiling(
            max_pairs=1 << 14, tile_capacity=64), densify=jdensify.DensifyConfig(
            densify_since=100, densify_until=0))
        jtr = jtrainer.Trainer(jcfg, init_jax_scene(xyz), 4.0, views,
                               log_fn=logged["jax"].append)
        logs = {"num_dropped_pairs": float(dropped), "num_tile_overflow": float(overflow),
                "num_pairs": 10.0}
        tr._maybe_grow_budgets(logs)
        jtr._maybe_grow_budgets(logs)
        assert tr.cfg.tiling.tile_capacity == jtr.cfg.tiling.tile_capacity
        assert tr.cfg.tiling.max_pairs == jtr.cfg.tiling.max_pairs
        assert logged["port"] == [m.replace(" (recompile)", "") for m in logged["jax"]]
        assert (tr.cfg.tiling.tile_capacity > 64) == (overflow > 0)


def test_adaptive_pair_budget_grows_and_shrinks():
    xyz, views = gt_views(n_views=3)
    grow = Trainer(small_cfg(tiling=TilingConfig(max_pairs=128, block=16),
                             overflow_check_interval=1),
                   init_scene(xyz), 4.0, views, **QUIET)
    grow.train()
    assert grow.cfg.tiling.max_pairs > 128  # grew past the tiny initial budget
    logged = []
    shrink = Trainer(small_cfg(num_iters=12, overflow_check_interval=1, shrink_patience=3,
                               tiling=TilingConfig(max_pairs=1 << 17)),
                     init_scene(xyz), 4.0, views, log_fn=logged.append)
    shrink.train()
    assert 16384 <= shrink.cfg.tiling.max_pairs < 1 << 17
    assert any("shrinking" in m for m in logged)


def poison(tr, when, value=np.nan):
    orig = tr._train_step
    calls = {"n": 0}

    def poisoned(*a, **k):
        scene, adam, logs = orig(*a, **k)
        calls["n"] += 1
        if when(calls["n"]):
            logs = dict(logs, loss=torch.tensor(value, dtype=torch.float32))
        return scene, adam, logs

    tr._train_step = poisoned


def test_nan_loss_rolls_back_to_checkpoint(tmp_path):
    xyz, views = gt_views(n_views=3)
    tr = Trainer(small_cfg(num_iters=20, checkpoint_interval=5, adaptive_pairs=False,
                           overflow_check_interval=1),
                 init_scene(xyz), 4.0, views, out_dir=str(tmp_path), **QUIET)
    poison(tr, lambda n: n == 13)  # after the step-5 and step-10 checkpoints
    tr.train()
    assert tr._nan_rollbacks == 1
    assert tr.step > 10  # resumed from ckpt-10 and kept going
    assert math.isfinite(tr.history[-1]["loss"])
    assert (tmp_path / f"ckpt-{tr.step:08d}").exists()  # the final state


def test_nan_loss_without_checkpoint_aborts():
    xyz, views = gt_views(n_views=2)
    tr = Trainer(small_cfg(num_iters=5, adaptive_pairs=False, overflow_check_interval=1),
                 init_scene(xyz), 4.0, views, **QUIET)
    poison(tr, lambda n: True, np.inf)
    with pytest.raises(RuntimeError, match="non-finite loss"):
        tr.train()


def test_save_restore_continue_equals_uninterrupted_run(tmp_path):
    """A checkpoint holds the scene, Adam, the step, exposure, the sampler
    and the noise generator, so a restored run replays the original's tail
    bit for bit (densify events with splits included)."""
    xyz, views = gt_views(n_views=3)

    def make(out):
        cfg = small_cfg(num_iters=12, log_interval=1, checkpoint_interval=5,
                        adaptive_pairs=False, use_exposure=True,
                        densify=DensifyConfig(densify_since=1, densify_interval=3,
                                              densify_until=12, densify_grad_threshold=0.0,
                                              clone_size_threshold=0.02))
        return Trainer(cfg, init_scene(xyz), 4.0, views, out_dir=str(out), **QUIET)

    tr_a = make(tmp_path / "a")
    tr_a.train()
    losses_a = {h["step"]: h["loss"] for h in tr_a.history}
    tr_b = make(tmp_path / "b")
    tr_b.restore_checkpoint(tmp_path / "a" / "ckpt-00000005")
    assert tr_b.step == 5
    tr_b.train(num_iters=7)  # steps 5..11, replaying run A's tail
    assert [h["step"] for h in tr_b.history] == list(range(5, 12))
    for h in tr_b.history:
        assert h["loss"] == losses_a[h["step"]], h["step"]
    for k in PARAM_NAMES:
        assert torch.equal(getattr(tr_b.scene.params, k), getattr(tr_a.scene.params, k)), k
        assert torch.equal(getattr(tr_b.adam.mu, k), getattr(tr_a.adam.mu, k)), k
        assert torch.equal(getattr(tr_b.adam.nu, k), getattr(tr_a.adam.nu, k)), k
    for k in ("alive", "max_radii2d", "grad_accum", "grad_count"):
        assert torch.equal(getattr(tr_b.scene, k), getattr(tr_a.scene, k)), k
    assert torch.equal(tr_b.exposure.params, tr_a.exposure.params)
    assert torch.equal(tr_b.generator.get_state(), tr_a.generator.get_state())
    assert tr_a.scene.n_alive() > 40  # the densify events grew the scene


def test_checkpoint_retention_keeps_last_n(tmp_path):
    xyz, views = gt_views(n_views=2)
    cfg = small_cfg(num_iters=10, checkpoint_interval=2, keep_last_ckpts=2,
                    adaptive_pairs=False)
    tr = Trainer(cfg, init_scene(xyz), 4.0, views, out_dir=str(tmp_path), **QUIET)
    tr.train()
    assert sorted(p.name for p in tmp_path.glob("ckpt-*")) == ["ckpt-00000008",
                                                               "ckpt-00000010"]
    tr2 = Trainer(cfg, init_scene(xyz), 4.0, views, out_dir=str(tmp_path), **QUIET)
    tr2.restore_checkpoint(tmp_path / "ckpt-00000010")
    assert tr2.step == 10
    assert torch.equal(tr2.scene.params.xyz, tr.scene.params.xyz)


def test_restore_checkpoint_saved_without_exposure(tmp_path):
    xyz, views = gt_views(n_views=2)
    base = dict(num_iters=2, adaptive_pairs=False)
    tr_a = Trainer(small_cfg(**base), init_scene(xyz), 4.0, views, out_dir=str(tmp_path / "a"),
                   **QUIET)
    tr_a.train()
    tr_b = Trainer(small_cfg(use_exposure=True, **base), init_scene(xyz), 4.0, views, **QUIET)
    fresh = tr_b.exposure.params.clone()
    tr_b.restore_checkpoint(tmp_path / "a" / "ckpt-00000002")
    assert tr_b.step == 2
    assert torch.equal(tr_b.exposure.params, fresh)  # fresh init kept
    assert torch.equal(tr_b.scene.params.xyz, tr_a.scene.params.xyz)
    # a checkpoint saved WITH exposure restores it
    tr_c = Trainer(small_cfg(use_exposure=True, **base), init_scene(xyz), 4.0, views,
                   out_dir=str(tmp_path / "c"), **QUIET)
    tr_c.train()
    tr_d = Trainer(small_cfg(use_exposure=True, **base), init_scene(xyz), 4.0, views, **QUIET)
    tr_d.restore_checkpoint(tmp_path / "c" / "ckpt-00000002")
    assert torch.equal(tr_d.exposure.params, tr_c.exposure.params)
    assert not torch.equal(tr_d.exposure.params, fresh)


def test_validate_regrows_budget_on_drops(tmp_path):
    xyz, views = gt_views(n_views=2, w=64, h=48)
    scene = init_scene(xyz)
    # chunky opaque splats so every (splat, tile) pair materializes
    scene.params.scales = torch.full_like(scene.params.scales, float(np.log(0.3)))
    scene.params.opacity = torch.full_like(scene.params.opacity, 3.0)
    logged = []
    tr = Trainer(small_cfg(num_iters=1, adaptive_pairs=False,
                           tiling=TilingConfig(max_pairs=64, block=16)),
                 scene, 4.0, views, valid_views=views[:1], out_dir=str(tmp_path),
                 log_fn=logged.append)
    metrics = tr.validate()
    assert any("re-rendering" in m for m in logged), logged
    assert metrics["valid_num_dropped_pairs"] == 0
    assert tr.cfg.tiling.max_pairs == 64  # the train budget is untouched
    n_msgs = len(logged)
    tr.validate()
    assert not any("re-rendering" in m for m in logged[n_msgs:])
    assert (tmp_path / "valid0-00000000.jpg").exists()
    assert (tmp_path / "point_cloud-00000000.ply").exists()


def test_find_resume_checkpoint_picks_newest_run(tmp_path):
    assert find_resume_checkpoint(tmp_path) is None
    old = tmp_path / "z-old-run"
    for step in (5, 99):
        (old / f"ckpt-{step:08d}").mkdir(parents=True)
    new = tmp_path / "a-new-run"
    for step in (3, 12):
        (new / f"ckpt-{step:08d}").mkdir(parents=True)
    now = time.time()
    for p in old.glob("ckpt-*"):
        os.utime(p, (now - 1000, now - 1000))
    for p in new.glob("ckpt-*"):
        os.utime(p, (now, now))
    assert find_resume_checkpoint(tmp_path) == new / "ckpt-00000012"
    assert find_resume_checkpoint(tmp_path) == jtrainer.find_resume_checkpoint(tmp_path)


def test_end_to_end_training_improves():
    """120 steps with two densify events and SH warm-up from jittered GT
    centres. Bounds: the logged loss falls by 20% and the held-out PSNR rises
    by 0.5 dB (measured: -29%, +0.95 dB; the JAX ``Trainer`` with its XLA
    rasterizer on the same views: -30% and +1.6 dB on the logged view)."""
    xyz, views = gt_views(n_views=6, w=64, h=48)
    cfg = small_cfg(num_iters=120, capacity=128, log_interval=20,
                    densify=DensifyConfig(densify_since=20, densify_interval=40,
                                          densify_until=100, opacity_reset_interval=10_000,
                                          sh_degree_step_interval=50),
                    optimizer=OptimizerConfig(xyz_lr_max_steps=120))
    tr = Trainer(cfg, init_scene(xyz, capacity=128, jitter=0.05), 4.0, views[1:],
                 valid_views=views[:1], **QUIET)
    before = tr.validate()["valid_psnr"]
    tr.train()
    assert tr.history[-1]["loss"] < tr.history[0]["loss"] * 0.8
    assert tr.scene.active_sh_degree == 1  # steps 50 and 100, capped at 1
    assert tr.scene.n_alive() > 40  # the densify events added splats
    assert tr.validate()["valid_psnr"] > before + 0.5


def test_depth_regularization_loss_decreases():
    xyz, views = gt_views(n_views=4, w=48, h=32)
    cfg = small_cfg(num_iters=50, log_interval=10, w_depth=0.2,
                    optimizer=OptimizerConfig(xyz_lr_max_steps=50))
    tr = Trainer(cfg, init_scene(xyz, jitter=0.05), 4.0, views, **QUIET)
    tr.train()
    assert "depth_l1" in tr.history[0]
    assert tr.history[-1]["depth_l1"] < tr.history[0]["depth_l1"] * 0.8
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]
