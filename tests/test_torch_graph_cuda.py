"""Captured graphs (``utils/graph.py``) against eager, on the card.

- The serving render (``make_render``) replayed on two cameras gives the
  eager render's bits: image, radii, depth, pair counts.
- The eval step replayed gives the eager eval step's bits.
- The train step replayed for 6 steps (one view; ``sparse_adam`` with
  exposure and a depth target; two views) against ``capture=False`` from the
  same start: each loss within 1e-6 relative, each parameter and moment
  column within 1e-6 of its largest |eager| value after the last step (the
  autograd of gathers and ``index_add_`` add with atomics, so the last bit
  may differ from run to run), the densification counts exact.
- A replay adds the launches its capture recorded (K1-K4 once, K5 twice a
  step); a capture launches nothing of its own.
- A function that reads a value back to the host cannot be captured: the
  capture raises.
- The ``Trainer`` on the captured step: a NaN loss rolls back to the last
  checkpoint and carries on; a run resumed from a checkpoint logs the
  uninterrupted run's losses within 1e-6.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip. On the
card:

    python -m pytest tests/test_torch_graph_cuda.py -q

This file imports no JAX: the machine with the card has none.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from gaussian_splatting_lightning_tpu_torch import interop
from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera, stack_cameras
from gaussian_splatting_lightning_tpu_torch.data.dataset import ViewItem
from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
from gaussian_splatting_lightning_tpu_torch.ops import _build
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.training import exposure as texposure
from gaussian_splatting_lightning_tpu_torch.training import trainer
from gaussian_splatting_lightning_tpu_torch.training.densify import DensifyConfig
from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam
from gaussian_splatting_lightning_tpu_torch.utils import graph

pytestmark = pytest.mark.cuda

W, H = 128, 96
TILING = TilingConfig(max_pairs=1 << 16, block=32)
STEP_KERNELS = {"expand_pairs": 1, "composite_fwd": 1, "composite_bwd": 1,
                "segment_sum": 1, "blur": 2}


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return interop.synthetic_scene(4000, 4096, sh_degree=3, aniso=True, scale=0.03,
                                   seed=11)


def ring_cams(n, w=W, h=H):
    cams = []
    for i in range(n):
        a = 2 * math.pi * i / 8
        rot = np.array([[math.cos(a), 0, -math.sin(a)], [0, 1, 0],
                        [math.sin(a), 0, math.cos(a)]])
        pose = np.concatenate([rot, [[0.0], [0.0], [4.0]]], 1)
        cams.append(make_camera(pose, w * 0.7, w * 0.7, w, h))
    return cams


def clone_scene(s):
    return dataclasses.replace(
        s, params=type(s.params)(**{k: getattr(s.params, k).clone() for k in PARAM_NAMES}),
        alive=s.alive.clone(), max_radii2d=s.max_radii2d.clone(),
        grad_accum=s.grad_accum.clone(), grad_count=s.grad_count.clone())


def col_close(got, want, tol=1e-6):
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    scale = want.abs().amax(dim=0).clamp_min(1e-30)
    return float(((got - want).abs().amax(dim=0) / scale).max()) <= tol


def test_captured_render_equals_eager(scene):
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    render = trainer.make_render(W, H, TILING)
    eager = trainer.make_render(W, H, TILING, capture=False)
    for i, cam in enumerate(ring_cams(2)):
        want, want_stats = eager(scene, cam, bg)
        _build.reset_launch_counts()
        got, stats = render(scene, cam, bg)
        torch.cuda.synchronize()
        runs = 2 if i == 0 else 1  # the first call warms up, captures and replays
        assert _build.launches["expand_pairs"] == _build.launches["composite_fwd"] == runs
        for f in ("image", "radii", "depth"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for k in ("num_pairs", "num_dropped_pairs", "num_binned_pairs"):
            assert int(stats[k]) == int(want_stats[k]), k
    assert render.captured.captures == 1


def test_captured_eval_step_equals_eager(scene):
    cam = ring_cams(1)[0]
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    target = torch.rand(3, H, W, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    cfg = trainer.TrainConfig(tiling=TILING)
    want = trainer.make_eval_step(cfg, W, H, capture=False)(scene, cam, target, bg)
    step = trainer.make_eval_step(cfg, W, H)
    for _ in range(2):
        got = step(scene, cam, target, bg)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert {k: float(v) for k, v in got[2].items()} == {
            k: float(v) for k, v in want[2].items()}


CASES = {"one-view": (1, False, False), "sparse-exposure-depth": (1, True, True),
         "two-views": (2, False, False)}


@pytest.mark.parametrize("case", list(CASES))
def test_captured_train_step_equals_eager(scene, case):
    b, sparse, extra = CASES[case]
    cams = ring_cams(3)
    gen = torch.Generator(device="cuda").manual_seed(1)
    imgs = torch.rand(3, 3, H, W, device="cuda", generator=gen)
    depths = torch.rand(3, 1, H, W, device="cuda", generator=gen) * 0.3
    bgs = torch.rand(3, 3, device="cuda", generator=gen)
    cfg = trainer.TrainConfig(tiling=TILING, batch_views=b, sparse_adam=sparse,
                              w_depth=0.5 if extra else 0.0)
    steps = {"eager": trainer.make_train_step(cfg, 1.0, W, H, capture=False),
             "captured": trainer.make_train_step(cfg, 1.0, W, H)}
    state = {k: {"scene": clone_scene(scene), "adam": init_adam(scene.params),
                 "exp": texposure.init_exposure(3, device="cuda"), "loss": []}
             for k in steps}
    for t in range(6):
        idx = [(t + v) % 3 for v in range(b)]
        if b == 1:
            i = idx[0]
            args = [cams[i], imgs[i], bgs[i]]
            kw = {"depth_target": depths[i]} if extra else {}
        else:
            i = torch.tensor(idx, device="cuda")
            args = [stack_cameras([cams[j] for j in idx]), imgs[idx], bgs[idx]]
            kw = {}
        for name, fn in steps.items():
            st = state[name]
            ex = [st["exp"].params[i]] if extra else []
            _build.reset_launch_counts()
            out = fn(st["scene"], st["adam"], t, *args, *ex, **kw)
            torch.cuda.synchronize()
            # the first captured call: one eager warm-up, then a replay; the
            # capture between them launches nothing
            runs = 2 if name == "captured" and t == 0 else 1
            want = {k: runs * n for k, n in STEP_KERNELS.items()}
            assert dict(_build.launches) == want, (name, t, _build.launches)
            st["scene"], st["adam"], logs = out[:3]
            if extra:
                st["exp"] = texposure.exposure_update(st["exp"], i, out[3], 0.001)
            st["loss"].append(float(logs["loss"]))
            assert int(logs["num_dropped_pairs"]) == 0
    cap, eag = state["captured"], state["eager"]
    assert steps["captured"].captured.captures == 1
    rel = [abs(a - b) / abs(b) for a, b in zip(cap["loss"], eag["loss"])]
    assert max(rel) <= 1e-6, rel
    assert cap["adam"].count == eag["adam"].count == 6
    for k in PARAM_NAMES:
        for get in (lambda s: s["scene"].params, lambda s: s["adam"].mu,
                    lambda s: s["adam"].nu):
            assert col_close(getattr(get(cap), k), getattr(get(eag), k)), k
    assert torch.equal(cap["scene"].grad_count, eag["scene"].grad_count)
    assert torch.equal(cap["scene"].max_radii2d, eag["scene"].max_radii2d)
    if extra:
        assert col_close(cap["exp"].params, eag["exp"].params)
    # the step's scene is the graph's own buffers, updated in place
    buf = steps["captured"].captured.inputs
    assert cap["scene"].params.xyz.data_ptr() == buf[0].data_ptr()


def test_capture_failure_raises(scene):
    def reads_back(_static, x):
        return x * float(x.sum())  # a host read: not allowed while capturing

    with pytest.raises(RuntimeError, match="CUDA graph capture of reads_back failed"):
        graph.capture(reads_back)(None, torch.ones(4, device="cuda"))


def small_views(n=4):
    gt = interop.synthetic_scene(300, 300, sh_degree=1, scale=0.08, seed=3)
    views = []
    for cam in ring_cams(n, 64, 48):
        out, _ = trainer.render_scene(gt, cam, 64, 48, torch.zeros(3, device="cuda"),
                                      TilingConfig(max_pairs=1 << 14))
        views.append(ViewItem(
            image=out.image.cpu().numpy(), viewmatrix=cam.viewmatrix.cpu().numpy(),
            projmatrix=cam.projmatrix.cpu().numpy(), campos=cam.campos.cpu().numpy(),
            tanfovx=float(cam.tanfovx), tanfovy=float(cam.tanfovy),
            background=np.zeros(3, np.float32), depth=None))
    return views


def small_trainer(out_dir, **kw):
    base = dict(num_iters=20, capacity=512, log_interval=1, checkpoint_interval=5,
                valid_interval=10_000, tiling=TilingConfig(max_pairs=1 << 14),
                densify=DensifyConfig(densify_since=2, densify_interval=4, densify_until=16,
                                      densify_grad_threshold=0.0, clone_size_threshold=0.05,
                                      sh_degree_step_interval=6))
    init = interop.synthetic_scene(200, 512, sh_degree=1, scale=0.05, seed=4)
    init = dataclasses.replace(init, active_sh_degree=0)
    return trainer.Trainer(trainer.TrainConfig(**dict(base, **kw)), init, 4.0, small_views(),
                           out_dir=str(out_dir), log_fn=lambda *a: None)


def test_trainer_rollback_and_resume_under_capture(scene, tmp_path):
    del scene  # the fixture only skips without a card
    full = small_trainer(tmp_path / "full")
    full.train()
    assert full._train_step.captured is not None and full._train_step.captured.captures >= 2
    losses = {h["step"]: h["loss"] for h in full.history}
    resumed = small_trainer(tmp_path / "resumed")
    resumed.restore_checkpoint(tmp_path / "full" / "ckpt-00000010")
    resumed.train(num_iters=10)
    diff = max(abs(h["loss"] - losses[h["step"]]) / losses[h["step"]]
               for h in resumed.history)
    assert [h["step"] for h in resumed.history] == list(range(10, 20))
    assert diff <= 1e-6, diff

    rolled = small_trainer(tmp_path / "rolled", overflow_check_interval=1,
                           adaptive_pairs=False)
    orig, calls = rolled._train_step, {"n": 0}

    def poisoned(*a, **k):
        scene, adam, logs = orig(*a, **k)
        calls["n"] += 1
        if calls["n"] == 13:
            logs = dict(logs, loss=torch.tensor(float("nan"), device="cuda"))
        return scene, adam, logs

    rolled._train_step = poisoned
    rolled.train()
    assert rolled._nan_rollbacks == 1 and rolled.step > 10  # resumed from ckpt-10
    assert all(math.isfinite(h["loss"]) for h in rolled.history)
