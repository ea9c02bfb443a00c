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
- A replay adds the launches its capture recorded (K1-K4, the
  preprocess pair and Adam once, the photometric loss's kernels four times
  a step; the mesh's step no preprocess kernel, and K5 twice where the
  photometric kernels would run); a capture launches nothing of its own.
- The photometric loss's kernels, forward and backward, captured and
  replayed twice give the eager call's bits, one view and a stack of two.
- A function that reads a value back to the host cannot be captured: the
  capture raises.
- The ``Trainer`` on the captured step: a NaN loss rolls back to the last
  checkpoint and carries on; a run resumed from a checkpoint logs the
  uninterrupted run's losses within 1e-6.
- The sharded step on a 1x1 NCCL mesh in this process (two views a step,
  exposure, ZeRO-1 Adam) captured and replayed for 5 steps against 5 eager
  steps (``capture=False``) from the same start: one capture, K1-K4 and
  Adam once and K5 twice a replay, every loss, parameter and moment the same bits.
- With four cards: the sharded step on four NCCL ranks (one per card,
  ``tests/torch_nccl_worker.py`` under torchrun), meshes (1, 4) and (2, 2),
  and (4, 1) on its own, captured against eager for 5 steps: one capture a
  mesh, every rank's losses, exposure gradients, parameters, Adam rows and
  statistics the same bits, and the replicated parameters the same on every
  rank; and ``scripts/dryrun_multichip.py`` on four NCCL ranks (its three
  passes and their asserts).
- The exposure graph (``make_exposure_update``) against the eager
  ``exposure_update``, bit for bit, for one view, three views and three
  with one repeated.
- Span marks (``utils/runtime.py``): the train step captured with spans on
  gives the bits of the one captured with them off; five profiled replays
  hold the ten marks of ``SPANS`` once a replay, in order, and the segments
  between them hold at least 98% of the card's busy time; the render and
  the eval step replay their own marks in order.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip. On the
card:

    python -m pytest tests/test_torch_graph_cuda.py -q

This file imports no JAX: the machine with the card has none.
"""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

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
from gaussian_splatting_lightning_tpu_torch.utils import graph, runtime

pytestmark = pytest.mark.cuda

PKG = "gaussian_splatting_lightning_tpu_torch"
W, H = 128, 96
TILING = TilingConfig(max_pairs=1 << 16, block=32)
# the loss runs as its kernels (three forward, one backward), not K5
STEP_KERNELS = {"expand_pairs": 1, "composite_fwd": 1, "composite_bwd": 1,
                "segment_sum": 1, "blur": 0, "preprocess_fwd": 1, "preprocess_bwd": 1,
                "adam": 1, "photometric": 4}
# the mesh's step composes its sharded preprocess (no preprocess kernel) and
# its band-local loss (K5 forward and VJP, no photometric kernel)
MESH_STEP_KERNELS = {"expand_pairs": 1, "composite_fwd": 1, "composite_bwd": 1,
                     "segment_sum": 1, "blur": 2, "adam": 1}
MESH_LAUNCHES = {k: MESH_STEP_KERNELS.get(k, 0) for k in STEP_KERNELS}


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


@pytest.mark.parametrize("views", [0, 2], ids=["one_view", "two_views"])
def test_captured_photometric_loss_equals_eager(scene, views):
    """The loss's kernels sum in a fixed order with no atomics: a captured
    forward and backward replays the eager call's outputs and gradient bit
    for bit; an eager call counts four launches."""
    from gaussian_splatting_lightning_tpu_torch.training.loss import (
        photometric_loss,
        photometric_losses,
    )

    fn = photometric_losses if views else photometric_loss
    shape = (views, 3, 1080, 1920) if views else (3, 1080, 1920)
    gen = torch.Generator(device="cuda").manual_seed(4)
    pred = torch.rand(shape, device="cuda", generator=gen)
    target = torch.rand(shape, device="cuda", generator=gen)

    def run(x):
        x = x.detach().requires_grad_()
        loss, logs = fn(x, target)
        (grad,) = torch.autograd.grad(loss.sum(), x)
        return [logs[k].detach() for k in ("loss", "recon", "ssim", "psnr")] + [grad]

    want = run(pred)  # eager; loads the library before the capture
    torch.cuda.synchronize()
    static = pred.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run(static)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    _build.reset_launch_counts()
    run(pred)
    assert _build.launches["photometric"] == 4


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


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_captured_mesh_step_equals_eager_on_nccl(scene):
    from gaussian_splatting_lightning_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        make_sharded_train_step,
        shutdown,
    )
    from gaussian_splatting_lightning_tpu_torch.parallel.shard import shard_adam

    cams = ring_cams(2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    imgs = torch.rand(2, 3, H, W, device="cuda", generator=gen)
    bgs = torch.rand(2, 3, device="cuda", generator=gen)
    cfg = trainer.TrainConfig(tiling=TILING, batch_views=2, capacity=scene.capacity,
                              use_exposure=True)
    info = init_distributed("cuda", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{free_port()}")
    steps, state, mesh = {}, {}, None
    try:
        mesh = make_mesh(1, 1, info=info)
        assert mesh.backend == "nccl"
        steps.update(eager=make_sharded_train_step(cfg, 1.0, W, H, mesh, capture=False),
                     captured=make_sharded_train_step(cfg, 1.0, W, H, mesh))
        assert steps["eager"].captured is None and steps["captured"].sharded_adam
        state.update({k: {"scene": clone_scene(scene),
                          "adam": shard_adam(init_adam(scene.params), mesh),
                          "exp": texposure.init_exposure(3, device="cuda"), "loss": [],
                          "exp_grad": []} for k in steps})
        for t in range(5):
            idx = [t % 3, (t + 1) % 3]
            args = [stack_cameras([cams[j % 2] for j in idx]), imgs[[j % 2 for j in idx]], bgs]
            for name, fn in steps.items():
                st = state[name]
                _build.reset_launch_counts()
                scene_t, adam, logs, exp_grad = fn(st["scene"], st["adam"], t, *args,
                                                   st["exp"].params[idx])
                torch.cuda.synchronize()
                runs = 2 if name == "captured" and t == 0 else 1  # warm-up, then a replay
                assert dict(_build.launches) == {k: runs * n for k, n in MESH_LAUNCHES.items()}
                st["scene"], st["adam"] = scene_t, adam
                st["loss"].append(float(logs["loss"]))
                st["exp_grad"].append(exp_grad.clone())
                assert int(logs["num_dropped_pairs"]) == 0
                st["exp"] = texposure.exposure_update(
                    st["exp"], torch.tensor(idx, device="cuda"), exp_grad, 0.001)
        cap, eag = state["captured"], state["eager"]
        assert steps["captured"].captured.captures == 1
        assert cap["loss"] == eag["loss"]
        assert all(torch.equal(a, b) for a, b in zip(cap["exp_grad"], eag["exp_grad"]))
        for k in PARAM_NAMES:
            for get in (lambda s: s["scene"].params, lambda s: s["adam"].mu,
                        lambda s: s["adam"].nu):
                assert torch.equal(getattr(get(cap), k), getattr(get(eag), k)), k
        for k in ("max_radii2d", "grad_accum", "grad_count"):
            assert torch.equal(getattr(cap["scene"], k), getattr(eag["scene"], k)), k
        assert cap["adam"].count == eag["adam"].count == 5
        buf = steps["captured"].captured.inputs
        assert cap["scene"].params.xyz.data_ptr() == buf[0].data_ptr()
    finally:
        shutdown(mesh)  # the step's graph goes before the communicators it uses


@pytest.fixture
def four_cards(scene):
    """Skips unless this machine has four cards (one NCCL rank each);
    builds the kernels once, before the ranks load them."""
    del scene  # the fixture only skips without a card
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: one NCCL rank each")
    _build.build()
    return Path(__file__).resolve().parents[1]


def torchrun(root, *args, timeout=600):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", *map(str, args)], cwd=root, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def four_rank_mismatches(root, tmp_path, shapes):
    """``tests/torch_nccl_worker.py`` on four NCCL ranks for ``shapes``; every
    difference of a rank's captured side from its eager side, a drop, a
    parameter that differs from rank 0's, another capture count than one or
    another set of kernels than the step's."""
    torchrun(root, root / "tests" / "torch_nccl_worker.py", tmp_path, *shapes)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    bad = []
    for mesh in shapes:
        for r, got in enumerate(ranks):
            if int(got[f"{mesh}/captures"]) != 1:
                bad.append((mesh, r, "captures", int(got[f"{mesh}/captures"])))
            for key, val in got.items():
                if key.startswith(f"{mesh}/captured/"):
                    want = got[key.replace("/captured/", "/eager/")]
                    if not np.array_equal(val, want):
                        err = float(np.abs(val.astype(np.float64) - want).max())
                        bad.append((mesh, r, key, err))
                if "/dropped/" in key and int(val):
                    bad.append((mesh, r, key, int(val)))
            for k in PARAM_NAMES:
                key = f"{mesh}/captured/param/{k}"
                if not np.array_equal(got[key], ranks[0][key]):
                    bad.append((mesh, r, key, "differs from rank 0"))
            names = set(got[f"{mesh}/launch_names"].tolist())
            if names != set(MESH_STEP_KERNELS):
                bad.append((mesh, r, "launches", sorted(names)))
    return bad


def test_captured_mesh_step_equals_eager_on_four_nccl_ranks(four_cards, tmp_path):
    bad = four_rank_mismatches(four_cards, tmp_path, ["1x4", "2x2"])
    assert not bad, bad[:20]


def test_captured_mesh_step_equals_eager_on_four_nccl_view_ranks(four_cards, tmp_path):
    """The (4, 1) mesh: four view groups of one rank each, a view per rank,
    only the gradient sums and the statistics crossing the ranks."""
    bad = four_rank_mismatches(four_cards, tmp_path, ["4x1"])
    assert not bad, bad[:20]


def test_dryrun_multichip_on_four_nccl_ranks(four_cards, tmp_path):
    """``scripts/dryrun_multichip.py`` on four cards: its three passes on
    NCCL, one rank per card, the steps captured; rank 0 prints the JAX
    function's three OK lines."""
    out = torchrun(four_cards, "-m", f"{PKG}.scripts.dryrun_multichip", "--out",
                   tmp_path / "dry.json")
    assert sum(x.startswith("dryrun_multichip OK") for x in out.splitlines()) == 3, out
    rec = json.loads((tmp_path / "dry.json").read_text())
    assert (rec["backend"], rec["ranks"], rec["routes"]) == ("nccl", 4, ["cuda", "cuda"])
    assert rec["pass1"]["n_alive"] > 48 and rec["pass3"]["cross_psnr_db"] > 45.0


def test_exposure_graph_equals_eager(scene):
    del scene  # the fixture only skips without a card
    gen = torch.Generator(device="cuda").manual_seed(3)
    start = texposure.init_exposure(6, device="cuda")
    start.params += 0.05 * torch.randn(start.params.shape, device="cuda", generator=gen)
    for idxs in ([[4]] * 4, [[0, 3, 5], [1, 2, 3], [5, 0, 4]], [[2, 5, 2], [1, 1, 1]]):
        update = texposure.make_exposure_update(0.01)
        eager = captured = dataclasses.replace(
            start, params=start.params.clone(), mu=start.mu.clone(), nu=start.nu.clone())
        for idx in idxs:
            ids = torch.tensor(idx, device="cuda")
            grad = 0.1 * torch.randn(len(idx), 3, 4, device="cuda", generator=gen)
            eager = texposure.exposure_update(eager, ids, grad, 0.01)
            captured = update(captured, ids, grad)
        assert update.captured.captures == 1
        assert captured.params.data_ptr() == update.captured.inputs[0].data_ptr()
        assert captured.count == eager.count == len(idxs)
        for f in ("params", "mu", "nu"):
            assert torch.equal(getattr(captured, f), getattr(eager, f)), (idxs, f)


def profiled_events(fn, n):
    """``fn()`` ``n`` times under ``torch.profiler``: the raw events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return prof.profiler.kineto_results.events()


def mark_names(events):
    dev = sorted((e.start_ns(), e.name()) for e in events
                 if str(e.device_type()).endswith("CUDA"))
    return [m.group(1) for _, name in dev if (m := runtime.MARK_RE.search(name))]


def test_span_marks_replay_in_order_and_keep_the_bits(scene):
    """The step captured with spans on against the one captured with them
    off, from the same start: the same bits; five profiled replays hold the
    ten marks once a replay in ``SPANS`` order, and the segments hold at
    least 98% of the card's busy time."""
    cams = ring_cams(3)
    gen = torch.Generator(device="cuda").manual_seed(4)
    imgs = torch.rand(3, 3, H, W, device="cuda", generator=gen)
    bgs = torch.rand(3, 3, device="cuda", generator=gen)
    cfg = trainer.TrainConfig(tiling=TILING)
    runs = {}
    for on in (False, True):
        step = trainer.make_train_step(cfg, 1.0, W, H)
        st = {"scene": clone_scene(scene), "adam": init_adam(scene.params), "t": 0,
              "loss": []}

        def one():
            i = st["t"] % 3
            st["scene"], st["adam"], logs = step(st["scene"], st["adam"], st["t"], cams[i],
                                                 imgs[i], bgs[i])
            st["loss"].append(float(logs["loss"]))
            st["t"] += 1

        with runtime.spanning(on):
            one()  # warm-up, capture, replay
            events = profiled_events(one, 5)
        assert step.captured.captures == 1
        runs[on] = (st, events)
    (off, off_events), (on, on_events) = runs[False], runs[True]
    assert on["loss"] == off["loss"]
    for k in PARAM_NAMES:
        for get in (lambda s: s["scene"].params, lambda s: s["adam"].mu,
                    lambda s: s["adam"].nu):
            assert torch.equal(getattr(get(on), k), getattr(get(off), k)), k
    for k in ("max_radii2d", "grad_accum", "grad_count"):
        assert torch.equal(getattr(on["scene"], k), getattr(off["scene"], k)), k
    assert mark_names(off_events) == [] and runtime.span_segments(off_events) is None
    assert mark_names(on_events) == list(runtime.SPANS) * 5
    seg = runtime.span_segments(on_events)
    assert seg["steps"] == 5 and seg["covered"] >= 0.98, seg
    assert all(ms > 0 for ms in seg["segment_ms"].values()), seg


def test_render_and_eval_marks_replay_in_order(scene):
    cam = ring_cams(1)[0]
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    target = torch.zeros(3, H, W, device="cuda")
    render = trainer.make_render(W, H, TILING)
    evals = trainer.make_eval_step(trainer.TrainConfig(tiling=TILING), W, H)
    with runtime.spanning():
        render(scene, cam, bg)
        evals(scene, cam, target, bg)
        assert mark_names(profiled_events(lambda: render(scene, cam, bg), 2)) == list(
            runtime.RENDER_SPANS) * 2
        assert mark_names(profiled_events(lambda: evals(scene, cam, target, bg), 2)) == list(
            runtime.EVAL_SPANS) * 2
    assert render.captured.captures == evals.captured.captures == 1
