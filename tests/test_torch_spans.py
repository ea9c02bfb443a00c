"""Span marks and host spans (``utils/runtime.py``), on the CPU.

A mark is a kernel launch and runs on the card only
(``tests/test_torch_graph_cuda.py`` counts them in a profiled replay
there). Checked here:

- With spans off, ``mark`` calls nothing in ``ops/_build`` (the marker
  library is neither built nor loaded) and ``mark_backward`` hands back the
  same tensors; with spans on a CUDA tensor's mark launches mark
  ``SPANS.index(name)`` on the tensor's stream. A host span enters a trace
  only with spans on: the profiler also lays it over the device kernels it
  launched, which would change a trace read with spans off.
- ``csrc/span_mark.cu`` switches over ``SPANS`` in its order, and no mark's
  name holds another kernel's ``__global__`` name, "sort", "scan" or
  "nccl".
- The capture keys of the train step, the eval step, the render and the
  sharded step differ with spans on and off in that one entry, and are
  otherwise equal.
- The eager step (the captured graph's body) gives the same bits with
  spans on and off: losses, parameters, moments and statistics, one view
  and two, with exposure, dense and with sparse Adam and a depth target;
  so does the sharded step on a 1x1 gloo mesh. The identity functions of
  the backward marks are in the graph with spans on.
- ``span_segments`` on hand-made events: segment sums, the busy share
  inside the segments, the eval and render sequences left out, and None for
  a mark missing, repeated or out of order.
- The train CLI with ``--trace-dir`` on the CPU: the traced last steps give
  the untraced run's logs and checkpoints, a Chrome trace is written, and
  the report says no marks ran (they run on the card).
"""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussian_splatting_lightning_tpu_torch import interop
from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera, stack_cameras
from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
from gaussian_splatting_lightning_tpu_torch.ops import _build
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.parallel import shard as tshard
from gaussian_splatting_lightning_tpu_torch.parallel.mesh import Mesh
from gaussian_splatting_lightning_tpu_torch.training import exposure as texposure
from gaussian_splatting_lightning_tpu_torch.training import trainer as ttrainer
from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam
from gaussian_splatting_lightning_tpu_torch.utils import runtime

W, H = 64, 48
TILING = TilingConfig(max_pairs=1 << 14, block=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ring_cams(n):
    cams = []
    for i in range(n):
        a = 2 * np.pi * i / 8
        rot = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        pose = np.concatenate([rot, [[0.0], [0.0], [4.0]]], 1)
        cams.append(make_camera(pose, W * 0.7, W * 0.7, W, H, device="cpu"))
    return cams


@pytest.fixture(scope="module")
def scene():
    return interop.synthetic_scene(300, 512, sh_degree=3, aniso=True, scale=0.05, seed=5,
                                   device="cpu")


class _FakeCuda:
    is_cuda = True


def test_mark_off_calls_nothing_and_on_launches_the_named_mark(monkeypatch):
    calls = []

    class Lib:
        def gs_span_mark(self, i, stream):
            calls.append(("mark", i, stream))
            return 0

    def load(name):
        calls.append(("load", name))
        return Lib()

    def refuse(*a, **k):
        raise AssertionError("ops/_build called with spans off")

    for name in ("load", "build", "raise_for", "check", "stream_of"):
        monkeypatch.setattr(_build, name, refuse)
    t = torch.ones(3)
    assert not runtime.spans_on()
    for name in runtime.SPANS:
        runtime.mark(name, _FakeCuda())
        runtime.mark(name, t)
    assert runtime.mark_backward("composite_bwd", t) == (t,)
    assert runtime.mark_backward("composite_bwd", t)[0] is t

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "stream_of", lambda like: "stream")
    monkeypatch.setattr(_build, "raise_for", lambda lib, name, rc: calls.append(("rc", rc)))
    with runtime.spanning():
        assert runtime.spans_on()
        runtime.mark("adam", t)  # a CPU tensor: no launch
        assert calls == []
        runtime.mark("adam", _FakeCuda())
        with runtime.spanning(False):
            runtime.mark("end", _FakeCuda())
        runtime.mark("end", _FakeCuda())
    assert not runtime.spans_on()
    assert calls == [("load", "span_mark"), ("mark", 7, "stream"), ("rc", 0),
                     ("load", "span_mark"), ("mark", 9, "stream"), ("rc", 0)]


def test_host_span_only_with_spans_on_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    def names(on):
        with runtime.spanning(on), profile(activities=[ProfilerActivity.CPU]) as prof:
            with runtime.span("trainer.step"):
                torch.ones(4).add_(1)
        return {e.name() for e in prof.profiler.kineto_results.events()}

    assert "trainer.step" not in names(False)
    assert "trainer.step" in names(True)


def test_every_host_span_is_named_in_host_spans():
    pkg = Path(runtime.__file__).resolve().parents[1]
    used = {m for f in pkg.rglob("*.py")
            for m in re.findall(r'runtime\.span\("([^"]+)"\)', f.read_text())}
    assert used == set(runtime.HOST_SPANS)


def test_mark_source_follows_spans_and_no_name_collides():
    src = (_build.SRC_DIR / _build.LIBRARIES["span_mark"]).read_text()
    cases = re.findall(r"case (\d+): gs_span_(\w+)<<<", src)
    assert [(int(i), n) for i, n in cases] == list(enumerate(runtime.SPANS))
    assert re.findall(r"^GS_SPAN\((\w+)\)", src, re.M) == list(runtime.SPANS)
    kernels = set()
    for f in _build.SOURCES.values():
        kernels |= set(re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?"
                                  r"(?:void\s+)?(\w+)\s*\(",
                                  (_build.SRC_DIR / f).read_text()))
    assert {"expand_pairs_kernel", "composite_fwd_kernel", "composite_bwd_kernel",
            "segment_sum_kernel", "blur_valid_kernel"} <= kernels
    for name in runtime.SPANS:
        full = f"gs_span_{name}"
        assert not any(k in full for k in kernels), full
        assert not any(w in full.lower() for w in ("sort", "scan", "nccl")), full
        assert runtime.MARK_RE.search(f"{full}()").group(1) == name
    assert "span_mark" not in _build.launches  # a mark is no kernel of the port's


def hand_mesh(backend="nccl"):
    return Mesh(grid=np.arange(1).reshape(1, 1), rank=0, device=torch.device("cpu"),
                backend=backend, groups={})


def _differ_in_spans_only(off, on):
    assert off != on
    assert off[1:] == on[1:]  # the inputs' shapes
    diff = [(a, b) for a, b in zip(off[0], on[0]) if a != b]
    assert diff == [(False, True)], diff


def test_capture_keys_hold_the_span_setting(scene):
    cam = ring_cams(1)[0]
    img, bg = torch.zeros(3, H, W), torch.zeros(3)
    adam = init_adam(scene.params)
    cfg = ttrainer.TrainConfig(tiling=TILING, capacity=scene.capacity)
    step = ttrainer.make_train_step(cfg, 1.0, W, H)
    evals = ttrainer.make_eval_step(cfg, W, H)
    render = ttrainer.make_render(W, H, TILING)
    cfg2 = dataclasses.replace(cfg, batch_views=2)
    sharded = tshard.make_sharded_train_step(cfg2, 1.0, W, H, hand_mesh())
    cams2 = stack_cameras(ring_cams(2))
    imgs2, bgs2 = torch.zeros(2, 3, H, W), torch.zeros(2, 3)

    def keys():
        return [step.key(scene, adam, 0, cam, img, bg),
                step.key(scene, adam, 0, cam, img, bg, exp_mat=torch.zeros(3, 4)),
                evals.key(scene, cam, img, bg), render.key(scene, cam, bg),
                sharded.key(scene, adam, 0, cams2, imgs2, bgs2)]

    off = keys()
    with runtime.spanning():
        on = keys()
    assert keys() == off
    for a, b in zip(off, on):
        _differ_in_spans_only(a, b)


CASES = {"one-view": 1, "two-views-exposure": 2}


def clone_scene(s):
    """A copy of ``s`` for a step to donate: the fixture stays as it is."""
    return dataclasses.replace(
        s, params=type(s.params)(**{k: getattr(s.params, k).clone() for k in PARAM_NAMES}),
        alive=s.alive.clone(), max_radii2d=s.max_radii2d.clone(),
        grad_accum=s.grad_accum.clone(), grad_count=s.grad_count.clone())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse-depth"])
def test_step_bits_equal_with_spans_on_and_off(scene, case, sparse):
    b = CASES[case]
    cams = ring_cams(3)
    gen = torch.Generator().manual_seed(1)
    imgs = torch.rand(3, 3, H, W, generator=gen)
    bgs = torch.rand(3, 3, generator=gen)
    depths = torch.rand(3, 1, H, W, generator=gen) * 0.3
    cfg = ttrainer.TrainConfig(tiling=TILING, batch_views=b, capacity=scene.capacity,
                               sparse_adam=sparse, w_depth=0.5 if sparse else 0.0)
    run = ttrainer.make_train_step(cfg, 1.0, W, H, capture=False)

    def steps(on):
        sc, adam = clone_scene(scene), init_adam(scene.params)
        exp = texposure.init_exposure(3, device="cpu")
        losses, exp_grads = [], []
        with runtime.spanning(on):
            for t in range(2):
                idx = [(t + v) % 3 for v in range(b)]
                if b == 1:
                    args, extra = [cams[idx[0]], imgs[idx[0]], bgs[idx[0]]], []
                    kw = {"depth_target": depths[idx[0]]} if sparse else {}
                else:
                    args = [stack_cameras([cams[j] for j in idx]), imgs[idx], bgs[idx]]
                    extra = [exp.params[idx]]
                    kw = {"depth_target": depths[idx]} if sparse else {}
                out = run(sc, adam, t, *args, *extra, **kw)
                sc, adam, logs = out[:3]
                if b > 1:
                    exp_grads.append(out[3].clone())
                losses.append({k: float(v) for k, v in logs.items()})
        return sc, adam, losses, exp_grads

    off, on = steps(False), steps(True)
    assert on[2] == off[2]
    assert all(torch.equal(x, y) for x, y in zip(on[3], off[3]))
    for k in PARAM_NAMES:
        for get in (lambda r: r[0].params, lambda r: r[1].mu, lambda r: r[1].nu):
            assert torch.equal(getattr(get(on), k), getattr(get(off), k)), k
    for k in ("max_radii2d", "grad_accum", "grad_count"):
        assert torch.equal(getattr(on[0], k), getattr(off[0], k)), k


def test_mesh_step_bits_equal_with_spans_on_and_off(scene, tmp_path):
    """The sharded step on a 1x1 gloo mesh in this process (two views,
    ZeRO-1 Adam, exposure), eagerly, with spans on and off."""
    from gaussian_splatting_lightning_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        make_sharded_train_step,
        shutdown,
    )
    from gaussian_splatting_lightning_tpu_torch.parallel.shard import shard_adam

    cams = stack_cameras(ring_cams(2))
    gen = torch.Generator().manual_seed(2)
    imgs, bgs = torch.rand(2, 3, H, W, generator=gen), torch.rand(2, 3, generator=gen)
    exp = texposure.init_exposure(2, device="cpu").params
    cfg = ttrainer.TrainConfig(tiling=TILING, batch_views=2, capacity=scene.capacity,
                               use_exposure=True)
    info = init_distributed("cpu", rank=0, world_size=1,
                            init_method=f"file://{(tmp_path / 'store').absolute()}")
    mesh = None
    try:
        mesh = make_mesh(1, 1, info=info)
        step = make_sharded_train_step(cfg, 1.0, W, H, mesh)
        assert step.captured is None

        def steps(on):
            sc, adam, out = clone_scene(scene), shard_adam(init_adam(scene.params), mesh), []
            with runtime.spanning(on):
                for t in range(2):
                    sc, adam, logs, exp_grad = step(sc, adam, t, cams, imgs, bgs, exp)
                    out.append(({k: float(v) for k, v in logs.items()}, exp_grad))
            return sc, adam, out

        off, on = steps(False), steps(True)
    finally:
        shutdown(mesh)
    assert [x[0] for x in on[2]] == [x[0] for x in off[2]]
    assert all(torch.equal(a[1], b[1]) for a, b in zip(on[2], off[2]))
    for k in PARAM_NAMES:
        for get in (lambda r: r[0].params, lambda r: r[1].mu, lambda r: r[1].nu):
            assert torch.equal(getattr(get(on), k), getattr(get(off), k)), k
    for k in ("max_radii2d", "grad_accum", "grad_count"):
        assert torch.equal(getattr(on[0], k), getattr(off[0], k)), k


def test_backward_marks_are_in_the_graph_with_spans_on(scene):
    cam = ring_cams(1)[0]
    cfg = ttrainer.TrainConfig(tiling=TILING, capacity=scene.capacity)

    def graph_names(on):
        names = set()
        with runtime.spanning(on), torch.enable_grad():
            leaves = {k: getattr(scene.params, k).detach().requires_grad_()
                      for k in PARAM_NAMES}
            live = dataclasses.replace(scene, params=type(scene.params)(**leaves))
            out, _ = ttrainer.render_scene(live, cam, W, H, torch.zeros(3), cfg.tiling)
            image, = runtime.mark_backward("composite_bwd", out.image)
            todo = [image.grad_fn]
            while todo:
                fn = todo.pop()
                if fn is None or type(fn).__name__ in names:
                    continue
                names.add(type(fn).__name__)
                todo += [f for f, _ in fn.next_functions]
        return names

    assert "_MarkBackwardBackward" not in graph_names(False)
    assert "_MarkBackwardBackward" in graph_names(True)


class _Event:
    def __init__(self, name, start, dur, dev=True):
        self._n, self._s, self._d, self._dev = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"


def step_events(t0, order=runtime.SPANS, work_ns=40):
    """Marks 100 ns apart from ``t0``, each followed by ``work_ns`` of work."""
    events = []
    for i, name in enumerate(order):
        events.append(_Event(f"gs_span_{name}()", t0 + 100 * i, 2))
        if i < len(order) - 1:
            events.append(_Event("void at::native::elementwise_kernel<128>", t0 + 100 * i + 10,
                                 work_ns))
    return events


def test_span_segments_by_hand():
    events = step_events(0) + step_events(2000, work_ns=60)
    events.append(_Event("Memcpy HtoD", 1500, 100))  # between steps: outside
    # the profiler's copy of a host span on the device: no work of its own
    events.append(_Event("trainer.step", 0, 3000))
    seg = runtime.span_segments(events)
    assert seg["steps"] == 2
    assert list(seg["segment_ms"]) == list(runtime.SPANS[:-1])
    for ms in seg["segment_ms"].values():
        assert ms == pytest.approx(50e-6)  # (40 + 60) ns over two steps
    assert seg["covered"] == pytest.approx(900 / 1000)
    # an eval and a render between the steps are left out
    mixed = (step_events(0) + step_events(1000, runtime.EVAL_SPANS)
             + step_events(1600, runtime.RENDER_SPANS) + step_events(2000, work_ns=60))
    got = runtime.span_segments(mixed)
    assert got["steps"] == 2 and got["segment_ms"] == seg["segment_ms"]
    assert runtime.span_segments([e for e in step_events(0)
                                  if "gs_span_adam" not in e.name()]) is None
    swapped = list(runtime.SPANS)
    swapped[3], swapped[4] = swapped[4], swapped[3]
    assert runtime.span_segments(step_events(0) + step_events(2000, swapped)) is None
    assert runtime.span_segments(step_events(0, runtime.SPANS[1:])) is None
    assert runtime.span_segments(step_events(0, runtime.EVAL_SPANS)) is None  # no step
    assert runtime.span_segments([_Event("gs_span_loss()", 5, 1, dev=False)]) is None


def write_scene(root: Path, views=4):
    from gaussian_splatting_lightning_tpu_torch.core.sh import SH_C0
    from gaussian_splatting_lightning_tpu_torch.data import colmap, image_io

    (root / "images").mkdir(parents=True)
    gt = interop.synthetic_scene(200, 200, sh_degree=1, seed=4, scale=0.08, aniso=True,
                                 device="cpu")
    images = {}
    for i in range(views):
        ang = 2 * np.pi * i / views
        fwd = -np.array([np.cos(ang), 0.3, np.sin(ang)])
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], 0)
        t = -R @ (-4.0 * fwd)
        cam = make_camera(np.concatenate([R, t[:, None]], 1), 50.0, 50.0, W, H, device="cpu")
        out, _ = ttrainer.render_scene(gt, cam, W, H, torch.zeros(3), TILING)
        img = np.moveaxis(out.image.clamp(0, 1).numpy(), 0, -1) * 255 + 0.5
        name = f"view_{i:03d}.png"
        image_io.write_image(root / "images" / name, img.astype(np.uint8))
        images[i + 1] = (colmap.rotmat_to_qvec(R), t, 1, name)
    rng = np.random.default_rng(2)
    xyz = gt.params.xyz.numpy() + rng.normal(size=(200, 3)).astype(np.float32) * 0.05
    rgb = np.clip(gt.params.features_dc[:, 0].numpy() * SH_C0 + 0.5, 0, 1)
    colmap.write_reconstruction(root / "sparse" / "0", {1: (W, H, 50.0, 50.0, W / 2, H / 2)},
                                images, xyz, rgb)


def test_train_cli_traces_its_last_steps(tmp_path, capsys):
    from gaussian_splatting_lightning_tpu_torch.scripts import train as cli

    root = tmp_path / "scene"
    write_scene(root)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"""
exp_name: spans
run_name: run
seed: 0
sh_degree: 1
capacity: 512
data:
  colmap_path: {root}
  image_folder: {root / "images"}
  holdout_every: 4
train:
  num_iters: 8
  log_interval: 1
  overflow_check_interval: 2
  valid_interval: 6
  checkpoint_interval: 4
  tiling:
    max_pairs: 16384
    block: 32
""")
    runs = {}
    for name, extra in (("plain", []), ("traced", ["--trace-dir", str(tmp_path / "tr"),
                                                   "--trace-steps", "3"])):
        tr = cli.main(["-c", str(cfg), "--device", "cpu", "--out-dir",
                       str(tmp_path / name), *extra])
        runs[name] = tr.out_dir
    out = capsys.readouterr().out
    assert "[trace] 3 steps: no complete step of span marks" in out
    assert len(list((tmp_path / "tr").glob("trace-*.json"))) == 1

    def logs(d):
        return [{k: v for k, v in json.loads(line).items() if k != "elapsed_s"}
                for line in (d / "train_log.jsonl").read_text().splitlines()]

    assert logs(runs["traced"]) == logs(runs["plain"])
    assert len(logs(runs["plain"])) == 8
    names = {n: sorted(p.name for p in d.glob("ckpt-*")) for n, d in runs.items()}
    assert names["traced"] == names["plain"] == ["ckpt-00000004", "ckpt-00000008"]
