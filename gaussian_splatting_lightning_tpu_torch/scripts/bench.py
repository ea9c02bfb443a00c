"""Benchmark: rays/s (forward + backward) of the kernel route at 1080p on the
1M-splat SH-3 bench scene, on one NVIDIA card.

Counterpart of the JAX repo's ``bench.py``: the same scene
(``interop.synthetic_scene(n, n, scale=0.008)``), camera, pair budget (the
exact host estimate plus 2%, rounded up to 8192) and timed work: the
gradient of ``photometric_loss(image, target, 0.2)`` with respect to the
five activated tensors through ``ops/rasterize.rasterize``, which launches
K1-K4 once per step, and the loss's kernels (``ops/photometric.py``, three
forward and one backward). The dropped-pair count comes back with the
gradient. On the card the gradient replays a captured graph
(``utils/graph.py``), as the JAX bench jits it. Timed by CUDA events and a
host wall over ``iters`` steps after ``warmup``; ``compile_s`` is JAX's
counterpart: the warm-up plus capture seconds (the kernels' build or load
included), or off the card the first call's seconds.

Rungs, in order; the first failure exits non-zero, and nothing is skipped
or stepped down to another route or device:
  1. small: 960x540, 250k splats, 5 iterations (printed);
  2. headline: 1920x1080, 1M splats, 10 iterations (printed with
     ``provisional: true``);
  3. parity: route "cuda" against the tiled route (``ops/rasterize_tiled``)
     at 512x384 on an anisotropic 100k-splat scene, image and every
     parameter gradient (pair cotangents are f32 only: one ``routing_f32``
     row);
  4. the banded check (``scripts/banded_check.py``);
then the headline with both as the last line, which is JSON.

The roofline is the card's: HBM bytes at the H100's 3.35 TB/s plus the
compositor's f32 operations at its 67 TFLOP/s (``roofline_ms``). It is a
shape-only bound: it counts every (pair, pixel) evaluation of a tile's
pairs, as if no tile stopped early and no warp were culled, so it is above
the bound of the work a scene's data needs (the K2 and K3 bounds of
``chip_smoke.py``, which count the evaluations up to each tile's early
stop).

Usage: python -m gaussian_splatting_lightning_tpu_torch.scripts.bench [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

BENCH_BLOCK = 32  # compositor tile edge (px)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak HBM3 bandwidth
F32_FLOPS = 67e12  # H100 SXM f32 peak outside the tensor cores (FMA = 2 flops)
# K2's f32 operations per (pair, pixel) evaluation, exp counted as one:
# up to the kill decision, every evaluation pays dx, dy, the quadratic form
# (7 mul, 2 add, x -0.5), exp, x opacity, min and the 1/255 test (16), plus
# four rect compares at 32 px tiles. K3 re-evaluates the same chain.
K2_OPS_TO_KILL = {16: 16, 32: 20}
PARITY_TOL = 1e-4  # route "cuda" against the tiled route: image max-abs and
# each gradient's max-abs over its largest |tiled| value


def _emit(result) -> None:
    """Print one JSON result line (stdout)."""
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def _note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def activated(scene):
    """The five activated tensors the bench differentiates: means, opacity,
    scales, rotation, SH features."""
    return (scene.params.xyz, scene.get_opacity(), scene.get_scales(),
            scene.get_rotation(), scene.get_features())


def bench_problem(w: int, h: int, n: int, device="cuda", capture: bool = True):
    """The bench's timed work: ``(grad_fn, args, pairs, budget)``.

    ``grad_fn(*args)`` returns ``(loss, grads, dropped)``: the loss, its
    gradients with respect to the five activated tensors (means, opacity,
    scales, rotation, SH features) and the dropped-pair count, all tensors
    (no host sync). On the card it replays a captured graph
    (``grad_fn.captured``; outputs hold until the next replay) unless
    ``capture=False``."""
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.ops.budget import estimate_pairs
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.ops.rasterize import rasterize
    from gaussian_splatting_lightning_tpu_torch.training.loss import photometric_loss
    from gaussian_splatting_lightning_tpu_torch.utils import graph

    scene = interop.synthetic_scene(n, n, scale=0.008, device=device)
    cam = interop.camera(w, h, device=device)
    dev = scene.device
    # the exact rect-level pair count (ops/budget.py mirrors tile_rect), so
    # 2% headroom suffices; the dropped-pair count guards it
    pairs = estimate_pairs(scene, cam, w, h, block=BENCH_BLOCK)
    budget = max(16384, -(-int(pairs * 1.02) // 8192) * 8192)
    cfg = TilingConfig(max_pairs=budget, block=BENCH_BLOCK)
    target = torch.from_numpy(
        np.random.default_rng(0).uniform(size=(3, h, w)).astype(np.float32)).to(dev)
    bg = torch.zeros(3, device=dev)

    def loss_grads(_static, *params):
        leaves = [p.detach().requires_grad_() for p in params]
        with torch.enable_grad():
            out, stats = rasterize(*leaves, cam, w, h, bg, 3, config=cfg)
            loss, _ = photometric_loss(out.image, target, 0.2)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads, stats["num_dropped_pairs"]

    captured = graph.capture(loss_grads, name="bench_grad") if (
        capture and dev.type == "cuda") else None

    def grad_fn(*params):
        return (captured or loss_grads)(None, *params)

    grad_fn.captured = captured
    return grad_fn, activated(scene), pairs, budget


def run(w: int, h: int, n: int, iters: int = 10, warmup: int = 2, device="cuda") -> dict:
    """Time the bench step. Returns ``step_s`` (host wall per step),
    ``device_ms`` (CUDA events per step; None off the card), ``compile_s``,
    ``pairs``, ``budget``, ``dropped`` (the first and the last timed step's
    largest count) and ``launches`` (each kernel's launches per timed step).
    Captured, the steps after the first take the graph's own input buffers
    back, so a step copies nothing in, as the jitted JAX bench passes its
    arrays by reference."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.ops import _build

    grad_fn, args, pairs, budget = bench_problem(w, h, n, device)
    cuda = args[0].is_cuda

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    _, _, dropped = grad_fn(*args)
    sync()
    compile_s = time.perf_counter() - t0
    first_dropped = int(dropped)
    if grad_fn.captured is not None:
        compile_s = grad_fn.captured.capture_s
        args = tuple(grad_fn.captured.inputs)
    for _ in range(warmup):
        grad_fn(*args)
    sync()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)] if cuda else []
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(iters):
        if cuda:
            events[i][0].record()
        _, _, dropped = grad_fn(*args)
        if cuda:
            events[i][1].record()
    sync()
    step_s = (time.perf_counter() - t0) / iters
    launches = {k: v / iters for k, v in _build.launches.items()}
    device_ms = (sum(a.elapsed_time(b) for a, b in events) / iters) if cuda else None
    return {"step_s": step_s, "device_ms": device_ms, "compile_s": compile_s,
            "pairs": pairs, "budget": budget, "dropped": max(first_dropped, int(dropped)),
            "launches": launches}


def parity_gate(w: int = 512, h: int = 384, n: int = 100_000, device="cuda",
                iters: int = 5) -> dict:
    """Route "cuda" against the tiled route (``ops/rasterize_tiled``), image
    and every parameter gradient of ``mean |image - target|``, on a scene
    with random anisotropic scales, unit quaternions, varied opacities and
    live SH bands >= 1, so every gradient axis carries signal. The kernel
    route's gradient is timed over ``iters`` calls after one, the tiled
    route's (seconds a call at 512x384 on the card) over one."""
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.ops.budget import pair_budget
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.ops.rasterize import rasterize
    from gaussian_splatting_lightning_tpu_torch.ops.rasterize_tiled import rasterize_tiled

    scene = interop.synthetic_scene(n, n, scale=0.01, aniso=True, seed=5, device=device)
    cam = interop.camera(w, h, device=device)
    dev = scene.device
    target = torch.from_numpy(
        np.random.default_rng(1).uniform(size=(3, h, w)).astype(np.float32)).to(dev)
    cfg = TilingConfig(max_pairs=pair_budget(scene, cam, w, h, headroom=2.0),
                       tile_capacity=4096)
    args = activated(scene)
    bg = torch.zeros(3, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed_grad(raster, iters):
        def fn():
            leaves = [p.detach().requires_grad_() for p in args]
            with torch.enable_grad():
                out, stats = raster(*leaves, cam, w, h, bg, 3, config=cfg)
                loss = torch.abs(out.image - target).mean()
                return torch.autograd.grad(loss, leaves), out.image.detach(), stats

        grads, image, stats = fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        return grads, image, stats, (time.perf_counter() - t0) / iters

    grad_t, img_t, stats_t, tiled_s = timed_grad(rasterize_tiled, 1)
    grad_p, img_p, stats_p, step_s = timed_grad(rasterize, iters)
    per_param = {}
    for name, gp, gt in zip(("xyz", "opacity", "scales", "quats", "sh"), grad_p, grad_t):
        scale = float(gt.abs().max()) + 1e-12
        per_param[name] = float((gp - gt).abs().max()) / scale
    return {"routing_f32": {
        "image_max_abs": float((img_p - img_t).abs().max()),
        "grad_rel_per_param": per_param,
        "grad_max_rel": max(per_param.values()),
        "step_ms": step_s * 1e3,
        "tiled_step_ms": tiled_s * 1e3,
        "dropped_pairs": int(stats_p["num_dropped_pairs"]) + int(stats_t["num_dropped_pairs"]),
        "tile_overflow": int(stats_t["num_tile_overflow"]),
    }}


def roofline_work(pairs: int, block: int, n_splats: int, w: int, h: int,
                  adam_splats: int = 0):
    """The step's irreducible work at this shape: (f32 operations, HBM bytes).

    Operations: the compositor's (pair, pixel) evaluations, ``pairs *
    block**2`` (no early stop, no cull), each up to the kill decision
    forward (K2) and again backward (K3). Bytes (the JAX bench model's
    shape-only terms): the parameter gradients written, Adam's other reads
    and writes for ``adam_splats`` splats (0 for the bench step, which runs
    no Adam; all of them, or a ZeRO-1 shard's, for a train step), the
    preprocess read, its outputs and their gradients, the pair features and
    their cotangents, the sort keys, ids and offsets, and images, target,
    SSIM maps and their gradients."""
    ops = 2 * pairs * block * block * K2_OPS_TO_KILL[block]
    nbytes = (
        236 * n_splats  # parameter gradients, written once
        + 6 * 236 * adam_splats  # Adam: params, grads, moments read; params, moments written
        + (236 + 2 * 52) * n_splats  # preprocess fwd read + prep + bwd
        + (3 * 16 * 4 + 16 * 2) * pairs  # pair features + cotangents
        + 10 * 3 * 4 * w * h  # image, target, SSIM maps, grads
        + 8 * 6 * pairs  # sort keys / ids / offsets passes
    )
    return ops, nbytes


def roofline_ms(pairs: int, block: int, n_splats: int, w: int, h: int) -> float:
    """The least time the card could take for the bench step (no Adam): its
    bytes at ``HBM_BYTES_PER_S`` plus the compositor's operations, unculled,
    at ``F32_FLOPS``."""
    ops, nbytes = roofline_work(pairs, block, n_splats, w, h)
    return 1e3 * (nbytes / HBM_BYTES_PER_S + ops / F32_FLOPS)


def _result_line(tag: str, w: int, h: int, n: int, res: dict, platform: str,
                 gpu: str | None = None, extra: dict | None = None) -> dict:
    """One result record in the JAX bench's schema; ``res`` is what ``run``
    returned."""
    step_s = res["step_s"]
    bound_ms = roofline_ms(res["pairs"], BENCH_BLOCK, n, w, h)
    result = {
        "metric": f"rays/s/chip fwd+bwd, {h}p, {n // 1000}k splats, SH3",
        "value": w * h / step_s,
        "unit": "rays/s",
        "vs_baseline": None,
        "extra": {
            "platform": platform,
            "gpu": gpu,
            "rung": tag,
            "step_ms": 1e3 * step_s,
            "device_ms": res["device_ms"],
            "compile_s": res["compile_s"],
            "impl": "cuda",
            "block_px": BENCH_BLOCK,
            "pairs": res["pairs"],
            "pair_budget": res["budget"],
            "dropped_pairs": res["dropped"],
            "launches": res["launches"],
            "roofline_hard_ms": bound_ms,
            "pct_of_roofline": 100 * bound_ms / (1e3 * step_s),
        },
    }
    if extra:
        result["extra"].update(extra)
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain versions)")
    args = parser.parse_args(argv)

    from gaussian_splatting_lightning_tpu_torch.device import resolve_device
    from gaussian_splatting_lightning_tpu_torch.scripts.banded_check import run_check

    dev = resolve_device(args.device)
    platform, gpu = ("gpu", gpu_line()) if dev.type == "cuda" else ("cpu", None)
    _note(f"platform={platform} ({gpu}); small rung starting")

    w1, h1, n1 = 960, 540, 250_000
    small = run(w1, h1, n1, iters=5, warmup=1, device=args.device)
    _emit(_result_line("small-540p", w1, h1, n1, small, platform, gpu))

    w, h, n = 1920, 1080, 1_000_000
    _note("headline rung starting")
    res = run(w, h, n, device=args.device)
    headline = _result_line("headline-1080p", w, h, n, res, platform, gpu)
    # the same measurement is printed again below with the parity and
    # banded blocks: a reader of every line skips provisional ones
    headline["extra"]["provisional"] = True
    _emit(headline)
    headline["extra"].pop("provisional")

    _note("parity gate starting")
    parity = parity_gate(device=args.device)
    headline["extra"]["parity_512x384_100k"] = parity
    _note("banded check starting")
    rec = run_check(device=args.device)
    headline["extra"]["banded_check"] = {
        "ok": rec["ok"],
        "psnr_vs_full_db": rec["banded_vs_full_psnr_db"],
        "pair_lists_identical": rec["per_tile_pair_lists_identical"],
        "sharded_1x1_loss_rel_err": rec["sharded_1x1_loss_rel_err"],
    }
    _emit(headline)

    row = parity["routing_f32"]
    failed = [msg for bad, msg in (
        (small["dropped"] or res["dropped"], "pairs dropped"),
        (not math.isfinite(headline["value"]), "non-finite rays/s"),
        (not row["image_max_abs"] <= PARITY_TOL or not row["grad_max_rel"] <= PARITY_TOL
         or row["dropped_pairs"] or row["tile_overflow"], "parity"),
        (not rec["ok"], "banded check"),
    ) if bad]
    if failed:
        raise SystemExit(f"bench: FAILED: {', '.join(failed)}")


if __name__ == "__main__":
    main()
