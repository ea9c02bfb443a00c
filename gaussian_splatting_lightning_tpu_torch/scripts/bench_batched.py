"""Measure the view-batched training step: ms per view at B views per step.

Counterpart of the JAX repo's ``scripts/bench_batched.py``: the same ring
cameras, scene (``scale=0.01``) and pair budget (1.3x the largest estimate
over the first four views), then for each B a fresh scene and Adam through
``training/trainer.make_train_step`` with B views stacked by
``core/camera.stack_cameras`` (B = 1 unstacked). Each row gives the host
wall per step, ms per view, views per second and the speed-up per view over
the first row, beside the CUDA-event time per step (``device_ms``), the peak
device memory over the timed steps, the first step's loss and the dropped
pairs. On the card each B's step replays a captured graph (the train step
of ``make_train_step``); the first step of each B warms up and captures,
outside the timed steps. The last line printed is the JSON summary.

Usage: python -m gaussian_splatting_lightning_tpu_torch.scripts.bench_batched \
    [--width 512 --height 384 --n 100000 --iters 20 --batches 1 2 4 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def ring_pose(i: int, total: int) -> np.ndarray:
    """A world-to-camera (3, 4) pose 4 units out on a ring, looking in."""
    ang = 2 * np.pi * i / total
    fwd = -np.array([np.cos(ang), 0.2, np.sin(ang)])
    fwd /= np.linalg.norm(fwd)
    pos = -4.0 * fwd
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], 0)
    t = -R @ pos
    return np.concatenate([R, t[:, None]], 1)


def ring_problem(w: int, h: int, n: int, device="cuda"):
    """The eight ring cameras and the pair budget: 1.3x the largest estimate
    over the first four views of the ``scale=0.01`` scene."""
    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera
    from gaussian_splatting_lightning_tpu_torch.ops.budget import pair_budget

    cams = [make_camera(ring_pose(i, 8), w * 0.7, w * 0.7, w, h, device=device)
            for i in range(8)]
    budget = pair_budget(interop.synthetic_scene(n, n, scale=0.01, device=device), cams[:4],
                         w, h, headroom=1.3)
    return cams, budget


def batch_problem(cams, budget: int, b: int, w: int, h: int, n: int, rng,
                  capture: bool = True):
    """The step at B views and its inputs, the target drawn from ``rng``:
    ``(step, scene, camera, image, background)``, a fresh scene each call (B
    = 1 unstacked); the step captured on the card unless ``capture=False``."""
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import (
        TrainConfig,
        make_train_step,
    )

    dev = cams[0].device
    cfg = TrainConfig(capacity=n, batch_views=b,
                      tiling=TilingConfig(max_pairs=budget, tile_capacity=4096))
    step = make_train_step(cfg, 4.0, w, h, capture=capture)
    sel = [cams[i % len(cams)] for i in range(b)]
    img = torch.from_numpy(rng.uniform(size=(b, 3, h, w)).astype(np.float32)).to(dev)
    bg = torch.zeros((b, 3), device=dev)
    cam_b = stack_cameras(sel)
    if b == 1:
        cam_b, img, bg = sel[0], img[0], bg[0]
    return step, interop.synthetic_scene(n, n, scale=0.01, device=dev), cam_b, img, bg


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=384)
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain versions)")
    args = parser.parse_args(argv)

    import torch

    from gaussian_splatting_lightning_tpu_torch.device import resolve_device
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    w, h, n = args.width, args.height, args.n
    cams, budget = ring_problem(w, h, n, dev)
    rng = np.random.default_rng(0)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rows = []
    for b in args.batches:
        # a fresh scene and Adam for each B, as the JAX step donates them
        step, scene, cam_b, img, bg = batch_problem(cams, budget, b, w, h, n, rng)
        s, a, logs = step(scene, init_adam(scene.params), 0, cam_b, img, bg)
        first_loss = float(logs["loss"])
        dropped = int(logs["num_dropped_pairs"])
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(args.iters)] if cuda else []
        t0 = time.perf_counter()
        for k in range(args.iters):
            if cuda:
                events[k][0].record()
            s, a, logs = step(s, a, k + 1, cam_b, img, bg)
            if cuda:
                events[k][1].record()
        sync()
        dt = (time.perf_counter() - t0) / args.iters
        rows.append({
            "batch_views": b,
            "step_ms": 1e3 * dt,
            "ms_per_view": 1e3 * dt / b,
            "views_per_s": b / dt,
            "device_ms": (sum(x.elapsed_time(y) for x, y in events) / args.iters
                          if cuda else None),
            "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
            "first_step_loss": first_loss,
            "dropped_pairs": max(dropped, int(logs["num_dropped_pairs"])),
        })
        print(json.dumps(rows[-1]), flush=True)
        del s, a, logs, scene
    base = rows[0]["ms_per_view"]
    for r in rows:
        r["speedup_per_view"] = base / r["ms_per_view"]
    result = {"config": f"{w}x{h}, {n} splats, budget {budget}", "device": dev.type,
              "rows": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
