"""Check the banded kernel path (the tile bands of a mesh) on one device.

Counterpart of the JAX repo's ``scripts/tpu_banded_check.py``:

1. one ``preprocess`` feeds a full-frame render and ``bands`` band renders
   on route "cuda" (``rasterize(..., tile_y_offset=b * gy_local,
   grid_y_local=gy_local)``: local tile grids, y-offset tile rects,
   band-local binning), and the stitched bands are compared with the full
   frame;
2. the per-tile depth-ordered pair lists of each band are compared with the
   full frame's;
3. one ``make_sharded_train_step`` on a 1x1 mesh (this process alone, NCCL
   on a card, where the step is captured and replayed as a CUDA graph, gloo
   on the CPU, where it runs eagerly) is compared with the one-process step.

Prints the record as JSON (the last line) and writes it to ``--out`` when
given; exits 1 when it is not ``ok``.

Usage: python -m gaussian_splatting_lightning_tpu_torch.scripts.banded_check \
    [--width 512 --height 384 --splats 100000 --bands 2] [--out FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import socket
from pathlib import Path

import numpy as np

BAND_PSNR_DB = 60.0  # stitched bands against the full frame, at least
SHARDED_LOSS_TOL = 1e-5  # the 1x1 mesh step's loss against one process, relative


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_check(width=512, height=384, splats=100_000, bands=2, out=None,
              device="cuda") -> dict:
    """Run the three checks; returns the record (``ok`` and the numbers)."""
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
    from gaussian_splatting_lightning_tpu_torch.ops import binning
    from gaussian_splatting_lightning_tpu_torch.ops.budget import pair_budget
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig, preprocess
    from gaussian_splatting_lightning_tpu_torch.ops.rasterize import rasterize
    from gaussian_splatting_lightning_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        shutdown,
    )
    from gaussian_splatting_lightning_tpu_torch.parallel.shard import (
        make_sharded_train_step,
        shard_adam,
    )
    from gaussian_splatting_lightning_tpu_torch.scripts.bench import activated
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam
    from gaussian_splatting_lightning_tpu_torch.training.trainer import (
        TrainConfig,
        make_train_step,
    )

    w, h, n = width, height, splats

    def fresh():  # the scene anew: each step donates its own
        return interop.synthetic_scene(n, n, scale=0.01, device=device)

    scene = fresh()
    cam = interop.camera(w, h, device=device)
    dev = scene.device
    budget = pair_budget(scene, cam, w, h, headroom=2.0)
    cfg = TilingConfig(max_pairs=budget)
    blk = cfg.resolve_block("cuda")
    grid_x, grid_y = binning.grid_shape(w, h, blk, blk)
    if grid_y % bands:
        raise ValueError(f"{grid_y} tile rows do not divide into {bands} bands")
    gy_local = grid_y // bands
    p = activated(scene)
    bg = torch.zeros(3, device=dev)

    # one preprocess renders the full frame and every band from the same
    # values, isolating the banded binning and compositing
    with torch.no_grad():
        prep = preprocess(*p, cam, w, h, 3)
        full, _ = rasterize(*p, cam, w, h, bg, 3, config=cfg, prep=prep)
        band_imgs, dropped = [], 0
        for b in range(bands):
            ob, stats = rasterize(*p, cam, w, h, bg, 3, config=cfg, prep=prep,
                                  tile_y_offset=b * gy_local, grid_y_local=gy_local)
            band_imgs.append(ob.image)
            dropped += int(stats["num_dropped_pairs"])
        img_full = full.image.cpu().numpy()
        stitched = torch.cat(band_imgs, dim=1)[:, :h].cpu().numpy()

        diff = np.abs(stitched - img_full)
        delta, mean_delta = float(diff.max()), float(diff.mean())
        mse = float((diff.astype(np.float64) ** 2).mean())
        psnr_vs_full = float(10 * np.log10(1.0 / max(mse, 1e-20)))
        print(f"banded vs full-frame ({bands} bands on {dev.type}): max |delta| = "
              f"{delta:.3e}, mean = {mean_delta:.3e}, psnr = {psnr_vs_full:.1f} dB, "
              f"dropped={dropped}")

        # the exact claim: each band does the full frame's per-tile work
        def lists(bins):
            start, count, ids = (x.cpu().numpy() for x in
                                 (bins.tile_start, bins.tile_count, bins.gauss_s))
            return [ids[s:s + c] for s, c in zip(start, count)]

        full_lists = lists(binning.build_sorted_bins(prep, grid_x, grid_y, budget, block=blk))
        band_lists = []
        for b in range(bands):
            band_lists += lists(binning.build_sorted_bins(
                prep, grid_x, grid_y, budget, b * gy_local, gy_local, block=blk))
    lists_equal = len(band_lists) == len(full_lists) and all(
        np.array_equal(a, b) for a, b in zip(band_lists, full_lists))
    print(f"per-tile pair lists identical: {lists_equal}")

    # the sharded step on a 1x1 mesh (captured on NCCL, as the mesh Trainer
    # runs it) against the eager one-process step: the check is of values
    tcfg = TrainConfig(capacity=scene.capacity, adaptive_pairs=False, rasterizer="cuda",
                       tiling=cfg)
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(1, 3, h, w)).astype(np.float32)).to(dev)
    bgs = torch.zeros(1, 3, device=dev)
    _, _, logs = make_train_step(tcfg, 2.0, w, h, capture=False)(
        fresh(), init_adam(scene.params), 0, cam, target[0], bgs[0])
    ref_loss = float(logs["loss"])
    info = init_distributed(dev.type, rank=0, world_size=1,
                            init_method=f"tcp://localhost:{_free_port()}")
    mesh = None
    try:
        mesh = make_mesh(view=1, tile=1, info=info)
        step = make_sharded_train_step(tcfg, 2.0, w, h, mesh)
        adam = init_adam(scene.params)
        if step.sharded_adam:
            adam = shard_adam(adam, mesh)
        _, _, logs = step(fresh(), adam, 0, stack_cameras([cam]), target, bgs)
        loss = float(logs["loss"])
    finally:
        shutdown(mesh)  # the step's graph goes before the communicators it uses
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    print(f"sharded 1x1 step ({info.backend}): loss={loss:.6f}, one process "
          f"{ref_loss:.6f} ({loss_err:.2e} relative)")

    rec = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "width": w, "height": h, "splats": n, "bands": bands,
        "banded_vs_full_max_delta": delta,
        "banded_vs_full_mean_delta": mean_delta,
        "banded_vs_full_psnr_db": psnr_vs_full,
        "per_tile_pair_lists_identical": bool(lists_equal),
        "banded_dropped_pairs": dropped,
        "sharded_1x1_loss": loss,
        "sharded_1x1_backend": info.backend,
        "one_process_loss": ref_loss,
        "sharded_1x1_loss_rel_err": loss_err,
        "ok": bool(lists_equal and psnr_vs_full > BAND_PSNR_DB and dropped == 0
                   and np.isfinite(loss) and loss_err <= SHARDED_LOSS_TOL),
    }
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(rec, indent=2))
        print(f"wrote {out}")
    return rec


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=384)
    parser.add_argument("--splats", type=int, default=100_000)
    parser.add_argument("--bands", type=int, default=2)
    parser.add_argument("--out", default=None, help="also write the record here")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain versions)")
    args = parser.parse_args(argv)
    rec = run_check(args.width, args.height, args.splats, args.bands, args.out, args.device)
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
