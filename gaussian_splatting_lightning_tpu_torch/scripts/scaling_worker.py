"""One rank of ``scripts/benchmark_scaling.py``: the sharded train step on one
mesh shape, under ``torch.distributed.run`` with one rank per mesh device.

Every rank builds the same scene and camera from seeds, runs one step of
``make_sharded_train_step`` (the first, untimed) and ``--iters`` timed
steps, and counts its own work with ``bench.roofline_work`` at its band:
its band's pairs, its band's pixels, the splat tables it holds (all of
them) and the Adam rows it updates (``capacity / n_dev`` under ZeRO-1).
Rank 0 writes every rank's record to ``--out`` as a JSON list.

Usage (what the harness runs):
    python -m torch.distributed.run --standalone --nproc-per-node N \
        -m gaussian_splatting_lightning_tpu_torch.scripts.scaling_worker \
        --view V --tile T --out FILE [--width 512 --height 256 --splats 20000 ...]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--view", type=int, required=True)
    parser.add_argument("--tile", type=int, required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--splats", type=int, default=20_000)
    parser.add_argument("--max-pairs", type=int, default=1 << 17)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--skip-timing", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.parallel import init_distributed, make_mesh
    from gaussian_splatting_lightning_tpu_torch.parallel.shard import (
        make_sharded_train_step,
        shard_adam,
    )
    from gaussian_splatting_lightning_tpu_torch.scripts.bench import roofline_work
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam
    from gaussian_splatting_lightning_tpu_torch.training.trainer import TrainConfig

    # env://: torchrun's rendezvous, which also joins a job of one rank
    info = init_distributed(args.device, init_method="env://")
    mesh = make_mesh(view=args.view, tile=args.tile, info=info)
    dev = info.device
    cuda = dev.type == "cuda"
    w, h, n = args.width, args.height, args.splats
    scene = interop.synthetic_scene(n, n, sh_degree=2, device=dev)
    cfg = TrainConfig(capacity=n, rasterizer="xla", tiling=TilingConfig(
        max_pairs=args.max_pairs, tile_capacity=256, chunk=64))
    step = make_sharded_train_step(cfg, 2.0, w, h, mesh)
    adam = init_adam(scene.params)
    if step.sharded_adam:
        adam = shard_adam(adam, mesh)
    # each view group renders one view of the global batch of n_view views
    cams = stack_cameras([interop.camera(w, h, device=dev)])
    image = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(1, 3, h, w)).astype(np.float32)).to(dev)
    bg = torch.zeros((1, 3), device=dev)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    scene, adam, logs = step(scene, adam, 0, cams, image, bg)
    loss = float(logs["loss"])
    first_s = time.perf_counter() - t0
    band_pairs = int(step.band_stats["num_pairs"].sum())
    dt = float("nan")
    if not args.skip_timing:
        sync()
        mesh.barrier()
        t0 = time.perf_counter()
        for i in range(args.iters):
            scene, adam, logs = step(scene, adam, i + 1, cams, image, bg)
        sync()
        dt = (time.perf_counter() - t0) / args.iters
    block = cfg.tiling.resolve_block(cfg.rasterizer)
    adam_rows = n // mesh.size if step.sharded_adam else n
    ops, nbytes = roofline_work(band_pairs, block, n, w, step.gy_local * block,
                                adam_splats=adam_rows)
    rec = {"rank": info.rank, "view": mesh.axis_index("view"), "tile": mesh.axis_index("tile"),
           "backend": info.backend, "device": str(dev), "step_s": dt, "first_step_s": first_s,
           "loss": loss, "last_loss": float(logs["loss"]),
           "dropped": int(logs["num_dropped_pairs"]),
           "tile_overflow": int(logs["num_tile_overflow"]), "band_pairs": band_pairs,
           "band_rows": step.gy_local * block, "adam_rows": adam_rows,
           "flops": float(ops), "bytes": float(nbytes)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, rec)
    if info.rank == 0:
        Path(args.out).write_text(json.dumps(every))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
