"""Training entry point.

Counterpart of the JAX package's ``scripts/train.py`` (itself capability
parity with the reference's ``scripts/train.py``): a YAML or JSON config with
``--set`` overrides, a COLMAP or Blender scene with a holdout split, the
``Trainer`` loop on the CUDA kernels, checkpoints and resume, PLY exports.

Usage:
    python -m gaussian_splatting_lightning_tpu_torch.scripts.train \
        -c configs/train_gs.yaml [--seed 42] [--iters N] [--out-dir runs] \
        [--resume CKPT_DIR|auto] [--set train.num_iters=100 ...] [--device cuda]

``--device cpu`` runs every kernel's plain PyTorch version (slow; for tests).
The run directory ``<out-dir>/<exp_name>/<run_name>-<time>/`` receives
``config.json``, ``train_log.jsonl``, ``valid_log.jsonl``, validation
triptychs, PLYs and ``ckpt-XXXXXXXX/`` checkpoints.

A mesh (``mesh_view``, ``mesh_tile``) runs one process per rank:

    python -m torch.distributed.run --nproc-per-node 4 \
        -m gaussian_splatting_lightning_tpu_torch.scripts.train \
        -c configs/train_gs.yaml --set mesh_view=2 --set mesh_tile=2

Each rank takes ``cuda:{LOCAL_RANK % device_count}`` (or the CPU with
``--device cpu``), NCCL when every rank has a card of its own, gloo
otherwise; rank 0 writes the run directory. On NCCL the sharded step and the
exposure update replay captured CUDA graphs (``parallel/shard.py``). Under
torchrun one rank is a job too (``--nproc-per-node 1`` with ``mesh_view=1``,
``mesh_tile=1``: a 1x1 mesh).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path

LAUNCH = ("python -m torch.distributed.run --nproc-per-node N "
          "-m gaussian_splatting_lightning_tpu_torch.scripts.train ...")


def load_views(d, holdout_every_default: int = 8):
    """(train views, valid views, init points xyz, rgb or None, scene
    normalisation) of the data config ``d``; rgb is None for a Blender scene,
    whose points come from ``random_init_points``."""
    from gaussian_splatting_lightning_tpu_torch.data.colmap import (
        get_nerf_norm,
        read_reconstruction,
    )
    from gaussian_splatting_lightning_tpu_torch.data.dataset import ColmapDataset
    from gaussian_splatting_lightning_tpu_torch.data.nerf import (
        NerfDataset,
        is_nerf_dataset,
        nerf_norm_from_views,
    )

    if is_nerf_dataset(d.colmap_path):
        # Blender / NeRF-synthetic scene: transforms_*.json cameras, RGBA
        # over the background, SfM-free random-point initialization
        common = dict(scene_path=d.colmap_path, resize_to=d.resize_to,
                      downscale=d.downscale, white_background=d.white_background,
                      z_near=d.z_near, z_far=d.z_far)
        train_ds = NerfDataset(split="train", **common)
        train_views = [train_ds[i] for i in range(len(train_ds))]
        try:
            valid_ds = NerfDataset(split="val", **common)
            valid_views = [valid_ds[i] for i in range(len(valid_ds))]
        except FileNotFoundError:
            k = d.holdout_every or holdout_every_default
            valid_views = train_views[::k]
            train_views = [v for i, v in enumerate(train_views) if i % k]
        return train_views, valid_views, None, None, nerf_norm_from_views(train_views)
    rec = read_reconstruction(d.colmap_path)
    common = dict(colmap_path=d.colmap_path, image_folder=d.image_folder,
                  mask_folder=d.mask_folder, depth_folder=d.depth_folder,
                  resize_to=d.resize_to, downscale=d.downscale,
                  white_background=d.white_background, z_near=d.z_near,
                  z_far=d.z_far, reconstruction=rec)
    if d.train_idx_file:
        train_ds = ColmapDataset(image_idx=d.train_idx_file, **common)
        valid_ds = ColmapDataset(image_idx=d.valid_idx_file, **common)
        train_views = [train_ds[i] for i in range(len(train_ds))]
        valid_views = [valid_ds[i] for i in range(len(valid_ds))]
    else:
        ds = ColmapDataset(**common)
        views = [ds[i] for i in range(len(ds))]
        k = d.holdout_every or holdout_every_default
        valid_views = views[::k]
        train_views = [v for i, v in enumerate(views) if i % k]
    return train_views, valid_views, rec.points_xyz, rec.points_rgb, get_nerf_norm(rec)


def main(argv=None):
    """Run training; returns the ``Trainer`` after its final validation. A
    rank of a mesh leaves the job (``parallel.shutdown``) before it returns
    or raises."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--iters", type=int, default=None)
    parser.add_argument("--out-dir", type=str, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="a ckpt-XXXXXXXX directory, or 'auto': the newest "
                        "checkpoint of the most recently written run")
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="dotted config override, e.g. --set train.num_iters=100 "
        "--set train.tiling.max_pairs=1048576 (repeatable)",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain versions)")
    args = parser.parse_args(argv)

    from gaussian_splatting_lightning_tpu_torch.parallel import shutdown
    from gaussian_splatting_lightning_tpu_torch.training.config import load_config

    cfg = load_config(args.config, overrides=args.set)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=args.seed))
    if args.iters is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 num_iters=args.iters))
    mesh, device = build_mesh(cfg, args.device)
    try:
        return run(args, cfg, mesh, device)
    finally:
        if mesh is not None:  # the graphs go first, on an error path too
            shutdown(mesh)


def run(args, cfg, mesh, device):
    """Train on this rank (``mesh`` None: one process); returns the
    ``Trainer`` after its final validation."""
    from gaussian_splatting_lightning_tpu_torch.data.nerf import random_init_points
    from gaussian_splatting_lightning_tpu_torch.models import from_points, save_ply
    from gaussian_splatting_lightning_tpu_torch.training.trainer import (
        Trainer,
        find_resume_checkpoint,
    )

    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a: None)

    out_dir = Path(args.out_dir or cfg.out_dir) / cfg.exp_name / (
        cfg.run_name + time.strftime("-%Y%m%d-%H%M%S"))
    if mesh is not None:  # rank 0's clock names the run directory
        import torch.distributed as dist

        name = [str(out_dir)]
        dist.broadcast_object_list(name, src=0)
        out_dir = Path(name[0])
    if rank0:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "config.json").write_text(
            json.dumps(dataclasses.asdict(cfg), indent=2, default=str))

    train_views, valid_views, pts_xyz, pts_rgb, norm = load_views(cfg.data)
    if pts_xyz is None:
        pts_xyz, pts_rgb = random_init_points(n=min(cfg.capacity, 100_000),
                                              seed=cfg.train.seed)
    say(f"scene radius (spatial scale): {norm['radius']:.3f}")
    scene = from_points(pts_xyz, pts_rgb, capacity=cfg.capacity,
                        sh_degree=cfg.sh_degree, device=device)
    say(f"init: {len(pts_xyz)} points, capacity {cfg.capacity}, "
        f"{len(train_views)} train / {len(valid_views)} valid views, {device}")

    trainer = Trainer(cfg.train, scene, norm["radius"], train_views, valid_views,
                      out_dir=out_dir, mesh=mesh)
    if args.resume:
        resume_path = args.resume
        if resume_path == "auto":
            best = find_resume_checkpoint(out_dir.parent)
            resume_path = str(best) if best else None
            if best:
                say(f"--resume auto: run {best.parent.name}, "
                    f"step {int(best.name.split('-')[-1])}")
                prev_cfg = best.parent / "config.json"
                if rank0 and prev_cfg.exists() and prev_cfg.read_text() != (
                        out_dir / "config.json").read_text():
                    say("WARNING: resumed run's config.json differs from the "
                        "current config — trajectories will diverge")
        if resume_path:
            trainer.restore_checkpoint(resume_path)
            say(f"resumed from {resume_path} at step {trainer.step}")
    trainer.train()
    trainer.validate()
    if rank0:
        save_ply(trainer.scene, out_dir / "point_cloud-final.ply")
    say(f"done; artifacts in {out_dir}")
    return trainer


def build_mesh(cfg, device):
    """(mesh or None, this rank's device). A mesh (``mesh_view`` > 1 or a
    ``mesh_tile``) needs the ranks that torchrun starts; several ranks with
    no mesh asked would each train alone, so both refuse. With a mesh the
    caller leaves the job with ``parallel.shutdown(mesh)``."""
    from gaussian_splatting_lightning_tpu_torch.device import resolve_device
    from gaussian_splatting_lightning_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        shutdown,
    )

    asked = cfg.mesh_tile is not None or cfg.mesh_view > 1
    # torchrun's rendezvous (it sets MASTER_ADDR) joins a job of one rank too
    torchrun = asked and "MASTER_ADDR" in os.environ
    info = init_distributed(device, init_method="env://" if torchrun else None)
    if info is None:
        if asked:
            raise ValueError(f"mesh_view={cfg.mesh_view}, mesh_tile={cfg.mesh_tile} needs "
                             f"one process per rank: launch with {LAUNCH}")
        return None, resolve_device(device)
    if not asked:
        shutdown()
        raise ValueError(f"{info.world_size} ranks but no mesh asked: set mesh_view "
                         "and/or mesh_tile")
    try:
        mesh = make_mesh(view=cfg.mesh_view, tile=cfg.mesh_tile, info=info)
    except BaseException:
        shutdown()
        raise
    if mesh.rank == 0:
        print(f"mesh: view={mesh.shape['view']} x tile={mesh.shape['tile']} "
              f"({mesh.size} devices)")
        if mesh.shape["tile"] > 16:
            print("WARNING: tile rings beyond 16 devices scale poorly (bands "
                  "shrink below the per-splat O(capacity) stages — BENCH.md); "
                  "the designed operating point is a HYBRID mesh: keep "
                  "mesh_tile at 8-16 and grow mesh_view (e.g. "
                  "--set mesh_view=4 --set mesh_tile=8)")
    return mesh, info.device


if __name__ == "__main__":
    main()
