"""Render a smooth camera path through a trained scene.

Counterpart of the JAX package's ``scripts/render_path.py``: keyframes are
the dataset's camera poses (COLMAP or Blender), the path interpolates
between them (slerp rotation, Catmull-Rom position), frames render through
the CUDA kernels under one pair budget sized over the keyframes with 1.5x
headroom, and are written as PNGs plus an optional looping GIF (Pillow).
Each frame's render time is taken by CUDA events and by the host clock. On
the card every frame replays one captured graph
(``training/trainer.make_render``), as the JAX CLI jits its render.

Usage:
    python -m gaussian_splatting_lightning_tpu_torch.scripts.render_path CKPT.ply \
        --colmap PATH [--image-folder PATH] [--n-frames 120] [--downscale 0.5] \
        [--loop] [--out frames_dir] [--gif path.gif] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical interpolation between two wxyz quaternions."""
    d = float(np.dot(q0, q1))
    if d < 0.0:  # shortest arc
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) rotation -> wxyz unit quaternion."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def catmull_rom(p0, p1, p2, p3, t: float) -> np.ndarray:
    """Centripetal-flavored cubic through p1..p2 (standard CR, tau=0.5)."""
    t2, t3 = t * t, t * t * t
    return 0.5 * (
        (2 * p1)
        + (-p0 + p2) * t
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
        + (-p0 + 3 * p1 - 3 * p2 + p3) * t3
    )


def interpolate_path(keys, n_frames: int, loop: bool):
    """keys: list of (R world->cam rows, C camera center). Yields (R, C)."""
    m = len(keys)
    quats = [rotmat_to_quat(R) for R, _ in keys]
    cents = [C for _, C in keys]
    n_seg = m if loop else m - 1
    for f in range(n_frames):
        u = f * n_seg / n_frames if loop else f * n_seg / max(n_frames - 1, 1)
        s = min(int(u), n_seg - 1)
        t = u - s

        def k(i):
            return (i % m) if loop else min(max(i, 0), m - 1)

        C = catmull_rom(
            cents[k(s - 1)], cents[k(s)], cents[k(s + 1)], cents[k(s + 2)], t
        )
        q = slerp(quats[k(s)], quats[k(s + 1)], t)
        yield quat_to_rotmat(q), C


def main(argv=None):
    """Render the path; returns the frame count, the pairs dropped over all
    frames, the per-frame render times and the budget."""
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint")
    parser.add_argument("--colmap", required=True)
    parser.add_argument("--image-folder", default=None)
    parser.add_argument("--n-frames", type=int, default=120)
    parser.add_argument("--resize-to", type=int, default=None)
    parser.add_argument("--downscale", type=float, default=None)
    parser.add_argument("--white-background", action="store_true")
    parser.add_argument("--loop", action="store_true",
                        help="close the path back to the first keyframe")
    parser.add_argument("--out", default="path_frames")
    parser.add_argument("--gif", default=None)
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain versions)")
    args = parser.parse_args(argv)

    import torch

    from gaussian_splatting_lightning_tpu_torch.core.camera import (
        camera_from_matrices,
        make_camera,
    )
    from gaussian_splatting_lightning_tpu_torch.data.dataset import ColmapDataset
    from gaussian_splatting_lightning_tpu_torch.data.image_io import write_gif, write_image
    from gaussian_splatting_lightning_tpu_torch.data.nerf import (
        NerfDataset,
        is_nerf_dataset,
    )
    from gaussian_splatting_lightning_tpu_torch.models import load_ply
    from gaussian_splatting_lightning_tpu_torch.ops.budget import pair_budget
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import make_render
    from gaussian_splatting_lightning_tpu_torch.utils.runtime import StepTimer

    scene = load_ply(args.checkpoint, device=args.device)
    dev = scene.device
    print(f"loaded {scene.n_alive()} splats")

    common = dict(
        resize_to=args.resize_to, downscale=args.downscale,
        white_background=args.white_background, preload_data=False,
    )
    if is_nerf_dataset(args.colmap):
        ds = NerfDataset(args.colmap, split="train", **common)
    else:
        ds = ColmapDataset(args.colmap, args.image_folder, **common)
    views = [ds[i] for i in range(len(ds))]
    h, w = views[0].image.shape[-2:]
    fx = (w * 0.5) / views[0].tanfovx
    fy = (h * 0.5) / views[0].tanfovy
    bg = torch.as_tensor(views[0].background, dtype=torch.float32).to(dev)

    # keyframes: (world->cam rotation rows, camera center), in dataset order
    keys = []
    for v in views:
        R = np.asarray(v.viewmatrix, dtype=np.float64)[:3, :3].T
        keys.append((R, np.asarray(v.campos, dtype=np.float64)))

    key_cams = [camera_from_matrices(v.viewmatrix, v.projmatrix, v.campos, v.tanfovx,
                                     v.tanfovy, device=dev) for v in views]
    # interpolated poses lie between the keyframes; extra headroom covers
    # pair-count variation along the path
    tiling = TilingConfig(max_pairs=pair_budget(
        scene, key_cams, w, h, TilingConfig().resolve_block("cuda"), headroom=1.5))
    render = make_render(w, h, tiling)

    cuda = dev.type == "cuda"
    timer = StepTimer(skip_first=0)
    event_ms = []
    dropped = 0
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    gif_frames = []
    for i, (R, C) in enumerate(interpolate_path(keys, args.n_frames, args.loop)):
        t = -R @ C
        cam = make_camera(np.concatenate([R, t[:, None]], 1), fx, fy, w, h, device=dev)
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
        with timer:
            if cuda:
                start.record()
            out, stats = render(scene, cam, bg)
            if cuda:
                end.record()
                torch.cuda.synchronize()
        if cuda:
            event_ms.append(start.elapsed_time(end))
        n_dropped = int(stats["num_dropped_pairs"])
        if n_dropped and not dropped:
            print(f"WARNING: dropped {n_dropped} splat-tile pairs "
                  f"(budget {tiling.max_pairs})")
        dropped += n_dropped
        img8 = (torch.clamp(out.image, 0.0, 1.0).permute(1, 2, 0) * 255.0 + 0.5
                ).to(torch.uint8).cpu().numpy()
        write_image(out_dir / f"frame_{i:05d}.png", img8)
        if args.gif:
            gif_frames.append(img8)
        if i % 10 == 0:
            print(f"frame {i}/{args.n_frames}")
    if args.gif:
        write_gif(args.gif, gif_frames, args.fps)
        print(f"wrote {args.gif}")
    print(f"wrote {args.n_frames} frames to {out_dir}")
    wall = timer.summary()
    if event_ms:
        print(f"frame render: median {sorted(event_ms)[len(event_ms) // 2]:.3f} ms "
              f"(CUDA events), host wall p50 {wall['p50_ms']:.3f} ms")
    return {"frames": args.n_frames, "dropped_pairs": dropped, "event_ms": event_ms,
            "wall": wall, "max_pairs": tiling.max_pairs}


if __name__ == "__main__":
    main()
