"""Inference entry point: render one trained view and save a triptych.

Counterpart of the JAX package's ``scripts/render.py`` (itself mirroring the
reference's ``scripts/render_trained_image.py``): load a checkpoint PLY, pick
a COLMAP (or Blender) frame, render through the CUDA kernels (or, with
``--use-oracle``, the readable oracle rasterizer), report the render time,
save [GT | render | depth]. On the card the render replays a captured graph
(``training/trainer.make_render``), as the JAX CLI jits it; its first call
warms up and captures.

Usage:
    python -m gaussian_splatting_lightning_tpu_torch.scripts.render CKPT.ply \
        --colmap PATH --image-folder PATH [--image-idx 1] [--resize-to 1600] \
        [--use-oracle] [--out out.png] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint")
    parser.add_argument("--colmap", required=True)
    parser.add_argument("--image-folder", default=None,
                        help="required for COLMAP scenes; unused for "
                        "Blender transforms.json scenes")
    parser.add_argument("--image-idx", type=int, default=None)
    parser.add_argument("--resize-to", type=int, default=None)
    parser.add_argument("--downscale", type=float, default=None)
    parser.add_argument("--use-oracle", action="store_true",
                        help="the readable oracle rasterizer (ops/rasterize_reference.py)")
    parser.add_argument("--white-background", action="store_true")
    parser.add_argument("--out", default="render.png")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain versions)")
    args = parser.parse_args(argv)

    from gaussian_splatting_lightning_tpu_torch.core.camera import camera_from_matrices
    from gaussian_splatting_lightning_tpu_torch.data.dataset import ColmapDataset
    from gaussian_splatting_lightning_tpu_torch.data.image_io import write_image
    from gaussian_splatting_lightning_tpu_torch.data.nerf import (
        NerfDataset,
        is_nerf_dataset,
    )
    from gaussian_splatting_lightning_tpu_torch.models import load_ply
    from gaussian_splatting_lightning_tpu_torch.ops.budget import pair_budget
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.ops.rasterize_reference import (
        rasterize_reference,
    )
    from gaussian_splatting_lightning_tpu_torch.training.trainer import make_render

    scene = load_ply(args.checkpoint, device=args.device)
    print(f"loaded {scene.n_alive()} splats, SH degree {scene.active_sh_degree}")

    if is_nerf_dataset(args.colmap):
        ds = NerfDataset(
            args.colmap, split="train",
            resize_to=args.resize_to, downscale=args.downscale,
            white_background=args.white_background, preload_data=False,
        )
        index = args.image_idx or 0
    else:
        ds = ColmapDataset(
            args.colmap, args.image_folder,
            resize_to=args.resize_to, downscale=args.downscale,
            white_background=args.white_background, preload_data=False,
        )
        index = 0
        if args.image_idx is not None:
            index = ds.image_indices.index(args.image_idx)
    view = ds[index]
    h, w = view.image.shape[-2:]
    cam = camera_from_matrices(view.viewmatrix, view.projmatrix, view.campos,
                               view.tanfovx, view.tanfovy, device=args.device)
    bg = torch.as_tensor(view.background, dtype=torch.float32).to(scene.device)

    if args.use_oracle:
        out = rasterize_reference(
            scene.params.xyz, scene.get_opacity(), scene.get_scales(),
            scene.get_rotation(), scene.get_features(), cam, w, h, bg,
            scene.active_sh_degree, alive=scene.alive,
        )
    else:
        tiling = TilingConfig(max_pairs=pair_budget(scene, cam, w, h,
                                                    TilingConfig().resolve_block("cuda")))
        render = make_render(w, h, tiling)
        out, stats = render(scene, cam, bg)  # builds the kernels, captures
        dropped = int(stats["num_dropped_pairs"])
        if dropped:
            print(f"WARNING: dropped {dropped} splat-tile pairs "
                  f"(budget {tiling.max_pairs}); image is degraded")
        sync = torch.cuda.synchronize if scene.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out, _ = render(scene, cam, bg)
        sync()
        elapsed = time.perf_counter() - t0
        print(f"render time: {elapsed * 1e3:.2f} ms ({w}x{h}, {scene.device})")

    image = np.clip(out.image.cpu().numpy(), 0, 1)
    depth = out.depth.cpu().numpy()
    depth_n = depth / max(depth.max(), 1e-8)
    trip = np.concatenate(
        [view.image, image, np.repeat(depth_n, 3, axis=0)], axis=-1
    )
    write_image(args.out, (np.moveaxis(trip, 0, -1) * 255).astype(np.uint8))
    print(f"saved {args.out}")
    return image, depth


if __name__ == "__main__":
    main()
