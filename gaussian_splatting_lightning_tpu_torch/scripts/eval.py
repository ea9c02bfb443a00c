"""Evaluate a trained checkpoint over a validation split.

Counterpart of the JAX package's ``scripts/eval.py``: render every selected
view of a COLMAP or Blender scene and report per-view and mean PSNR, SSIM
and L1 of the render clipped to [0, 1], and LPIPS with ``--lpips-weights``
(an ``lpips_vgg16.npz`` in the layout of the JAX package's
``scripts/export_lpips_weights.py``; ``ops/lpips.py``). Renders go through
the CUDA kernels under a pair budget sized for the evaluated views
(``--use-oracle``: the readable oracle rasterizer), SSIM through the blur
kernel. On the card the render and the metrics replay captured graphs
(``training/trainer.make_render``, ``utils/graph.py``), as the JAX CLI jits
its render; the oracle and LPIPS run eagerly.

Usage:
    python -m gaussian_splatting_lightning_tpu_torch.scripts.eval CKPT.ply \
        --colmap PATH --image-folder PATH [--resize-to 1600 | --downscale 0.5] \
        [--holdout-every 8] [--idx-file eval.txt] [--white-background] \
        [--use-oracle] [--lpips-weights lpips_vgg16.npz] [--out metrics.json] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def main(argv=None):
    """Run the evaluation; returns ``{"views": [...], "mean": {...}}``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint")
    parser.add_argument("--colmap", required=True)
    parser.add_argument("--image-folder", default=None,
                        help="required for COLMAP scenes; unused for "
                        "Blender transforms.json scenes")
    parser.add_argument("--resize-to", type=int, default=None)
    parser.add_argument("--downscale", type=float, default=None)
    parser.add_argument("--holdout-every", type=int, default=None,
                        help="evaluate every Nth view (llff-style split)")
    parser.add_argument("--idx-file", default=None)
    parser.add_argument("--white-background", action="store_true")
    parser.add_argument("--use-oracle", action="store_true",
                        help="the readable oracle rasterizer (ops/rasterize_reference.py)")
    parser.add_argument("--lpips-weights", default=None,
                        help="path to an lpips_vgg16.npz (the JAX package's "
                        "scripts/export_lpips_weights.py layout); adds LPIPS "
                        "to the metrics")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain versions)")
    args = parser.parse_args(argv)

    from gaussian_splatting_lightning_tpu_torch.core.camera import camera_from_matrices
    from gaussian_splatting_lightning_tpu_torch.data.dataset import ColmapDataset
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
    from gaussian_splatting_lightning_tpu_torch.ops.ssim import psnr, ssim
    from gaussian_splatting_lightning_tpu_torch.training.trainer import make_render
    from gaussian_splatting_lightning_tpu_torch.utils import graph

    scene = load_ply(args.checkpoint, device=args.device)
    lpips_weights = None
    if args.lpips_weights:
        from gaussian_splatting_lightning_tpu_torch.ops.lpips import load_weights, lpips

        lpips_weights = {k: torch.from_numpy(v).to(scene.device)
                         for k, v in load_weights(args.lpips_weights).items()}
    if is_nerf_dataset(args.colmap):
        split = "test" if (Path(args.colmap) / "transforms_test.json").exists() else "train"
        ds = NerfDataset(
            args.colmap, split=split,
            resize_to=args.resize_to, downscale=args.downscale,
            white_background=args.white_background, preload_data=False,
        )
    else:
        ds = ColmapDataset(
            args.colmap, args.image_folder, image_idx=args.idx_file,
            resize_to=args.resize_to, downscale=args.downscale,
            white_background=args.white_background, preload_data=False,
        )
    indices = list(range(len(ds)))
    if args.holdout_every:
        indices = indices[:: args.holdout_every]
    views = [ds[i] for i in indices]
    cams = [camera_from_matrices(v.viewmatrix, v.projmatrix, v.campos, v.tanfovx,
                                 v.tanfovy, device=scene.device) for v in views]
    h, w = views[0].image.shape[-2:]
    # size the static pair budget for THIS scene over the evaluated views
    tiling = None if args.use_oracle else TilingConfig(
        max_pairs=pair_budget(scene, cams, w, h, TilingConfig().resolve_block("cuda")))
    cuda = scene.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    render = None if args.use_oracle else make_render(w, h, tiling)

    def view_metrics(image, gt):
        image = torch.clamp(image, 0.0, 1.0)
        return image, psnr(image, gt), ssim(image, gt), torch.mean(torch.abs(image - gt))

    if cuda:
        captured = graph.capture(lambda _, image, gt: view_metrics(image, gt),
                                 name="eval_metrics")
        metrics = lambda image, gt: captured(None, image, gt)  # noqa: E731
    else:
        metrics = view_metrics

    rows = []
    for i, view, cam in zip(indices, views, cams):
        bg = torch.as_tensor(view.background, dtype=torch.float32).to(scene.device)
        sync()
        t0 = time.perf_counter()
        if args.use_oracle:
            image = rasterize_reference(
                scene.params.xyz, scene.get_opacity(), scene.get_scales(),
                scene.get_rotation(), scene.get_features(), cam, w, h, bg,
                scene.active_sh_degree, alive=scene.alive,
            ).image
        else:
            out, stats = render(scene, cam, bg)
            image = out.image
            dropped = int(stats["num_dropped_pairs"])
            if dropped:
                print(f"WARNING: view {i} dropped {dropped} splat-tile pairs "
                      f"(budget {tiling.max_pairs}); metrics are degraded")
        sync()
        render_ms = (time.perf_counter() - t0) * 1e3
        gt = torch.as_tensor(view.image, dtype=torch.float32).to(scene.device)
        image, v_psnr, v_ssim, v_l1 = metrics(image, gt)
        row = dict(view=view.name or str(i), psnr=float(v_psnr), ssim=float(v_ssim),
                   l1=float(v_l1), render_ms=render_ms)
        if lpips_weights is not None:
            sync()
            t0 = time.perf_counter()
            row["lpips"] = float(lpips(image, gt, lpips_weights))
            row["lpips_ms"] = (time.perf_counter() - t0) * 1e3
        rows.append(row)
        print(f"{row['view']}: psnr={row['psnr']:.2f} ssim={row['ssim']:.4f} "
              f"l1={row['l1']:.4f}"
              + (f" lpips={row['lpips']:.4f}" if "lpips" in row else "")
              + f" render={render_ms:.2f} ms")

    keys = ("psnr", "ssim", "l1") + (("lpips",) if lpips_weights is not None else ())
    mean = {k: float(np.mean([r[k] for r in rows])) for k in keys}
    print(f"MEAN over {len(rows)} views: psnr={mean['psnr']:.2f} "
          f"ssim={mean['ssim']:.4f} l1={mean['l1']:.4f}"
          + (f" lpips={mean['lpips']:.4f}" if "lpips" in mean else ""))
    result = {"views": rows, "mean": mean}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
