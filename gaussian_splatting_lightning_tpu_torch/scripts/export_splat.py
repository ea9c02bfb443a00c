"""Convert a trained PLY checkpoint to the web-viewer ``.splat`` format.

Counterpart of the JAX package's ``scripts/export_splat.py``; the layout is
in ``models/splat_export.py``.

Usage:
    python -m gaussian_splatting_lightning_tpu_torch.scripts.export_splat CKPT.ply \
        [--out scene.splat] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    """Write the .splat file; returns the number of splats written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda",
                        help="where the checkpoint is loaded (cuda or cpu)")
    args = parser.parse_args(argv)

    from gaussian_splatting_lightning_tpu_torch.models import load_ply, save_splat

    out = args.out or str(Path(args.checkpoint).with_suffix(".splat"))
    scene = load_ply(args.checkpoint, device=args.device)
    n = save_splat(scene, out)
    print(f"wrote {n} splats ({n * 32 / 1e6:.1f} MB) to {out}")
    return n


if __name__ == "__main__":
    main()
