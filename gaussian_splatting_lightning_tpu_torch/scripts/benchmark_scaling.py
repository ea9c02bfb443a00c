"""Scaling harness: rays/s and efficiency of the sharded train step over a
sweep of mesh shapes.

Counterpart of the JAX repo's ``scripts/benchmark_scaling.py``: the same
``TrainConfig`` (``rasterizer="xla"``, ``tile_capacity=256``, ``chunk=64``,
SH 2), image (512x256), scene (20k splats), ``VIEWxTILE`` sweep and skip
rule. Each mesh shape runs as its own ``torch.distributed.run`` job of
``scripts/scaling_worker.py``, one rank per mesh device, through
``parallel/mesh`` and ``make_sharded_train_step``; the backend comes from
``parallel.mesh.choose_backend`` (NCCL when each rank has a card, gloo on the
CPU or on a shared card).

Devices: on ``cuda`` the cards (``torch.cuda.device_count()``; ``--devices``
larger than that lets ranks share a card, and such rows are marked
``shared_card``: not scaling numbers); on ``cpu`` ``--devices`` gloo ranks
(default 32, the JAX harness's virtual CPU mesh).

The "struct eff" columns come from the port's own work count, not from a
compiler's estimate: ``bench.roofline_work``'s operations and bytes at each
rank's band (its band pairs, its band pixels, the splat tables it holds,
its Adam rows under ZeRO-1), the largest over the ranks. A mesh whose
step, or the first mesh's, dropped pairs or overflowed a tile renders
less than the whole frame, so its three eff columns are null ("not
comparable"): the JAX operating point (``--max-pairs 131072``, tile
capacity 256) drops some at 1x1. Prints a line per mesh and, last, a
JSON summary; writes a markdown table to ``--out`` only when given.

Usage: python -m gaussian_splatting_lightning_tpu_torch.scripts.benchmark_scaling \
    [--meshes 1x1,1x2] [--device cuda|cpu] [--devices N] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

WORKER = "gaussian_splatting_lightning_tpu_torch.scripts.scaling_worker"
JOB_TIMEOUT_S = 1800


def _pct(eff) -> str:
    return "n/c" if eff is None else f"{eff:.0%}"


def run_mesh(n_view: int, n_tile: int, args, out: Path) -> list:
    """One ``torch.distributed.run`` job of the worker; every rank's record."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n_view * n_tile), "-m", WORKER,
           "--view", str(n_view), "--tile", str(n_tile), "--out", str(out),
           "--width", str(args.width), "--height", str(args.height),
           "--splats", str(args.splats), "--max-pairs", str(args.max_pairs),
           "--iters", str(args.iters), "--device", args.device]
    if args.skip_timing:
        cmd.append("--skip-timing")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.terminate()  # torchrun's agent stops its ranks on SIGTERM
        stdout, stderr = proc.communicate()
    if proc.returncode != 0 or not out.exists():
        raise SystemExit(f"benchmark_scaling: mesh {n_view}x{n_tile} exited "
                         f"{proc.returncode}:\n{stdout[-4000:]}\n{stderr[-8000:]}")
    return json.loads(out.read_text())


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--splats", type=int, default=20_000)
    parser.add_argument("--max-pairs", type=int, default=1 << 17)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--devices", type=int, default=None,
                        help="devices to sweep over: cards on cuda (default all), "
                        "gloo ranks on cpu (default 32)")
    parser.add_argument("--meshes", default="1x1,1x2,1x4,1x8,1x16,1x32,2x8,4x8,2x16",
                        help="comma-separated VIEWxTILE mesh shapes to sweep")
    parser.add_argument("--skip-timing", action="store_true",
                        help="work counts only: one untimed step per mesh")
    parser.add_argument("--out", default=None, help="also write the markdown table here")
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL across cards) or cpu (gloo ranks)")
    args = parser.parse_args(argv)

    import torch

    from gaussian_splatting_lightning_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    n_avail = args.devices or (n_cards if dev.type == "cuda" else 32)
    w, h, n = args.width, args.height, args.splats

    rows, skipped, base = [], [], None
    with tempfile.TemporaryDirectory() as tmp:
        for spec in args.meshes.split(","):
            n_view, n_tile = (int(x) for x in spec.strip().split("x"))
            n_dev = n_view * n_tile
            if n_dev > n_avail:
                print(f"skip {n_view}x{n_tile}: only {n_avail} devices", flush=True)
                skipped.append(f"{n_view}x{n_tile}")
                continue
            ranks = run_mesh(n_view, n_tile, args, Path(tmp) / f"{n_view}x{n_tile}.json")
            dt = max(r["step_s"] for r in ranks)  # the step ends with its slowest rank
            flops = max(r["flops"] for r in ranks)
            bytes_ = max(r["bytes"] for r in ranks)
            rays = w * h * n_view / dt  # the global batch renders n_view views a step
            dropped = max(r["dropped"] for r in ranks)
            overflow = max(r["tile_overflow"] for r in ranks)
            if base is None:
                # relative to the first mesh run, whatever its size
                base = (flops, bytes_, n_tile, n_dev, rays / n_dev, dropped + overflow == 0)
                if n_dev != 1:
                    print(f"WARNING: baseline mesh is {n_view}x{n_tile} ({n_dev} devices), "
                          "not 1x1: the eff columns are relative to it", flush=True)
            # never compare across a drop: both steps must render everything
            comparable = base[5] and dropped + overflow == 0
            row = {
                "mesh": f"{n_view}x{n_tile}", "backend": ranks[0]["backend"],
                "shared_card": dev.type == "cuda" and n_dev > n_cards,
                "step_ms": 1e3 * dt, "rays_per_s": rays,
                "wall_eff": (rays / n_dev) / base[4] if comparable else None,
                "gflop_per_dev": flops / 1e9, "gb_per_dev": bytes_ / 1e9,
                # ideal per-device work for one view is work(1 view) / n_tile
                "flops_eff": base[0] * base[2] / (n_tile * flops) if comparable else None,
                "bytes_eff": base[1] * base[2] / (n_tile * bytes_) if comparable else None,
                "loss": ranks[0]["loss"], "last_loss": ranks[0]["last_loss"],
                "dropped": dropped, "tile_overflow": overflow,
                "band_pairs": [r["band_pairs"] for r in ranks],
            }
            rows.append(row)
            note = " (ranks share a card: not a scaling number)" if row["shared_card"] else ""
            print(f"mesh={row['mesh']} ({row['backend']}): {row['step_ms']:.1f} ms/step, "
                  f"{rays:,.0f} rays/s, wall eff {_pct(row['wall_eff'])} | per-device "
                  f"{row['gflop_per_dev']:.2f} GFLOP, {row['gb_per_dev']:.3f} GB | struct eff "
                  f"flops {_pct(row['flops_eff'])} bytes {_pct(row['bytes_eff'])} | dropped "
                  f"{dropped}, tile overflow {overflow}{note}", flush=True)

    if args.out:
        where = (f"{n_avail} x {torch.cuda.get_device_name(0)}" if dev.type == "cuda"
                 else f"{n_avail} gloo ranks on the CPU")
        lines = [
            "# Scaling (tile-sharded train step, fwd+bwd, the port)",
            "",
            f"{where} | {w}x{h} px, {n} splats, SH2, route xla",
            "",
            "'struct eff' columns are the port's own work count (bench.roofline_work at",
            "each rank's band: band pairs, band pixels, the splat tables held, the Adam",
            "rows under ZeRO-1), not a compiler's estimate: work(first mesh) /",
            "(n_tile * work(this mesh)), the largest rank's work. 'wall eff' of ranks",
            "on the CPU or sharing a card only shows that the program runs. A mesh",
            "whose step or the first mesh's dropped pairs or overflowed a tile has no",
            "eff columns (n/c: not comparable).",
            "",
            "| mesh (view x tile) | backend | ms/step | rays/s | wall eff | GFLOP/dev |"
            " GB/dev | flops eff | bytes eff | dropped | tile overflow | shared card |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|",
        ]
        for r in rows:
            lines.append(
                f"| {r['mesh']} | {r['backend']} | {r['step_ms']:.1f} | {r['rays_per_s']:,.0f} "
                f"| {_pct(r['wall_eff'])} | {r['gflop_per_dev']:.2f} | {r['gb_per_dev']:.3f} | "
                f"{_pct(r['flops_eff'])} | {_pct(r['bytes_eff'])} | {r['dropped']} | "
                f"{r['tile_overflow']} | {r['shared_card']} |")
        Path(args.out).write_text("\n".join(lines) + "\n")
        print(f"wrote {args.out}")
    result = {"device": dev.type, "devices": n_avail, "rows": rows, "skipped": skipped}
    print(json.dumps(result), flush=True)
    if any(not math.isfinite(r["loss"]) for r in rows):
        raise SystemExit("benchmark_scaling: FAILED: a non-finite loss")
    return result


if __name__ == "__main__":
    main()
