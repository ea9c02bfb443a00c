"""Run one cell of the port's benchmark once and print its result line.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit (also the last lines of standard error). Without the cards
the cell asks for, or with JAX or the JAX package loaded once the line is
built, the run exits non-zero and prints no result.

A cell whose configuration has a ``mesh`` runs on one process per card
(``ranks.py``): rank 0 builds the line; a rank with JAX loaded in its
process once its part is done exits non-zero; this process prints the line
once every rank has exited 0, and exits non-zero with no line when a rank
fails or stalls.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent  # the checkout
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_splatting_lightning_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's or
    the JAX package's, compared whole: the port's name begins with the JAX
    package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


@dataclass
class Context:
    """What a per-layer metric's reader reads."""

    trace: object  # trace.Trace of the traced steps
    chips: int
    step_s: float  # the window's wall over its steps
    work: dict  # contributing evaluations and visible splats of the traced steps
    params: int  # parameters (floats) of the store
    capacity: int
    pixels_per_step: int
    busy_s: float  # the device's busy time of the traced steps, the ranks' mean


def _params(config: dict) -> int:
    k = (config["sh_degree"] + 1) ** 2
    return config["capacity"] * (3 + 3 * k + 1 + 3 + 4)


def result_line(spec: dict, res: dict, trace: bool, kind: str, count: int,
                here: Path | None = None) -> dict:
    """The result line of run ``res``; ``here`` is where the per-layer
    readers are (``gsbench/``)."""
    from gsbench import manifest

    limits = spec["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in res["checks"].items()
              if k in limits}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    breakdown = None
    if not trace:
        rate = res["steps"] * res["pixels_per_step"] / res["wall_s"] / 1e6
        values = {"train_mrays_per_s": rate, "setup_s": res["setup_s"]}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        tr = res["trace"]
        config = spec["config"]
        ctx = Context(tr, spec["chips"], res["wall_s"] / res["steps"], res.get("work"),
                      _params(config), config["capacity"], res["pixels_per_step"],
                      res.get("busy_s", tr.busy_s))
        for m in spec["per_layer"]:
            value = manifest.reader(m["name"], here or manifest.HERE)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = ctx.busy_s
        device["window_s"] = tr.wall_s
        breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps[:10]}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def refused() -> bool:
    """True, with what was found named on standard error, when JAX or the
    JAX package is loaded in this process."""
    found = forbidden_modules()
    if found:
        print(f"gsbench: JAX modules loaded: {', '.join(found)}", file=sys.stderr)
    return bool(found)


def show(line: dict) -> None:
    """Each check beside its limit on standard error, then the line last on
    standard output."""
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def emit(spec: dict, res: dict, trace: bool, kind: str, count: int,
         here: Path | None = None) -> int:
    """Build the result line (the per-layer readers load here), then refuse
    it if JAX or the JAX package is loaded; else show it."""
    line = result_line(spec, res, trace, kind, count, here)
    if refused():
        return 3
    show(line)
    return 0


def _diag(res: dict) -> None:
    diag = {k: res[k] for k in ("steps", "wall_s", "setup_s", "budget", "pairs", "lines",
                                "chunk_s", "readings", "work") if k in res}
    print("gsbench: " + json.dumps(diag), file=sys.stderr, flush=True)


def rank_run(ranks, spec: dict, seed: int, seconds: float, trace: bool,
             t_start: float) -> None:
    """One rank of a mesh cell's run; rank 0 hands back the result line.
    Every rank, once its part is done, exits 3 when JAX or the JAX package
    is loaded in its process, so the launcher prints no line."""
    import torch

    from gsbench import cell

    res = cell.run(spec, seed, seconds, trace, t_start, device=ranks.mesh.device,
                   ranks=ranks)
    line = None
    if res is not None:
        _diag(res)
        dev = ranks.mesh.device
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        line = result_line(spec, res, trace, kind, spec["chips"])
    if refused():
        raise SystemExit(3)
    if line is not None:
        ranks.hand_back(line)


def run_ranks(spec: dict, seed: int, seconds: float, trace: bool, t_start: float,
              device: str = "cuda", target=rank_run, limit_s: float | None = None) -> int:
    """Run a mesh cell on ``spec["chips"]`` ranks (``ranks.launch``) and
    show rank 0's line once every rank has exited 0."""
    from gsbench import ranks

    try:
        line = ranks.launch(spec["chips"], spec["config"]["mesh"], target,
                            (spec, seed, seconds, trace, t_start), device,
                            limit_s or ranks.LIMIT_S)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    if line is None:
        print("gsbench: rank 0 handed back no result line", file=sys.stderr)
        return 1
    if refused():
        return 3
    show(line)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout (the port's
    # own, ``_build/``, is there already)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".gsbench_cache" / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".gsbench_cache" / "triton"))

    from gsbench import manifest

    spec = manifest.cell(manifest.load(ROOT), args.workload)
    import torch

    chips = spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gsbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if "mesh" in spec["config"]:
        return run_ranks(spec, args.seed, args.seconds, bool(args.trace), T_START)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gsbench import cell

    res = cell.run(spec, args.seed, args.seconds, bool(args.trace), T_START)
    _diag(res)
    return emit(spec, res, bool(args.trace), torch.cuda.get_device_name(0), chips)


if __name__ == "__main__":
    sys.exit(main())
