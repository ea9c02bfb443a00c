"""The readings that set the upper ends of a cell's limits: the precision
control and the planted faults.

    python3 gsbench/faults.py --workload <cell> --seeds 11,12,13 --seconds 2 \
        --what control,unchanged,half_batch,altered_image[,no_exchange][,none]

``control`` is the reference put in the program's place and computed in
bfloat16, the nearest precision below the configuration's float32, held to
the float32 reference (on one card, for every cell). The faults are planted
in the program for the run (its module attributes replaced in this process,
or in each rank's, no file changed) and the cell runs as the benchmark runs
it, with a short window:

- ``unchanged``: the step returns its state unchanged (Adam writes nothing);
- ``half_batch``: half of the batch left out, the mean taken over the rest:
  on one process the loss over the top half of the image's rows; on a mesh
  the second half of the view groups' loss left out and the first half's
  doubled;
- ``altered_image``: the rendered image is raised by 0.01 where it is made;
- ``no_exchange`` (a mesh only): the sum over the ranks that the gradients'
  reduce-scatter makes is left out, each rank keeping its own part;
- ``none``: no fault, a sound run (the lower readings).

The benchmark's own runs never run this. Prints one JSON line per seed and
fault with the compared numbers. On a mesh the ranks run every seed and
fault in one job, and the reference runs once a seed, on rank 0's card.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` in place, for the duration of the block."""
    from gaussian_splatting_lightning_tpu_torch.parallel import mesh as mesh_mod
    from gaussian_splatting_lightning_tpu_torch.parallel import shard
    from gaussian_splatting_lightning_tpu_torch.training import optimizer
    from gaussian_splatting_lightning_tpu_torch.training import trainer as tr

    saved = []

    def patch(module, name, value):
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    if fault == "unchanged":
        def adam_update(params, grads, state, *a, **k):
            return params, optimizer.AdamState(state.count + 1, state.mu, state.nu)

        def adam_update_(params, grads, state, *a, **k):
            return optimizer.AdamState(state.count + 1, state.mu, state.nu)

        patch(tr, "adam_update", adam_update)
        patch(tr, "adam_update_", adam_update_)
        patch(shard, "adam_update_", adam_update_)
    elif fault == "half_batch":
        def half(fn):
            def loss(pred, target, *a, **k):
                h = pred.shape[-2] // 2
                return fn(pred[..., :h, :], target[..., :h, :], *a, **k)
            return loss

        band_loss = shard._band_loss_partials

        def band_loss_partials(bands, images, height, mesh, *a, **k):
            kept = 2.0 * (mesh.axis_index("view") < mesh.axis_size("view") // 2)
            return tuple(kept * p for p in band_loss(bands, images, height, mesh, *a, **k))

        patch(tr, "photometric_loss", half(tr.photometric_loss))
        patch(tr, "photometric_losses", half(tr.photometric_losses))
        patch(shard, "_band_loss_partials", band_loss_partials)
    elif fault == "altered_image":
        render, render_band = tr.render_scene, shard._render_band

        def render_scene(*a, **k):
            out, stats = render(*a, **k)
            return type(out)(out.image + 0.01, out.radii, out.depth), stats

        def _render_band(*a, **k):
            out, *rest = render_band(*a, **k)
            return (type(out)(out.image + 0.01, out.radii, out.depth), *rest)

        patch(tr, "render_scene", render_scene)
        patch(shard, "_render_band", _render_band)
    elif fault == "no_exchange":
        def reduce_scatter(self, t, axis, dim=0):
            n, i = self.axis_size(axis), self.axis_index(axis)
            src = t.movedim(dim, 0)
            rows = src.shape[0] // n
            return src[i * rows:(i + 1) * rows].movedim(0, dim).contiguous().clone()

        patch(mesh_mod.Mesh, "reduce_scatter", reduce_scatter)
    elif fault != "none":
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for module, name, value in reversed(saved):
            setattr(module, name, value)


def control(spec: dict, seed: int, device) -> tuple:
    """The reference in bfloat16 held to the reference in float32: the
    compared numbers and the other readings (``cell.compare``)."""
    import torch

    from gsbench import cell

    config, mix = spec["config"], spec["traffic"]
    inp = cell.make_inputs(config, mix, seed, device)
    want, first_moved = cell.reference_readings(inp, config, mix, seed, torch.float32)
    got, _ = cell.reference_readings(inp, config, mix, seed, torch.bfloat16)
    return cell.compare(got, want, first_moved)


def fault_run(spec: dict, seed: int, seconds: float, fault: str, device) -> tuple:
    """The cell with ``fault`` planted: the compared numbers and the other
    readings."""
    from gsbench import cell

    with planted(fault):
        res = cell.run(spec, seed, seconds, False, time.time(), device=device)
    return res["checks"], res["readings"]


def _row(what: str, seed: int, checks: dict, readings: dict, seconds: float) -> dict:
    other = {k: v for k, v in readings.items() if k.startswith("step_gap")}
    return {"what": what, "seed": seed, "checks": checks, "other": other, "s": seconds}


def mesh_job(ranks, spec: dict, seeds: list, seconds: float, faults: list) -> None:
    """On each rank of a mesh: every seed's faults, each planted in the
    program and run as the benchmark runs it; then rank 0 reads the
    reference once and compares each. Rank 0 prints each row on standard
    error and hands the rows back."""
    import torch

    from gsbench import cell

    dev = ranks.mesh.device
    config, mix = spec["config"], spec["traffic"]
    rows = []
    for seed in seeds:
        got = {}
        for what in faults:
            t0 = time.perf_counter()
            with planted(what):
                _, readings, _ = cell.program(spec, seed, seconds, False, time.time(), dev,
                                              ranks)
            got[what] = (readings, time.perf_counter() - t0)
            gc.collect()  # the dropped trainer's graph and pool
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if ranks.rank == 0:
            want = cell.reference_readings(cell.make_inputs(config, mix, seed, dev), config,
                                           mix, seed, torch.float32)
            for what, (readings, s) in got.items():
                res = cell.check(spec, seed, readings, dev, want=want)
                row = _row(what, seed, res["checks"], res["readings"], s)
                print(json.dumps(row), file=sys.stderr, flush=True)
                rows.append(row)
            del want
        ranks.gather(None)  # the others wait for rank 0's reference
        ranks.beat(f"seed {seed}")
    if ranks.rank == 0:
        ranks.hand_back(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--what", default="control,unchanged,half_batch,altered_image")
    args = ap.parse_args(argv)

    import torch

    from gsbench import manifest, ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = manifest.cell(manifest.load(ROOT), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    whats = args.what.split(",")
    if "mesh" in spec["config"]:
        planted_faults = [w for w in whats if w != "control"]
        if planted_faults:
            for row in ranks.launch(spec["chips"], spec["config"]["mesh"], mesh_job,
                                    (spec, seeds, args.seconds, planted_faults)):
                print(json.dumps(row), flush=True)
        whats = ["control"] if "control" in whats else []
    for what in whats:
        for seed in seeds:
            t0 = time.perf_counter()
            if what == "control":
                checks, readings = control(spec, seed, "cuda")
                torch.cuda.empty_cache()
            else:
                checks, readings = fault_run(spec, seed, args.seconds, what, "cuda")
            print(json.dumps(_row(what, seed, checks, readings, time.perf_counter() - t0)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
