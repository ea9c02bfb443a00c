"""The readings that set the upper ends of a cell's limits: the precision
control and the planted faults.

    python3 gsbench/faults.py --workload <cell> --seeds 11,12,13 --seconds 2 \
        --what control,unchanged,half_batch,altered_image

``control`` is the reference put in the program's place and computed in
bfloat16, the nearest precision below the configuration's float32, held to
the float32 reference. The faults are planted in the program for the run
(its module attributes replaced in this process, no file changed) and the
cell runs as the benchmark runs it, with a short window:

- ``unchanged``: the step returns its state unchanged (Adam writes nothing);
- ``half_batch``: one view a step, the loss takes the mean over the top
  half of the image's rows and leaves the rest out;
- ``altered_image``: the rendered image is raised by 0.01 where it is made.

The benchmark's own runs never run this. Prints one JSON line per seed and
fault with the compared numbers.
"""

from __future__ import annotations

import argparse
import contextlib
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
    elif fault == "half_batch":
        def half(fn):
            def loss(pred, target, *a, **k):
                h = pred.shape[-2] // 2
                return fn(pred[..., :h, :], target[..., :h, :], *a, **k)
            return loss

        patch(tr, "photometric_loss", half(tr.photometric_loss))
        patch(tr, "photometric_losses", half(tr.photometric_losses))
    elif fault == "altered_image":
        render = tr.render_scene

        def render_scene(*a, **k):
            out, stats = render(*a, **k)
            return type(out)(out.image + 0.01, out.radii, out.depth), stats

        patch(tr, "render_scene", render_scene)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--what", default="control,unchanged,half_batch,altered_image")
    args = ap.parse_args(argv)

    import torch

    from gsbench import manifest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = manifest.cell(manifest.load(ROOT), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for what in args.what.split(","):
        for seed in seeds:
            t0 = time.perf_counter()
            if what == "control":
                checks, readings = control(spec, seed, "cuda")
                torch.cuda.empty_cache()
            else:
                checks, readings = fault_run(spec, seed, args.seconds, what, "cuda")
            other = {k: v for k, v in readings.items() if k.startswith("step_gap")}
            print(json.dumps({"what": what, "seed": seed, "checks": checks, "other": other,
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
