"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<cell>`` is ``workloads/<cell>.json`` (its kind, of ``KINDS``, and
the limits of its check); its configuration ``configs/<config>.json``; its traffic mix
``mixes/<traffic>.json``; a per-layer metric ``<metric>`` the reader
``metrics/<metric>.py``, whose ``read(ctx)`` returns the metric's value or
None when the run gave it nothing to read. Adding a cell, a configuration,
a mix or a metric is adding such files and entries. A configuration may
also name its trainer options, its plain reference and a mesh (``cell.py``);
a cell of a configuration with a mesh ``{"view": v, "tile": t}`` asks for
``v * t`` chips.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
# what a cell runs: ``train`` is ``cell.run``, the Trainer in a closed loop
KINDS = ("train",)


def load(root: Path) -> dict:
    """The manifest at ``root`` (the checkout)."""
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` applies to those cells; one without to
    every cell that reports what it moves (end-to-end metrics: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(manifest: dict, name: str, here: Path = HERE) -> dict:
    """Everything one run of cell ``name`` needs."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    spec = _json(here / "workloads" / f"{name}.json")
    if spec["kind"] not in KINDS:
        raise ValueError(f"workload {name!r}: unknown kind {spec['kind']!r}")
    config = dict(_json(here.parent / config_entry["file"]), name=entry["config"])
    mesh = config.get("mesh")
    if mesh is not None:
        if set(mesh) != {"view", "tile"}:
            raise ValueError(f"configuration {entry['config']!r}: mesh {mesh!r} is not "
                             "{\"view\": v, \"tile\": t}")
        if mesh["view"] * mesh["tile"] != entry["chips"]:
            raise ValueError(f"workload {name!r}: chips {entry['chips']} is not the "
                             f"{mesh['view']} x {mesh['tile']} ranks of its mesh")
    e2e = [m for m in manifest["end_to_end"] if applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    return {
        "name": name,
        "chips": entry["chips"],
        "kind": spec["kind"],
        "limits": spec["limits"],
        "config": config,
        "traffic": dict(_json(here / "mixes" / f"{entry['traffic']}.json"),
                        name=entry["traffic"]),
        "end_to_end": e2e,
        "per_layer": [m for m in manifest["per_layer"] if applies(m, name, reported)],
    }


def reader(name: str, here: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gsbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
