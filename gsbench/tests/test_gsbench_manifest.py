"""The manifest, the files it names, and that adding a cell, a configuration,
a mix or a per-layer metric needs no edit of an existing file."""

import hashlib
import json
import re
import shutil

import pytest

from gsbench import manifest
from gsbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = manifest.load(ROOT)


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["gsbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    shapes = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source"},
              "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, keys in shapes.items():
        for entry in MANIFEST[group]:
            assert set(entry) - {"workloads"} == keys, entry
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
            for text in ("why", "layer"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    assert all(m["moves"] in e2e for m in MANIFEST["per_layer"])
    assert all(0 < m["bound"] <= 0.25 for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_loads_with_its_readers(cell):
    spec = manifest.cell(MANIFEST, cell)
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s", "train_mrays_per_s"}
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    assert set(spec["limits"]) == {"loss_gap", "grad_gap", "step_gap", "stats_gap"}
    assert spec["config"]["width"] == 1920 and spec["config"]["height"] == 1080


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_added_cell_config_mix_and_metric_are_found(tmp_path):
    shutil.copytree(ROOT / "gsbench", tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    here = tmp_path / "gsbench"
    before = _digest(here)

    config = json.loads((here / "configs" / "scene1m-sh3-1080p.json").read_text())
    (here / "configs" / "scene-new.json").write_text(json.dumps(dict(config, width=960)))
    mix = json.loads((here / "mixes" / "orbit-from15k.json").read_text())
    (here / "mixes" / "orbit-new.json").write_text(json.dumps(dict(mix, distance=5.0)))
    (here / "workloads" / "cell-new.json").write_text(json.dumps(
        {"kind": "train", "limits": {"loss_gap": 1.0}}))
    (here / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx.step_s\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "scene-new", "source": "x", "why": "x", "reduced": [],
                         "file": "gsbench/configs/scene-new.json"})
    m["workloads"].append({"name": "cell-new", "config": "scene-new", "traffic": "orbit-new",
                           "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "new_metric", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "x",
                           "moves": "train_mrays_per_s", "workloads": ["cell-new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    spec = manifest.cell(manifest.load(tmp_path), "cell-new", here)
    assert spec["config"]["width"] == 960 and spec["traffic"]["distance"] == 5.0
    assert [p["name"] for p in spec["per_layer"]] == ["new_metric"]
    read = manifest.reader("new_metric", here)
    assert read(type("Ctx", (), {"step_s": 0.5})) == 1.0
    after = _digest(here)
    assert all(after[k] == v for k, v in before.items()), "an existing file changed"


def test_a_cell_of_an_unknown_kind_is_refused(tmp_path):
    shutil.copytree(ROOT / "gsbench", tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "gsbench"
    cell = MANIFEST["workloads"][0]["name"]
    path = here / "workloads" / f"{cell}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), kind="render")))
    with pytest.raises(ValueError, match="unknown kind"):
        manifest.cell(MANIFEST, cell, here)
