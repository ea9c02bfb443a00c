"""A configuration's own ``train`` options, ``reference`` and ``mesh``."""

import json
import shutil
import time

import pytest

from gsbench import cell, manifest
from gsbench.tests.tiny import ROOT, tiny_spec


def _base():
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import TrainConfig

    return TrainConfig(seed=7, capacity=2000, log_interval=1, batch_views=1, w_ssim=0.2,
                       tiling=TilingConfig(max_pairs=8192))


def test_train_options_reach_the_trainer(monkeypatch):
    from gaussian_splatting_lightning_tpu_torch.training import trainer

    seen = {}

    class Spy(trainer.Trainer):
        def __init__(self, cfg, *a, **k):
            seen["cfg"] = cfg
            super().__init__(cfg, *a, **k)

    monkeypatch.setattr(trainer, "Trainer", Spy)
    spec = tiny_spec()
    spec["config"]["train"] = {"antialias": True}
    cell.run(spec, 5, 0.05, False, time.time(), device="cpu")
    cfg = seen["cfg"]
    assert cfg.antialias is True
    assert (cfg.seed, cfg.capacity, cfg.batch_views) == (5, 2000, 1)


def test_train_options_apply_over_the_harness_nested_too():
    base = _base()
    cfg = cell.train_config({"train": {"sparse_adam": True, "tiling": {"block": 16},
                                       "densify": {"densify_until": 100}}}, base)
    assert cfg.sparse_adam and cfg.tiling.block == 16 and cfg.densify.densify_until == 100
    assert cfg.tiling.max_pairs == 8192 and cfg.seed == 7
    assert cfg.densify.densify_interval == base.densify.densify_interval
    assert cell.train_config({}, base) is base


@pytest.mark.parametrize("train", [{"no_such_field": 1}, {"tiling": {"no_such_field": 1}},
                                   {"rasterizer": "no_such_route"}])
def test_an_unknown_train_option_is_refused(train):
    with pytest.raises(ValueError, match="train"):
        cell.train_config({"name": "c", "train": train}, _base())


@pytest.mark.parametrize("train", [{"seed": 1}, {"capacity": 8}, {"log_interval": 5},
                                   {"batch_views": 2}, {"tiling": {"max_pairs": 8}}])
def test_a_train_option_the_harness_owns_is_refused(train):
    with pytest.raises(ValueError, match="owns"):
        cell.train_config({"name": "c", "train": train}, _base())


def test_the_reference_is_the_configurations(monkeypatch):
    from gsbench.tests import stub_reference as stub

    monkeypatch.setattr(cell, "REFERENCE_PACKAGE", "gsbench.tests")
    spec = tiny_spec()
    spec["config"]["reference"] = "stub_reference"
    for k in stub.CALLS:
        stub.CALLS[k] = 0
    res = cell.run(spec, 5, 0.05, True, time.time(), device="cpu")
    assert stub.CALLS["train"] == 1  # the check
    assert stub.CALLS["project"] >= 6 and stub.CALLS["render"] >= 1  # budget, work
    assert res["work"]["kept"] > 0
    assert all(res["checks"][k] <= v for k, v in spec["limits"].items())


@pytest.mark.parametrize("mesh", [{"view": 2, "tile": 1}, {"view": 1, "tile": 2},
                                  {"view": 2, "tile": 2, "depth": 1}])
def test_a_mesh_that_is_not_the_cells_chips_is_refused(tmp_path, mesh):
    shutil.copytree(ROOT / "gsbench", tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "gsbench"
    m = manifest.load(ROOT)
    name = "train-1080p-1m-mesh2x2"
    entry = next(w for w in m["workloads"] if w["name"] == name)
    config = next(c for c in m["configs"] if c["name"] == entry["config"])
    path = tmp_path / config["file"]
    path.write_text(json.dumps(dict(json.loads(path.read_text()), mesh=mesh)))
    assert manifest.cell(m, name)["config"]["mesh"] == {"view": 2, "tile": 2}
    with pytest.raises(ValueError, match="mesh"):
        manifest.cell(m, name, here)
