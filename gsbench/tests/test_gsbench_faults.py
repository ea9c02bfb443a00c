"""The check itself: a sound run of a cell at a tiny size on the CPU passes
its limits, and each fault the cell can have, planted under the harness,
and the precision control fail them (a mesh cell's faults, on four ranks:
``test_gsbench_ranks.py``). The readings at the cells' own sizes are taken
on the chip (``gsbench/faults.py``); ``test_control_fails_at_the_cell_size``
is that run for the control."""

import time

import pytest
import torch

from gsbench import cell, faults, run
from gsbench.tests.tiny import ROOT, tiny_spec


def _correct(spec, checks) -> bool:
    return all(checks[k] <= v for k, v in spec["limits"].items())


def _single(spec, fault, seed=5):
    with faults.planted(fault):
        res = cell.run(spec, seed, 0.05, False, time.time(), device="cpu")
    line = run.result_line(spec, res, False, "cpu", 1)
    assert line["attempted"] > 0 and line["failed"] == 0
    return line


def test_a_sound_run_is_correct():
    assert _single(tiny_spec(), "none")["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_image"])
def test_each_fault_is_caught(fault):
    assert _single(tiny_spec(), fault)["correct"] is False


@pytest.mark.parametrize("cell_name", ["train-1080p-1m", "train-1080p-1m-mesh2x2"])
def test_the_precision_control_is_caught(cell_name):
    spec = tiny_spec(cell_name)
    assert not _correct(spec, faults.control(spec, 6, "cpu")[0])


@pytest.mark.cuda
def test_control_fails_at_the_cell_size(card):
    torch.backends.cuda.matmul.allow_tf32 = False
    from gsbench import manifest

    spec = manifest.cell(manifest.load(ROOT), "train-1080p-1m")
    for seed in (3100000001, 3100000002, 3100000003):
        assert not _correct(spec, faults.control(spec, seed, card)[0])
