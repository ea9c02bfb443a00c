"""The benchmark's cell ``train-1080p-3m`` at a tiny size on the CPU (the
kernels' plain versions): views from inside the cloud, each of which sees a
part of the store, with rows behind the camera, in the near band and off
screen beside the rows on screen. Imports no JAX.

The cell's check holds the port's first steps to the plain reference
(``gsbench/reference/gs.py``); here a sound run passes it on two seeds, and
each planted fault and the bfloat16 control fail it. ``num_on_screen``, the
step's count of splats with a pair, is held to the reference's count.
"""

import time

import pytest
import torch

from gaussian_splatting_lightning_tpu_torch.core.camera import (
    camera_from_matrices,
    stack_cameras,
)
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.training import trainer
from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam
from gsbench import cell, faults, run, traffic
from gsbench.reference import gs
from gsbench.tests.tiny import tiny_spec

CELL = "train-1080p-3m"
BLOCK = 32  # the port's pair block on route cuda (and its plain versions)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain kernels are loops of small ops: threads only add overhead,
    # and the test workers already share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spec():
    return tiny_spec(CELL)


def _correct(spec, checks) -> bool:
    return all(checks[k] <= v for k, v in spec["limits"].items())


def _line(spec, fault, seed):
    with faults.planted(fault):
        res = cell.run(spec, seed, 0.05, False, time.time(), device="cpu")
    line = run.result_line(spec, res, False, "cpu", 1)
    assert line["attempted"] > 0 and line["failed"] == 0
    return line


@pytest.mark.parametrize("seed", [5, 2**31 + 12345])
def test_a_sound_run_is_correct(spec, seed):
    assert _line(spec, "none", seed)["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_image"])
def test_each_fault_is_caught(spec, fault):
    assert _line(spec, fault, 5)["correct"] is False


def test_the_precision_control_is_caught(spec):
    assert not _correct(spec, faults.control(spec, 6, "cpu")[0])


def _reference_pairs(inp, i, config):
    """The reference's projection of view ``i`` and each splat's count of
    (splat, 32 px block) pairs, as the harness sizes the pair budget."""
    w, h = config["width"], config["height"]
    pr = gs.project(inp.params, inp.alive, cell.ref_view(inp, i, "cpu"), w, h,
                    config["sh_degree"])
    x0, x1, y0, y1 = gs.block_rect(pr.p_pix, pr.reach, -(-w // BLOCK), -(-h // BLOCK), BLOCK)
    n = (x1 - x0).clamp_min(0) * (y1 - y0).clamp_min(0)
    return pr, torch.where(pr.visible, n, 0)


@pytest.mark.parametrize("seed", [5, 7])
def test_each_checked_view_has_every_kind_of_row(spec, seed):
    """Every view of the checked steps has live rows behind the camera, in
    the near band (0 < z <= 0.2), in front but off screen, and on screen."""
    config, mix = spec["config"], spec["traffic"]
    inp = cell.make_inputs(config, mix, seed, "cpu")
    checked = traffic.view_order(seed, config["views"], mix["check_steps"])
    with torch.no_grad():
        for i in checked:
            pr, pairs = _reference_pairs(inp, i, config)
            z = pr.depth[inp.alive]
            kinds = {"behind": z <= 0.0, "near": (z > 0.0) & (z <= gs.NEAR_Z),
                     "off_screen": (z > gs.NEAR_Z) & (pairs[inp.alive] == 0),
                     "on_screen": pairs[inp.alive] > 0}
            for name, rows in kinds.items():
                assert int(rows.sum()) > 0, (i, name)


@pytest.mark.parametrize("views", [1, 2])
def test_num_on_screen_is_the_reference_count(spec, views):
    """The step's ``num_on_screen`` is the count of splats with a pair in any
    of its views, as the reference projects them; in the logs of one step
    per view (or pair of views) from the same scene."""
    config, mix = spec["config"], spec["traffic"]
    w, h = config["width"], config["height"]
    inp = cell.make_inputs(config, mix, 5, "cpu")
    cfg = trainer.TrainConfig(capacity=config["capacity"], batch_views=views,
                              w_ssim=gs.W_SSIM, tiling=TilingConfig(max_pairs=1 << 16))
    step = trainer.make_train_step(cfg, mix["extent"], w, h)
    cams = [camera_from_matrices(c["viewmatrix"], c["projmatrix"], c["campos"], c["tanfovx"],
                                 c["tanfovy"], device="cpu") for c in inp.cams]
    counts = []
    for first in range(0, config["views"] - views + 1, views):
        ids = list(range(first, first + views))
        with torch.no_grad():
            seen = torch.stack([_reference_pairs(inp, i, config)[1] > 0 for i in ids]).any(0)
        want = int(seen.sum())
        scene = cell.program_scene(inp, config)
        if views == 1:
            args = (cams[first], inp.targets[first], inp.background)
        else:
            args = (stack_cameras([cams[i] for i in ids]), inp.targets[ids],
                    inp.background.expand(views, 3))
        logs = step(scene, init_adam(scene.params), mix["first_step"], *args)[2]
        assert int(logs["num_dropped_pairs"]) == 0
        assert int(logs["num_on_screen"]) == want, ids
        counts.append(want)
    # each view sees a part of the store
    assert 0 < min(counts) and max(counts) < config["splats"]
