"""The reference against the port's plain route at a tiny size."""

import time

import pytest
import torch

from gsbench import cell
from gsbench.reference import gs
from gsbench.tests.tiny import tiny_spec


@pytest.mark.parametrize("seed", [3, 4])
def test_reference_step_matches_the_plain_route(seed):
    from gaussian_splatting_lightning_tpu_torch.core.camera import camera_from_matrices
    from gaussian_splatting_lightning_tpu_torch.training.trainer import (
        TrainConfig,
        step_gradients,
    )

    spec = tiny_spec()
    config, mix = spec["config"], spec["traffic"]
    inp = cell.make_inputs(config, mix, seed, "cpu")
    view = cell.ref_view(inp, 0, "cpu")
    rec = gs.gradients(inp.params, inp.alive, [view], config["width"], config["height"], 3)

    c = inp.cams[0]
    cam = camera_from_matrices(c["viewmatrix"], c["projmatrix"], c["campos"], c["tanfovx"],
                               c["tanfovy"], device="cpu")
    scene = cell.program_scene(inp, config)
    grads, screen, _, radii, logs, _ = step_gradients(
        TrainConfig(rasterizer="plain", capacity=config["capacity"]), scene, cam,
        config["width"], config["height"], inp.targets[0], inp.background)
    assert float(logs["loss"]) == pytest.approx(rec.loss, rel=1e-6)
    assert torch.equal(radii, rec.radius[0])
    for k in gs.LEAVES:
        want = rec.grads[k]
        got = getattr(grads, k)
        assert float((got - want).norm()) <= 1e-4 * float(want.norm()) + 1e-12, k
    screen_norm = torch.linalg.vector_norm(screen, dim=-1)
    assert float((screen_norm - rec.screen[0]).norm()) <= 1e-4 * float(rec.screen[0].norm())


def test_reference_image_matches_the_plain_render():
    from gaussian_splatting_lightning_tpu_torch.core.camera import camera_from_matrices
    from gaussian_splatting_lightning_tpu_torch.training.trainer import render_scene

    spec = tiny_spec(width=80, height=40)
    config, mix = spec["config"], spec["traffic"]
    inp = cell.make_inputs(config, mix, 9, "cpu")
    for i in range(2):
        c = inp.cams[i]
        cam = camera_from_matrices(c["viewmatrix"], c["projmatrix"], c["campos"],
                                   c["tanfovx"], c["tanfovy"], device="cpu")
        out, _ = render_scene(cell.program_scene(inp, config), cam, 80, 40, inp.background)
        pr = gs.project(inp.params, inp.alive, cell.ref_view(inp, i, "cpu"), 80, 40, 3)
        image, _, _ = gs.render(pr, 80, 40, inp.background)
        assert float((out.image - image).abs().max()) < 1e-5


def test_a_dense_scene_moves_what_the_reference_leaves_by_round_off():
    """Where pixels reach their transmittance stop, the program's backward
    gives splats that contribute nothing a round-off gradient, which Adam
    turns into a step; the change counted from each element's first move in
    the reference leaves exactly those steps out and agrees."""
    import time

    spec = tiny_spec(splats=20000, capacity=20000, width=96, height=64, scale=0.03)
    res = cell.run(spec, 11, 0.05, False, time.time(), device="cpu")
    drift = res["readings"]["unmoved_change_sq"]["opacity"]
    assert res["readings"]["step_gap_every_element"] > 0.05 and drift > 0
    assert res["checks"]["step_gap"] <= spec["limits"]["step_gap"]


def test_a_splat_at_depth_zero_in_a_checked_view(monkeypatch):
    """A splat exactly on the first checked view's camera plane: the
    reference's gradient stays finite, every leaf moves, and the run is
    correct. The view's camera sits at the origin with the world's axes, so
    a splat with z = 0 has view-space depth exactly 0."""
    import math

    import numpy as np

    from gsbench import traffic

    spec = tiny_spec()
    config, mix = spec["config"], spec["traffic"]
    seed = 5
    first = traffic.view_order(seed, config["views"], 1)[0]
    make = cell.make_inputs

    def inputs(*a, **k):
        inp = make(*a, **k)
        inp.cams[first] = traffic.camera(np.eye(4)[:3], config["width"], config["height"],
                                         mix["focal"] * config["width"])
        inp.params["xyz"][0] = torch.tensor([0.05, 0.02, 0.0])
        return inp

    monkeypatch.setattr(cell, "make_inputs", inputs)
    inp = cell.make_inputs(config, mix, seed, "cpu")
    hom = torch.cat([inp.params["xyz"][:1], torch.ones(1, 1)], 1)
    assert float((hom @ cell.ref_view(inp, first, "cpu")["viewmatrix"])[0, 2]) == 0.0
    ref, first_moved = cell.reference_readings(inp, config, mix, seed, torch.float32)
    assert all(math.isfinite(v) and v > 0 for v in ref.grad_sq.values())
    checks, _ = cell.compare(ref, ref, first_moved)
    assert checks == {k: 0.0 for k in checks}
    res = cell.run(spec, seed, 0.05, False, time.time(), device="cpu")
    assert all(res["checks"][k] <= v for k, v in spec["limits"].items())


def test_a_reading_that_is_not_finite_fails_the_check():
    import math

    leaves = ("a", "b")
    good = cell.Readings([1.0], {"a": 1.0, "b": 4.0}, [{k: torch.ones(2) for k in leaves}],
                         {"count": 2.0})
    bad = cell.Readings([math.nan], {"a": math.nan, "b": 4.0},
                        [{k: torch.ones(2) for k in leaves}], {"count": math.nan})
    first_moved = {k: torch.zeros(2, dtype=torch.uint8) for k in leaves}
    checks, _ = cell.compare(bad, good, first_moved)
    assert checks["loss_gap"] == checks["grad_gap"] == checks["stats_gap"] == math.inf
    # a reference gradient that is not finite leaves no leaf to compare
    lost = cell.Readings([1.0], {"a": math.nan, "b": math.nan},
                         [{k: torch.ones(2) for k in leaves}], {"count": 2.0})
    assert cell.compare(good, lost, first_moved)[0]["step_gap"] == math.inf
