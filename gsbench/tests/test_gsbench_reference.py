"""The reference against the port's plain route at a tiny size."""

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
