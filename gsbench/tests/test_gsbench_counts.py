"""The work counts against hand counts on tiny scenes, and the rate."""

import math

import numpy as np
import pytest
import torch

from gsbench import counts
from gsbench.reference import gs


def _view(w, h, focal):
    from gsbench import traffic

    cam = traffic.camera(traffic.look_at(np.array([0.0, 0.0, -4.0])), w, h, focal)
    out = {k: torch.tensor(np.asarray(cam[k], np.float32)) for k in
           ("viewmatrix", "projmatrix", "campos")}
    out.update(tanfovx=np.float32(cam["tanfovx"]), tanfovy=np.float32(cam["tanfovy"]))
    return out


def _scene(xyz, opacity_logit, log_scale):
    n = len(xyz)
    return {"xyz": torch.tensor(xyz, dtype=torch.float32),
            "features_dc": torch.zeros(n, 1, 3), "features_rest": torch.zeros(n, 15, 3),
            "opacity": torch.full((n, 1), float(opacity_logit)),
            "scales": torch.full((n, 3), float(log_scale)),
            "quats": torch.tensor([[1.0, 0, 0, 0]] * n)}


def _brute_kept(pr, w, h, rows=None):
    """Contributing evaluations pixel by pixel, front to back, by the rules
    in ``reference/gs.py``'s docstring; with ``rows`` (first, end) in those
    pixel rows alone."""
    order = np.argsort(pr.depth.numpy(), kind="stable")
    p, con, op = pr.p_pix.numpy(), pr.conic.numpy(), pr.opacity.numpy()
    rad, vis = pr.radius.numpy(), pr.visible.numpy()
    gx, gy = -(-w // 16), -(-h // 16)
    kept = 0
    for y in range(*(rows or (0, h))):
        for x in range(w):
            t = 1.0
            for i in order:
                if not vis[i]:
                    continue
                x0 = min(max(int(np.trunc((p[i, 0] - rad[i]) / 16)), 0), gx)
                x1 = min(max(int(np.trunc((p[i, 0] + rad[i] + 15) / 16)), 0), gx)
                y0 = min(max(int(np.trunc((p[i, 1] - rad[i]) / 16)), 0), gy)
                y1 = min(max(int(np.trunc((p[i, 1] + rad[i] + 15) / 16)), 0), gy)
                if not (x0 <= x // 16 < x1 and y0 <= y // 16 < y1):
                    continue
                dx, dy = p[i, 0] - x, p[i, 1] - y
                q = con[i, 0] * dx * dx + 2 * con[i, 1] * dx * dy + con[i, 2] * dy * dy
                a = min(0.99, op[i] * math.exp(-0.5 * q))
                if a <= 1.0 / 255.0:
                    continue
                if t > 1e-4:
                    kept += 1
                t *= 1.0 - a
    return kept


@pytest.mark.parametrize("layers", [1, 12])
def test_kept_evaluations_match_a_hand_count(layers):
    w, h = 40, 24
    rng = np.random.default_rng(layers)
    xyz = np.concatenate([rng.normal(0, 0.05, (layers, 2)),
                          np.linspace(-0.5, 0.5, layers)[:, None]], 1)
    p = _scene(xyz, 4.0, math.log(0.05))
    pr = gs.project(p, torch.ones(layers, dtype=torch.bool), _view(w, h, 30.0), w, h, 3)
    _, _, kept = gs.render(pr, w, h, torch.zeros(3))
    assert kept == _brute_kept(pr, w, h)
    if layers > 1:  # the stack is opaque enough that some pixels stop
        assert kept < layers * w * h


@pytest.mark.parametrize("band", [(0, 32), (32, 64)])
def test_kept_evaluations_of_a_band_match_a_hand_count(band):
    w, h = 40, 56  # two bands of 32 rows, the second cut by the image
    n = 12
    rng = np.random.default_rng(7)
    xyz = np.stack([rng.normal(0, 0.3, n), np.linspace(-1.5, 1.5, n),
                    np.linspace(-0.5, 0.5, n)], 1)
    p = _scene(xyz, 2.0, math.log(0.15))
    pr = gs.project(p, torch.ones(n, dtype=torch.bool), _view(w, h, 30.0), w, h, 3)
    _, _, kept = gs.render(pr, w, h, torch.zeros(3), pixel_rows=band)
    assert 0 < kept == _brute_kept(pr, w, h, (band[0], min(band[1], h)))


def test_rank_0s_share_of_the_traced_work():
    """On one card rank 0's share is the whole; on the (2, 2) mesh it is
    the first view group's views, in band 0's rows."""
    from gsbench import cell
    from gsbench.tests.tiny import tiny_spec

    spec = tiny_spec()
    config, mix = spec["config"], spec["traffic"]
    w, h = config["width"], config["height"]
    inp = cell.make_inputs(config, mix, 5, "cpu")
    work = cell.traced_work(inp.params, inp, config, [0, 1, 2, 0], "cpu")
    assert work["rank0"] == {"kept": work["kept"], "visible": work["visible"],
                             "pixels": 4 * w * h}

    config = tiny_spec("train-1080p-1m-mesh2x2")["config"]
    views = [0, 1, 2, 3, 4, 5, 0, 1]  # two steps of four: rank 0 draws 0, 1 and 4, 5
    work = cell.traced_work(inp.params, inp, config, views, "cpu")
    band = -(-h // 32) // 2 * 32  # 32 of 48 rows
    kept = visible = whole = 0
    for i in (0, 1, 4, 5):
        pr = gs.project(inp.params, inp.alive, cell.ref_view(inp, i, "cpu"), w, h, 3)
        kept += gs.render(pr, w, h, inp.background, pixel_rows=(0, band))[2]
        whole += gs.render(pr, w, h, inp.background)[2]
        x0, x1, y0, y1 = gs.block_rect(pr.p_pix, pr.reach, 2, 2, 32)
        visible += int((pr.visible & (x1 > x0) & (y1 > y0) & (y0 < 1)).sum())
    assert work["rank0"] == {"kept": kept, "visible": visible, "pixels": 4 * band * w}
    assert 0 < kept < whole


def test_step_work_by_hand():
    work = counts.step_work(kept_evals=10, visible=2, params=59, capacity=1, pixels=4)
    assert work["flops"] == 10 * (22 + 40) + 2 * 3 * (96 + 100) + 59 * 11
    assert work["bytes"] == 4 * 59 * 8 + 4 * 12 * 5 + 3 * 4 * 2
    assert counts.least_s(67e12, 0) == pytest.approx(1.0)
    assert counts.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.k2_least_s(1e12, 0, 0) == pytest.approx(22 / 67)
    assert counts.k3_least_s(1e12, 0, 0) == pytest.approx(40 / 67)
