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


def _brute_kept(pr, w, h):
    """Contributing evaluations pixel by pixel, front to back, by the rules
    in ``reference/gs.py``'s docstring."""
    order = np.argsort(pr.depth.numpy(), kind="stable")
    p, con, op = pr.p_pix.numpy(), pr.conic.numpy(), pr.opacity.numpy()
    rad, vis = pr.radius.numpy(), pr.visible.numpy()
    gx, gy = -(-w // 16), -(-h // 16)
    kept = 0
    for y in range(h):
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


def test_step_work_by_hand():
    work = counts.step_work(kept_evals=10, visible=2, params=59, capacity=1, pixels=4)
    assert work["flops"] == 10 * (22 + 40) + 2 * 3 * (96 + 100) + 59 * 11
    assert work["bytes"] == 4 * 59 * 8 + 4 * 12 * 5 + 3 * 4 * 2
    assert counts.least_s(67e12, 0) == pytest.approx(1.0)
    assert counts.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.k2_least_s(1e12, 0, 0) == pytest.approx(22 / 67)
    assert counts.k3_least_s(1e12, 0, 0) == pytest.approx(40 / 67)
