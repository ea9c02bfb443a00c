"""The benchmark's inputs, made from the seed: the splat cloud, the camera
orbit and the target images.

Everything is drawn on the run's device by one ``torch.Generator`` in a few
large calls, so the same seed gives the same inputs and set-up stays short.
The program receives only these tensors (as its own scene type and view
records); the reference receives the same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SH_C0 = 0.28209479177387814
DEAD_LOGIT = -20.0


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def splats(cfg: dict, seed: int, device) -> dict:
    """The six raw parameters (logit opacity, log scales, wxyz quaternions)
    of ``cfg["splats"]`` splats in a store of ``cfg["capacity"]`` rows: means
    from a unit normal, colours uniform in [0.1, 0.9], scales log-uniform
    within ``cfg["scale_range"]`` of ``cfg["scale"]``, random rotations,
    opacity logits uniform in ``cfg["opacity_logit"]`` and the higher SH
    bands normal with deviation ``cfg["sh_rest_std"]``. Rows past the
    splats are dead (alive False, opacity logit -20)."""
    g = generator(seed, device)
    n, cap = cfg["splats"], cfg["capacity"]
    k = (cfg["sh_degree"] + 1) ** 2
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, **f32) * (hi - lo) + lo

    lo, hi = (math.log(cfg["scale"] * r) for r in cfg["scale_range"])
    quats = torch.randn((cap, 4), generator=g, **f32)
    p = dict(
        xyz=torch.randn((cap, 3), generator=g, **f32),
        features_dc=((uniform((cap, 1, 3), 0.1, 0.9) - 0.5) / SH_C0),
        features_rest=torch.randn((cap, k - 1, 3), generator=g, **f32) * cfg["sh_rest_std"],
        opacity=uniform((cap, 1), *cfg["opacity_logit"]),
        scales=uniform((cap, 3), lo, hi),
        quats=quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True),
    )
    alive = torch.arange(cap, device=device) < n
    p["opacity"][n:] = DEAD_LOGIT
    return dict(params=p, alive=alive)


def look_at(eye: np.ndarray) -> np.ndarray:
    """(3, 4) world->camera matrix of a camera at ``eye`` looking at the
    origin (x right, y down, z forward; world up is -y)."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd])
    return np.concatenate([rot, -rot @ eye[:, None]], 1)


def projection(fx: float, fy: float, w: int, h: int, znear=0.01, zfar=100.0) -> np.ndarray:
    """Column-vector perspective matrix mapping z to [0, 1]."""
    m = np.zeros((4, 4))
    m[0, 0] = 2.0 * fx / w
    m[1, 1] = 2.0 * fy / h
    m[3, 2] = 1.0
    m[2, 2] = (zfar + znear) / (zfar - znear)
    m[2, 3] = -(zfar * znear) / (zfar - znear)
    return m


def camera(cam_from_world: np.ndarray, w: int, h: int, focal: float) -> dict:
    """Row-vector view and full projection matrices (float64), the camera's
    centre and the tangents of its half fields of view."""
    view = np.eye(4)
    view[:, :3] = cam_from_world[:3, :4].T
    full = view @ projection(focal, focal, w, h).T
    return dict(viewmatrix=view, projmatrix=full, campos=np.linalg.inv(view)[3, :3],
                tanfovx=w * 0.5 / focal, tanfovy=h * 0.5 / focal)


def orbit(traffic: dict, seed: int, n: int, w: int, h: int) -> list:
    """``n`` cameras at distance ``traffic["distance"]`` from the origin,
    azimuth uniform on the circle and elevation uniform within
    ``traffic["elevation_deg"]``, focal ``traffic["focal"]`` x width."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    az = rng.uniform(0.0, 2.0 * np.pi, n)
    el = np.radians(rng.uniform(*traffic["elevation_deg"], n))
    d = traffic["distance"]
    eyes = np.stack([d * np.cos(el) * np.sin(az), -d * np.sin(el), -d * np.cos(el) * np.cos(az)], 1)
    return [camera(look_at(e), w, h, traffic["focal"] * w) for e in eyes]


def targets(traffic: dict, seed: int, n: int, w: int, h: int, device) -> torch.Tensor:
    """(n, 3, H, W) target images: smooth random fields, noise on a coarse
    grid of ``traffic["target_cells"]`` cells across the width, upsampled
    bicubically and clamped to [0, 1]."""
    g = generator(seed + 1, device)
    cells = traffic["target_cells"]
    coarse = torch.rand((n, 3, max(2, round(cells * h / w)), cells), generator=g,
                        dtype=torch.float32, device=device)
    return F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False).clamp_(0, 1)


def view_order(seed: int, n_views: int, count: int) -> list:
    """The views the trainer draws first: fresh permutations of the view
    set, one after another, from ``numpy.random.default_rng(seed)`` (the
    reference's random sampler, as the trainer documents it)."""
    rng = np.random.default_rng(seed)
    out: list = []
    while len(out) < count:
        out += [int(i) for i in rng.permutation(n_views)]
    return out[:count]
