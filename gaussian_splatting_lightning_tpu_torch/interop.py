"""Carry weights, optimizer state and cameras across from numpy, and the
bench's fixtures.

``scene_from_numpy`` / ``adam_from_numpy`` / ``camera_from_numpy`` take the
fields of the JAX package's ``GaussianParams``, ``AdamState`` and ``Camera``
as numpy arrays and return the port's objects. ``synthetic_scene`` and ``camera`` reproduce
``__graft_entry__._synthetic_scene`` and ``_camera`` number for number (the
same ``numpy.random.default_rng`` draws in the same order); unlike
``from_points`` they skip the KNN scale step, whose result those fixtures
overwrite.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_splatting_lightning_tpu_torch.core.camera import (
    Camera,
    camera_from_matrices,
    make_camera,
)
from gaussian_splatting_lightning_tpu_torch.device import resolve_device
from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianParams,
    GaussianScene,
    initial_arrays,
    pad_arrays,
    scene_from_arrays,
)
from gaussian_splatting_lightning_tpu_torch.training.optimizer import AdamState


def scene_from_numpy(params: dict, alive, active_sh_degree: int,
                     device="cuda") -> GaussianScene:
    """``params`` maps the six ``GaussianParams`` field names to arrays."""
    return scene_from_arrays(
        params["xyz"], params["features_dc"], params["features_rest"],
        params["opacity"], params["scales"], params["quats"], alive,
        active_sh_degree, device,
    )


def adam_from_numpy(count, mu: dict, nu: dict, device="cuda") -> AdamState:
    """``mu`` and ``nu`` map the six ``GaussianParams`` field names to the
    moment arrays; ``count`` is the number of steps taken."""
    dev = resolve_device(device)

    def params(d):
        return GaussianParams(**{k: torch.tensor(np.asarray(d[k]), dtype=torch.float32,
                                                 device=dev) for k in PARAM_NAMES})

    return AdamState(count=int(count), mu=params(mu), nu=params(nu))


def camera_from_numpy(viewmatrix, projmatrix, campos, tanfovx, tanfovy,
                      device="cuda") -> Camera:
    return camera_from_matrices(viewmatrix, projmatrix, campos, tanfovx,
                                tanfovy, device=device)


def synthetic_scene(n, capacity, sh_degree=3, seed=0, scale=0.05, opacity=1.0,
                    aniso=False, device="cuda") -> GaussianScene:
    """Random scene: n unit-normal means with random colours; isotropic
    ``scale`` and opacity logit ``opacity``, or (``aniso``) random anisotropic
    scales around ``scale``, random unit quaternions, varied opacity logits
    and non-zero higher SH bands."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    zeros = np.zeros((n, 3), np.float32)  # KNN scales: overwritten below
    p, alive = pad_arrays(initial_arrays(xyz, rgb, sh_degree, zeros), capacity)
    if aniso:
        p["scales"] = rng.uniform(
            np.log(scale * 0.3), np.log(scale * 3.0), size=(capacity, 3)
        ).astype(np.float32)
        quats = rng.normal(size=(capacity, 4)).astype(np.float32)
        quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
        p["quats"] = quats
        p["opacity"] = rng.uniform(-2.0, 3.0, size=(capacity, 1)).astype(np.float32)
        p["features_rest"] = (
            rng.normal(size=p["features_rest"].shape) * 0.2
        ).astype(np.float32)
    else:
        p["scales"] = np.full_like(p["scales"], np.log(scale))
        p["opacity"] = np.full_like(p["opacity"], opacity)
    return scene_from_numpy(p, alive, sh_degree, device)


def camera(w, h, fx=0.7, device="cuda") -> Camera:
    """The bench camera: identity rotation, 4 units back, focal = fx * w."""
    R = np.eye(3)
    t = np.array([0.0, 0.0, 4.0])
    focal = w * fx
    return make_camera(np.concatenate([R, t[:, None]], 1), focal, focal, w, h,
                       device=device)
