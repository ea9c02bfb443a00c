"""Scenes at the edges of the preprocess, for the kernel pair's tests
(``tests/test_torch_cuda_kernels.py``) and its CPU tests
(``tests/test_torch_preprocess.py``). Imports no JAX.

``edge_scene`` mixes ordinary splats with splats at the near plane, behind
the camera, exactly on the camera plane (the ``|z| > 1e-12`` nudge), far
outside the ``1.3 tan`` limit (the clip), with colours under the
``clamp_min`` and in dead ``alive`` slots, and unnormalised quaternions.
``inside_scene`` is the benchmark's cloud seen from inside (``inside_camera``).
"""

import numpy as np
import torch

from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera, stack_cameras
from gaussian_splatting_lightning_tpu_torch.models.gaussians import scene_from_arrays

W, H = 128, 96


def edge_scene(n: int, max_degree: int, degree: int, seed: int = 0, device="cpu"):
    """``n`` splats around the axis of ``camera(0)``: of every ten, the
    first at the near plane, the second behind the camera, the third on the
    camera plane, the fourth far outside the clip, the fifth dark; every
    seventh dead."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    kind = np.arange(n) % 10
    # camera 0 sits at world z = -4 looking down +z: view z = world z + 4
    xyz[kind == 0, 2] = rng.uniform(0.15, 0.25, (kind == 0).sum()) - 4.0
    xyz[kind == 1, 2] = rng.uniform(-2.0, -0.01, (kind == 1).sum()) - 4.0
    xyz[kind == 2, 2] = -4.0
    clipped = kind == 3
    xyz[clipped, 0] = (xyz[clipped, 2] + 4.0) * rng.choice([-3.0, 3.0], clipped.sum())
    k = (max_degree + 1) ** 2
    dc = rng.normal(size=(n, 1, 3)).astype(np.float32)
    dc[kind == 4] = -4.0  # rgb under 0 before the clamp
    rest = (rng.normal(size=(n, k - 1, 3)) * 0.3).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats *= rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    scales = rng.uniform(np.log(0.01), np.log(0.15), (n, 3)).astype(np.float32)
    opacity = rng.uniform(-3.0, 4.0, (n, 1)).astype(np.float32)
    alive = np.arange(n) % 7 != 6
    return scene_from_arrays(xyz, dc, rest, opacity, scales, quats, alive, degree,
                             device=device)


def inside_scene(n: int, seed: int = 0, device="cpu"):
    """``n`` splats of the benchmark's cloud (means from a unit normal,
    scales log-uniform in 0.3x-3x of 0.008, opacity logits in [-2, 3], SH
    degree 3) for ``inside_camera``: about half lie on screen, some in the
    near band (0 < z <= 0.2) and some behind the camera."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    dc = ((rng.uniform(0.1, 0.9, (n, 1, 3)) - 0.5) / 0.28209479177387814).astype(np.float32)
    rest = (rng.normal(size=(n, 15, 3)) * 0.2).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = rng.uniform(np.log(0.0024), np.log(0.024), (n, 3)).astype(np.float32)
    opacity = rng.uniform(-2.0, 3.0, (n, 1)).astype(np.float32)
    return scene_from_arrays(xyz, dc, rest, opacity, scales, quats, np.ones(n, bool), 3,
                             device=device)


def inside_camera(device="cpu"):
    """A camera 2 units from the origin looking at it, inside the 2-sigma
    shell of ``inside_scene``'s cloud (the benchmark's cell from inside)."""
    eye = np.array([0.6, -0.5, -1.8])
    eye *= 2.0 / np.linalg.norm(eye)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, -1.0, 0.0])
    right /= np.linalg.norm(right)
    rot = np.stack([right, np.cross(fwd, right), fwd])
    return make_camera(np.concatenate([rot, -rot @ eye[:, None]], 1), 0.7 * W, 0.7 * W, W, H,
                       device=device)


def camera(i: int = 0, device="cpu"):
    """View ``i`` of a ring around the scene's axis, 4 units out; view 0 is
    the one ``edge_scene`` is laid out for."""
    a = 0.4 * i
    rot = np.array([[np.cos(a), 0.0, -np.sin(a)], [0.0, 1.0, 0.0],
                    [np.sin(a), 0.0, np.cos(a)]])
    t = np.array([0.0, 0.0, 4.0]) + np.array([0.1 * i, -0.05 * i, 0.0])
    return make_camera(np.concatenate([rot, t[:, None]], 1), 0.7 * W, 0.7 * W, W, H,
                       device=device)


def cameras(views: int, device="cpu"):
    """One camera (views == 1) or a stack of ``views``."""
    if views == 1:
        return camera(0, device)
    return stack_cameras([camera(i, device) for i in range(views)])


def cotangent(shape, seed: int, device="cpu") -> torch.Tensor:
    """A seeded gradient for a ([B,] N, 16) table: columns 10-15 zero, as
    the compositor's backward leaves them."""
    gen = torch.Generator().manual_seed(seed)
    ct = torch.randn(shape, generator=gen)
    ct[..., 10:] = 0.0
    return ct.to(device)
