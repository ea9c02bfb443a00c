"""GaussianScene: the splat store as padded-capacity tensors on one device.

Counterpart of ``gaussian_splatting_lightning_tpu/models/gaussians.py``;
densification edits the scene in ``training/densify.py``. Every tensor has
``capacity`` rows and an ``alive`` mask, as in the JAX package.

Parameters (the reference's six, gaussian_model.py:19-26, pre-activation):
  xyz (C,3) | features_dc (C,1,3) | features_rest (C,K-1,3) |
  opacity (C,1) logit | scales (C,3) log | quats (C,4) unnormalized wxyz
Activations (gaussian_model.py:317-333): sigmoid / exp / L2-normalize.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaussian_splatting_lightning_tpu_torch.core import sh as sh_lib
from gaussian_splatting_lightning_tpu_torch.core import transforms as tf
from gaussian_splatting_lightning_tpu_torch.device import resolve_device
from gaussian_splatting_lightning_tpu_torch.models import ply as ply_io
from gaussian_splatting_lightning_tpu_torch.ops.knn import mean_knn_sq_dist

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "opacity", "scales", "quats")

DEAD_OPACITY_LOGIT = -20.0  # sigmoid(-20) ~ 2e-9: dead slots never render


@dataclasses.dataclass
class GaussianParams:
    """The six learnable tensors."""

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    opacity: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor


@dataclasses.dataclass
class GaussianScene:
    params: GaussianParams
    alive: torch.Tensor  # (C,) bool
    max_radii2d: torch.Tensor  # (C,) f32
    grad_accum: torch.Tensor  # (C,) f32
    grad_count: torch.Tensor  # (C,) f32
    active_sh_degree: int

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device

    @property
    def max_sh_degree(self) -> int:
        k = 1 + self.params.features_rest.shape[1]
        return int(round(np.sqrt(k))) - 1

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity)

    def get_scales(self) -> torch.Tensor:
        return torch.exp(self.params.scales)

    def get_rotation(self) -> torch.Tensor:
        return tf.normalize_quat(self.params.quats)

    def get_features(self) -> torch.Tensor:
        return torch.cat([self.params.features_dc, self.params.features_rest], dim=1)

    def n_alive(self) -> int:
        return int(self.alive.sum())

    def step_sh_degree(self) -> "GaussianScene":
        """Reference gaussian_model.py:302-303."""
        return dataclasses.replace(
            self, active_sh_degree=min(self.active_sh_degree + 1, self.max_sh_degree)
        )

    def reset_opacity(self) -> "GaussianScene":
        """min(opacity, 0.01) in probability space; gaussian_model.py:289-293."""
        new = tf.inverse_sigmoid(torch.clamp_max(self.get_opacity(), 0.01))
        return dataclasses.replace(
            self, params=dataclasses.replace(self.params, opacity=new))


def _pad(arr: np.ndarray, capacity: int, fill: float = 0.0) -> np.ndarray:
    n = len(arr)
    if n > capacity:
        raise ValueError(f"capacity {capacity} < initial points {n}")
    out = np.full((capacity,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:n] = arr
    return out


def scene_from_arrays(
    xyz, features_dc, features_rest, opacity, scales, quats, alive,
    active_sh_degree: int, device="cuda", dtype=torch.float32,
) -> GaussianScene:
    """GaussianScene from capacity-sized numpy arrays (copied to ``device``)."""
    dev = resolve_device(device)

    def t(a):  # a copy: the scene never aliases the caller's arrays
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    params = GaussianParams(
        xyz=t(xyz), features_dc=t(features_dc), features_rest=t(features_rest),
        opacity=t(opacity), scales=t(scales), quats=t(quats),
    )
    capacity = params.xyz.shape[0]
    return GaussianScene(
        params=params,
        alive=torch.tensor(np.asarray(alive, bool), device=dev),
        max_radii2d=torch.zeros(capacity, dtype=dtype, device=dev),
        grad_accum=torch.zeros(capacity, dtype=dtype, device=dev),
        grad_count=torch.zeros(capacity, dtype=dtype, device=dev),
        active_sh_degree=int(active_sh_degree),
    )


def pad_arrays(d: dict, capacity: int):
    """Pad per-splat arrays (a dict keyed by PARAM_NAMES) to ``capacity`` the
    way the JAX package does: dead rows get zero parameters, an identity
    quaternion and DEAD_OPACITY_LOGIT. Returns (padded dict, alive mask)."""
    n = len(d["xyz"])
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    out = {k: _pad(d[k], capacity) for k in PARAM_NAMES if k != "opacity"}
    out["opacity"] = _pad(d["opacity"], capacity, DEAD_OPACITY_LOGIT)
    out["quats"][n:, 0] = 1.0
    return out, alive


def _padded_scene(d: dict, capacity: int, sh_degree: int, device, dtype):
    padded, alive = pad_arrays(d, capacity)
    return scene_from_arrays(**padded, alive=alive,
                             active_sh_degree=sh_degree, device=device,
                             dtype=dtype)


def initial_arrays(xyz: np.ndarray, rgb: np.ndarray, sh_degree: int,
                   log_scales: np.ndarray) -> dict:
    """Per-splat initial parameters (numpy) for ``from_points``: sh0 from
    rgb, higher bands zero, isotropic ``log_scales``, identity quaternion,
    opacity = inverse_sigmoid(0.1)."""
    n = len(xyz)
    k = sh_lib.num_sh_coeffs(sh_degree)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    return dict(
        xyz=np.asarray(xyz, np.float32),
        features_dc=sh_lib.rgb_to_sh0(rgb).reshape(n, 1, 3).astype(np.float32),
        features_rest=np.zeros((n, k - 1, 3), np.float32),
        opacity=np.full((n, 1), np.log(0.1 / 0.9), np.float32),
        scales=np.asarray(log_scales, np.float32),
        quats=quats,
    )


def from_points(
    xyz: np.ndarray,
    rgb: np.ndarray,
    capacity: int,
    sh_degree: int = 3,
    dtype=torch.float32,
    device="cuda",
) -> GaussianScene:
    """Initialize from a sparse SfM point cloud.

    Spec: reference ``GaussianModel.initialize`` (gaussian_model.py:65-107):
    log-scale from sqrt of clamped mean 3-NN squared distance, isotropic;
    active_sh_degree starts at 0.
    """
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    dist = np.maximum(mean_knn_sq_dist(xyz), 1e-7)
    log_scales = np.repeat(np.log(np.sqrt(dist))[:, None], 3, axis=1)
    d = initial_arrays(xyz, rgb, sh_degree, log_scales)
    return _padded_scene(d, capacity, 0, device, dtype)


def from_colmap_points_ply(ply_path: str, capacity: int, sh_degree: int = 3,
                           device="cuda") -> GaussianScene:
    """``from_points`` on a COLMAP-style points PLY (x, y, z, red, green,
    blue)."""
    xyz, rgb = ply_io.read_points_ply(ply_path)
    return from_points(xyz, rgb, capacity, sh_degree, device=device)


def save_ply(scene: GaussianScene, path: str) -> None:
    """Checkpoint the *alive* splats in the reference/Inria PLY layout."""
    alive = scene.alive.detach().cpu().numpy()
    p = scene.params

    def host(t):
        return t.detach().cpu().numpy()[alive]

    ply_io.write_gaussian_ply(
        path,
        xyz=host(p.xyz),
        features_dc=host(p.features_dc),
        features_rest=host(p.features_rest),
        opacity=host(p.opacity),
        scales=host(p.scales),
        quats=host(p.quats),
    )


def load_ply(
    path: str, capacity: int | None = None, dtype=torch.float32, device="cuda"
) -> GaussianScene:
    """Load a checkpoint PLY (ours, the reference's, or Inria's).

    ``active_sh_degree`` is the checkpoint's full degree.
    """
    d = ply_io.read_gaussian_ply(path)
    return _padded_scene(d, capacity or len(d["xyz"]), d["sh_degree"], device,
                         dtype)
