"""Camera model: a dataclass of tensors + projection-matrix construction.

Counterpart of ``gaussian_splatting_lightning_tpu/core/camera.py``. Spec:
reference ``gs_lightning/utils/camera.py`` (projection matrix, z in [0, 1],
z_sign=+1) and ``gs_lightning/datasets/colmap_dataset.py:85-108`` (row-vector
view/proj chain: ``full_proj = view @ proj^T``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaussian_splatting_lightning_tpu_torch.device import resolve_device


def get_projection_matrix(
    fx: float, fy: float, w: int, h: int, znear: float, zfar: float
) -> np.ndarray:
    """Column-vector perspective matrix, z -> [0, 1], z_sign = +1 (float64).

    Spec: reference ``utils/camera.py:4-41``. Callers transpose it into the
    row-vector convention.
    """
    right = (w * 0.5) * (znear / fx)
    top = (h * 0.5) * (znear / fy)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = znear / right
    m[1, 1] = znear / top
    m[3, 2] = 1.0
    m[2, 2] = (zfar + znear) / (zfar - znear)
    m[2, 3] = -(zfar * znear) / (zfar - znear)
    return m


@dataclasses.dataclass(frozen=True)
class Camera:
    """One view's rasterization settings, every field a tensor on one device;
    or a stack of B views (``stack_cameras``), every field with a leading B."""

    viewmatrix: torch.Tensor  # (4, 4) row-vector world->cam, translation in row 3
    projmatrix: torch.Tensor  # (4, 4) full projection = view @ proj^T
    campos: torch.Tensor  # (3,)
    tanfovx: torch.Tensor  # scalar
    tanfovy: torch.Tensor  # scalar

    @property
    def device(self) -> torch.device:
        return self.viewmatrix.device

    @property
    def views(self) -> int | None:
        """B for a stack of views, None for one view."""
        return self.viewmatrix.shape[0] if self.viewmatrix.dim() == 3 else None

    def view(self, i: int) -> "Camera":
        """View ``i`` of a stack."""
        return Camera(*(getattr(self, f.name)[i] for f in dataclasses.fields(self)))

    def focal(self, width: int, height: int):
        return (width * 0.5) / self.tanfovx, (height * 0.5) / self.tanfovy


def stack_cameras(cameras) -> Camera:
    """One Camera whose fields stack the views' along a leading axis (B, ...),
    the input of a view-batched render or train step."""
    return Camera(*(torch.stack([getattr(c, f.name) for c in cameras])
                    for f in dataclasses.fields(Camera)))


def make_camera(
    cam_from_world: np.ndarray,  # (3, 4) or (4, 4) column-vector world->cam
    fx: float,
    fy: float,
    width: int,
    height: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    dtype=torch.float32,
    device="cuda",
) -> Camera:
    """Build a Camera from a COLMAP-style world->cam matrix.

    The matrix chain runs in float64 numpy and is rounded once to ``dtype``,
    exactly as the JAX package does.
    """
    world_view = np.eye(4, dtype=np.float64)
    world_view[:, :3] = np.asarray(cam_from_world, dtype=np.float64)[:3, :4].T
    proj = get_projection_matrix(fx, fy, width, height, znear, zfar).T
    full_proj = world_view @ proj
    campos = np.linalg.inv(world_view)[3, :3]
    return camera_from_matrices(
        world_view, full_proj, campos, (width * 0.5) / fx, (height * 0.5) / fy,
        dtype=dtype, device=device,
    )


def camera_from_matrices(
    viewmatrix, projmatrix, campos, tanfovx, tanfovy, dtype=torch.float32,
    device="cuda",
) -> Camera:
    """Wrap pre-built (row-vector convention) matrices."""
    dev = resolve_device(device)

    def t(x):
        # round through numpy in ``dtype`` first so a float64 source rounds
        # exactly like jnp.asarray(x, float32)
        arr = np.asarray(x, dtype=torch.empty((), dtype=dtype).numpy().dtype)
        return torch.tensor(arr, device=dev)

    return Camera(
        viewmatrix=t(viewmatrix),
        projmatrix=t(projmatrix),
        campos=t(campos),
        tanfovx=t(tanfovx),
        tanfovy=t(tanfovy),
    )
