"""Per-view exposure compensation: learnable 3x4 affine colour transforms.

Counterpart of ``gaussian_splatting_lightning_tpu/training/exposure.py``:
applied to the rendered image before the loss, initialised to identity,
with its own Adam step on the stepped view's row.
"""

from __future__ import annotations

import dataclasses

import torch

from gaussian_splatting_lightning_tpu_torch.device import resolve_device


@dataclasses.dataclass
class ExposureState:
    params: torch.Tensor  # (V, 3, 4) affine [A | b]
    mu: torch.Tensor  # Adam moments, same shape
    nu: torch.Tensor
    count: int  # steps taken


def init_exposure(n_views: int, device="cuda") -> ExposureState:
    eye = torch.cat([torch.eye(3), torch.zeros(3, 1)], dim=1)
    params = eye[None].repeat(n_views, 1, 1).to(resolve_device(device))
    return ExposureState(params=params, mu=torch.zeros_like(params),
                         nu=torch.zeros_like(params), count=0)


def apply_exposure(mat: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """mat (3, 4), image (3, H, W) -> colour-transformed image."""
    return torch.einsum("ij,jhw->ihw", mat[:, :3], image) + mat[:, 3][:, None, None]


@torch.no_grad()
def exposure_update(
    state: ExposureState,
    view_idx: int,
    grad: torch.Tensor,  # (3, 4) gradient of the view's matrix
    lr: float = 0.001,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
) -> ExposureState:
    """Adam step on the stepped view's exposure row (a new state; the
    caller's tensors are not modified)."""
    count = state.count + 1
    t = torch.tensor(float(count), dtype=torch.float32)
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
    m = b1 * state.mu[view_idx] + (1 - b1) * grad
    v = b2 * state.nu[view_idx] + (1 - b2) * grad * grad
    update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    params, mu, nu = state.params.clone(), state.mu.clone(), state.nu.clone()
    params[view_idx] += -lr * update
    mu[view_idx] = m
    nu[view_idx] = v
    return ExposureState(params=params, mu=mu, nu=nu, count=count)
