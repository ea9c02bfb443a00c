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
    """mat (3, 4), image (3, H, W) -> colour-transformed image; per view for
    (B, 3, 4) and (B, 3, H, W)."""
    if mat.dim() == 3:
        return (torch.einsum("bij,bjhw->bihw", mat[:, :, :3], image)
                + mat[:, :, 3][:, :, None, None])
    return torch.einsum("ij,jhw->ihw", mat[:, :3], image) + mat[:, 3][:, None, None]


@torch.no_grad()
def exposure_update(
    state: ExposureState,
    view_idx,  # int, or (B,) int tensor: one row per view of the step
    grad: torch.Tensor,  # (3, 4) or (B, 3, 4) gradient of the views' matrices
    lr: float = 0.001,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
) -> ExposureState:
    """Adam step on the stepped views' exposure rows (a new state; the
    caller's tensors are not modified). A view twice in one batch (the
    sampler's batch that straddles two epochs) gets both updates added to
    its matrix and the later view's moments, as JAX's ``.at[].add`` and
    ``.at[].set`` give them."""
    count = state.count + 1
    t = torch.tensor(float(count), dtype=torch.float32)
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
    m = b1 * state.mu[view_idx] + (1 - b1) * grad
    v = b2 * state.nu[view_idx] + (1 - b2) * grad * grad
    update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    params, mu, nu = state.params.clone(), state.mu.clone(), state.nu.clone()
    if isinstance(view_idx, torch.Tensor) and view_idx.dim() == 1:
        idx = view_idx.to(device=params.device, dtype=torch.long)
        params.index_add_(0, idx, -lr * update)
        # of equal indices the last one's moments stay: the others write to
        # a spare row, so the result needs no host read and no write order
        later = torch.triu(idx[:, None] == idx[None, :], diagonal=1).any(dim=1)
        dst = torch.where(later, torch.full_like(idx, params.shape[0]), idx)
        for moment, value in ((mu, m), (nu, v)):
            spare = torch.cat([moment, moment[:1]])
            spare.index_copy_(0, dst, value)
            moment.copy_(spare[:-1])
    else:
        params[view_idx] += -lr * update
        mu[view_idx] = m
        nu[view_idx] = v
    return ExposureState(params=params, mu=mu, nu=nu, count=count)
