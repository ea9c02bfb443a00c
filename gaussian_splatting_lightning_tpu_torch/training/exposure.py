"""Per-view exposure compensation: learnable 3x4 affine colour transforms.

Counterpart of ``gaussian_splatting_lightning_tpu/training/exposure.py``:
applied to the rendered image before the loss, initialised to identity,
with its own Adam step on the stepped view's row. The JAX loop runs that
step as ``jax.jit(exposure_update, donate_argnums=(0,))``; here
``make_exposure_update`` replays ``exposure_update_`` (in place) as a
captured CUDA graph (``utils/graph.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from gaussian_splatting_lightning_tpu_torch.device import resolve_device
from gaussian_splatting_lightning_tpu_torch.training.optimizer import (
    bias_corrections,
    scalars_tensor,
)
from gaussian_splatting_lightning_tpu_torch.utils import graph


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
def exposure_update_(
    state: ExposureState,
    view_idx: torch.Tensor,  # () or (B,) int64 on the state's device
    grad: torch.Tensor,  # (3, 4) or (B, 3, 4) gradient of the views' matrices
    scalars: torch.Tensor,  # (2,): bias_corrections(b1, b2, state.count + 1)
    lr: float = 0.001,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
) -> ExposureState:
    """Adam step on the stepped views' exposure rows, written into the
    state's own tensors (JAX donates the state); returns the state with its
    count raised. The bias corrections arrive as a device input, so a
    captured update replays with each step's values. The rows are updated
    one view at a time in batch order: a view twice in one batch (the
    sampler's batch that straddles two epochs) gets both updates added to
    its matrix and keeps the later view's moments, as JAX's ``.at[].add``
    and ``.at[].set`` give them, with no host read."""
    idx = view_idx.reshape(-1)
    grad = grad.reshape(idx.shape[0], 3, 4)
    m = b1 * state.mu[idx] + (1 - b1) * grad
    v = b2 * state.nu[idx] + (1 - b2) * grad * grad
    update = -lr * ((m / scalars[0]) / (torch.sqrt(v / scalars[1]) + eps))
    for b in range(idx.shape[0]):
        row = idx[b:b + 1]
        state.params.index_add_(0, row, update[b:b + 1])
        state.mu.index_copy_(0, row, m[b:b + 1])
        state.nu.index_copy_(0, row, v[b:b + 1])
    return ExposureState(state.params, state.mu, state.nu, state.count + 1)


def exposure_update(
    state: ExposureState,
    view_idx,  # int, or (B,) int tensor: one row per view of the step
    grad: torch.Tensor,  # (3, 4) or (B, 3, 4) gradient of the views' matrices
    lr: float = 0.001,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
) -> ExposureState:
    """``exposure_update_`` on a copy: a new state, the caller's tensors
    left as they were (the JAX function's form; the tests' reference)."""
    dev = state.params.device
    new = ExposureState(state.params.clone(), state.mu.clone(), state.nu.clone(),
                        state.count)
    return exposure_update_(new, torch.as_tensor(view_idx, dtype=torch.long, device=dev),
                            grad, scalars_tensor(bias_corrections(b1, b2, state.count + 1),
                                                 dev), lr, b1, b2, eps)


def make_exposure_update(lr: float = 0.001):
    """The loop's exposure step, the counterpart of ``exposure_update_jit``:
    ``update(state, view_idx, grad)`` -> the state after ``exposure_update_``,
    ``view_idx`` a () or (B,) int64 tensor on the state's device. On CUDA it
    replays a captured graph per B (the key: ``lr`` and the shapes of the
    state, the index and the gradient); the returned state's tensors are the
    graph's own buffers, updated in place by every replay, and another state
    is copied in. A CPU state is updated in place eagerly."""

    def body(lr, params, mu, nu, scalars, idx, grad):
        exposure_update_(ExposureState(params, mu, nu, 0), idx, grad, scalars, lr)

    graphed = graph.capture(body, name="exposure_update")

    def update(state: ExposureState, view_idx: torch.Tensor, grad: torch.Tensor):
        scalars = scalars_tensor(bias_corrections(0.9, 0.999, state.count + 1),
                                 state.params.device)
        if state.params.device.type != "cuda":
            return exposure_update_(state, view_idx, grad, scalars, lr)
        graphed(lr, state.params, state.mu, state.nu, scalars, view_idx, grad)
        return ExposureState(*graphed.inputs[:3], state.count + 1)

    update.captured = graphed
    return update
