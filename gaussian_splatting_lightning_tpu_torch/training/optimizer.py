"""Per-parameter-group Adam with a sparse (visible-only) mode.

Counterpart of ``gaussian_splatting_lightning_tpu/training/optimizer.py``.
The state is shaped like ``GaussianParams`` (one moment tensor per group),
so densification can edit it row by row. The update is the JAX package's,
operation for operation:
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), with b1^t taken in
float32 and the reference's eps = 1e-15. It is not ``torch.optim.Adam``,
which orders these operations differently and has no visibility mask. On
CUDA tensors the update of all six groups is one kernel (``ops/adam.py``,
``csrc/adam.cu``) that gives these operations' bits; on the CPU it is the
operations themselves (``_adam_plain``).
The learning rate of xyz follows the warmup-exp-decay schedule scaled by the
scene's spatial extent; the other five groups are constant. The rates and
the bias corrections reach the update as one small device tensor
(``adam_scalars``), so the in-place form ``adam_update_`` runs inside a
captured step (``utils/graph.py``) with each step's values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianParams,
)
from gaussian_splatting_lightning_tpu_torch.ops import adam as adam_kernel
from gaussian_splatting_lightning_tpu_torch.training.schedule import (
    constant_schedule,
    warmup_exp_decay_schedule,
)


@dataclasses.dataclass
class AdamState:
    count: int  # steps taken
    mu: GaussianParams  # first moments
    nu: GaussianParams  # second moments


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Defaults are the reference's (CFGOptimizer/CFGScheduler,
    gs_lightning_module.py:54-71; configs/train_gs.yaml:21-30)."""

    xyz_lr_init: float = 0.00016  # x spatial_scale
    xyz_lr_final: float = 0.0000016  # x spatial_scale
    xyz_lr_delay_steps: int = 0
    xyz_lr_delay_mult: float = 0.001
    xyz_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    r_dc2rest: float = 20.0  # features_rest lr = feature_lr / r_dc2rest
    opacity_lr: float = 0.025
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15


def make_lr_schedules(cfg: OptimizerConfig, spatial_scale: float) -> Dict[str, Callable]:
    return dict(
        xyz=warmup_exp_decay_schedule(
            cfg.xyz_lr_init * spatial_scale,
            cfg.xyz_lr_final * spatial_scale,
            cfg.xyz_lr_max_steps,
            cfg.xyz_lr_delay_steps,
            cfg.xyz_lr_delay_mult,
        ),
        features_dc=constant_schedule(cfg.feature_lr),
        features_rest=constant_schedule(cfg.feature_lr / cfg.r_dc2rest),
        opacity=constant_schedule(cfg.opacity_lr),
        scales=constant_schedule(cfg.scaling_lr),
        quats=constant_schedule(cfg.rotation_lr),
    )


def init_adam(params: GaussianParams) -> AdamState:
    def zeros():
        return GaussianParams(**{k: torch.zeros_like(getattr(params, k))
                                 for k in PARAM_NAMES})

    return AdamState(count=0, mu=zeros(), nu=zeros())


def bias_corrections(b1: float, b2: float, count: int) -> list:
    """1 - b1^t and 1 - b2^t of Adam step ``count`` as float32 values, with
    b^t taken in float32 (the JAX update's ``b ** count.astype(f32)``)."""
    t = torch.tensor(float(count), dtype=torch.float32)
    return [float(1.0 - torch.tensor(b, dtype=torch.float32) ** t) for b in (b1, b2)]


def adam_scalars(schedules: Dict[str, Callable], cfg: OptimizerConfig, step,
                 count: int) -> list:
    """The step's host scalars, in float32 values: the six groups' learning
    rates at ``step`` (``PARAM_NAMES`` order), then the bias corrections of
    Adam step ``count`` (``bias_corrections``)."""
    return ([schedules[name](step) for name in PARAM_NAMES]
            + bias_corrections(cfg.beta1, cfg.beta2, count))


def scalars_tensor(values, device) -> torch.Tensor:
    """``values`` as a float32 tensor on ``device``; to a card through pinned
    memory without a host sync."""
    host = torch.tensor(values, dtype=torch.float32)
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _adam(params, grads, state, scalars, cfg, visible):
    """The update of every group, written into ``params``' and ``state``'s
    own tensors. CUDA tensors take one launch of ``ops/adam.py``'s kernel,
    which raises on what it does not take; other devices take
    ``_adam_plain``."""
    if params.xyz.device.type != "cuda":
        _adam_plain(params, grads, state, scalars, cfg, visible)
        return
    groups = [tuple(getattr(x, name) for x in (params, grads, state.mu, state.nu, params,
                                               state.mu, state.nu))
              for name in PARAM_NAMES]
    adam_kernel.adam_update_kernel(groups, scalars, visible, cfg.beta1, cfg.beta2, cfg.eps)


def _adam_plain(params, grads, state, scalars, cfg, visible):
    """``_adam``'s plain version, the JAX update operation for operation,
    written into ``params``' and ``state``'s tensors. A sparse update writes
    its masked results. The kernel rounds where these operations round on
    the card, so it gives their bits."""
    b1, b2 = cfg.beta1, cfg.beta2
    bc1, bc2 = scalars[len(PARAM_NAMES)], scalars[len(PARAM_NAMES) + 1]
    dense = visible is None
    for i, name in enumerate(PARAM_NAMES):
        p, g, m, v = (getattr(x, name) for x in (params, grads, state.mu, state.nu))
        m_new = torch.add(b1 * m, (1.0 - b1) * g, out=m if dense else None)
        v_new = torch.add(b2 * v, (1.0 - b2) * g * g, out=v if dense else None)
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if dense:
            torch.sub(p, scalars[i] * update, out=p)
        else:
            vis = visible.reshape((-1,) + (1,) * (p.dim() - 1))
            torch.where(vis, p - scalars[i] * update, p, out=p)
            torch.where(vis, m_new, m, out=m)
            torch.where(vis, v_new, v, out=v)


@torch.no_grad()
def adam_update(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    schedules: Dict[str, Callable],
    cfg: OptimizerConfig,
    step,
    visible=None,
):
    """``adam_update_`` on a copy: returns (new params, new state) and
    leaves the inputs as they were (the JAX function's form; the tests'
    reference). ``step`` is the global training step, which drives the
    learning-rate schedules.

    ``visible`` (C,) bool gives sparse-Adam semantics: rows not rendered
    this step keep their parameters and moments.
    """
    def copy(x):
        return GaussianParams(**{k: getattr(x, k).clone() for k in PARAM_NAMES})

    new_params = copy(params)
    new = AdamState(count=state.count, mu=copy(state.mu), nu=copy(state.nu))
    scalars = scalars_tensor(adam_scalars(schedules, cfg, step, state.count + 1),
                             params.xyz.device)
    return new_params, adam_update_(new_params, grads, new, scalars, cfg, visible)


@torch.no_grad()
def adam_update_(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    scalars: torch.Tensor,
    cfg: OptimizerConfig,
    visible=None,
) -> AdamState:
    """One Adam step in place, the counterpart of the JAX step's donated
    update: writes the new parameters and moments into ``params``' and
    ``state``'s own tensors and returns the state with its count raised.
    ``scalars`` (8,) is ``adam_scalars`` of this step on the parameters'
    device, an input rather than constants, so a captured step replays
    with each step's values.

    ``visible`` (C,) bool gives sparse-Adam semantics: rows not rendered
    this step keep their parameters and moments."""
    _adam(params, grads, state, scalars, cfg, visible)
    return AdamState(count=state.count + 1, mu=state.mu, nu=state.nu)
