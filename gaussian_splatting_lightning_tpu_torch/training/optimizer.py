"""Per-parameter-group Adam with a sparse (visible-only) mode.

Counterpart of ``gaussian_splatting_lightning_tpu/training/optimizer.py``.
The state is shaped like ``GaussianParams`` (one moment tensor per group),
so densification can edit it row by row. The update is the JAX package's,
operation for operation:
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), with b1^t taken in
float32 and the reference's eps = 1e-15. It is not ``torch.optim.Adam``,
which orders these operations differently and has no visibility mask.
The learning rate of xyz follows the warmup-exp-decay schedule scaled by the
scene's spatial extent; the other five groups are constant.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianParams,
)
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
    """One Adam step; returns (new params, new state) and leaves the inputs
    as they were (out of place, like the JAX function). ``step`` is the
    global training step, which drives the learning-rate schedules.

    ``visible`` (C,) bool gives sparse-Adam semantics: rows not rendered
    this step keep their parameters and moments.
    """
    b1, b2 = cfg.beta1, cfg.beta2
    count = state.count + 1
    t = torch.tensor(float(count), dtype=torch.float32)
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
    new_params, new_mu, new_nu = {}, {}, {}
    for name in PARAM_NAMES:
        p = getattr(params, name)
        g = getattr(grads, name)
        m = getattr(state.mu, name)
        v = getattr(state.nu, name)
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        lr = schedules[name](step)
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        p_new = p - lr * update
        if visible is not None:
            vis = visible.reshape((-1,) + (1,) * (p.dim() - 1))
            p_new = torch.where(vis, p_new, p)
            m_new = torch.where(vis, m_new, m)
            v_new = torch.where(vis, v_new, v)
        new_params[name] = p_new
        new_mu[name] = m_new
        new_nu[name] = v_new
    return GaussianParams(**new_params), AdamState(
        count=count, mu=GaussianParams(**new_mu), nu=GaussianParams(**new_nu))
