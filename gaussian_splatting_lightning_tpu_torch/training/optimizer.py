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


def _adam(params, grads, state, scalars, cfg, visible, out):
    """The update of every group, ``out`` None (new tensors) or
    (params, state) to write into: the same operations either way, so the
    two give the same bits. A sparse update writes its masked results."""
    b1, b2 = cfg.beta1, cfg.beta2
    bc1, bc2 = scalars[len(PARAM_NAMES)], scalars[len(PARAM_NAMES) + 1]
    dense = visible is None
    new = {"p": {}, "m": {}, "v": {}}
    for i, name in enumerate(PARAM_NAMES):
        p, g, m, v = (getattr(x, name) for x in (params, grads, state.mu, state.nu))
        p_out, m_out, v_out = (None, None, None) if out is None else (
            getattr(x, name) for x in (out[0], out[1].mu, out[1].nu))
        m_new = torch.add(b1 * m, (1.0 - b1) * g, out=m_out if dense else None)
        v_new = torch.add(b2 * v, (1.0 - b2) * g * g, out=v_out if dense else None)
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if dense:
            p_new = torch.sub(p, scalars[i] * update, out=p_out)
        else:
            vis = visible.reshape((-1,) + (1,) * (p.dim() - 1))
            p_new = torch.where(vis, p - scalars[i] * update, p, out=p_out)
            m_new = torch.where(vis, m_new, m, out=m_out)
            v_new = torch.where(vis, v_new, v, out=v_out)
        new["p"][name], new["m"][name], new["v"][name] = p_new, m_new, v_new
    return (GaussianParams(**new["p"]), GaussianParams(**new["m"]),
            GaussianParams(**new["v"]))


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
    count = state.count + 1
    scalars = scalars_tensor(adam_scalars(schedules, cfg, step, count), params.xyz.device)
    new_params, mu, nu = _adam(params, grads, state, scalars, cfg, visible, None)
    return new_params, AdamState(count=count, mu=mu, nu=nu)


@torch.no_grad()
def adam_update_(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    scalars: torch.Tensor,
    cfg: OptimizerConfig,
    visible=None,
) -> AdamState:
    """``adam_update`` in place, the counterpart of the JAX step's donated
    update: writes the new parameters and moments into ``params``' and
    ``state``'s own tensors and returns the state with its count raised.
    ``scalars`` (8,) is ``adam_scalars`` of this step on the parameters'
    device, an input rather than constants, so a captured step replays
    with each step's values. The same bits as ``adam_update``."""
    _adam(params, grads, state, scalars, cfg, visible, (params, state))
    return AdamState(count=state.count + 1, mu=state.mu, nu=state.nu)
