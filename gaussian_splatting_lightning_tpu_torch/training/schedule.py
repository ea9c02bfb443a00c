"""Learning-rate schedules, computed in float32 on the host.

Counterpart of ``gaussian_splatting_lightning_tpu/training/schedule.py``:
the warmup + log-space exponential decay of the reference's
``GSWarmUpExponentialDecayScheduler`` and a constant. Each schedule returns
a Python float holding the float32 value the JAX package computes (a
float64 curve drifts from it by ~1e-7 relative).
"""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def warmup_exp_decay_schedule(
    lr_init: float,
    lr_final: float,
    max_steps: int,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
):
    log_init = torch.log(_f32(lr_init))
    log_final = torch.log(_f32(lr_final))

    def schedule(step) -> float:
        step = _f32(step)
        if lr_delay_steps > 0:
            ramp = torch.clamp(step / lr_delay_steps, 0.0, 1.0)
            delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * ramp)
        else:
            delay_rate = _f32(1.0)
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        log_lerp = torch.exp(log_init * (1.0 - t) + log_final * t)
        return float(delay_rate * log_lerp)

    return schedule


def constant_schedule(lr: float):
    value = float(_f32(lr))

    def schedule(step) -> float:
        del step
        return value

    return schedule
