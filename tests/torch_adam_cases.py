"""Inputs for the Adam kernel's tests (``ops/adam.py``), on any device.

``adam_case`` makes a store of ``rows`` splats at an SH degree: parameters,
gradients and both moments, seeded. Gradients are either one tensor per
group or, as the mesh's ZeRO-1 update passes them, column slices of one
(rows, 59) table. A few gradients are exactly 0 and a few second moments 0,
so the update meets the root of 0 plus eps. No JAX here: the card's
machine has none.
"""

import torch

from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES, GaussianParams
from gaussian_splatting_lightning_tpu_torch.training.optimizer import AdamState


def group_shapes(rows: int, degree: int) -> dict:
    k = (degree + 1) ** 2
    return {"xyz": (rows, 3), "features_dc": (rows, 1, 3), "features_rest": (rows, k - 1, 3),
            "opacity": (rows, 1), "scales": (rows, 3), "quats": (rows, 4)}


def strided(table: torch.Tensor, shapes: dict) -> GaussianParams:
    """The groups as column slices of ``table`` (rows, widths summed), the
    way ``parallel/shard.py`` splits the summed gradients."""
    widths = [int(torch.Size(s[1:]).numel()) for s in shapes.values()]
    parts = torch.split(table, widths, dim=1)
    return GaussianParams(**{k: p.reshape(shapes[k]) for (k, p) in zip(PARAM_NAMES, parts)})


def adam_case(rows: int, degree: int, grads: str, device, seed: int = 0, count: int = 7):
    """(params, grads, state, visible) with ``grads`` "contiguous" or
    "strided"; ``visible`` marks about 70% of the rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = group_shapes(rows, degree)

    def rand(scale=1.0):
        return GaussianParams(**{k: torch.randn(s, generator=gen, device=device) * scale
                                 for k, s in shapes.items()})

    params, mu = rand(), rand(1e-3)
    nu = GaussianParams(**{k: getattr(rand(1e-3), k) ** 2 for k in PARAM_NAMES})
    if grads == "strided":
        width = sum(int(torch.Size(s[1:]).numel()) for s in shapes.values())
        g = strided(torch.randn((rows, width), generator=gen, device=device) * 1e-2, shapes)
    else:
        g = rand(1e-2)
    for k in PARAM_NAMES:
        if rows > 8:
            getattr(g, k)[3:5] = 0.0
            getattr(nu, k)[4:7] = 0.0
    visible = torch.rand(rows, generator=gen, device=device) > 0.3
    return params, g, AdamState(count=count, mu=mu, nu=nu), visible


def clone_state(params, state):
    def copy(x):
        return GaussianParams(**{k: getattr(x, k).clone() for k in PARAM_NAMES})

    return copy(params), AdamState(count=state.count, mu=copy(state.mu), nu=copy(state.nu))


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """How many elements of two float32 tensors differ in any bit."""
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())
