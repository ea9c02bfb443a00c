"""Densification statistics.

Counterpart of ``accumulate_stats`` in
``gaussian_splatting_lightning_tpu/training/densify.py``;
``densify_and_prune`` (clone, split, prune and the Adam surgery) and its
``DensifyConfig`` come in a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from gaussian_splatting_lightning_tpu_torch.models.gaussians import GaussianScene


def accumulate_stats(
    scene: GaussianScene,
    radii: torch.Tensor,  # (C,) from the render
    screenspace_grad: torch.Tensor,  # (C, 2) NDC mean gradients
) -> GaussianScene:
    """One view's update_max_radii2D / update_xyz_gradient
    (gaussian_model.py:174-181), gated on radii > 0."""
    seen = radii > 0
    norms = torch.linalg.vector_norm(screenspace_grad[..., :2], dim=-1)
    contrib = torch.where(seen, norms, 0.0)
    return dataclasses.replace(
        scene,
        max_radii2d=torch.where(
            seen, torch.maximum(scene.max_radii2d, radii), scene.max_radii2d),
        grad_accum=scene.grad_accum + contrib,
        grad_count=scene.grad_count + seen.to(scene.grad_count.dtype),
    )
