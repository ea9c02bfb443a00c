"""Densification: statistics, then clone/split/prune as gather/scatter.

Counterpart of ``gaussian_splatting_lightning_tpu/training/densify.py``
(spec: the reference's ``GaussianModel.densify_and_prune`` and the Lightning
module's Adam surgery, ``gaussian_model.py:174-300``,
``gs_lightning_module.py:192-235``). Under the padded-capacity design the
events keep every shape:

- prune    -> clear ``alive`` bits
- clone    -> copy a row into a free slot, zero its Adam moments
- split    -> move and shrink the parent in place (one sampled
              displacement), then clone the *modified* parent
- surgery  -> surviving rows keep their moments in place; activated slots
              zero theirs

Children go to free slots by two stable argsorts and a scatter that drops
the children beyond the free slots (counted in ``n_dropped_children``). The
scatter writes into a buffer one row longer than the capacity whose last row
takes the dropped writes, so no step reads a count back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from gaussian_splatting_lightning_tpu_torch.core import transforms as tf
from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
    DEAD_OPACITY_LOGIT,
    PARAM_NAMES,
    GaussianParams,
    GaussianScene,
)
from gaussian_splatting_lightning_tpu_torch.training.optimizer import AdamState


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """Defaults are the reference's CFGTrainer (gs_lightning_module.py:21-45)."""

    densify_since: int = 500
    densify_until: int = 15_000
    densify_interval: int = 100
    densify_grad_threshold: float = 0.0002
    clone_size_threshold: float = 0.01  # x spatial_scale
    prune_opacity_threshold: float = 0.005
    prune_size_threshold: float = 0.1  # x spatial_scale
    prune_screensize_threshold: float = 40.0
    opacity_reset_interval: int = 3000
    sh_degree_step_interval: int = 1000
    use_screensize_threshold: bool = True
    split_scale_shrink: float = 1.6  # gaussian_model.py:262


def accumulate_stats(
    scene: GaussianScene,
    radii: torch.Tensor,  # (C,) or (B, C) from the render
    screenspace_grad: torch.Tensor,  # (C, 2) or (B, C, 2) NDC mean gradients
) -> GaussianScene:
    """``accumulate_stats_`` on a copy of the three statistics: a new scene,
    the caller's tensors left as they were (the JAX function's form; the
    tests' reference)."""
    copy = dataclasses.replace(scene, max_radii2d=scene.max_radii2d.clone(),
                               grad_accum=scene.grad_accum.clone(),
                               grad_count=scene.grad_count.clone())
    return accumulate_stats_(copy, radii, screenspace_grad)


def accumulate_stats_(scene: GaussianScene, radii: torch.Tensor,
                      screenspace_grad: torch.Tensor) -> GaussianScene:
    """update_max_radii2D / update_xyz_gradient (gaussian_model.py:174-181),
    gated on radii > 0, written into the scene's own statistics (the donated
    step's form). A leading view axis (the view-batched step) reduces as B
    reference steps in a row would: the max of the radii, the sum of the
    per-view gradient norms, and the count raised by the number of views
    that saw the splat. Returns the scene."""
    seen = radii > 0
    norms = torch.linalg.vector_norm(screenspace_grad[..., :2], dim=-1)
    contrib = torch.where(seen, norms, 0.0)
    if radii.dim() == 2:
        radii = torch.amax(radii, dim=0)
        contrib = torch.sum(contrib, dim=0)
        count = torch.sum(seen.to(scene.grad_count.dtype), dim=0)
        seen = radii > 0
    else:
        count = seen.to(scene.grad_count.dtype)
    torch.where(seen, torch.maximum(scene.max_radii2d, radii), scene.max_radii2d,
                out=scene.max_radii2d)
    torch.add(scene.grad_accum, contrib, out=scene.grad_accum)
    torch.add(scene.grad_count, count, out=scene.grad_count)
    return scene


def _scatter_drop(leaf: torch.Tensor, dst: torch.Tensor, values) -> torch.Tensor:
    """``leaf.at[dst].set(values, mode="drop")``: a copy of ``leaf`` with rows
    ``dst`` set to ``values`` (rows or a scalar); ``dst == capacity`` drops
    its write. ``dst`` is unique below the capacity."""
    cap = leaf.shape[0]
    out = torch.empty((cap + 1,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                      device=leaf.device)
    out[:cap] = leaf
    if isinstance(values, torch.Tensor):
        out.index_copy_(0, dst, values)
    else:
        out.index_fill_(0, dst, values)
    return out[:cap]


def densify_and_prune(
    scene: GaussianScene,
    adam: AdamState,
    noise: torch.Tensor,  # (C, 3) standard-normal draw for the split
    cfg: DensifyConfig,
    spatial_scale: float,
    apply_screensize: bool,  # step > opacity_reset_interval
):
    """Returns (scene, adam, stats) as new objects; the inputs are left as
    they were. ``stats`` holds 0-dim int64 tensors under the JAX keys."""
    p = scene.params
    capacity = scene.capacity
    alive = scene.alive
    opacity = torch.sigmoid(p.opacity[:, 0])
    scales = torch.exp(p.scales)
    size = torch.amax(scales, dim=-1)

    # ---- prune (gaussian_model.py:212-237) ------------------------------
    keep = alive & (opacity > cfg.prune_opacity_threshold)
    n_pruned_opacity = (alive & (opacity <= cfg.prune_opacity_threshold)).sum()
    zero = torch.zeros((), dtype=torch.int64, device=scene.device)
    n_pruned_screen = n_pruned_size = zero
    if apply_screensize:
        if cfg.use_screensize_threshold:
            big_screen = alive & (scene.max_radii2d >= cfg.prune_screensize_threshold)
            n_pruned_screen = big_screen.sum()
            keep = keep & ~big_screen
        big_world = alive & (size >= cfg.prune_size_threshold * spatial_scale)
        n_pruned_size = big_world.sum()
        keep = keep & ~big_world

    # ---- densification signal (gaussian_model.py:198-205) ---------------
    grad = torch.where(scene.grad_count > 0, scene.grad_accum / scene.grad_count, 0.0)
    bad = keep & (grad >= cfg.densify_grad_threshold)
    small = size < cfg.clone_size_threshold * spatial_scale
    clone_mask = bad & small
    split_mask = bad & ~small

    # ---- split: move + shrink parents in place (gaussian_model.py:251-265)
    displace = noise.to(p.xyz.dtype) * scales
    R = tf.quat_to_rotmat(tf.normalize_quat(p.quats))
    moved_xyz = p.xyz + torch.einsum("nij,nj->ni", R, displace)
    shrink = torch.log(torch.tensor(cfg.split_scale_shrink, dtype=p.scales.dtype))
    shrunk_scales = p.scales - shrink.to(p.scales.device)
    parent = {k: getattr(p, k) for k in PARAM_NAMES}
    parent["xyz"] = torch.where(split_mask[:, None], moved_xyz, p.xyz)
    parent["scales"] = torch.where(split_mask[:, None], shrunk_scales, p.scales)

    # ---- assign children to free slots ----------------------------------
    child = clone_mask | split_mask
    n_child = child.sum()
    n_free = capacity - keep.sum()
    rank = torch.arange(capacity, device=scene.device)
    # stable: dead slots first, then children first, each in index order
    free_slots = torch.argsort(keep.to(torch.uint8), stable=True)
    child_src = torch.argsort((~child).to(torch.uint8), stable=True)
    valid = (rank < n_child) & (rank < n_free)
    dst = torch.where(valid, free_slots, capacity)  # capacity: dropped

    new = {k: _scatter_drop(v, dst, v[child_src]) for k, v in parent.items()}
    # pruned-but-unreused slots: force opacity dead so stale rows can never
    # render even if an alive mask is dropped somewhere downstream
    newly_dead = _scatter_drop(~keep, dst, False)
    new["opacity"] = torch.where(newly_dead[:, None], DEAD_OPACITY_LOGIT, new["opacity"])
    new_alive = _scatter_drop(keep, dst, True)

    # ---- Adam surgery (gs_lightning_module.py:213-235) -------------------
    def zero_new(moments: GaussianParams) -> GaussianParams:
        return GaussianParams(**{k: _scatter_drop(getattr(moments, k), dst, 0.0)
                                 for k in PARAM_NAMES})

    adam = AdamState(count=adam.count, mu=zero_new(adam.mu), nu=zero_new(adam.nu))

    # ---- reset accumulators (gs_lightning_module.py:207-208) -------------
    zeros = torch.zeros_like(scene.max_radii2d)
    new_scene = GaussianScene(
        params=GaussianParams(**new),
        alive=new_alive,
        max_radii2d=zeros,
        grad_accum=zeros.clone(),
        grad_count=zeros.clone(),
        active_sh_degree=scene.active_sh_degree,
    )
    stats = {
        "n_cloned": clone_mask.sum(),
        "n_split": split_mask.sum(),
        "n_pruned": (alive & ~keep).sum(),
        "n_pruned_opacity": n_pruned_opacity,
        "n_pruned_screen": n_pruned_screen,
        "n_pruned_size": n_pruned_size,
        "n_dropped_children": torch.clamp_min(n_child - n_free, 0),
        "n_alive": new_alive.sum(),
    }
    return new_scene, adam, stats
