"""The training step and the render entry points of the trainer.

Counterpart of ``TrainConfig``, ``resolve_rasterizer``, ``render_scene``,
``make_train_step`` and ``make_eval_step`` in
``gaussian_splatting_lightning_tpu/training/trainer.py``, for one view per
step. One ``train_step`` is render -> loss -> backward -> Adam ->
densification statistics, eager PyTorch around the kernels (K1 and K2 in
the render, K5 in the loss and its backward, K3 and K4 in the render's
backward). The ``Trainer`` loop with its cadences, ``densify_and_prune``,
``reset_opacity`` and checkpoints come in a later slice.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gaussian_splatting_lightning_tpu_torch.core.camera import Camera
from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianParams,
    GaussianScene,
)
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.ops.rasterize import rasterize
from gaussian_splatting_lightning_tpu_torch.training.densify import accumulate_stats
from gaussian_splatting_lightning_tpu_torch.training.exposure import apply_exposure
from gaussian_splatting_lightning_tpu_torch.training.loss import photometric_loss
from gaussian_splatting_lightning_tpu_torch.training.optimizer import (
    OptimizerConfig,
    adam_update,
    make_lr_schedules,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields the step reads; defaults mirror the reference CFGTrainer
    (gs_lightning_module.py:21-45) and configs/train_gs.yaml. Exposure is on
    for a step when it is given ``exp_mat``; the loop's fields (cadences,
    densify thresholds, exposure lr) come with the ``Trainer``."""

    w_ssim: float = 0.2
    w_depth: float = 0.0  # inverse-depth L1 against a depth map
    antialias: bool = False
    sparse_adam: bool = False  # update only the splats visible this step
    rasterizer: str = "cuda"  # cuda | plain
    optimizer: OptimizerConfig = OptimizerConfig()
    tiling: TilingConfig = TilingConfig()


def resolve_rasterizer(name: str):
    """``"cuda"``: the kernel path (CUDA tensors launch the kernels, CPU
    tensors run their plain versions); ``"plain"``: the plain PyTorch
    versions on any device."""
    if name == "cuda":
        return rasterize
    if name == "plain":
        return functools.partial(rasterize, plain=True)
    raise ValueError(f"unknown rasterizer {name!r} (cuda | plain)")


def render_scene(
    scene: GaussianScene,
    camera: Camera,
    width: int,
    height: int,
    background,
    tiling: TilingConfig = TilingConfig(),
    antialias: bool = False,
    means2d_ndc_offset=None,
    rasterize_fn=None,
):
    """Render with live activations — the reference's ``render`` wrapper
    (gs_lightning_module.py:301-350). Returns (RenderOutput, stats)."""
    rasterize_fn = rasterize_fn or rasterize
    return rasterize_fn(
        scene.params.xyz,
        scene.get_opacity(),
        scene.get_scales(),
        scene.get_rotation(),
        scene.get_features(),
        camera, width, height, background,
        scene.active_sh_degree,
        config=tiling,
        max_sh_degree=scene.max_sh_degree,
        antialias=antialias,
        alive=scene.alive,
        means2d_ndc_offset=means2d_ndc_offset,
    )


def step_gradients(cfg: TrainConfig, scene: GaussianScene, camera: Camera,
                   width: int, height: int, image, background, exp_mat=None,
                   depth_target=None):
    """The step's forward and backward without the update.

    Returns (param_grads, screen_grads, exp_grad, radii, logs, stats):
    ``screen_grads`` (C, 2) is the gradient of the NDC offset added to every
    projected mean (the densification signal), ``exp_grad`` that of
    ``exp_mat`` or None."""
    rasterize_fn = resolve_rasterizer(cfg.rasterizer)
    plain = cfg.rasterizer == "plain"
    leaves = {k: getattr(scene.params, k).detach().requires_grad_() for k in PARAM_NAMES}
    offset = torch.zeros(scene.capacity, 2, dtype=scene.params.xyz.dtype,
                         device=scene.device, requires_grad=True)
    inputs = [leaves[k] for k in PARAM_NAMES] + [offset]
    if exp_mat is not None:
        exp_mat = exp_mat.detach().requires_grad_()
        inputs.append(exp_mat)
    live = dataclasses.replace(scene, params=GaussianParams(**leaves))
    with torch.enable_grad():
        out, stats = render_scene(live, camera, width, height, background,
                                  cfg.tiling, cfg.antialias,
                                  means2d_ndc_offset=offset, rasterize_fn=rasterize_fn)
        rendered = out.image
        if exp_mat is not None:
            rendered = apply_exposure(exp_mat, rendered)
        loss, logs = photometric_loss(rendered, image, cfg.w_ssim, plain)
        if cfg.w_depth > 0.0 and depth_target is not None:
            # inverse-depth L1: the depth output is sum(w / z)
            d_l1 = torch.mean(torch.abs(out.depth - depth_target))
            loss = loss + cfg.w_depth * d_l1
            logs = dict(logs, loss=loss, depth_l1=d_l1)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    param_grads = GaussianParams(**dict(zip(PARAM_NAMES, grads)))
    exp_grad = grads[len(PARAM_NAMES) + 1] if exp_mat is not None else None
    logs = {k: v.detach() for k, v in logs.items()}
    return (param_grads, grads[len(PARAM_NAMES)], exp_grad, out.radii.detach(),
            logs, stats)


def make_train_step(cfg: TrainConfig, spatial_scale: float, width: int, height: int):
    """Build the train step for a fixed image size:

    ``train_step(scene, adam, step, camera, image, background, exp_mat=None,
    depth_target=None)`` -> ``(scene, adam, logs)``, plus ``exp_grad`` (the
    gradient of ``exp_mat``, for ``exposure_update``) when ``exp_mat`` is
    given. Logs hold 0-dim tensors under the JAX step's keys."""
    schedules = make_lr_schedules(cfg.optimizer, spatial_scale)
    resolve_rasterizer(cfg.rasterizer)  # refuse an unknown name up front

    def train_step(scene: GaussianScene, adam, step, camera: Camera, image,
                   background, exp_mat=None, depth_target=None):
        param_grads, screen_grads, exp_grad, radii, logs, stats = step_gradients(
            cfg, scene, camera, width, height, image, background, exp_mat,
            depth_target)
        visible = (radii > 0) if cfg.sparse_adam else None
        new_params, adam = adam_update(scene.params, param_grads, adam, schedules,
                                       cfg.optimizer, step, visible=visible)
        scene = dataclasses.replace(scene, params=new_params)
        # densification signal for the next batch start
        # (gs_lightning_module.py:175-178)
        scene = accumulate_stats(scene, radii, screen_grads)
        logs["n_gaussians"] = scene.alive.sum()
        for k in ("num_dropped_pairs", "num_tile_overflow", "num_pairs"):
            logs[k] = stats[k]
        if exp_mat is not None:
            return scene, adam, logs, exp_grad
        return scene, adam, logs

    return train_step


def make_eval_step(cfg: TrainConfig, width: int, height: int):
    """``eval_step(scene, camera, image, background)`` ->
    ``(image, depth, logs)`` with the pair-drop counts in the logs."""
    rasterize_fn = resolve_rasterizer(cfg.rasterizer)
    plain = cfg.rasterizer == "plain"

    @torch.no_grad()
    def eval_step(scene, camera, image, background):
        out, stats = render_scene(scene, camera, width, height, background,
                                  cfg.tiling, cfg.antialias, rasterize_fn=rasterize_fn)
        _, logs = photometric_loss(out.image, image, cfg.w_ssim, plain)
        logs["num_dropped_pairs"] = stats["num_dropped_pairs"]
        logs["num_tile_overflow"] = stats["num_tile_overflow"]
        return out.image, out.depth, logs

    return eval_step
