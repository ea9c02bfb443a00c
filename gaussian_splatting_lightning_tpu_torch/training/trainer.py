"""The training loop: the step, the scene-changing events and their cadences.

Counterpart of ``gaussian_splatting_lightning_tpu/training/trainer.py`` on
one device. One ``train_step`` is render -> loss -> backward -> Adam ->
densification statistics, PyTorch around the kernels (K1 and K2 in the
render, K5 in the loss and its backward, K3 and K4 in the render's
backward). On the card the step, the eval step, the serving render
(``make_render``) and the exposure update (``training/exposure.py``) each
replay a captured CUDA graph (``utils/graph.py``), the counterpart of the
JAX package's ``jax.jit``; on the CPU, with ``capture=False`` and on the
``plain`` and ``xla`` routes they run eagerly.
With ``batch_views`` B > 1 the step takes B views stacked along a leading
axis and renders them in one pass (each kernel launched once for all B, as
``vmap`` gives the JAX kernels a batch grid axis); the loss is the mean over
views. The events that change the scene (densify/prune,
opacity reset, SH warm-up) run between steps on the cadences of the
reference's ``on_train_batch_start`` (gs_lightning_module.py:144-161):

  step t (0-based, == Lightning global_step at batch start), t >= 1:
    - densify stats from step t-1 are already accumulated (in-step tail)
    - if t > densify_since and t % densify_interval == 0 and
      t < densify_until:   densify_and_prune (+ Adam surgery)
    - if t % opacity_reset_interval == 0:  reset opacity
    - if t % sh_degree_step_interval == 0: step SH degree

The ``Trainer`` adds adaptive pair budgets, NaN rollback, validation and
checkpoints (``torch.save`` of the scene, Adam and the step, plus the view
sampler's and the noise generator's state as JSON, so a resume replays the
same trajectory) with retention, and a PLY at every validation. On a
``parallel.Mesh`` every rank runs the loop (SPMD) with the sharded step of
``parallel/shard.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gaussian_splatting_lightning_tpu_torch.core.camera import (
    Camera,
    camera_from_matrices,
    stack_cameras,
)
from gaussian_splatting_lightning_tpu_torch.data.dataset import ViewSampler
from gaussian_splatting_lightning_tpu_torch.models import gaussians as gm
from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianParams,
    GaussianScene,
)
from gaussian_splatting_lightning_tpu_torch.ops.common import RenderOutput, TilingConfig
from gaussian_splatting_lightning_tpu_torch.ops.rasterize import rasterize
from gaussian_splatting_lightning_tpu_torch.ops.rasterize_tiled import rasterize_tiled
from gaussian_splatting_lightning_tpu_torch.training.densify import (
    DensifyConfig,
    accumulate_stats,
    accumulate_stats_,
    densify_and_prune,
)
from gaussian_splatting_lightning_tpu_torch.training.exposure import (
    ExposureState,
    apply_exposure,
    init_exposure,
    make_exposure_update,
)
from gaussian_splatting_lightning_tpu_torch.training.loss import (
    photometric_loss,
    photometric_losses,
)
from gaussian_splatting_lightning_tpu_torch.training.optimizer import (
    AdamState,
    OptimizerConfig,
    adam_scalars,
    adam_update,
    adam_update_,
    init_adam,
    make_lr_schedules,
    scalars_tensor,
)
from gaussian_splatting_lightning_tpu_torch.utils import graph


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Defaults mirror the reference CFGTrainer (gs_lightning_module.py:21-45)
    and configs/train_gs.yaml, field for field with the JAX ``TrainConfig``.
    A step applies exposure when it is given ``exp_mat``; the ``Trainer``
    gives it one when ``use_exposure`` is set."""

    num_iters: int = 30_000
    w_ssim: float = 0.2
    w_depth: float = 0.0  # inverse-depth L1 against a depth map
    log_interval: int = 100
    valid_interval: int = 1000
    checkpoint_interval: int = 5000
    seed: int = 42
    capacity: int = 1 << 20
    antialias: bool = False
    sparse_adam: bool = False  # update only the splats visible this step
    adaptive_pairs: bool = True  # double max_pairs when a checked step drops pairs
    overflow_check_interval: int = 50  # steps between host reads of the stats
    shrink_patience: int = 8  # checks below max_pairs/4 before the budget shrinks
    max_nan_rollbacks: int = 3  # non-finite loss: restore the newest checkpoint
    keep_last_ckpts: int = 3  # checkpoint retention; 0 keeps every checkpoint
    batch_views: int = 1  # views per step, stacked along a leading axis
    use_exposure: bool = False  # per-view affine colour compensation
    exposure_lr: float = 0.001
    rasterizer: str = "cuda"  # cuda | plain | xla
    densify: DensifyConfig = DensifyConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    tiling: TilingConfig = TilingConfig()


def find_resume_checkpoint(exp_dir) -> Optional[Path]:
    """``--resume auto`` selection: the most recently WRITTEN run under the
    experiment dir, then the newest checkpoint BY STEP within that run."""
    exp_dir = Path(exp_dir)
    candidates = [p for p in exp_dir.glob("*/ckpt-*") if p.is_dir()]
    if not candidates:
        return None
    newest = max(candidates, key=lambda p: p.stat().st_mtime)
    return max(
        (p for p in newest.parent.glob("ckpt-*") if p.is_dir()),
        key=lambda p: int(p.name.split("-")[-1]),
    )


def resolve_rasterizer(name: str):
    """``"cuda"``: the kernel path (CUDA tensors launch the kernels, CPU
    tensors run their plain versions); ``"plain"``: the plain PyTorch
    versions on any device; ``"xla"``: the tiled route
    (``ops/rasterize_tiled.py``, the JAX package's XLA path), plain PyTorch
    over a per-tile member table of ``tiling.tile_capacity`` slots."""
    if name == "cuda":
        return rasterize
    if name == "plain":
        return functools.partial(rasterize, plain=True)
    if name == "xla":
        return rasterize_tiled
    raise ValueError(f"unknown rasterizer {name!r} (cuda | plain | xla)")


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


def _render_each(live, camera, width, height, background, cfg, offset, rasterize_fn):
    """A stack of views rendered one at a time (the tiled route has no view
    axis), stacked as one batched render's output and stats."""
    outs, stats = zip(*(render_scene(live, camera.view(v), width, height, background[v],
                                     cfg.tiling, cfg.antialias,
                                     means2d_ndc_offset=offset[v],
                                     rasterize_fn=rasterize_fn)
                        for v in range(camera.views)))
    out = RenderOutput(*(torch.stack([getattr(o, f) for o in outs])
                         for f in ("image", "radii", "depth")))
    per = {k: torch.stack([s[k] for s in stats]) for k in stats[0]}
    return out, {"num_dropped_pairs": per["num_dropped_pairs"].sum(),
                 "num_tile_overflow": per["num_tile_overflow"].max(),
                 "num_pairs": per["num_pairs"].max()}


def _scene_tensors(scene: GaussianScene, stats: bool = True) -> list:
    """A scene's tensors in capture order: the six parameters, ``alive`` and,
    with ``stats``, the three densification statistics."""
    tensors = [getattr(scene.params, k) for k in PARAM_NAMES] + [scene.alive]
    if stats:
        tensors += [scene.max_radii2d, scene.grad_accum, scene.grad_count]
    return tensors


def _scene_of(tensors, active_sh_degree: int) -> GaussianScene:
    """The scene whose tensors are ``tensors`` (``_scene_tensors`` order; the
    statistics None when absent)."""
    stats = list(tensors[len(PARAM_NAMES) + 1:]) or [None] * 3
    return GaussianScene(GaussianParams(*tensors[:len(PARAM_NAMES)]),
                         tensors[len(PARAM_NAMES)], *stats, active_sh_degree)


def _camera_tensors(camera: Camera) -> list:
    return [getattr(camera, f.name) for f in dataclasses.fields(Camera)]


N_SCENE = len(PARAM_NAMES) + 4  # parameters, alive, three statistics
N_CAMERA = len(dataclasses.fields(Camera))


def step_tensors(scene, adam, scalars, camera, image, background, exp_mat,
                 depth_target) -> list:
    """A donating step's inputs in capture order: the scene's tensors, Adam's
    moments, the ``adam_scalars`` tensor, the camera's tensors, the targets
    and, when given, ``exp_mat`` and ``depth_target``."""
    return (_scene_tensors(scene) + [getattr(adam.mu, k) for k in PARAM_NAMES]
            + [getattr(adam.nu, k) for k in PARAM_NAMES] + [scalars]
            + _camera_tensors(camera) + [image, background]
            + [x for x in (exp_mat, depth_target) if x is not None])


def donated_state(t, active_sh_degree: int, count: int):
    """The (scene, Adam state) whose tensors are the first ones of
    ``step_tensors`` ``t``."""
    n = len(PARAM_NAMES)
    return (_scene_of(t[:N_SCENE], active_sh_degree),
            AdamState(count, GaussianParams(*t[N_SCENE:N_SCENE + n]),
                      GaussianParams(*t[N_SCENE + n:N_SCENE + 2 * n])))


def step_args(t, active_sh_degree: int, has_exp: bool, has_depth: bool):
    """``step_tensors`` ``t`` back as (scene, adam, scalars, camera, image,
    background, exp_mat, depth_target), the absent ones None."""
    scene, adam = donated_state(t, active_sh_degree, 0)
    at = N_SCENE + 2 * len(PARAM_NAMES)
    scalars, camera = t[at], Camera(*t[at + 1:at + 1 + N_CAMERA])
    image, background, *rest = t[at + 1 + N_CAMERA:]
    exp_mat = rest.pop(0) if has_exp else None
    depth_target = rest.pop(0) if has_depth else None
    return scene, adam, scalars, camera, image, background, exp_mat, depth_target


def make_render(width: int, height: int, tiling: TilingConfig = TilingConfig(),
                antialias: bool = False, capture: bool = True):
    """The serving render, the counterpart of the JAX CLIs'
    ``jax.jit(render_scene)``: ``render(scene, camera, background)`` ->
    ``(RenderOutput, stats)`` without autograd. On CUDA it replays a
    captured graph (``utils/graph.py``) per SH degree and shape, the camera's
    tensors and the background its inputs; its outputs hold until the next
    replay of any graph. ``capture=False``, or a CPU scene, renders
    eagerly."""

    @torch.no_grad()
    def render_eager(scene, camera, background):
        return render_scene(scene, camera, width, height, background, tiling, antialias)

    if not capture:
        return render_eager

    def body(static, *t):
        scene = _scene_of(t[:len(PARAM_NAMES) + 1], static[-1])
        return render_eager(scene, Camera(*t[-N_CAMERA - 1:-1]), t[-1])

    graphed = graph.capture(body, name="render")

    def render(scene, camera, background):
        if scene.device.type != "cuda":
            return render_eager(scene, camera, background)
        out, stats = graphed((width, height, tiling, antialias, scene.active_sh_degree),
                             *_scene_tensors(scene, stats=False), *_camera_tensors(camera),
                             background)
        return out, dict(stats)

    render.captured = graphed
    return render


def step_gradients(cfg: TrainConfig, scene: GaussianScene, camera: Camera,
                   width: int, height: int, image, background, exp_mat=None,
                   depth_target=None):
    """The step's forward and backward without the update.

    Returns (param_grads, screen_grads, exp_grad, radii, logs, stats):
    ``screen_grads`` (C, 2) is the gradient of the NDC offset added to every
    projected mean (the densification signal), ``exp_grad`` that of
    ``exp_mat`` or None.

    With ``cfg.batch_views`` B > 1 the camera is a stack of B views
    (``stack_cameras``), ``image`` (B, 3, H, W), ``background`` (B, 3),
    ``exp_mat`` (B, 3, 4) and ``depth_target`` (B, 1, H, W); the loss is the
    mean of the views' losses and the logs the means of their logs.
    ``screen_grads`` (B, C, 2) and ``exp_grad`` are then scaled by B, so each
    view's is the gradient of its own loss, and ``radii`` is (B, C)."""
    rasterize_fn = resolve_rasterizer(cfg.rasterizer)
    plain = cfg.rasterizer == "plain"
    views = cfg.batch_views if cfg.batch_views > 1 else None
    leaves = {k: getattr(scene.params, k).detach().requires_grad_() for k in PARAM_NAMES}
    offset = torch.zeros(((views,) if views else ()) + (scene.capacity, 2),
                         dtype=scene.params.xyz.dtype, device=scene.device,
                         requires_grad=True)
    inputs = [leaves[k] for k in PARAM_NAMES] + [offset]
    if exp_mat is not None:
        exp_mat = exp_mat.detach().requires_grad_()
        inputs.append(exp_mat)
    live = dataclasses.replace(scene, params=GaussianParams(**leaves))
    with torch.enable_grad():
        if views and cfg.rasterizer == "xla":
            out, stats = _render_each(live, camera, width, height, background, cfg,
                                      offset, rasterize_fn)
        else:
            out, stats = render_scene(live, camera, width, height, background,
                                      cfg.tiling, cfg.antialias,
                                      means2d_ndc_offset=offset, rasterize_fn=rasterize_fn)
        rendered = out.image
        if exp_mat is not None:
            rendered = apply_exposure(exp_mat, rendered)
        losses = photometric_losses if views else photometric_loss
        loss, logs = losses(rendered, image, cfg.w_ssim, plain)
        if cfg.w_depth > 0.0 and depth_target is not None:
            # inverse-depth L1: the depth output is sum(w / z)
            diff = torch.abs(out.depth - depth_target)
            d_l1 = torch.mean(diff, dim=(1, 2, 3)) if views else torch.mean(diff)
            loss = loss + cfg.w_depth * d_l1
            logs = dict(logs, loss=loss, depth_l1=d_l1)
        if views:  # the batch mean, and the mean of each log over the views
            loss = torch.mean(loss)
            logs = {k: torch.mean(v) for k, v in logs.items()}
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    param_grads = GaussianParams(**dict(zip(PARAM_NAMES, grads)))
    screen_grads = grads[len(PARAM_NAMES)]
    exp_grad = grads[len(PARAM_NAMES) + 1] if exp_mat is not None else None
    if views:
        # each view's own loss gradient, as the reference accumulates it
        # (gs_lightning_module.py:175-178): undo the 1/B of the batch mean
        screen_grads = screen_grads * views
        if exp_grad is not None:
            exp_grad = exp_grad * views
    logs = {k: v.detach() for k, v in logs.items()}
    return param_grads, screen_grads, exp_grad, out.radii.detach(), logs, stats


def _step_logs(logs: dict, scene: GaussianScene, stats: dict) -> dict:
    """The step's logs under the JAX step's keys."""
    logs = dict(logs, n_gaussians=scene.alive.sum())
    for k in ("num_dropped_pairs", "num_tile_overflow", "num_pairs"):
        logs[k] = stats[k]
    return logs


def _visible(cfg: TrainConfig, radii):
    """Sparse Adam's rows: the splats any view saw (None: every row)."""
    if not cfg.sparse_adam:
        return None
    return (radii > 0) if radii.dim() == 1 else torch.any(radii > 0, dim=0)


def make_train_step(cfg: TrainConfig, spatial_scale: float, width: int, height: int,
                    capture: bool = True):
    """Build the train step for a fixed image size:

    ``train_step(scene, adam, step, camera, image, background, exp_mat=None,
    depth_target=None)`` -> ``(scene, adam, logs)``, plus ``exp_grad`` (the
    gradient of ``exp_mat``, for ``exposure_update``) when ``exp_mat`` is
    given. Logs hold 0-dim tensors under the JAX step's keys. With
    ``cfg.batch_views`` B > 1 the inputs are stacks of B views
    (``step_gradients``) and the stats reduce over the views as the JAX
    batched step's do: dropped pairs summed, pairs and overflow maxed.

    On CUDA the kernel route (``rasterizer: cuda``) replays a captured graph
    of the whole step (``utils/graph.py``), the counterpart of the JAX
    step's ``jax.jit(..., donate_argnums=(0, 1))``: the step's key is the
    config, the image size, the active SH degree, whether ``exp_mat`` and
    ``depth_target`` are given and the inputs' shapes, so a new budget or SH
    degree captures anew. The scene and Adam are donated: the returned ones
    are the graph's own buffers, updated in place by every replay (passing
    them back copies nothing; another scene is copied in), and the logs and
    ``exp_grad`` hold until the next replay of any graph. The learning
    rates and bias corrections reach the graph as a device input
    (``adam_scalars``), computed on the host per step as the eager step
    does. ``capture=False``, a CPU scene, and the ``plain`` and ``xla``
    routes run eagerly, out of place. ``train_step.key(...)`` (same
    arguments) gives the capture key in pure Python, ``train_step.captured``
    the ``graph.Captured`` (None when the step never captures), and
    ``train_step.in_place(...)`` the donating step run eagerly on any
    device: the graph's body, updating the caller's tensors in place."""
    schedules = make_lr_schedules(cfg.optimizer, spatial_scale)
    resolve_rasterizer(cfg.rasterizer)  # refuse an unknown name up front
    capture = capture and cfg.rasterizer == "cuda"
    n_scalars = len(PARAM_NAMES) + 2

    def eager(scene: GaussianScene, adam, step, camera: Camera, image,
              background, exp_mat=None, depth_target=None):
        param_grads, screen_grads, exp_grad, radii, logs, stats = step_gradients(
            cfg, scene, camera, width, height, image, background, exp_mat,
            depth_target)
        new_params, adam = adam_update(scene.params, param_grads, adam, schedules,
                                       cfg.optimizer, step, visible=_visible(cfg, radii))
        scene = dataclasses.replace(scene, params=new_params)
        # densification signal for the next batch start
        # (gs_lightning_module.py:175-178)
        scene = accumulate_stats(scene, radii, screen_grads)
        logs = _step_logs(logs, scene, stats)
        if exp_mat is not None:
            return scene, adam, logs, exp_grad
        return scene, adam, logs

    def static_of(scene, exp_mat, depth_target):
        return (cfg, width, height, scene.active_sh_degree, exp_mat is not None,
                depth_target is not None)

    def body(static, *t):
        scene, adam, scalars, camera, image, background, exp_mat, depth_target = step_args(
            t, *static[-3:])
        param_grads, screen_grads, exp_grad, radii, logs, stats = step_gradients(
            cfg, scene, camera, width, height, image, background, exp_mat,
            depth_target)
        adam_update_(scene.params, param_grads, adam, scalars, cfg.optimizer,
                     visible=_visible(cfg, radii))
        accumulate_stats_(scene, radii, screen_grads)
        return _step_logs(logs, scene, stats), exp_grad

    graphed = graph.capture(body, name="train_step") if capture else None

    def in_place(scene: GaussianScene, adam, step, camera: Camera, image, background,
                 exp_mat=None, depth_target=None, run=body):
        """The donating step: ``run`` (the step's body eagerly, or its
        captured graph) updates the scene's and Adam's tensors in place (the
        graph's buffers when captured) and the results are built on them."""
        scalars = scalars_tensor(adam_scalars(schedules, cfg.optimizer, step, adam.count + 1),
                                 scene.device)
        inputs = step_tensors(scene, adam, scalars, camera, image, background, exp_mat,
                              depth_target)
        logs, exp_grad = run(static_of(scene, exp_mat, depth_target), *inputs)
        scene, adam = donated_state(graphed.inputs if run is graphed else inputs,
                                    scene.active_sh_degree, adam.count + 1)
        if exp_mat is not None:
            return scene, adam, dict(logs), exp_grad
        return scene, adam, dict(logs)

    def train_step(scene: GaussianScene, adam, step, camera: Camera, image,
                   background, exp_mat=None, depth_target=None):
        if graphed is None or scene.device.type != "cuda":
            return eager(scene, adam, step, camera, image, background, exp_mat,
                         depth_target)
        return in_place(scene, adam, step, camera, image, background, exp_mat,
                        depth_target, run=graphed)

    def key(scene, adam, step, camera, image, background, exp_mat=None, depth_target=None):
        del step
        return graph.graph_key(static_of(scene, exp_mat, depth_target), step_tensors(
            scene, adam, torch.empty(n_scalars), camera, image, background, exp_mat,
            depth_target))

    train_step.key = key
    train_step.captured = graphed
    train_step.in_place = in_place
    return train_step


def make_eval_step(cfg: TrainConfig, width: int, height: int, capture: bool = True):
    """``eval_step(scene, camera, image, background)`` ->
    ``(image, depth, logs)`` with the pair-drop counts in the logs. On CUDA
    the kernel route replays a captured graph (``make_render``'s inputs and
    the target image); its outputs hold until the next replay of any graph.
    ``capture=False``, a CPU scene, and the ``plain`` and ``xla`` routes run
    eagerly."""
    rasterize_fn = resolve_rasterizer(cfg.rasterizer)
    plain = cfg.rasterizer == "plain"

    @torch.no_grad()
    def eager(scene, camera, image, background):
        out, stats = render_scene(scene, camera, width, height, background,
                                  cfg.tiling, cfg.antialias, rasterize_fn=rasterize_fn)
        _, logs = photometric_loss(out.image, image, cfg.w_ssim, plain)
        logs["num_dropped_pairs"] = stats["num_dropped_pairs"]
        logs["num_tile_overflow"] = stats["num_tile_overflow"]
        return out.image, out.depth, logs

    if not capture or cfg.rasterizer != "cuda":
        return eager

    def body(static, *t):
        scene = _scene_of(t[:len(PARAM_NAMES) + 1], static[-1])
        return eager(scene, Camera(*t[-N_CAMERA - 2:-2]), t[-2], t[-1])

    graphed = graph.capture(body, name="eval_step")

    def eval_step(scene, camera, image, background):
        if scene.device.type != "cuda":
            return eager(scene, camera, image, background)
        out, depth, logs = graphed((cfg, width, height, scene.active_sh_degree),
                                   *_scene_tensors(scene, stats=False),
                                   *_camera_tensors(camera), image, background)
        return out, depth, dict(logs)

    eval_step.captured = graphed
    return eval_step


def densify_step(scene, adam, noise, cfg: DensifyConfig, spatial_scale, apply_screensize):
    """``densify_and_prune`` (the JAX event of the same name)."""
    return densify_and_prune(scene, adam, noise, cfg, spatial_scale, apply_screensize)


def opacity_reset_step(scene: GaussianScene) -> GaussianScene:
    return scene.reset_opacity()


def sh_degree_step(scene: GaussianScene) -> GaussianScene:
    return scene.step_sh_degree()


def _quiet(*args, **kwargs) -> None:
    """The log function of ranks other than 0."""


def _host_floats(logs: dict) -> dict:
    """Every log value (0-dim tensors) as a Python float, read from the
    device in one transfer (the counts are exact in float64)."""
    keys = list(logs)
    dev = logs[keys[0]].device
    vals = torch.stack([logs[k].to(dev, torch.float64).reshape(()) for k in keys]).tolist()
    return dict(zip(keys, vals))


class Trainer:
    """Host-side orchestration: cadences, logging, eval, checkpoints.

    The scene's device is the Trainer's: every view, the noise generator and
    the checkpoints' tensors live there. With ``batch_views`` B > 1 each step
    draws B views from the sampler and stacks their cameras, images,
    backgrounds, depth maps and exposure rows.

    With ``mesh`` (``parallel.make_mesh``) every rank runs this loop on its
    own process: a step takes B x the mesh's view size views from the
    identically seeded sampler, and each rank materialises only its view
    group's rows; the sharded step (``parallel/shard.py``) keeps the scene
    replicated and Adam ZeRO-1-sharded when the capacity divides by the rank
    count. Every decision on the host reads values reduced over the mesh,
    and the split noise comes from the identically seeded generator, so
    every rank takes the same branches and holds the same scene. Rank 0
    alone writes logs, PLYs and checkpoints; a checkpoint holds the whole
    Adam state, so a mesh run resumes in one process and the other way
    round. Validation renders the replicated scene on each rank, unsharded.

    On the card the step is the captured one (``make_train_step``; on an
    NCCL mesh the sharded step, ``parallel/shard.py``): after a step
    ``self.scene`` and ``self.adam`` are the graph's own buffers. With
    ``use_exposure`` the exposure update replays a graph of its own after
    the step (``make_exposure_update``), and ``self.exposure`` holds its
    buffers. The events (densify, opacity reset, SH degree, the NaN
    rollback, ``restore_checkpoint``) stay eager and give new tensors, which
    the next step copies into those buffers (on a ZeRO-1 mesh after
    ``_local_adam`` has cut this rank's rows); an SH degree step or a budget
    growth changes the step's key and captures anew on every rank, where the
    JAX trainer recompiles on a budget growth. Checkpoints and densify read
    the buffers (on a mesh gathering Adam with eager collectives between
    replays). A gloo mesh, the ``plain`` and ``xla`` routes and the CPU run
    eagerly.
    """

    def __init__(
        self,
        cfg: TrainConfig,
        scene: GaussianScene,
        spatial_scale: float,
        train_views,  # sequence of ViewItem (all same image size)
        valid_views=(),
        out_dir: Optional[str] = None,
        log_fn=print,
        mesh=None,
    ):
        if mesh is not None:
            from gaussian_splatting_lightning_tpu_torch.parallel.mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.Mesh, got {type(mesh).__name__}")
            if mesh.device != scene.device:
                raise ValueError(f"the scene is on {scene.device}, the mesh rank on "
                                 f"{mesh.device}")
        self.mesh = mesh
        self.is_writer = mesh is None or mesh.rank == 0  # rank 0 alone writes
        self.cfg = cfg
        self.scene = scene
        self.device = scene.device
        self.spatial_scale = float(spatial_scale)
        self.train_views = list(train_views)
        self.valid_views = list(valid_views)
        self.out_dir = Path(out_dir) if out_dir else None
        if self.out_dir and self.is_writer:
            self.out_dir.mkdir(parents=True, exist_ok=True)
        self.log_fn = log_fn if self.is_writer else _quiet
        self.step = 0
        # the split noise of densification: the JAX loop's PRNG key
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.exposure: Optional[ExposureState] = None
        if cfg.use_exposure:
            self.exposure = init_exposure(len(self.train_views), device=self.device)
            self._exposure_update = make_exposure_update(cfg.exposure_lr)

        h, w = self.train_views[0].image.shape[-2:]
        self.height, self.width = h, w
        self._build_steps()
        # this rank's ZeRO-1 rows of Adam when the sharded step shards it
        self._zero1 = mesh is not None and self._train_step.sharded_adam
        self.adam = self._local_adam(init_adam(scene.params))
        self._sampler = ViewSampler(len(self.train_views), cfg.seed)
        self._view_cache: dict = {}
        self._depth_cache: dict = {}
        # view ids on the device: a batch's id tensor is cut from it, so
        # stepping builds no tensor from host data
        self._view_ids = torch.arange(len(self.train_views), device=self.device)
        self.history: list = []
        self._shrink_streak = 0
        self._nan_rollbacks = 0
        self._last_ckpt: Optional[Path] = None

    def _build_steps(self):
        if self.mesh is not None:
            from gaussian_splatting_lightning_tpu_torch.parallel.shard import (
                make_sharded_train_step,
            )

            self._train_step = make_sharded_train_step(
                self.cfg, self.spatial_scale, self.width, self.height, self.mesh)
        else:
            self._train_step = make_train_step(self.cfg, self.spatial_scale, self.width,
                                               self.height)
        self._eval_step = make_eval_step(self.cfg, self.width, self.height)
        # validation-only grown budget re-derives from the new train budget
        self._valid_eval_step = None
        self._valid_tiling = None

    def _maybe_grow_budgets(self, logs):
        """Adaptive pair budget: every per-pair stage is shaped by
        ``tiling.max_pairs``, so the budget doubles when a checked step
        dropped pairs (the step only lost its farthest splats), and shrinks
        to 2x the observed count after ``shrink_patience`` consecutive checks
        below a quarter of it. The tiled route's per-tile member table grows
        the same way on ``num_tile_overflow``. ``logs`` holds host floats; the
        caller reads them only every ``overflow_check_interval`` steps."""
        if not self.cfg.adaptive_pairs:
            return
        tiling = self.cfg.tiling
        grown = None
        if int(logs.get("num_dropped_pairs", 0)) > 0:
            grown = dataclasses.replace(tiling, max_pairs=tiling.max_pairs * 2)
            self.log_fn(
                f"[tiling] step {self.step}: pair budget overflow, growing "
                f"max_pairs to {grown.max_pairs}"
            )
        overflow = int(logs.get("num_tile_overflow", 0))
        if overflow > 0:
            # the tiled route's member table (the kernel route reports 0):
            # double until it holds the deepest tile seen
            cap = (grown or tiling).tile_capacity
            while cap < tiling.tile_capacity + overflow:
                cap *= 2
            grown = dataclasses.replace(grown or tiling, tile_capacity=cap)
            self.log_fn(
                f"[tiling] step {self.step}: tile capacity overflow "
                f"(+{overflow}), growing tile_capacity to {cap}"
            )
        pairs = int(logs.get("num_pairs", -1))
        if grown is None and pairs >= 0:
            if pairs * 4 < tiling.max_pairs and tiling.max_pairs > 16384:
                self._shrink_streak += 1
            else:
                self._shrink_streak = 0
            if self._shrink_streak >= self.cfg.shrink_patience:
                new_pairs = max(16384, -(-pairs * 2 // 8192) * 8192)
                if new_pairs < tiling.max_pairs:
                    grown = dataclasses.replace(tiling, max_pairs=new_pairs)
                    self.log_fn(
                        f"[tiling] step {self.step}: pair budget idle "
                        f"({pairs} used of {tiling.max_pairs}), shrinking "
                        f"max_pairs to {new_pairs}"
                    )
                self._shrink_streak = 0
        else:
            self._shrink_streak = 0
        if grown is not None:
            self.cfg = dataclasses.replace(self.cfg, tiling=grown)
            self._build_steps()

    def _check_finite(self, logs) -> bool:
        """A non-finite loss restores the newest checkpoint and re-enters
        training from its step; without one, or after ``max_nan_rollbacks``,
        it raises. Returns True if rolled back."""
        if math.isfinite(logs["loss"]):
            return False
        self._nan_rollbacks += 1
        if self._nan_rollbacks > self.cfg.max_nan_rollbacks:
            raise RuntimeError(
                f"non-finite loss at step {self.step}: exceeded "
                f"{self.cfg.max_nan_rollbacks} checkpoint rollbacks"
            )
        if self._last_ckpt is None:
            raise RuntimeError(
                f"non-finite loss at step {self.step} and no checkpoint to "
                "roll back to (lower learning rates or densify thresholds)"
            )
        self.log_fn(
            f"[recover] step {self.step}: non-finite loss, restoring "
            f"{self._last_ckpt.name} "
            f"(rollback {self._nan_rollbacks}/{self.cfg.max_nan_rollbacks})"
        )
        self.restore_checkpoint(self._last_ckpt)
        return True

    def _camera_of(self, view) -> Camera:
        return camera_from_matrices(view.viewmatrix, view.projmatrix, view.campos,
                                    view.tanfovx, view.tanfovy, device=self.device)

    def _upload(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array, np.float32)).to(self.device)

    def _device_view(self, idx):
        """Per-view device tensors, uploaded once and cached."""
        cached = self._view_cache.get(idx)
        if cached is None:
            view = self.train_views[idx]
            cached = (self._camera_of(view), self._upload(view.image),
                      self._upload(view.background))
            self._view_cache[idx] = cached
        return cached

    def _device_depth(self, idx):
        cached = self._depth_cache.get(idx)
        if cached is None:
            depth = self.train_views[idx].depth
            if depth is None:
                raise ValueError("w_depth > 0 requires depth maps (data.depth_folder)")
            cached = self._depth_cache[idx] = self._upload(depth)
        return cached

    def _step_inputs(self):
        """(view index, camera, image, background, depth target or None) for
        one step: one view, or with ``batch_views`` B > 1 the sampler's next
        B draws stacked along a leading axis, their ids as a (B,) device
        tensor. On a mesh the step draws B x the view size, the ids are the
        whole batch's and the rest this rank's view group's rows."""
        b = self.cfg.batch_views
        depth = self.cfg.w_depth > 0
        if b == 1 and self.mesh is None:
            idx = self._sampler.next_index()
            return (idx,) + self._device_view(idx) + (
                self._device_depth(idx) if depth else None,)
        n_view = 1 if self.mesh is None else self.mesh.shape["view"]
        all_idxs = [self._sampler.next_index() for _ in range(b * n_view)]
        ids = torch.cat([self._view_ids[i:i + 1] for i in all_idxs])
        idxs = self._local(all_idxs)
        cams, imgs, bgs = zip(*(self._device_view(i) for i in idxs))
        depths = torch.stack([self._device_depth(i) for i in idxs]) if depth else None
        return ids, stack_cameras(cams), torch.stack(imgs), torch.stack(bgs), depths

    def _local(self, rows):
        """This rank's rows of a whole batch: its view group's slice on a
        mesh, all of them in one process."""
        if self.mesh is None:
            return rows
        b, v = self.cfg.batch_views, self.mesh.axis_index("view")
        return rows[v * b:(v + 1) * b]

    def _local_adam(self, adam: AdamState) -> AdamState:
        if not self._zero1:
            return adam
        from gaussian_splatting_lightning_tpu_torch.parallel.shard import shard_adam

        return shard_adam(adam, self.mesh)

    def _whole_adam(self) -> AdamState:
        """The whole Adam state (on a ZeRO-1 mesh every rank calls this)."""
        if not self._zero1:
            return self.adam
        from gaussian_splatting_lightning_tpu_torch.parallel.shard import gather_adam

        return gather_adam(self.adam, self.mesh)

    def densify_noise(self) -> torch.Tensor:
        """The split displacement's standard-normal draw, (capacity, 3)."""
        return torch.randn((self.scene.capacity, 3), generator=self.generator,
                           device=self.device, dtype=self.scene.params.xyz.dtype)

    def maybe_densify(self):
        """Cadence gate: reference on_train_batch_start
        (gs_lightning_module.py:144-161)."""
        t, d = self.step, self.cfg.densify
        if t < 1:
            return
        if t < d.densify_until and t > d.densify_since and t % d.densify_interval == 0:
            self.scene, adam, stats = densify_step(
                self.scene, self._whole_adam(), self.densify_noise(), d, self.spatial_scale,
                t > d.opacity_reset_interval,
            )
            self.adam = self._local_adam(adam)
            stats = {k: int(v) for k, v in _host_floats(stats).items()}
            if stats["n_dropped_children"] > 0:
                self.log_fn(
                    f"[densify] step {t}: capacity full, dropped "
                    f"{stats['n_dropped_children']} children"
                )
            if stats["n_pruned"] > max(100, 0.1 * stats["n_alive"]):
                self.log_fn(
                    f"[densify] step {t}: pruned {stats['n_pruned']} "
                    f"(opacity {stats['n_pruned_opacity']}, "
                    f"screen {stats['n_pruned_screen']}, "
                    f"size {stats['n_pruned_size']}), alive {stats['n_alive']}"
                )
        if t % d.opacity_reset_interval == 0:
            self.scene = opacity_reset_step(self.scene)
        if t % d.sh_degree_step_interval == 0:
            self.scene = sh_degree_step(self.scene)

    def train(self, num_iters: Optional[int] = None):
        num_iters = num_iters or self.cfg.num_iters
        t_start = time.perf_counter()
        check_interval = max(1, min(self.cfg.overflow_check_interval, self.cfg.log_interval))
        for _ in range(num_iters):
            if self.valid_views and self.step > 0 and self.step % self.cfg.valid_interval == 0:
                # validate BEFORE this step's densify hook: after an opacity
                # reset on the same step the PSNR reads low by construction
                self.validate()
            self.maybe_densify()
            view_idx, cam, img, bg, depth = self._step_inputs()
            extra = {} if depth is None else {"depth_target": depth}
            exp_grad = None
            if self.exposure is not None:
                self.scene, self.adam, logs, exp_grad = self._train_step(
                    self.scene, self.adam, self.step, cam, img, bg,
                    self.exposure.params[self._local(view_idx)], **extra)
            else:
                self.scene, self.adam, logs = self._train_step(
                    self.scene, self.adam, self.step, cam, img, bg, **extra)
            # the host reads the logs before the exposure graph replays:
            # graphs that share the memory pool may overwrite each other's
            # outputs
            host = None
            if self.step % check_interval == 0:
                host = _host_floats(logs)
                if self._check_finite(host):
                    continue  # rolled back; re-enter the loop from the ckpt
                self._maybe_grow_budgets(host)
            if self.step % self.cfg.log_interval == 0:
                logs = dict(host or _host_floats(logs))
                logs["step"] = self.step
                logs["elapsed_s"] = time.perf_counter() - t_start
                self.history.append(logs)
                self.log_fn(
                    f"step {self.step}: loss={logs['loss']:.4f} "
                    f"psnr={logs['psnr']:.2f} n={int(logs['n_gaussians'])}"
                )
                if self.out_dir and self.is_writer:
                    with open(self.out_dir / "train_log.jsonl", "a") as f:
                        f.write(json.dumps(logs) + "\n")
            if exp_grad is not None:
                ids = view_idx if torch.is_tensor(view_idx) else self._view_ids[
                    view_idx:view_idx + 1]
                self.exposure = self._exposure_update(self.exposure, ids, exp_grad)
            self.step += 1
            # checkpoint AFTER the increment: a saved "step" is the next step
            # to run, so a restore replays the remaining trajectory exactly
            if self.out_dir and self.step % self.cfg.checkpoint_interval == 0:
                self.save_checkpoint()
        if self.out_dir and (
            self._last_ckpt is None or int(self._last_ckpt.name.split("-")[-1]) != self.step
        ):
            # the final state, so a completed run resumes from its end
            self.save_checkpoint()
        return self.scene

    def _save_triptych(self, view, image, depth, name):
        """[GT | render | depth] artifact, the reference's get_visuals
        (gs_lightning_module.py:352-363)."""
        from gaussian_splatting_lightning_tpu_torch.data.image_io import write_image

        image = np.clip(image.detach().cpu().numpy(), 0, 1)
        depth = depth.detach().cpu().numpy()
        depth = depth / max(float(depth.max()), 1e-8)
        trip = np.concatenate([view.image, image, np.repeat(depth, 3, axis=0)], axis=-1)
        write_image(self.out_dir / name, (np.moveaxis(trip, 0, -1) * 255).astype(np.uint8))

    def _valid_render(self, view):
        """Render one validation view; on pair drops or tile overflow, grow a
        validation-only budget and re-render (up to 3 doublings) instead of
        reporting a degraded PSNR. The grown budget persists across
        validations and never touches the train-adapted budget."""
        step_fn = self._valid_eval_step or self._eval_step
        cam = self._camera_of(view)
        img, bg = self._upload(view.image), self._upload(view.background)
        for attempt in range(4):
            image, depth, logs = step_fn(self.scene, cam, img, bg)
            logs = _host_floats(logs)
            dropped = int(logs["num_dropped_pairs"])
            overflow = int(logs["num_tile_overflow"])
            if (not dropped and not overflow) or attempt == 3:
                break
            tiling = self._valid_tiling or self.cfg.tiling
            if dropped:
                tiling = dataclasses.replace(tiling, max_pairs=tiling.max_pairs * 2)
            if overflow:
                tiling = dataclasses.replace(tiling, tile_capacity=tiling.tile_capacity * 2)
            self.log_fn(
                f"[valid] step {self.step}: render dropped {dropped} pairs "
                f"/ {overflow} tile overflow — re-rendering with "
                f"max_pairs={tiling.max_pairs} tile_capacity={tiling.tile_capacity}"
            )
            self._valid_tiling = tiling
            step_fn = self._valid_eval_step = make_eval_step(
                dataclasses.replace(self.cfg, tiling=tiling), self.width, self.height)
        return image, depth, logs

    def validate(self):
        metrics = []
        for i, view in enumerate(self.valid_views):
            image, depth, logs = self._valid_render(view)
            if self.out_dir and self.is_writer and i < 2:  # two views, like the reference
                self._save_triptych(view, image, depth, f"valid{i}-{self.step:08d}.jpg")
            metrics.append(logs)
        mean = {f"valid_{k}": float(np.mean([m[k] for m in metrics])) for k in metrics[0]}
        mean["step"] = self.step
        dropped = int(sum(m["num_dropped_pairs"] for m in metrics))
        overflow = int(sum(m["num_tile_overflow"] for m in metrics))
        mean["valid_num_dropped_pairs"] = dropped
        if dropped or overflow:
            self.log_fn(
                f"[valid] WARNING step {self.step}: validation renders "
                f"still dropped {dropped} pairs / {overflow} tile overflow "
                f"after 3 budget growths — PSNR below is degraded"
            )
        self.log_fn(
            f"[valid] step {self.step}: psnr={mean['valid_psnr']:.2f} "
            f"loss={mean['valid_loss']:.4f}"
        )
        if self.out_dir and self.is_writer:
            with open(self.out_dir / "valid_log.jsonl", "a") as f:
                f.write(json.dumps(mean) + "\n")
            gm.save_ply(self.scene, self.out_dir / f"point_cloud-{self.step:08d}.ply")
        return mean

    # -- checkpoint/resume (a capability the reference lacks) --------------
    def save_checkpoint(self):
        """``ckpt-XXXXXXXX/``: ``state.pt`` (scene, Adam, step, exposure) and
        ``trainer_state.json`` (view sampler, noise generator). On a mesh
        every rank calls it (a ZeRO-1 Adam is gathered whole) and rank 0
        writes."""
        path = (self.out_dir / f"ckpt-{self.step:08d}").absolute()
        adam = self._whole_adam()
        self._last_ckpt = path
        if not self.is_writer:
            self.mesh.barrier()  # rank 0 has written the checkpoint
            return
        path.mkdir(parents=True, exist_ok=True)
        s = self.scene
        ckpt = {
            "scene": dict({k: getattr(s.params, k) for k in PARAM_NAMES},
                          alive=s.alive, max_radii2d=s.max_radii2d,
                          grad_accum=s.grad_accum, grad_count=s.grad_count,
                          active_sh_degree=s.active_sh_degree),
            "adam": {"count": adam.count,
                     "mu": {k: getattr(adam.mu, k) for k in PARAM_NAMES},
                     "nu": {k: getattr(adam.nu, k) for k in PARAM_NAMES}},
            "step": self.step,
        }
        if self.exposure is not None:
            e = self.exposure
            ckpt["exposure"] = {"params": e.params, "mu": e.mu, "nu": e.nu, "count": e.count}
        torch.save(ckpt, path / "state.pt")
        host_state = dict(self._sampler.state(),
                          generator=bytes(self.generator.get_state().tolist()).hex())
        with open(path / "trainer_state.json", "w") as f:
            json.dump(host_state, f)
        self._gc_checkpoints()
        if self.mesh is not None:
            self.mesh.barrier()

    def _gc_checkpoints(self):
        """Retention: keep only the newest ``keep_last_ckpts`` checkpoints by
        step (each is a capacity-sized scene and two Adam moments)."""
        keep = self.cfg.keep_last_ckpts
        if not keep or self.out_dir is None:
            return
        ckpts = sorted((p for p in self.out_dir.glob("ckpt-*") if p.is_dir()),
                       key=lambda p: int(p.name.split("-")[-1]))
        for stale in ckpts[:-keep]:
            shutil.rmtree(stale, ignore_errors=True)

    def restore_checkpoint(self, path):
        """Load a checkpoint onto the Trainer's device. One without an
        ``exposure`` entry keeps the current exposure."""
        path = Path(path).absolute()
        ckpt = torch.load(path / "state.pt", map_location=self.device, weights_only=True)
        sc = ckpt["scene"]
        self.scene = GaussianScene(
            params=GaussianParams(**{k: sc[k] for k in PARAM_NAMES}),
            alive=sc["alive"], max_radii2d=sc["max_radii2d"],
            grad_accum=sc["grad_accum"], grad_count=sc["grad_count"],
            active_sh_degree=int(sc["active_sh_degree"]))
        ad = ckpt["adam"]
        self.adam = self._local_adam(AdamState(
            count=int(ad["count"]), mu=GaussianParams(**ad["mu"]),
            nu=GaussianParams(**ad["nu"])))
        self.step = int(ckpt["step"])
        if self.exposure is not None and "exposure" in ckpt:
            self.exposure = ExposureState(**ckpt["exposure"])
        state_file = path / "trainer_state.json"
        if state_file.exists():
            host_state = json.loads(state_file.read_text())
            self._sampler.set_state(host_state)
            self.generator.set_state(torch.tensor(
                list(bytes.fromhex(host_state["generator"])), dtype=torch.uint8))
