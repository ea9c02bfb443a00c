"""Tile- and view-sharded rendering and training over a ``parallel.Mesh``.

Counterpart of ``gaussian_splatting_lightning_tpu/parallel/shard.py``, as
plain functions on tensors that every rank calls (SPMD) with its own part of
the batch. Per step:

  1. the per-splat preprocess is splat-sharded over the tile axis: each
     rank preprocesses capacity/N splats and all-gathers the compact
     per-splat outputs; the gather's backward is a reduce-scatter back to
     each rank's shard (``_GatherShards``), the transpose JAX gives its
     ``all_gather``;
  2. binning and compositing only for the rank's band of tile rows of its
     view group's cameras, through the same rasterizer (K1-K4) at
     ``tile_y_offset``/``grid_y_local``, with the pair budget divided by the
     band count;
  3. the loss is band-local: L1 over the rank's rows plus masked partial sums
     of the exact full-image SSIM map (K5 on the band with a 10-row halo
     from each neighbour); received halos are detached, so each pixel's
     gradient goes to the rank that owns it;
  4. one sum over ("view", "tile") combines the parameter gradients; Adam is
     ZeRO-1-sharded when the capacity divides by the rank count (reduce-
     scatter, a shard-local update, an all-gather of the rows), replicated
     otherwise;
  5. the densification statistics are combined over "view", so every rank
     holds the same scene afterwards.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import torch
import torch.nn.functional as F

from gaussian_splatting_lightning_tpu_torch.core.camera import Camera, stack_cameras
from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianParams,
    GaussianScene,
)
from gaussian_splatting_lightning_tpu_torch.ops.common import (
    BLOCK_Y,
    Preprocessed,
    TilingConfig,
    preprocess,
)
from gaussian_splatting_lightning_tpu_torch.ops.ssim import ssim_map
from gaussian_splatting_lightning_tpu_torch.parallel.mesh import Mesh
from gaussian_splatting_lightning_tpu_torch.training.exposure import apply_exposure
from gaussian_splatting_lightning_tpu_torch.training.optimizer import (
    AdamState,
    adam_scalars,
    adam_update_,
    make_lr_schedules,
    scalars_tensor,
)
from gaussian_splatting_lightning_tpu_torch.training.trainer import (
    donated_state,
    resolve_rasterizer,
    step_args,
    step_tensors,
)
from gaussian_splatting_lightning_tpu_torch.utils import graph, runtime

batch_cameras = stack_cameras  # the JAX name of the camera stack

SSIM_RADIUS = 5  # 11x11 window
HALO = 2 * SSIM_RADIUS  # rendered rows exchanged per seam: windows centred
# up to SSIM_RADIUS rows off-band contribute gradients to this band's rows,
# and those centres need SSIM_RADIUS more rows of data


def _band_geometry(height: int, n_tile: int, block: int = BLOCK_Y):
    grid_y = (height + block - 1) // block
    gy_local = -(-grid_y // n_tile)  # pad so every rank owns an equal band
    return grid_y, gy_local


def band_tiling(tiling: TilingConfig, n_tile: int) -> TilingConfig:
    """A band's pair budget: the whole-image ``max_pairs`` over the band
    count, rounded up to 8192 (the JAX step's rule)."""
    return dataclasses.replace(
        tiling, max_pairs=max(8192, -(-tiling.max_pairs // (n_tile * 8192)) * 8192))


class _GatherShards(torch.autograd.Function):
    """All-gather along ``dim`` over a mesh axis; the backward sums the
    cotangents over the axis and keeps this rank's part (a reduce-scatter).
    Slicing out only this rank's part would drop the other bands' terms of
    the splats in this rank's shard, and the later sum over the mesh cannot
    restore them."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, dim = ctx.args
        return mesh.reduce_scatter(grad, axis, dim), None, None, None


_PREP_FIELDS = [f.name for f in dataclasses.fields(Preprocessed)]


def _pack(prep: Preprocessed) -> torch.Tensor:
    """The Preprocessed fields as one (..., N, K) f32 table (``visible`` as
    0/1), so that one collective carries them."""
    lead = prep.depth.dim()
    cols = [getattr(prep, k).to(torch.float32) for k in _PREP_FIELDS]
    return torch.cat([c.unsqueeze(-1) if c.dim() == lead else c for c in cols], dim=-1)


def _unpack(table: torch.Tensor, like: Preprocessed) -> Preprocessed:
    lead, out, i = like.depth.dim(), {}, 0
    for k in _PREP_FIELDS:
        ref = getattr(like, k)
        width = 1 if ref.dim() == lead else ref.shape[-1]
        col = table[..., i:i + width]
        col = col[..., 0] if ref.dim() == lead else col
        # each field contiguous, as the kernels take it
        out[k] = (col > 0.5 if ref.dtype == torch.bool else col.to(ref.dtype)).contiguous()
        i += width
    return Preprocessed(**out)


def _preprocess_sharded(live: GaussianScene, cam: Camera, width: int, height: int,
                        antialias: bool, offset, mesh: Mesh, axis: str):
    """Per-splat preprocess of this rank's capacity/N splats, then one
    all-gather of the packed outputs along the splat axis. Exact:
    preprocess is elementwise per splat and the gather concatenates the
    shards in axis order. Replicated when the capacity does not divide by
    the shard count."""
    n_shards, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    cap = live.capacity
    args = (cam, width, height, live.active_sh_degree, live.max_sh_degree, antialias)
    if cap % n_shards:
        return preprocess(live.params.xyz, live.get_opacity(), live.get_scales(),
                          live.get_rotation(), live.get_features(), *args, live.alive,
                          offset)
    sz = cap // n_shards

    def sl(x, dim=0):
        return x.narrow(dim, idx * sz, sz)

    shard = preprocess(sl(live.params.xyz), sl(live.get_opacity()), sl(live.get_scales()),
                       sl(live.get_rotation()), sl(live.get_features()), *args,
                       sl(live.alive), None if offset is None else sl(offset, offset.dim() - 2))
    table = _pack(shard)
    full = _GatherShards.apply(table, mesh, axis, table.dim() - 2)
    return _unpack(full, shard)


def _render_band(rasterize_fn, route, live, cams, width, height, backgrounds, tiling,
                 antialias, prep, tile_y_offset, gy_local):
    """Render a stack of views' band; the tiled route (no view axis)
    renders one view at a time. Returns (RenderOutput, per-view pairs,
    per-view dropped pairs, tile overflow)."""
    kw = dict(config=tiling, max_sh_degree=live.max_sh_degree, antialias=antialias,
              alive=live.alive, tile_y_offset=tile_y_offset, grid_y_local=gy_local)
    act = (live.params.xyz, live.get_opacity(), live.get_scales(), live.get_rotation(),
           live.get_features())
    if route != "xla":
        out, stats = rasterize_fn(*act, cams, width, height, backgrounds,
                                  live.active_sh_degree, prep=prep, **kw)
        return (out, stats["num_pairs_per_view"], stats["num_dropped_pairs_per_view"],
                stats["num_tile_overflow"])
    outs, stats = [], []
    for v in range(cams.views):
        pv = Preprocessed(*(getattr(prep, k)[v] for k in _PREP_FIELDS))
        o, s = rasterize_fn(*act, cams.view(v), width, height, backgrounds[v],
                            live.active_sh_degree, prep=pv, **kw)
        outs.append(o)
        stats.append(s)
    out = type(outs[0])(*(torch.stack([getattr(o, f) for o in outs])
                          for f in ("image", "radii", "depth")))
    return (out, torch.stack([s["num_pairs"] for s in stats]),
            torch.stack([s["num_dropped_pairs"] for s in stats]),
            torch.stack([s["num_tile_overflow"] for s in stats]).max())


def _band_loss_partials(bands: torch.Tensor, images: torch.Tensor, height: int,
                        mesh: Mesh, plain: bool = False):
    """Band-local photometric loss: exact partial sums of the full-image
    L1 + SSIM objective over the tile ring.

    ``bands`` (B, 3, band_h, W) are this rank's live rendered rows,
    ``images`` (B, 3, H, W) the targets. The SSIM map at a centre row equals
    the full-image map's wherever it is computed (halos bring the true
    neighbour rows; zeros at the ring's ends reproduce the blur's zero
    padding; rendered rows at or below the image edge are zeroed). The value
    counts each centre once (``value_mask``); the gradient term also takes
    the off-band centres within SSIM_RADIUS whose windows touch live rows,
    their value cancelled by ``detach``. Summing over "tile" gives both the
    full-image loss and its gradient. Returns per-view (l1, ssim, mse), each
    (B,), normalised so that the sum over "tile" gives full-image means."""
    b, c, band_h, w = bands.shape
    n_t, ax_t = mesh.axis_size("tile"), mesh.axis_index("tile")
    r0 = ax_t * band_h  # first global pixel row of this band
    norm = 1.0 / (c * height * w)
    dev = bands.device

    row_g = r0 + torch.arange(band_h, device=dev)
    bands = torch.where((row_g < height)[None, None, :, None], bands, 0.0)

    # target rows [r0 - HALO, r0 + band_h + HALO), zero outside [0, H)
    tgt_pad = F.pad(images, (0, 0, HALO, n_t * band_h - height + HALO))
    tgt_ext = tgt_pad[:, :, r0:r0 + band_h + 2 * HALO]
    diff = bands - tgt_ext[:, :, HALO:HALO + band_h]
    l1_part = torch.sum(torch.abs(diff), dim=(1, 2, 3)) * norm
    mse_part = torch.sum(diff * diff, dim=(1, 2, 3)) * norm

    # halo exchange: every rank's top and bottom HALO rows, gathered over the
    # tile ring; from_above is neighbour t-1's bottom rows, from_below
    # neighbour t+1's top rows, zeros at the ring's ends
    edges = torch.stack([bands[:, :, :HALO], bands[:, :, -HALO:]]).detach()
    ring = mesh.all_gather(edges[None], "tile", dim=0)  # (n_t, 2, B, C, HALO, W)
    zeros = torch.zeros_like(edges[0])
    from_above = ring[ax_t - 1, 1] if ax_t > 0 else zeros
    from_below = ring[ax_t + 1, 0] if ax_t < n_t - 1 else zeros
    pred_ext = torch.cat([from_above, bands, from_below], dim=2)

    smap = ssim_map(pred_ext, tgt_ext, plain)
    e = torch.arange(band_h + 2 * HALO, device=dev)
    g = r0 - HALO + e  # global row of each extended row
    in_image = (g >= 0) & (g < height)
    value_mask = ((e >= HALO) & (e < HALO + band_h) & in_image).to(smap.dtype)
    grad_mask = ((e >= HALO - SSIM_RADIUS) & (e < HALO + band_h + SSIM_RADIUS)
                 & in_image).to(smap.dtype)
    sg = smap.detach()
    ssim_part = (torch.sum(sg * value_mask[None, None, :, None], dim=(1, 2, 3))
                 + torch.sum((smap - sg) * grad_mask[None, None, :, None], dim=(1, 2, 3))
                 ) * norm
    return l1_part, ssim_part, mse_part


def _band_depth_partials(dbands: torch.Tensor, depth_tgt: torch.Tensor, height: int,
                         mesh: Mesh):
    """Band-local partial sums of the full-image inverse-depth L1 (pixel-
    local, no halo): ``dbands`` (B, band_h, W), ``depth_tgt`` (B, H, W);
    the sum over "tile" gives the full-image mean."""
    b, band_h, w = dbands.shape
    n_t, ax_t = mesh.axis_size("tile"), mesh.axis_index("tile")
    r0 = ax_t * band_h
    row_g = r0 + torch.arange(band_h, device=dbands.device)
    tgt_pad = F.pad(depth_tgt, (0, 0, 0, n_t * band_h - height))
    tgt_band = tgt_pad[:, r0:r0 + band_h]
    diff = torch.where((row_g < height)[None, :, None], dbands - tgt_band, 0.0)
    return torch.sum(torch.abs(diff), dim=(1, 2)) / (height * w)


@torch.no_grad()
def sharded_render(scene: GaussianScene, camera: Camera, width: int, height: int,
                   background, mesh: Mesh, tiling: TilingConfig = TilingConfig(),
                   antialias: bool = False, rasterizer: str = "cuda"):
    """Render one view with its tile rows sharded over the whole mesh (both
    axes act as one ring of bands) on the route ``rasterizer`` names.
    Returns the full (3, H, W) image, the radii and the (1, H, W) depth on
    every rank."""
    n_dev, band = mesh.size, mesh.axis_index("world")
    _, gy_local = _band_geometry(height, n_dev, tiling.resolve_block(rasterizer))
    cams = stack_cameras([camera])
    prep = _preprocess_sharded(scene, cams, width, height, antialias, None, mesh, "world")
    bg = torch.as_tensor(background, dtype=torch.float32).to(mesh.device).reshape(1, 3)
    out, _, _, _ = _render_band(resolve_rasterizer(rasterizer), rasterizer, scene, cams, width, height,
                                bg, tiling, antialias, prep, band * gy_local, gy_local)
    image = mesh.all_gather(out.image[0], "world", dim=1)[:, :height]
    depth = mesh.all_gather(out.depth[0], "world", dim=1)[:, :height]
    return image, out.radii[0], depth


class ShardedTrainStep:
    """The multi-rank train step (``make_sharded_train_step``).

    ``step(scene, adam, step, cameras, images, backgrounds, exp_mat=None,
    depth_target=None)`` -> ``(scene, adam, logs)``, plus the exposure
    gradient of the whole batch (B, 3, 4) when ``exp_mat`` is given. Each
    rank passes its view group's rows of the global batch: a stacked
    ``Camera`` of B_local views, images (B_local, 3, H, W), backgrounds
    (B_local, 3), ``exp_mat`` (B_local, 3, 4), ``depth_target``
    (B_local, [1,] H, W). The scene is replicated; ``adam`` is this rank's
    ZeRO-1 shard (``shard_adam``) when ``sharded_adam``, else whole. The
    logs are the same on every rank. ``band_stats`` holds this rank's last
    per-view band ``num_pairs`` and ``num_dropped_pairs``.

    The step donates the scene and Adam as ``make_train_step``'s does, the
    counterpart of the JAX step's
    ``jax.jit(shard_map(...), donate_argnums=(0, 1))``: it writes the new
    parameters, moments and statistics into the tensors it was given, and
    the returned scene and state are built on the tensors it wrote.

    On an NCCL mesh on the kernel route (``rasterizer: cuda``) every call
    replays a captured graph of that step (``utils/graph.py``). The choice
    is made here, once: gloo's collectives run on the host and cannot be
    captured, and the tiled route's member table reads the host, so a gloo
    mesh and the ``plain`` and ``xla`` routes run the graph's body eagerly,
    as does ``capture=False``. The mesh keeps a weak reference to the
    graph, so that ``shutdown(mesh)`` releases it before the process group
    its collectives use. The key is the config, the image size, the mesh
    shape, the band geometry (``gy_local``, ``band_tiling``),
    ``sharded_adam``, whether spans are on (``utils/runtime.spanning``), the
    active SH degree, whether ``exp_mat`` and ``depth_target`` are given and
    the inputs' shapes: the same on every rank, so every rank captures anew
    at the same step. Captured, the returned scene and Adam are the graph's
    own buffers, updated in place by every replay (another scene or Adam
    state is copied in), and the logs, the exposure gradient and
    ``band_stats`` hold until the next replay of any graph. ``.key(...)``
    (the call's arguments) gives the capture key in pure Python and
    ``.captured`` the ``graph.Captured`` (None when the step never
    captures).

    ``cfg.sparse_adam`` has no effect here, as in the JAX sharded step."""

    def __init__(self, cfg, spatial_scale: float, width: int, height: int, mesh: Mesh,
                 capture: bool = True):
        self.cfg, self.width, self.height, self.mesh = cfg, width, height, mesh
        self.schedules = make_lr_schedules(cfg.optimizer, spatial_scale)
        self.route = cfg.rasterizer
        self.rasterize_fn = resolve_rasterizer(self.route)
        self.n_tile, self.n_view = mesh.shape["tile"], mesh.shape["view"]
        # optimizer-state sharding needs equal splat shards per rank
        self.sharded_adam = cfg.capacity % mesh.size == 0
        _, self.gy_local = _band_geometry(height, self.n_tile,
                                          cfg.tiling.resolve_block(self.route))
        self.band_tiling = band_tiling(cfg.tiling, self.n_tile)
        self.band_stats: dict = {}
        capture = capture and mesh.backend == "nccl" and self.route == "cuda"
        self.captured = None
        if capture:
            # the graph holds the step weakly: no reference cycle keeps the
            # graph and its memory once the step is dropped
            body = weakref.WeakMethod(self._body)
            self.captured = graph.capture(lambda static, *t: body()(static, *t),
                                          name="sharded_train_step")
            mesh.graphs.add(self.captured)  # for shutdown(mesh)

    def __call__(self, scene: GaussianScene, adam: AdamState, step, cameras: Camera,
                 images, backgrounds, exp_mat=None, depth_target=None):
        self._check_capacity(scene)
        run = (self._body if self.captured is None or scene.device.type != "cuda"
               else self.captured)
        scalars = scalars_tensor(adam_scalars(self.schedules, self.cfg.optimizer, step,
                                              adam.count + 1), scene.device)
        inputs = step_tensors(scene, adam, scalars, cameras, images, backgrounds, exp_mat,
                              depth_target)
        logs, exp_grad, n_pairs, dropped = run(self._static(scene, exp_mat, depth_target),
                                               *inputs)
        self.band_stats = {"num_pairs": n_pairs, "num_dropped_pairs": dropped}
        scene, adam = donated_state(run.inputs if run is self.captured else inputs,
                                    scene.active_sh_degree, adam.count + 1)
        if exp_mat is not None:
            return scene, adam, dict(logs), exp_grad
        return scene, adam, dict(logs)

    def key(self, scene, adam, step, cameras, images, backgrounds, exp_mat=None,
            depth_target=None) -> tuple:
        del step
        return graph.graph_key(self._static(scene, exp_mat, depth_target), step_tensors(
            scene, adam, torch.empty(len(PARAM_NAMES) + 2), cameras, images, backgrounds,
            exp_mat, depth_target))

    def _static(self, scene, exp_mat, depth_target) -> tuple:
        return (self.cfg, self.width, self.height, (self.n_view, self.n_tile), self.gy_local,
                self.band_tiling, self.sharded_adam, runtime.spans_on(),
                scene.active_sh_degree, exp_mat is not None, depth_target is not None)

    def _check_capacity(self, scene):
        n_dev = self.mesh.size
        if self.sharded_adam and scene.capacity % n_dev:
            raise ValueError(
                f"scene capacity {scene.capacity} is not divisible by {n_dev} devices but "
                f"cfg.capacity={self.cfg.capacity} selected sharded Adam — pass a scene whose "
                "capacity matches cfg.capacity (or a capacity divisible by the mesh size)")

    def _body(self, static, *t):
        scene, adam, scalars, cameras, images, backgrounds, exp_mat, depth_target = step_args(
            t, *static[-3:])
        return self._step(scene, adam, scalars, cameras, images, backgrounds, exp_mat,
                          depth_target)

    def _step(self, scene, adam, scalars, cameras, images, backgrounds, exp_mat,
              depth_target):
        """The step with ``scalars`` (``adam_scalars`` on the device): the new
        parameters, moments and statistics written into ``scene``'s and
        ``adam``'s own tensors. Returns (logs, exp_grad, band pairs, band
        drops)."""
        cfg, mesh = self.cfg, self.mesh
        n_dev = mesh.size
        b_local = images.shape[0]
        use_depth = cfg.w_depth > 0.0 and depth_target is not None
        runtime.mark("preprocess", scene.params.xyz)
        leaves = {k: getattr(scene.params, k).detach().requires_grad_() for k in PARAM_NAMES}
        offset = torch.zeros((b_local, scene.capacity, 2), dtype=scene.params.xyz.dtype,
                             device=scene.device, requires_grad=True)
        inputs = [leaves[k] for k in PARAM_NAMES] + [offset]
        if exp_mat is not None:
            exp_mat = exp_mat.detach().requires_grad_()
            inputs.append(exp_mat)
        live = dataclasses.replace(scene, params=GaussianParams(**leaves))
        ax_t = mesh.axis_index("tile")
        with torch.enable_grad():
            prep = _preprocess_sharded(live, cameras, self.width, self.height,
                                       cfg.antialias, offset, mesh, "tile")
            out, n_pairs, dropped, overflow = _render_band(
                self.rasterize_fn, self.route, live, cameras, self.width, self.height,
                backgrounds, self.band_tiling, cfg.antialias, prep, ax_t * self.gy_local,
                self.gy_local)
            bands = out.image  # (B_local, 3, band_h, W)
            if exp_mat is not None:
                # a per-pixel affine colour map: applied to the band rows it
                # equals slicing the exposed full image
                bands = apply_exposure(exp_mat, bands)
            bands, = runtime.mark_backward("composite_bwd", bands)
            runtime.mark("loss", bands)
            l1_p, ssim_p, mse_p = _band_loss_partials(bands, images, self.height, mesh,
                                                      self.route == "plain")
            # this rank's share of the full loss: the sum of the ranks'
            # gradients is the full-image gradient (constants drop out)
            loss_local = torch.mean((1.0 - cfg.w_ssim) * l1_p - cfg.w_ssim * ssim_p)
            parts = [l1_p, ssim_p, mse_p]
            if use_depth:
                d_p = _band_depth_partials(
                    out.depth[:, 0], depth_target.reshape(b_local, self.height, self.width),
                    self.height, mesh)
                loss_local = loss_local + cfg.w_depth * torch.mean(d_p)
                parts.append(d_p)
            # the logs: the true full-image metrics, summed over the ring
            sums = mesh.all_reduce(torch.stack(parts).detach(), "tile")
            runtime.mark("loss_bwd", loss_local)
            grads = torch.autograd.grad(loss_local, inputs, allow_unused=True)
        runtime.mark("adam", loss_local)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
        l1_v, ssim_v, mse_v = sums[0], sums[1], sums[2]
        loss_v = (1.0 - cfg.w_ssim) * l1_v + cfg.w_ssim * (1.0 - ssim_v)
        logs = {"loss": loss_v.mean(), "recon": l1_v.mean(), "ssim": (1.0 - ssim_v).mean(),
                "psnr": (10.0 * torch.log10(1.0 / torch.clamp_min(mse_v, 1e-12))).mean()}
        if use_depth:
            logs["depth_l1"] = sums[3].mean()
            logs["loss"] = logs["loss"] + cfg.w_depth * logs["depth_l1"]

        self._update(scene, adam, grads[:len(PARAM_NAMES)], scalars)
        # each view's own screen-space signal: the sum over the ring, times
        # b_local to undo the batch mean (gs_lightning_module.py:175-178)
        screen = mesh.all_reduce(grads[len(PARAM_NAMES)], "tile") * b_local
        exp_grad = None
        if exp_mat is not None:
            exp_grad = mesh.all_reduce(grads[-1], "tile") * b_local
            exp_grad = mesh.all_gather(exp_grad, "view", dim=0)  # the whole batch's

        # densification statistics, combined over the batch: every rank holds
        # the same scene afterwards
        radii = out.radii.detach()  # (B_local, C)
        runtime.mark("stats", radii)
        seen = radii > 0
        norms = torch.linalg.vector_norm(screen[..., :2], dim=-1)
        acc = mesh.all_reduce(torch.stack([torch.where(seen, norms, 0.0).sum(dim=0),
                                           seen.to(torch.float32).sum(dim=0)]), "view")
        max_radii = mesh.all_reduce(torch.amax(radii, dim=0), "view", op="max")

        torch.maximum(scene.max_radii2d, max_radii, out=scene.max_radii2d)
        torch.add(scene.grad_accum, acc[0], out=scene.grad_accum)
        torch.add(scene.grad_count, acc[1], out=scene.grad_count)

        keys = list(logs)
        mean = mesh.all_reduce(torch.stack([logs[k] for k in keys]), "world") / n_dev
        logs = dict(zip(keys, mean.unbind()))
        logs["n_gaussians"] = scene.alive.sum()
        logs["num_dropped_pairs"] = mesh.all_reduce(dropped.sum().to(torch.int64), "world")
        # the whole-image pair count the budget adapts to: the band budget is
        # max_pairs / n_tile, so the worst band is scaled back up (an upper
        # bound on the total)
        top = mesh.all_reduce(torch.stack([n_pairs.max().to(torch.int64),
                                           overflow.to(torch.int64)]), "world", op="max")
        logs["num_pairs"] = top[0] * self.n_tile
        logs["num_tile_overflow"] = top[1]
        runtime.mark("end", radii)
        return logs, exp_grad, n_pairs, dropped

    def _update(self, scene, adam, grads, scalars):
        """Sum the ranks' gradients and run Adam in place: ZeRO-1
        (reduce-scatter, this rank's rows, all-gather, the gathered rows
        copied into the scene's parameters) or replicated (all-reduce). The
        six groups travel as one (C, 59) table."""
        cfg, mesh, cap = self.cfg, self.mesh, scene.capacity
        widths = [g[0].numel() for g in grads]
        flat = torch.cat([g.reshape(cap, -1) for g in grads], dim=1)

        def split(table, like):
            parts = torch.split(table, widths, dim=1)
            return GaussianParams(**{k: p.reshape((-1,) + like[i].shape[1:])
                                     for i, (k, p) in enumerate(zip(PARAM_NAMES, parts))})

        shapes = [getattr(scene.params, k) for k in PARAM_NAMES]
        if not self.sharded_adam:
            summed = mesh.all_reduce(flat, "world") / self.n_view
            adam_update_(scene.params, split(summed, shapes), adam, scalars, cfg.optimizer)
            return
        rows = cap // mesh.size
        i = mesh.axis_index("world")
        g_shard = mesh.reduce_scatter(flat, "world", dim=0) / self.n_view
        p_shard = GaussianParams(**{k: getattr(scene.params, k)[i * rows:(i + 1) * rows]
                                    for k in PARAM_NAMES})
        adam_update_(p_shard, split(g_shard, shapes), adam, scalars, cfg.optimizer)
        table = torch.cat([getattr(p_shard, k).reshape(rows, -1) for k in PARAM_NAMES],
                          dim=1)
        whole = split(mesh.all_gather(table, "world", dim=0), shapes)
        for k in PARAM_NAMES:
            getattr(scene.params, k).copy_(getattr(whole, k))


def make_sharded_train_step(cfg, spatial_scale: float, width: int, height: int,
                            mesh: Mesh, capture: bool = True) -> ShardedTrainStep:
    """The multi-rank train step; see ``ShardedTrainStep``."""
    return ShardedTrainStep(cfg, spatial_scale, width, height, mesh, capture)


def _shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    rows = x.shape[0] // mesh.size
    i = mesh.axis_index("world")
    return x[i * rows:(i + 1) * rows].clone()


def shard_adam(adam: AdamState, mesh: Mesh) -> AdamState:
    """This rank's ZeRO-1 rows of a whole Adam state."""
    def rows(moments):
        return GaussianParams(**{k: _shard_rows(getattr(moments, k), mesh)
                                 for k in PARAM_NAMES})

    return AdamState(count=adam.count, mu=rows(adam.mu), nu=rows(adam.nu))


def gather_adam(adam: AdamState, mesh: Mesh) -> AdamState:
    """The whole Adam state from the ranks' ZeRO-1 rows (every rank calls
    it; every rank gets it)."""
    gather = functools.partial(mesh.all_gather, axis="world", dim=0)

    def whole(moments):
        return GaussianParams(**{k: gather(getattr(moments, k)) for k in PARAM_NAMES})

    return AdamState(count=adam.count, mu=whole(adam.mu), nu=whole(adam.nu))
