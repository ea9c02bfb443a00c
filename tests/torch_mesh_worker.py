"""One rank of the port's CPU mesh tests (``tests/test_torch_parallel.py``).

Run as a subprocess, one per rank, all joined by a ``FileStore``:

    python tests/torch_mesh_worker.py <rank> <world> <store file> <out dir> <task>...

Imports only torch, numpy and the port (never the test module or JAX). Each
task runs the port's mesh code on gloo with every rank on the CPU and one
torch thread, and each rank writes what it computed to
``<out dir>/rank<r>.npz`` (keys prefixed by the task's name). The problem
(scene, cameras, targets) is built here from numpy seeds; the test builds
the JAX side from the same functions.

Tasks: ``coords``, ``loss``, ``render``, ``steps``, ``seam``, ``donate``,
``trainer``.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gaussian_splatting_lightning_tpu_torch.scripts.bench_batched import ring_pose  # noqa: E402

W, H = 64, 112  # 2 x 4 tiles of 32 px, 4 x 7 of 16 px; the last band is cut
N_SPLATS, SEED, SCALE, SH = 100, 1, 0.1, 1
BATCH = 2  # the global batch of every step case
MAX_PAIRS = 1 << 14
MESHES = ((1, 4), (2, 2), (4, 1))
# (name, mesh, route, capacity, exposure, depth): ZeRO-1 at capacity 128;
# at 126 Adam is replicated (and the (1, 4) preprocess too: 126 % 4 != 0)
STEP_CASES = (
    ("plain-2x2-zero-exp", (2, 2), "plain", 128, True, False),
    ("plain-2x2-rep-depth", (2, 2), "plain", 126, False, True),
    ("plain-1x4-zero-depth", (1, 4), "plain", 128, False, True),
    ("plain-1x4-rep-exp", (1, 4), "plain", 126, True, False),
    ("xla-2x2-zero-exp-depth", (2, 2), "xla", 128, True, True),
    ("xla-1x4-rep", (1, 4), "xla", 126, False, False),
)
SEAM_CASE = STEP_CASES[2]
# (name, mesh, capacity, exposure, depth): the sharded step's donating body
# (``in_place``, run eagerly: what an NCCL mesh captures) against the
# out-of-place step, DONATE_STEPS steps from the same start on route "plain"
DONATE_CASES = (
    ("2x2-zero-exp-depth", (2, 2), 128, True, True),
    ("1x4-rep", (1, 4), 126, False, False),
)
DONATE_STEPS = 3
TRAINER_MESH = (2, 2)
TRAINER_STEPS = 5


FOCAL = 50.0


def targets(seed=0):
    """(images (B, 3, H, W), depth targets (B, H, W), exposure (B, 3, 4))."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(BATCH, 3, H, W)).astype(np.float32)
    depth = rng.uniform(0.1, 0.5, size=(BATCH, H, W)).astype(np.float32)
    exp = np.tile(np.concatenate([np.eye(3), np.full((3, 1), 0.05)], 1), (BATCH, 1, 1))
    exp = (exp * np.asarray([0.9, 1.1])[:, None, None]).astype(np.float32)
    return images, depth, exp


def step_config(route, capacity, exposure, depth):
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import TrainConfig

    return TrainConfig(capacity=capacity, rasterizer=route, use_exposure=exposure,
                       w_depth=0.5 if depth else 0.0, batch_views=BATCH,
                       tiling=TilingConfig(max_pairs=MAX_PAIRS))


def port_scene(capacity, device="cpu"):
    from gaussian_splatting_lightning_tpu_torch import interop

    return interop.synthetic_scene(N_SPLATS, capacity, sh_degree=SH, seed=SEED, scale=SCALE,
                                   aniso=True, device=device)


def port_cameras(n=BATCH):
    from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera

    return [make_camera(ring_pose(i, 5), FOCAL, FOCAL, W, H, device="cpu") for i in range(n)]


def trainer_views():
    """Four GT views of a 60-splat scene rendered by the port (route
    "plain"), as ``ViewItem``s."""
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera
    from gaussian_splatting_lightning_tpu_torch.data.dataset import ViewItem
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import (
        render_scene,
        resolve_rasterizer,
    )

    gt = interop.synthetic_scene(60, 60, sh_degree=SH, seed=7, scale=0.12, device="cpu")
    views = []
    for i in range(4):
        cam = make_camera(ring_pose(i, 4), FOCAL, FOCAL, W, H, device="cpu")
        with torch.no_grad():
            out, _ = render_scene(gt, cam, W, H, torch.zeros(3), TilingConfig(max_pairs=MAX_PAIRS),
                                  rasterize_fn=resolve_rasterizer("plain"))
        views.append(ViewItem(
            image=out.image.numpy(), viewmatrix=cam.viewmatrix.numpy(),
            projmatrix=cam.projmatrix.numpy(), campos=cam.campos.numpy(),
            tanfovx=float(cam.tanfovx), tanfovy=float(cam.tanfovy),
            background=np.zeros(3, np.float32)))
    return views


def trainer_config(batch_views, checkpoint_interval=10_000):
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.densify import DensifyConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import TrainConfig

    # threshold 0: every seen splat densifies, so the discrete decision
    # cannot flip on rounding between the mesh and the one-process run
    return TrainConfig(
        num_iters=TRAINER_STEPS, capacity=128, log_interval=1, valid_interval=10_000,
        checkpoint_interval=checkpoint_interval, overflow_check_interval=1, seed=3,
        rasterizer="plain", batch_views=batch_views, use_exposure=True,
        tiling=TilingConfig(max_pairs=MAX_PAIRS),
        densify=DensifyConfig(densify_since=1, densify_interval=3, densify_until=10,
                              densify_grad_threshold=0.0))


def trainer_scene():
    return port_scene(128)


# ---- the tasks --------------------------------------------------------------

def task_coords(info, out):
    from gaussian_splatting_lightning_tpu_torch.parallel import make_mesh

    for v, t in MESHES:
        mesh = make_mesh(view=v, tile=t, info=info)
        out[f"coords/{v}x{t}"] = np.array([mesh.axis_index("view"), mesh.axis_index("tile"),
                                           mesh.axis_size("view"), mesh.axis_size("tile")])
        # a sum over each axis: the groups hold the ranks that share the
        # other coordinate
        import torch

        x = torch.tensor([float(info.rank)])
        out[f"coords/{v}x{t}/sums"] = np.array([float(mesh.all_reduce(x, a)) for a in
                                                ("view", "tile", "world")])


def task_loss(info, out):
    """``_band_loss_partials`` on mesh (1, 4): this rank's band of a full
    rendered image, the partials summed over the ring, and the gradient of
    the band loss gathered into the full image's."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.parallel import make_mesh
    from gaussian_splatting_lightning_tpu_torch.parallel.shard import _band_loss_partials

    mesh = make_mesh(view=1, tile=4, info=info)
    pred, images, band_h = loss_inputs()
    t = mesh.axis_index("tile")
    band = torch.from_numpy(pred[:, :, t * band_h:(t + 1) * band_h]).requires_grad_()
    l1, ss, mse = _band_loss_partials(band, torch.from_numpy(images), H, mesh, plain=True)
    loss_local = torch.mean(0.8 * l1 - 0.2 * ss)
    (grad,) = torch.autograd.grad(loss_local, band)
    out["loss/partials"] = mesh.all_reduce(torch.stack([l1, ss, mse]).detach(), "tile").numpy()
    out["loss/grad"] = mesh.all_gather(grad, "tile", dim=2).numpy()


def loss_inputs():
    """A rendered stack padded to 4 bands of 32 rows (rows below H hold
    junk the loss must ignore) and its targets."""
    rng = np.random.default_rng(5)
    band_h = 32
    pred = rng.uniform(size=(BATCH, 3, 4 * band_h, W)).astype(np.float32)
    images = rng.uniform(size=(BATCH, 3, H, W)).astype(np.float32)
    return pred, images, band_h


def task_render(info, out):
    import torch

    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.parallel import make_mesh, sharded_render

    mesh = make_mesh(view=2, tile=2, info=info)
    scene, cam = port_scene(128), port_cameras(1)[0]
    for route in ("plain", "xla"):
        image, radii, depth = sharded_render(scene, cam, W, H, torch.tensor([0.1, 0.2, 0.3]),
                                             mesh, TilingConfig(max_pairs=MAX_PAIRS),
                                             rasterizer=route)
        out[f"render/{route}/image"] = image.numpy()
        out[f"render/{route}/depth"] = depth.numpy()
        out[f"render/{route}/radii"] = radii.numpy()


def run_step_case(info, out, case, prefix):
    import torch

    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussian_splatting_lightning_tpu_torch.ops.common import preprocess
    from gaussian_splatting_lightning_tpu_torch.parallel import make_mesh, make_sharded_train_step
    from gaussian_splatting_lightning_tpu_torch.parallel.shard import (
        _preprocess_sharded,
        gather_adam,
        shard_adam,
    )
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam

    name, (v, t), route, cap, exposure, depth = case
    mesh = make_mesh(view=v, tile=t, info=info)
    cfg = step_config(route, cap, exposure, depth)
    step = make_sharded_train_step(cfg, 4.0, W, H, mesh)
    scene = port_scene(cap)
    adam = init_adam(scene.params)
    if step.sharded_adam:
        adam = shard_adam(adam, mesh)
    images, depth_t, exp = targets()
    b = BATCH // v
    rows = slice(mesh.axis_index("view") * b, (mesh.axis_index("view") + 1) * b)
    cams = stack_cameras(port_cameras()[rows])
    kw = {}
    if exposure:
        kw["exp_mat"] = torch.from_numpy(exp[rows])
    if depth:
        kw["depth_target"] = torch.from_numpy(depth_t[rows])
    res = step(scene, adam, 0, cams, torch.from_numpy(images[rows]),
               torch.zeros(b, 3), **kw)
    scene, adam, logs = res[:3]
    whole = gather_adam(adam, mesh) if step.sharded_adam else adam
    key = f"{prefix}/{name}"
    for k in PARAM_NAMES:
        out[f"{key}/param/{k}"] = getattr(scene.params, k).numpy()
        out[f"{key}/mu/{k}"] = getattr(whole.mu, k).numpy()
    for k in ("grad_accum", "grad_count", "max_radii2d"):
        out[f"{key}/{k}"] = getattr(scene, k).numpy()
    for k, val in logs.items():
        out[f"{key}/log/{k}"] = np.asarray(float(val))
    if exposure:
        out[f"{key}/exp_grad"] = res[3].numpy()
    out[f"{key}/band_dropped"] = step.band_stats["num_dropped_pairs"].numpy()
    out[f"{key}/sharded_adam"] = np.asarray(step.sharded_adam)
    # the kernels take only contiguous tensors, which the CPU versions do not
    # check: every field of the sharded preprocess must be contiguous where
    # the one-process preprocess's is
    with torch.no_grad():
        prep = _preprocess_sharded(scene, cams, W, H, False, None, mesh, "tile")
        one = preprocess(scene.params.xyz, scene.get_opacity(), scene.get_scales(),
                         scene.get_rotation(), scene.get_features(), cams, W, H,
                         scene.active_sh_degree, scene.max_sh_degree, False, scene.alive)
    out[f"{key}/prep_contiguous"] = np.asarray(
        [getattr(prep, f.name).is_contiguous() or not getattr(one, f.name).is_contiguous()
         for f in dataclasses.fields(prep)])


def task_steps(info, out):
    for case in STEP_CASES:
        run_step_case(info, out, case, "steps")


def task_seam(info, out):
    """The step with an all-gather whose backward only slices out this
    rank's rows (no sum over the ring): the other bands' terms of this
    rank's splats are lost."""
    from gaussian_splatting_lightning_tpu_torch.parallel import shard

    def slice_only(ctx, grad):
        mesh, axis, dim = ctx.args
        n = grad.shape[dim] // mesh.axis_size(axis)
        return grad.narrow(dim, mesh.axis_index(axis) * n, n), None, None, None

    real = shard._GatherShards.backward
    shard._GatherShards.backward = staticmethod(slice_only)
    try:
        run_step_case(info, out, SEAM_CASE, "seam")
    finally:
        shard._GatherShards.backward = real


def task_donate(info, out):
    import torch

    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussian_splatting_lightning_tpu_torch.parallel import make_mesh, make_sharded_train_step
    from gaussian_splatting_lightning_tpu_torch.parallel.shard import gather_adam, shard_adam
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam

    for name, (v, t), cap, exposure, depth in DONATE_CASES:
        mesh = make_mesh(view=v, tile=t, info=info)
        step = make_sharded_train_step(step_config("plain", cap, exposure, depth), 4.0, W, H,
                                       mesh)
        images, depth_t, exp = targets()
        b = BATCH // v
        rows = slice(mesh.axis_index("view") * b, (mesh.axis_index("view") + 1) * b)
        args = (stack_cameras(port_cameras()[rows]), torch.from_numpy(images[rows]),
                torch.zeros(b, 3))
        kw = {}
        if exposure:
            kw["exp_mat"] = torch.from_numpy(exp[rows])
        if depth:
            kw["depth_target"] = torch.from_numpy(depth_t[rows])
        key = f"donate/{name}"
        for side, fn in (("out", step), ("in", step.in_place)):
            scene = port_scene(cap)
            adam = init_adam(scene.params)
            if step.sharded_adam:
                adam = shard_adam(adam, mesh)
            given = [getattr(scene.params, k) for k in PARAM_NAMES] + [scene.grad_accum]
            logs = {}
            for i in range(DONATE_STEPS):
                res = fn(scene, adam, i, *args, **kw)
                scene, adam = res[:2]
                for k, val in res[2].items():
                    logs.setdefault(k, []).append(float(val))
                if exposure:
                    out[f"{key}/{side}/exp_grad/{i}"] = res[3].numpy()
            for k, val in logs.items():
                out[f"{key}/{side}/log/{k}"] = np.array(val)
            whole = gather_adam(adam, mesh) if step.sharded_adam else adam
            for k in PARAM_NAMES:
                out[f"{key}/{side}/param/{k}"] = getattr(scene.params, k).numpy()
                out[f"{key}/{side}/mu/{k}"] = getattr(whole.mu, k).numpy()
                out[f"{key}/{side}/nu/{k}"] = getattr(whole.nu, k).numpy()
            for k in ("grad_accum", "grad_count", "max_radii2d"):
                out[f"{key}/{side}/{k}"] = getattr(scene, k).numpy()
            out[f"{key}/{side}/count"] = np.asarray(adam.count)
            now = [getattr(scene.params, k) for k in PARAM_NAMES] + [scene.grad_accum]
            out[f"{key}/{side}/same_tensors"] = np.asarray(
                [a.data_ptr() == b.data_ptr() for a, b in zip(given, now)])
        out[f"{key}/sharded_adam"] = np.asarray(step.sharded_adam)


def task_trainer(info, out, out_dir):
    """``Trainer(mesh)`` for TRAINER_STEPS steps through a densify event,
    checkpointing every 3 steps under ``out_dir/trainer``."""
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussian_splatting_lightning_tpu_torch.parallel import make_mesh
    from gaussian_splatting_lightning_tpu_torch.training.trainer import Trainer

    mesh = make_mesh(*TRAINER_MESH, info=info)
    tr = Trainer(trainer_config(1, checkpoint_interval=3), trainer_scene(), 4.0,
                 trainer_views(), out_dir=os.path.join(out_dir, "trainer"),
                 log_fn=lambda *a: None, mesh=mesh)
    tr.train()
    out["trainer/loss"] = np.array([h["loss"] for h in tr.history])
    out["trainer/n_gaussians"] = np.array([h["n_gaussians"] for h in tr.history])
    adam = tr._whole_adam()
    for k in PARAM_NAMES:
        out[f"trainer/param/{k}"] = getattr(tr.scene.params, k).numpy()
        out[f"trainer/mu/{k}"] = getattr(adam.mu, k).numpy()
        out[f"trainer/nu/{k}"] = getattr(adam.nu, k).numpy()
        # this rank's own rows of Adam (its ZeRO-1 shard)
        out[f"local/trainer/mu/{k}"] = getattr(tr.adam.mu, k).numpy()
    for k in ("alive", "grad_accum", "grad_count", "max_radii2d"):
        out[f"trainer/{k}"] = getattr(tr.scene, k).numpy()
    if tr.exposure is not None:
        out["trainer/exposure"] = tr.exposure.params.numpy()
    out["trainer/zero1"] = np.asarray(tr._zero1)


def main(argv):
    rank, world, store, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    tasks = argv[4:]
    import torch

    torch.set_num_threads(1)
    from gaussian_splatting_lightning_tpu_torch.parallel import init_distributed

    info = init_distributed("cpu", rank=rank, world_size=world, init_method=f"file://{store}")
    out: dict = {}
    try:
        for task in tasks:
            if task == "trainer":
                task_trainer(info, out, out_dir)
            else:
                globals()[f"task_{task}"](info, out)
    finally:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
