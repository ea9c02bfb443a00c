"""One rank of the four-card check of the captured sharded step on NCCL
(``tests/test_torch_graph_cuda.py``), one rank per card:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        tests/torch_nccl_worker.py <out dir> [VxT ...]

For each mesh (default ``MESHES``) the sharded step runs captured (what
``Trainer(mesh=…)`` replays on NCCL: real collectives across the ranks, on
the "tile", "view" and "world" groups) and eagerly (``capture=False``),
``STEPS`` steps each from the same start, on ``tests/torch_mesh_worker.py``'s
problem on route "cuda" with ZeRO-1 Adam, exposure and a depth target, on a
global batch of ``torch_mesh_worker.BATCH`` views (one per view group when
the view axis is longer). Each
rank writes ``<out dir>/rank<r>.npz``: per mesh and side the losses, the
exposure gradients, the parameters, this rank's Adam rows and the
densification statistics, and for the captured side its captures and
launches per replay. ``parallel.shutdown`` releases the graphs before the
process group. Imports only torch, numpy and the port.
"""

from __future__ import annotations

import os
import sys

import numpy as np

# this file's directory is on the path (run as a script): another installed
# ``tests`` package may shadow the repo's
import torch_mesh_worker as mw

MESHES = ((1, 4), (2, 2))
STEPS = 5
CAPACITY = 128  # divisible by 4: ZeRO-1


def run_mesh(mesh, out):
    import torch

    from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera, stack_cameras
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussian_splatting_lightning_tpu_torch.parallel import make_sharded_train_step
    from gaussian_splatting_lightning_tpu_torch.parallel.shard import shard_adam
    from gaussian_splatting_lightning_tpu_torch.scripts.bench_batched import ring_pose
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam

    dev = mesh.device
    cfg = mw.step_config("cuda", CAPACITY, True, True)
    steps = {"captured": make_sharded_train_step(cfg, 4.0, mw.W, mw.H, mesh),
             "eager": make_sharded_train_step(cfg, 4.0, mw.W, mw.H, mesh, capture=False)}
    batch = max(mw.BATCH, mesh.shape["view"])
    images, depth_t, exp = mw.targets(batch=batch)
    b = batch // mesh.shape["view"]
    rows = slice(mesh.axis_index("view") * b, (mesh.axis_index("view") + 1) * b)
    cams = [make_camera(ring_pose(i, 5), mw.FOCAL, mw.FOCAL, mw.W, mw.H, device=dev)
            for i in range(batch)][rows]
    args = (stack_cameras(cams), torch.from_numpy(images[rows]).to(dev),
            torch.zeros(b, 3, device=dev))
    kw = dict(exp_mat=torch.from_numpy(exp[rows]).to(dev),
              depth_target=torch.from_numpy(depth_t[rows]).to(dev))
    state = {}
    for side, step in steps.items():
        scene = mw.port_scene(CAPACITY, device=dev)
        state[side] = [scene, shard_adam(init_adam(scene.params), mesh), []]
    key = f"{mesh.shape['view']}x{mesh.shape['tile']}"
    for t in range(STEPS):
        for side, step in steps.items():  # every rank in the same order
            scene, adam, losses = state[side]
            scene, adam, logs, exp_grad = step(scene, adam, t, *args, **kw)
            losses.append(float(logs["loss"]))
            out[f"{key}/{side}/exp_grad/{t}"] = exp_grad.cpu().numpy()
            out[f"{key}/{side}/dropped/{t}"] = np.asarray(int(logs["num_dropped_pairs"]))
            state[side][:2] = scene, adam
    for side, (scene, adam, losses) in state.items():
        out[f"{key}/{side}/loss"] = np.array(losses)
        for k in PARAM_NAMES:
            out[f"{key}/{side}/param/{k}"] = getattr(scene.params, k).cpu().numpy()
            out[f"{key}/{side}/mu/{k}"] = getattr(adam.mu, k).cpu().numpy()
            out[f"{key}/{side}/nu/{k}"] = getattr(adam.nu, k).cpu().numpy()
        for k in ("grad_accum", "grad_count", "max_radii2d"):
            out[f"{key}/{side}/{k}"] = getattr(scene, k).cpu().numpy()
    captured = steps["captured"].captured
    out[f"{key}/captures"] = np.asarray(captured.captures)
    out[f"{key}/launch_names"] = np.array(sorted(captured.launches))


def main(out_dir, shapes=()):
    from gaussian_splatting_lightning_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        shutdown,
    )

    info = init_distributed("cuda")
    out: dict = {}
    meshes = []
    try:
        for view, tile in [tuple(map(int, s.split("x"))) for s in shapes] or MESHES:
            meshes.append(make_mesh(view, tile, info=info))
            run_mesh(meshes[-1], out)
    finally:
        np.savez(os.path.join(out_dir, f"rank{info.rank}.npz"), **out)
        shutdown(*meshes)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
