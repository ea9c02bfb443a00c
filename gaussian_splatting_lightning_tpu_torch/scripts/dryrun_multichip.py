"""Dry run of the mesh through the product path: the counterpart of the JAX
repo's ``dryrun_multichip(n)`` (``__graft_entry__.py``).

Full sharded training (data parallel over views x spatial parallel over
image tile rows) on an N-rank mesh, through the same ``Trainer`` class the
train CLI constructs, with ``mesh=`` set: sharded train steps, the densify
event with its Adam surgery, and the band-local halo loss, at tiny shapes.
Three passes, with the JAX function's sizes, configs, seeds and asserts:

  1. a (view x tile) mesh, view 2 when N is even and at least 4, 3 steps
     with a densify event at step 2;
  2. the same mesh with the product kernels (the JAX pass runs its Pallas
     kernels in interpret mode): route ``cuda`` on the cards, ``plain`` with
     ``--device cpu``, one step;
  3. a 1xN tile mesh against one process, 15 steps at 192 x 16N on 5000
     splats: the last losses within 2e-3 and the two end states rendering
     the same image (cross-PSNR above 45 dB).

Passes 1 and 3 take the JAX ``TrainConfig``'s default route, ``auto``, as
the port's config maps it: ``cuda`` (the kernels on the cards, their plain
versions on CPU tensors). Every pass renders 16 px tiles, the JAX passes'
"one tile row per device band".

Run one process per rank:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m gaussian_splatting_lightning_tpu_torch.scripts.dryrun_multichip \\
        [--device cpu] [--out result.json]

On the cards every rank needs a card of its own (NCCL; the steps replay
captured graphs, as the ``Trainer`` runs them): with fewer cards than ranks
it exits non-zero, and never shares a card or falls back to gloo. With
``--device cpu`` the ranks run on gloo. Rank 0 prints the JAX function's
lines and writes ``--out``: each pass's logged losses, alive counts and
steps, the last losses, the largest relative parameter difference and the
cross-PSNR. Every rank leaves through ``parallel.shutdown``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np

SEAM_LOSS_TOL = 2e-3  # |l1 - l2| of pass 3, the JAX assert
SEAM_PSNR_DB = 45.0  # the end renders' cross-PSNR, the JAX assert
STEPS3 = 15


def routes(device) -> tuple:
    """(route of passes 1 and 3, route of pass 2): the JAX ``auto`` as the
    port maps it, and the product kernels (their plain versions on the
    CPU, as the JAX pass runs its kernels in interpret mode)."""
    return "cuda", "cuda" if device.type == "cuda" else "plain"


def join(device: str):
    """``init_distributed`` from torchrun's environment; on the cards only
    with a card per rank."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.device import resolve_device
    from gaussian_splatting_lightning_tpu_torch.parallel import init_distributed

    if resolve_device(device).type == "cuda":
        ranks = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
        cards = torch.cuda.device_count()
        if cards < ranks:
            raise SystemExit(f"dryrun_multichip: {ranks} ranks on this host but {cards} "
                             "card(s): each rank needs a card of its own (or --device cpu)")
    info = init_distributed(device, init_method="env://")
    if info is None:
        raise SystemExit("dryrun_multichip: one process per rank: launch with python -m "
                         "torch.distributed.run --nproc-per-node N -m "
                         "gaussian_splatting_lightning_tpu_torch.scripts.dryrun_multichip")
    return info


def view_items(gt, cams, w, h, tiling, route):
    """Each camera's GT render as a ``ViewItem``."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.data.dataset import ViewItem
    from gaussian_splatting_lightning_tpu_torch.training.trainer import (
        render_scene,
        resolve_rasterizer,
    )

    items = []
    for cam in cams:
        with torch.no_grad():
            out, _ = render_scene(gt, cam, w, h, torch.zeros(3, device=gt.device), tiling,
                                  rasterize_fn=resolve_rasterizer(route))
        items.append(ViewItem(
            image=out.image.cpu().numpy(), viewmatrix=cam.viewmatrix.cpu().numpy(),
            projmatrix=cam.projmatrix.cpu().numpy(), campos=cam.campos.cpu().numpy(),
            tanfovx=float(cam.tanfovx), tanfovy=float(cam.tanfovy),
            background=np.zeros(3, np.float32)))
    return items


def history(trainer) -> dict:
    return {"losses": [h["loss"] for h in trainer.history],
            "logged_steps": [h["step"] for h in trainer.history],
            "n_alive": int(trainer.scene.n_alive()), "steps": trainer.step}


def run(info, say, meshes: list) -> dict:
    """The three passes on this rank, each mesh appended to ``meshes`` as it
    is built; returns this rank's record (rank 0's alone holds pass 3's
    comparison)."""
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.parallel import make_mesh
    from gaussian_splatting_lightning_tpu_torch.training.densify import DensifyConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import (
        TrainConfig,
        Trainer,
        render_scene,
        resolve_rasterizer,
    )

    dev, n_dev = info.device, info.world_size
    route, product = routes(dev)
    rec, seconds = {"device": str(dev), "backend": info.backend, "ranks": n_dev,
                    "routes": [route, product]}, {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def scene(n, cap, **kw):
        return interop.synthetic_scene(n, cap, sh_degree=2, device=dev, **kw)

    # pass 1: view gets 2 when possible (data parallel and tile parallel)
    t0 = time.perf_counter()
    view = 2 if n_dev % 2 == 0 and n_dev >= 4 else 1
    meshes.append(make_mesh(view=view, tile=n_dev // view, info=info))
    mesh = meshes[-1]
    w, h = 64, 16 * (n_dev // view)  # one tile row per band
    cap = 64
    cfg = TrainConfig(
        num_iters=3, capacity=cap, log_interval=1, valid_interval=10_000,
        checkpoint_interval=10_000, rasterizer=route,
        tiling=TilingConfig(max_pairs=1 << 13, tile_capacity=64, chunk=32, block=16),
        densify=DensifyConfig(densify_since=1, densify_interval=2, densify_until=10))
    views = view_items(scene(48, 48), [interop.camera(w, h, device=dev)] * (2 * view), w, h,
                       cfg.tiling, route)
    trainer = Trainer(cfg, scene(48, cap, seed=3), 2.0, views, log_fn=lambda *a: None,
                      mesh=mesh)
    trainer.train()
    sync()
    rec["pass1"] = dict(history(trainer), mesh=[view, n_dev // view])
    say(f"dryrun_multichip OK: mesh=({view}x{n_dev // view}) "
        f"loss={trainer.history[-1]['loss']:.4f} n_alive={rec['pass1']['n_alive']} "
        f"steps={trainer.step}")
    del trainer
    seconds["pass1"] = time.perf_counter() - t0

    # pass 2: the product kernels on the same mesh
    t0 = time.perf_counter()
    cfg_p = dataclasses.replace(cfg, num_iters=1, rasterizer=product)
    trainer = Trainer(cfg_p, scene(48, cap, seed=3), 2.0, views, log_fn=lambda *a: None,
                      mesh=mesh)
    trainer.train()
    sync()
    rec["pass2"] = history(trainer)
    say(f"dryrun_multichip OK ({product}): loss={trainer.history[-1]['loss']:.4f}")
    del trainer
    seconds["pass2"] = time.perf_counter() - t0

    # pass 3: a tile-sharded run against one process. Tile sharding is a
    # spatial decomposition (band-local binning, halo-exact SSIM, summed
    # gradients), so after STEPS3 Adam steps both land on the same
    # parameters up to f32 summation order
    t0 = time.perf_counter()
    w2, h2 = 192, 16 * n_dev  # one tile row per band
    n2 = cap2 = 5000
    meshes.append(make_mesh(view=1, tile=n_dev, info=info))
    cfg2 = TrainConfig(
        num_iters=STEPS3, capacity=cap2, log_interval=STEPS3, valid_interval=10_000,
        checkpoint_interval=10_000, adaptive_pairs=False, rasterizer=route,
        tiling=TilingConfig(max_pairs=1 << 18, tile_capacity=1024, chunk=64, block=16),
        densify=DensifyConfig(densify_since=STEPS3 + 1, densify_until=0))
    cams2 = [interop.camera(w2, h2, fx=0.6 + 0.05 * i, device=dev) for i in range(4)]
    views2 = view_items(scene(n2, n2, seed=11, scale=0.02), cams2, w2, h2, cfg2.tiling, route)

    def train(mesh_arg):
        tr = Trainer(cfg2, scene(n2, cap2, seed=13, scale=0.03), 2.0, views2,
                     log_fn=lambda *a: None, mesh=mesh_arg)
        tr.train()
        sync()
        return tr

    # one process on rank 0 alone; the others wait in the sharded run's
    # first collective
    single = train(None) if info.rank == 0 else None
    shard = train(meshes[-1])
    rec["pass3"] = {"mesh": [1, n_dev], "sharded": history(shard)}
    if single is not None:
        l1, l2 = single.history[-1]["loss"], shard.history[-1]["loss"]
        max_rel = 0.0
        for k in PARAM_NAMES:
            a, b = getattr(single.scene.params, k), getattr(shard.scene.params, k)
            max_rel = max(max_rel, float((a - b).abs().max() / (a.abs().max() + 1e-12)))
        # the decisive check: the two end states render the same scene (raw
        # parameters drift through Adam's sign-sensitive first updates)
        cam0 = interop.camera(w2, h2, fx=0.62, device=dev)
        bg = torch.zeros(3, device=dev)
        with torch.no_grad():
            img = [render_scene(tr.scene, cam0, w2, h2, bg, cfg2.tiling,
                                rasterize_fn=resolve_rasterizer(route))[0].image.clamp(0, 1)
                   for tr in (single, shard)]
        mse = float(((img[0] - img[1]) ** 2).mean())
        psnr = 10 * float(np.log10(1.0 / max(mse, 1e-12)))
        rec["pass3"].update(single=history(single), l1=l1, l2=l2, param_max_rel_diff=max_rel,
                            cross_psnr_db=psnr)
        say(f"dryrun_multichip sharded-vs-single ({STEPS3} steps, {w2}x{h2}, {n2} splats, "
            f"1x{n_dev} tile mesh): loss {l1:.5f} vs {l2:.5f}, param max rel diff "
            f"{max_rel:.2e}, end-render cross-PSNR {psnr:.1f} dB")
        if not abs(l1 - l2) < SEAM_LOSS_TOL:
            raise AssertionError(f"pass 3: last losses {l1} and {l2}")
        if not psnr > SEAM_PSNR_DB:
            raise AssertionError(f"pass 3: end-render cross-PSNR {psnr} dB")
        say("dryrun_multichip OK (sharded == single-device within tolerance)")
    seconds["pass3"] = time.perf_counter() - t0
    rec["seconds"] = seconds
    return rec


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (a card per rank, NCCL) or cpu (gloo ranks)")
    parser.add_argument("--out", default=None, help="rank 0 writes its record here (JSON)")
    args = parser.parse_args(argv)

    from gaussian_splatting_lightning_tpu_torch.parallel import shutdown

    meshes = []
    try:
        info = join(args.device)
        say = (lambda *a: print(*a, flush=True)) if info.rank == 0 else (lambda *a: None)
        rec = run(info, say, meshes)
        if info.rank == 0 and args.out:
            Path(args.out).write_text(json.dumps(rec))
    finally:
        shutdown(*meshes)  # the graphs go before the communicators, on any path


if __name__ == "__main__":
    main()
