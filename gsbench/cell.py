"""One run of a training cell: the port's ``Trainer`` in a closed loop of
captured steps, timed over a window, traced when asked, and checked against
the plain reference (``reference/gs.py``).

The run, in order:

1. set-up: the scene, the orbit and the targets from the seed
   (``traffic.py``); the pair budget from the reference's projection; the
   ``Trainer`` built on them; three steps through ``Trainer.train``, whose
   losses, first gradient (from Adam's first moment after one step),
   densification statistics after one step and the parameters' change
   after each step are kept for the check; the host reads of the window's
   cadence restored and the rest of the first pass over the views run;
2. the window: ``Trainer.train`` in chunks until ``seconds`` have passed,
   the step counter set back before it would reach an opacity reset;
3. with ``trace``: a stretch of steps under ``torch.profiler``, and the
   work those steps needed, counted by the reference on the scene as the
   stretch began;
4. the program freed, then the reference's three steps from the same
   inputs, and the comparison.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from gsbench import traffic
from gsbench import trace as trace_mod
from gsbench.reference import gs

LEAVES = gs.LEAVES
BETA1 = 0.9


@dataclasses.dataclass
class Inputs:
    params: dict
    alive: torch.Tensor
    cams: list  # numpy camera dicts
    targets: torch.Tensor  # (V, 3, H, W)
    background: torch.Tensor  # (3,)


def make_inputs(config: dict, mix: dict, seed: int, device) -> Inputs:
    w, h = config["width"], config["height"]
    scene = traffic.splats(config, seed, device)
    cams = traffic.orbit(mix, seed, config["views"], w, h)
    return Inputs(scene["params"], scene["alive"], cams,
                  traffic.targets(mix, seed, len(cams), w, h, device),
                  torch.zeros(3, device=device))


def ref_view(inp: Inputs, i: int, device) -> dict:
    """View ``i`` as the reference takes it (float32 tensors)."""
    cam = inp.cams[i]
    out = {k: torch.tensor(np.asarray(cam[k], np.float32), device=device)
           for k in ("viewmatrix", "projmatrix", "campos")}
    out.update(tanfovx=np.float32(cam["tanfovx"]), tanfovy=np.float32(cam["tanfovy"]),
               image=inp.targets[i], background=inp.background)
    return out


def pair_budget(inp: Inputs, config: dict, mix: dict, device) -> int:
    """The pair budget: the most (splat, 32 px block) pairs any view needs
    at the splats' reach, with the mix's headroom, rounded up to 8192."""
    w, h = config["width"], config["height"]
    blk = 32
    gx, gy = -(-w // blk), -(-h // blk)
    worst = 0
    with torch.no_grad():
        for i in range(len(inp.cams)):
            pr = gs.project(inp.params, inp.alive, ref_view(inp, i, device), w, h,
                            config["sh_degree"])
            x0, x1, y0, y1 = gs.block_rect(pr.p_pix, pr.reach, gx, gy, blk)
            n = (x1 - x0).clamp_min(0) * (y1 - y0).clamp_min(0)
            worst = max(worst, int(torch.where(pr.visible, n, 0).sum()))
    return -(-int(worst * mix["budget_headroom"]) // 8192) * 8192


def program_scene(inp: Inputs, config: dict):
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
        GaussianParams,
        GaussianScene,
    )

    cap = config["capacity"]
    dev = inp.alive.device
    zeros = [torch.zeros(cap, device=dev) for _ in range(3)]
    return GaussianScene(GaussianParams(**{k: inp.params[k].clone() for k in LEAVES}),
                         inp.alive.clone(), *zeros, config["sh_degree"])


def program_views(inp: Inputs) -> list:
    from gaussian_splatting_lightning_tpu_torch.data.dataset import ViewItem

    host = inp.targets.cpu().numpy()
    bg = inp.background.cpu().numpy()
    return [ViewItem(image=host[i], viewmatrix=c["viewmatrix"], projmatrix=c["projmatrix"],
                     campos=c["campos"], tanfovx=c["tanfovx"], tanfovy=c["tanfovy"],
                     background=bg, name=f"orbit{i:02d}")
            for i, c in enumerate(inp.cams)]


def _sq_norms(tensors: dict) -> dict:
    """Squared norms of each leaf."""
    return {k: float(tensors[k].double().square().sum()) for k in LEAVES}


@dataclasses.dataclass
class Readings:
    """What a side produced in its first steps."""

    losses: list
    grad_sq: dict  # leaf -> squared norm of the first step's gradient
    changes: list  # after each step: leaf -> the parameters' change so far (on the host)
    stats: dict  # norms of the densification statistics after the first step

    def summary(self) -> dict:
        return {"losses": self.losses, "grad_sq": self.grad_sq, "stats": self.stats,
                "change_sq": _change_sq(self.changes[-1])}


def _stats(max_radius, grad_sum, count) -> dict:
    return {"grad_sum": float(grad_sum.double().norm()), "count": float(count.double().sum()),
            "max_radius": float(max_radius.double().norm())}


def check_steps(trainer, inp: Inputs, n: int) -> Readings:
    """The first ``n`` steps through ``Trainer.train``, one call each."""
    hist0 = len(trainer.history)
    trainer.train(1)
    adam, s = trainer.adam, trainer.scene
    grad_sq = _sq_norms({k: getattr(adam.mu, k) / (1.0 - BETA1) for k in LEAVES})
    stats = _stats(s.max_radii2d, s.grad_accum, s.grad_count)
    changes = [_change(trainer.scene.params, inp.params)]
    for _ in range(n - 1):
        trainer.train(1)
        changes.append(_change(trainer.scene.params, inp.params))
    losses = [float(h["loss"]) for h in trainer.history[hist0:]]
    return Readings(losses, grad_sq, changes, stats)


def _change(params, start: dict) -> dict:
    """``params`` (a parameter record or a dict) less ``start``, on the host."""
    get = params.get if isinstance(params, dict) else lambda k: getattr(params, k)
    return {k: (get(k).float() - start[k]).cpu() for k in LEAVES}


def reference_readings(inp: Inputs, config: dict, mix: dict, seed: int, dtype) -> tuple:
    """The reference's readings of the same steps, on the same views, from
    the same inputs, computed in ``dtype``, and for each leaf the step in
    which the reference first moved each element (``gs.train``)."""
    dev = inp.alive.device
    vps = config["batch_views"]
    n = mix["check_steps"]
    order = traffic.view_order(seed, len(inp.cams), n * vps)
    steps = []
    for s in range(n):
        views = []
        for i in order[s * vps:(s + 1) * vps]:
            v = ref_view(inp, i, dev)
            v["image"], v["background"] = v["image"].to(dtype), v["background"].to(dtype)
            views.append(v)
        steps.append(views)
    p0 = {k: v.to(dtype) for k, v in inp.params.items()}
    records, after, stats, first_moved = gs.train(p0, inp.alive, steps, config["width"],
                                                  config["height"], config["sh_degree"],
                                                  mix["first_step"], mix["extent"])
    grad_sq = {k: float(records[0].grads[k].double().square().sum()) for k in LEAVES}
    ref = Readings([r.loss for r in records], grad_sq, [_change(a, inp.params) for a in after],
                   _stats(stats["max_radius"], stats["grad_sum"], stats["count"]))
    return ref, {k: v.cpu() for k, v in first_moved.items()}


def _leaf_gap(got: dict, want: dict, leaves) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    norms = {k: math.sqrt(want[k]) for k in leaves}
    median = float(np.median([norms[k] for k in leaves]))
    return max(abs(math.sqrt(got[k]) - norms[k]) / max(norms[k], median, 1e-30)
               for k in leaves)


def _change_sq(change: dict, where=None) -> dict:
    return {k: float((v if where is None else v[where[k]]).double().square().sum())
            for k, v in change.items()}


def _from_first_move(changes: list, first_moved: dict) -> dict:
    """Each element's change from the start of the step in which the
    reference first moved it to the end of the last step; 0 where the
    reference never moved it."""
    n = len(changes)
    out = {}
    for k in LEAVES:
        c = changes[-1][k].clone()
        f = first_moved[k]
        for s in range(1, n):
            at = f == s
            c[at] -= changes[s - 1][k][at]
        c[f >= n] = 0.0
        out[k] = c
    return out


def compare(got: Readings, ref: Readings, first_moved: dict) -> tuple:
    """The numbers compared, each a relative gap (see PERF.md), and
    readings of the change by other rules, which are not compared."""
    ref_g = {k: math.sqrt(v) for k, v in ref.grad_sq.items()}
    median = float(np.median(list(ref_g.values())))
    # a leaf whose gradient is round-off in the reference moves under Adam
    # by round-off alone: its change is not compared. Within a leaf, an
    # element whose reference gradient has been exactly 0 in every step so
    # far has moments of 0, and the reference leaves it where it is; the
    # program's round-off there (Adam's eps is 1e-15) moves it a step of the
    # learning rate. Such steps are not compared: each element's change is
    # counted from the step in which the reference first moved it.
    moving = [k for k in LEAVES if ref_g[k] >= 1e-3 * median]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses)) \
        if len(got.losses) == len(ref.losses) else float("inf")
    stats_gap = max(abs(got.stats[k] - ref.stats[k]) / max(abs(ref.stats[k]), 1e-30)
                    for k in ref.stats)
    checks = {"loss_gap": loss_gap, "grad_gap": _leaf_gap(got.grad_sq, ref.grad_sq, LEAVES),
              "step_gap": _leaf_gap(_change_sq(_from_first_move(got.changes, first_moved)),
                                    _change_sq(_from_first_move(ref.changes, first_moved)),
                                    moving),
              "stats_gap": stats_gap}
    n = len(ref.changes)
    never = {k: v >= n for k, v in first_moved.items()}
    readings = {
        "step_gap_every_element": _leaf_gap(_change_sq(got.changes[-1]),
                                            _change_sq(ref.changes[-1]), moving),
        # elements the reference never moved, and the program's change there
        "unmoved_share": {k: float(v.float().mean()) for k, v in never.items()},
        "unmoved_change_sq": _change_sq(got.changes[-1], never),
        "first_moved_share": {k: [float((v == s).float().mean()) for s in range(n)]
                              for k, v in first_moved.items()},
    }
    return checks, readings


def traced_work(inp_params: dict, inp: Inputs, config: dict, views: list, device) -> dict:
    """Contributing evaluations and visible splats of ``views`` (indices,
    with repeats) on the scene ``inp_params``, by the reference."""
    w, h = config["width"], config["height"]
    kept = visible = 0.0
    uniq, reps = np.unique(np.asarray(views), return_counts=True)
    with torch.no_grad():
        for i, r in zip(uniq.tolist(), reps.tolist()):
            pr = gs.project(inp_params, inp.alive, ref_view(inp, i, device), w, h,
                            config["sh_degree"])
            _, _, k = gs.render(pr, w, h, inp.background)
            kept += r * k
            visible += r * float(pr.visible.sum())
    return {"kept": kept, "visible": visible, "views": len(views)}


def run(spec: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda") -> dict:
    """One run of the cell ``spec`` (its config, traffic and limits merged by
    ``manifest.cell``): the fields of its result."""
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import TrainConfig, Trainer

    config, mix = spec["config"], spec["traffic"]
    dev = torch.device(device)
    w, h = config["width"], config["height"]
    vps = config["batch_views"]
    n_views = config["views"]

    inp = make_inputs(config, mix, seed, dev)
    budget = pair_budget(inp, config, mix, dev)
    cfg = TrainConfig(seed=int(seed), capacity=config["capacity"], log_interval=1,
                      batch_views=vps, w_ssim=gs.W_SSIM,
                      tiling=TilingConfig(max_pairs=budget))
    lines: list = []
    trainer = Trainer(cfg, program_scene(inp, config), mix["extent"], program_views(inp),
                      log_fn=lines.append)
    trainer.step = mix["first_step"]
    got = check_steps(trainer, inp, mix["check_steps"])
    trainer.cfg = dataclasses.replace(trainer.cfg, log_interval=mix["log_interval"])
    # the rest of the first pass over the views: the trainer uploads a view
    # the first time it draws it, so every view the window draws is then on
    # the card
    first_pass = -(-n_views // vps)
    if first_pass > mix["check_steps"]:
        trainer.train(first_pass - mix["check_steps"])
    del inp
    _sync(dev)
    setup_s = time.time() - t_start

    def chunk(n):
        if trainer.step + n >= mix["reset_before"]:
            trainer.step = mix["first_step"]
        trainer.train(n)

    failed = 0
    n_lines = len(lines)
    steps, t0, marks = 0, time.perf_counter(), []
    while time.perf_counter() - t0 < seconds:
        chunk(mix["chunk_steps"])
        steps += mix["chunk_steps"]
        marks.append(time.perf_counter() - t0)  # host time at each chunk's end
    _sync(dev)
    wall = time.perf_counter() - t0
    failed += sum("overflow" in ln for ln in lines[n_lines:])
    out = {"steps": steps, "wall_s": wall, "setup_s": setup_s, "budget": budget,
           "pixels_per_step": w * h * vps, "lines": lines[-4:], "chunk_s": marks,
           "pairs": [int(h_["num_pairs"]) for h_ in trainer.history[mix["check_steps"]:]]}
    drawn = (max(mix["check_steps"], first_pass) + steps) * vps

    if trace:
        snapshot = {k: getattr(trainer.scene.params, k).detach().clone() for k in LEAVES}
        n_lines = len(lines)
        box: dict = {}
        _sync(dev)
        with trace_mod.profiled(box):
            t1 = time.perf_counter()
            chunk(mix["trace_steps"])
            _sync(dev)
            traced_wall = time.perf_counter() - t1
        failed += sum("overflow" in ln for ln in lines[n_lines:])
        out["trace"] = trace_mod.reduce_events(box.pop("events"), mix["trace_steps"],
                                               traced_wall)
        traced_views = traffic.view_order(seed, n_views, drawn + mix["trace_steps"] * vps)[
            drawn:]
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out["attempted"], out["failed"] = steps, failed
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    inp = make_inputs(config, mix, seed, dev)
    if trace:
        out["work"] = traced_work(snapshot, inp, config, traced_views, dev)
        del snapshot
    t_ref = time.perf_counter()
    ref, first_moved = reference_readings(inp, config, mix, seed, torch.float32)
    out["checks"], extra = compare(got, ref, first_moved)
    out["readings"] = dict(extra, program=got.summary(), reference=ref.summary(),
                           reference_s=time.perf_counter() - t_ref)
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
