"""One run of a training cell: the port's ``Trainer`` in a closed loop of
captured steps, timed over a window, traced when asked, and checked against
the configuration's plain reference (``reference/<name>.py``, by default
``reference/gs.py``).

A configuration may say how its cell runs, with three optional keys; absent,
the cell runs as it always has:

- ``train``: ``TrainConfig`` fields, named as in the ``train:`` block of the
  port's YAML configurations (nested ``densify``, ``optimizer`` and
  ``tiling`` too), loaded by the port's own loader and applied over what the
  harness sets; the harness owns ``OWNED`` and ``tiling.max_pairs``;
- ``reference``: the module under ``gsbench/reference/`` that is the plain
  reference, with the interface that ``reference/gs.py`` lists;
- ``mesh``: ``{"view": v, "tile": t}``, the port's ("view", "tile") mesh on
  ``v * t`` ranks, one a card (``ranks.py``); a step takes ``batch_views``
  views for each view group.

The run, in order:

1. set-up: the scene, the orbit and the targets from the seed
   (``traffic.py``); the pair budget from the reference's projection (on a
   mesh, of the worst band); the ``Trainer`` built on them (on a mesh with
   ``mesh=``, as the port's train CLI builds it); three steps through
   ``Trainer.train``, whose losses, first gradient (from Adam's first
   moment after one step), densification statistics after one step and
   the parameters' change after each step are kept for the check; the host reads of the window's
   cadence restored and the rest of the first pass over the views run;
2. the window: ``Trainer.train`` in chunks until ``seconds`` have passed,
   the step counter set back before it would reach an opacity reset;
3. with ``trace``: a stretch of steps under ``torch.profiler``, and the
   work those steps needed, counted by the reference on the scene as the
   stretch began;
4. the program freed (on a mesh, the mesh left: every rank but rank 0
   is done), then the reference's three steps from the same inputs, each
   step's views in the order the sampler drew them, and the comparison.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time

import numpy as np
import torch

from gsbench import traffic
from gsbench import trace as trace_mod
from gsbench.ranks import Solo

BETA1 = 0.9
REFERENCE_PACKAGE = "gsbench.reference"
# TrainConfig fields the harness sets itself (and ``tiling.max_pairs``)
OWNED = ("seed", "capacity", "log_interval", "batch_views")


def reference(config: dict):
    """The configuration's plain reference: ``reference/<name>.py``."""
    return importlib.import_module(f"{REFERENCE_PACKAGE}.{config.get('reference', 'gs')}")


def views_per_step(config: dict) -> int:
    """``batch_views`` for each of the mesh's view groups."""
    return config["batch_views"] * config.get("mesh", {}).get("view", 1)


def _over(base, fields, given: dict):
    """``base`` with the fields named in ``given`` taken from ``fields``
    (the loader's record of ``given``), nested records field by field."""
    out = {}
    for k, v in given.items():
        got = getattr(fields, k)
        out[k] = _over(getattr(base, k), got, v) if isinstance(v, dict) else got
    return dataclasses.replace(base, **out)


def train_config(config: dict, base):
    """``base`` (the harness's ``TrainConfig``) with the configuration's
    ``train`` options applied over it; a field that is not the port's, or
    one the harness owns, is refused."""
    given = config.get("train")
    if not given:
        return base
    from gaussian_splatting_lightning_tpu_torch.training import config as loader

    name = config.get("name", "configuration")
    owned = [k for k in OWNED if k in given]
    if "max_pairs" in (given.get("tiling") or {}):
        owned.append("tiling.max_pairs")
    if owned:
        raise ValueError(f"{name}: train sets {', '.join(owned)}, which the harness owns")
    try:
        fields = loader._build(type(base), given)
    except (KeyError, ValueError, TypeError) as e:
        raise ValueError(f"{name}: train: {e}") from None
    return _over(base, fields, given)


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
    at the splats' reach, with the mix's headroom, rounded up to 8192. On a
    mesh a rank renders a band of block rows with the budget over the band
    count: there the worst band's pairs times the band count."""
    ref = reference(config)
    w, h = config["width"], config["height"]
    blk = 32
    gx, gy = -(-w // blk), -(-h // blk)
    bands = config.get("mesh", {}).get("tile", 1)
    rows = -(-gy // bands)
    worst = 0
    with torch.no_grad():
        for i in range(len(inp.cams)):
            pr = ref.project(inp.params, inp.alive, ref_view(inp, i, device), w, h,
                             config["sh_degree"])
            x0, x1, y0, y1 = ref.block_rect(pr.p_pix, pr.reach, gx, gy, blk)
            nx = (x1 - x0).clamp_min(0)
            for b in range(bands):
                ny = (y1.clamp_max((b + 1) * rows) - y0.clamp_min(b * rows)).clamp_min(0)
                worst = max(worst, int(torch.where(pr.visible, nx * ny, 0).sum()))
    return -(-int(worst * bands * mix["budget_headroom"]) // 8192) * 8192


def program_scene(inp: Inputs, config: dict):
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
        GaussianParams,
        GaussianScene,
    )

    cap = config["capacity"]
    dev = inp.alive.device
    zeros = [torch.zeros(cap, device=dev) for _ in range(3)]
    leaves = reference(config).LEAVES
    return GaussianScene(GaussianParams(**{k: inp.params[k].clone() for k in leaves}),
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
    return {k: float(v.double().square().sum()) for k, v in tensors.items()}


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


def check_steps(trainer, inp: Inputs, n: int, leaves) -> Readings:
    """The first ``n`` steps through ``Trainer.train``, one call each; the
    first moment is the whole one (gathered on every rank of a ZeRO-1
    mesh)."""
    hist0 = len(trainer.history)
    trainer.train(1)
    adam, s = trainer._whole_adam(), trainer.scene
    grad_sq = _sq_norms({k: getattr(adam.mu, k) / (1.0 - BETA1) for k in leaves})
    del adam
    stats = _stats(s.max_radii2d, s.grad_accum, s.grad_count)
    changes = [_change(trainer.scene.params, inp.params, leaves)]
    for _ in range(n - 1):
        trainer.train(1)
        changes.append(_change(trainer.scene.params, inp.params, leaves))
    losses = [float(h["loss"]) for h in trainer.history[hist0:]]
    return Readings(losses, grad_sq, changes, stats)


def _change(params, start: dict, leaves) -> dict:
    """``params`` (a parameter record or a dict) less ``start``, on the host."""
    get = params.get if isinstance(params, dict) else lambda k: getattr(params, k)
    return {k: (get(k).float() - start[k]).cpu() for k in leaves}


def reference_readings(inp: Inputs, config: dict, mix: dict, seed: int, dtype) -> tuple:
    """The reference's readings of the same steps, on the same views, from
    the same inputs, computed in ``dtype``, and for each leaf the step in
    which the reference first moved each element (``train`` of the
    reference). A step's views are the sampler's next draws, in order: on a
    mesh the whole batch, which the view groups share in that order."""
    ref = reference(config)
    dev = inp.alive.device
    vps = views_per_step(config)
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
    records, after, stats, first_moved = ref.train(p0, inp.alive, steps, config["width"],
                                                   config["height"], config["sh_degree"],
                                                   mix["first_step"], mix["extent"])
    grad_sq = {k: float(records[0].grads[k].double().square().sum()) for k in ref.LEAVES}
    want = Readings([r.loss for r in records], grad_sq,
                    [_change(a, inp.params, ref.LEAVES) for a in after],
                    _stats(stats["max_radius"], stats["grad_sum"], stats["count"]))
    return want, {k: v.cpu() for k, v in first_moved.items()}


def _failed_as_inf(x: float) -> float:
    """A reading that is not finite is a failed check: inf."""
    return x if math.isfinite(x) else math.inf


def _leaf_gap(got: dict, want: dict, leaves) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf; inf with no leaf
    to compare or a reading that is not finite."""
    if not leaves:
        return math.inf
    norms = {k: math.sqrt(want[k]) for k in leaves}
    median = float(np.median([norms[k] for k in leaves]))
    return _failed_as_inf(max(abs(math.sqrt(got[k]) - norms[k]) / max(norms[k], median, 1e-30)
                              for k in leaves))


def _change_sq(change: dict, where=None) -> dict:
    return {k: float((v if where is None else v[where[k]]).double().square().sum())
            for k, v in change.items()}


def _from_first_move(changes: list, first_moved: dict) -> dict:
    """Each element's change from the start of the step in which the
    reference first moved it to the end of the last step; 0 where the
    reference never moved it."""
    n = len(changes)
    out = {}
    for k in first_moved:
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
    readings of the change by other rules, which are not compared. A
    reading that is not finite, or with nothing to compare, is inf."""
    leaves = list(ref.grad_sq)
    ref_g = {k: math.sqrt(v) for k, v in ref.grad_sq.items()}
    median = float(np.median(list(ref_g.values())))
    # a leaf whose gradient is round-off in the reference moves under Adam
    # by round-off alone: its change is not compared. Within a leaf, an
    # element whose reference gradient has been exactly 0 in every step so
    # far has moments of 0, and the reference leaves it where it is; the
    # program's round-off there (Adam's eps is 1e-15) moves it a step of the
    # learning rate. Such steps are not compared: each element's change is
    # counted from the step in which the reference first moved it.
    moving = [k for k in leaves if ref_g[k] >= 1e-3 * median]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses)) \
        if len(got.losses) == len(ref.losses) else math.inf
    stats_gap = max(abs(got.stats[k] - ref.stats[k]) / max(abs(ref.stats[k]), 1e-30)
                    for k in ref.stats)
    checks = {"loss_gap": _failed_as_inf(loss_gap),
              "grad_gap": _leaf_gap(got.grad_sq, ref.grad_sq, leaves),
              "step_gap": _leaf_gap(_change_sq(_from_first_move(got.changes, first_moved)),
                                    _change_sq(_from_first_move(ref.changes, first_moved)),
                                    moving),
              "stats_gap": _failed_as_inf(stats_gap)}
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
    with repeats, ``views_per_step`` a step) on the scene ``inp_params``, by
    the reference; under ``rank0`` rank 0's share of them and the pixels it
    renders: on a mesh its view group's views (the first ``batch_views`` of
    each step's) and in them its band's block rows (a visible splat counted
    where its blocks reach the band), on one card the whole."""
    ref = reference(config)
    w, h = config["width"], config["height"]
    blk = 32
    gx, gy = -(-w // blk), -(-h // blk)
    rows = -(-gy // config.get("mesh", {}).get("tile", 1))  # rank 0's band: [0, rows)
    vps, b = views_per_step(config), config["batch_views"]
    own = [i for n, i in enumerate(views) if n % vps < b]
    kept = visible = kept0 = visible0 = 0.0
    uniq, reps = np.unique(np.asarray(views), return_counts=True)
    reps0 = dict(zip(*np.unique(np.asarray(own), return_counts=True)))
    with torch.no_grad():
        for i, r in zip(uniq.tolist(), reps.tolist()):
            pr = ref.project(inp_params, inp.alive, ref_view(inp, i, device), w, h,
                             config["sh_degree"])
            _, _, k = ref.render(pr, w, h, inp.background)
            kept += r * k
            visible += r * float(pr.visible.sum())
            r0 = int(reps0.get(i, 0))
            if r0 and rows < gy:
                _, _, k = ref.render(pr, w, h, inp.background, pixel_rows=(0, rows * blk))
                x0, x1, y0, y1 = ref.block_rect(pr.p_pix, pr.reach, gx, gy, blk)
                reach = pr.visible & (x1 > x0) & (y1.clamp_max(rows) > y0)
                kept0 += r0 * k
                visible0 += r0 * float(reach.sum())
            elif r0:
                kept0 += r0 * k
                visible0 += r0 * float(pr.visible.sum())
    return {"kept": kept, "visible": visible, "views": len(views),
            "rank0": {"kept": kept0, "visible": visible0,
                      "pixels": len(own) * min(rows * blk, h) * w}}


def run(spec: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", ranks=None) -> dict | None:
    """One run of the cell ``spec`` (its config, traffic and limits merged by
    ``manifest.cell``): the fields of its result. On a mesh (``ranks`` a
    ``ranks.Ranks``) every rank runs the program and leaves the mesh; rank 0
    alone then checks and returns the fields, the others None."""
    ranks = ranks or Solo()
    out, got, traced = program(spec, seed, seconds, trace, t_start, device, ranks)
    if not ranks.leave():
        return None
    out.update(check(spec, seed, got, torch.device(device), traced))
    return out


def check(spec: dict, seed: int, got: Readings, dev, traced=None, want=None) -> dict:
    """The check half of a run, once the program's state is freed: with
    ``traced`` (``program``'s) the traced steps' work, then the reference's
    readings of the checked steps (or ``want``, a seed's read already) and
    the comparison. The result's fields ``work``, ``checks`` and
    ``readings``."""
    config, mix = spec["config"], spec["traffic"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {}
    inp = make_inputs(config, mix, seed, dev) if traced or want is None else None
    if traced:
        snapshot, views = traced
        out["work"] = traced_work(snapshot, inp, config, views, dev)
        del snapshot, traced
    t_ref = time.perf_counter()
    ref, first_moved = want or reference_readings(inp, config, mix, seed, torch.float32)
    del inp
    out["checks"], extra = compare(got, ref, first_moved)
    out["readings"] = dict(extra, program=got.summary(), reference=ref.summary(),
                           reference_s=time.perf_counter() - t_ref)
    return out


def program(spec: dict, seed: int, seconds: float, trace: bool, t_start: float, device,
            ranks) -> tuple:
    """The program's part of a run on this rank: set-up, the checked steps,
    the window and, with ``trace``, the traced stretch. Returns the result's
    fields so far, the checked steps' ``Readings`` and, traced, the scene as
    the stretch began (rank 0's) with the views the stretch drew. The
    program's state is dropped on return."""
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import TrainConfig, Trainer

    config, mix = spec["config"], spec["traffic"]
    ref = reference(config)
    dev = torch.device(device)
    w, h = config["width"], config["height"]
    vps = views_per_step(config)
    n_views = config["views"]

    inp = make_inputs(config, mix, seed, dev)
    budget = pair_budget(inp, config, mix, dev)
    cfg = train_config(config, TrainConfig(
        seed=int(seed), capacity=config["capacity"], log_interval=1,
        batch_views=config["batch_views"], w_ssim=ref.W_SSIM,
        tiling=TilingConfig(max_pairs=budget)))
    lines: list = []
    trainer = Trainer(cfg, program_scene(inp, config), mix["extent"], program_views(inp),
                      log_fn=lines.append, mesh=ranks.mesh)
    trainer.step = mix["first_step"]
    ranks.beat("trainer")
    got = check_steps(trainer, inp, mix["check_steps"], ref.LEAVES)
    trainer.cfg = dataclasses.replace(trainer.cfg, log_interval=mix["log_interval"])
    # the rest of the first pass over the views, then every view on the
    # card: the trainer uploads a view the first time it draws it (on a
    # mesh, only its view group's), so every view the window draws is there
    first_pass = -(-n_views // vps)
    if first_pass > mix["check_steps"]:
        trainer.train(first_pass - mix["check_steps"])
    for i in range(n_views):
        trainer._device_view(i)
    del inp
    ranks.fence(dev)
    setup_s = time.time() - t_start
    ranks.beat("set-up")

    def chunk(n):
        if trainer.step + n >= mix["reset_before"]:
            trainer.step = mix["first_step"]
        trainer.train(n)

    failed = 0
    n_lines = len(lines)
    steps, t0, marks = 0, time.perf_counter(), []
    while ranks.go(time.perf_counter() - t0 < seconds):
        chunk(mix["chunk_steps"])
        steps += mix["chunk_steps"]
        marks.append(time.perf_counter() - t0)  # host time at each chunk's end
        ranks.beat("window")
    ranks.fence(dev)
    wall = time.perf_counter() - t0
    failed += sum("overflow" in ln for ln in lines[n_lines:])
    out = {"steps": steps, "wall_s": wall, "setup_s": setup_s, "budget": budget,
           "pixels_per_step": w * h * vps, "lines": lines[-4:], "chunk_s": marks,
           "pairs": [int(h_["num_pairs"]) for h_ in trainer.history[mix["check_steps"]:]]}
    drawn = (max(mix["check_steps"], first_pass) + steps) * vps

    traced = None
    if trace:
        snapshot = {k: getattr(trainer.scene.params, k).detach().clone()
                    for k in ref.LEAVES} if ranks.rank == 0 else None
        n_lines = len(lines)
        box: dict = {}
        ranks.fence(dev)
        with trace_mod.profiled(box):
            t1 = time.perf_counter()
            chunk(mix["trace_steps"])
            _sync(dev)
            traced_wall = time.perf_counter() - t1
        failed += sum("overflow" in ln for ln in lines[n_lines:])
        out["trace"] = trace_mod.reduce_events(box.pop("events"), mix["trace_steps"],
                                               traced_wall)
        # the device's busy time, averaged over the ranks (rank 0's alone
        # on one card): the line's ``busy_s`` and ``device_idle_pct.train``'s
        out["busy_s"] = float(np.mean(ranks.gather(out["trace"].busy_s)))
        traced = (snapshot, traffic.view_order(seed, n_views,
                                               drawn + mix["trace_steps"] * vps)[drawn:])
        ranks.beat("trace")
    # the fullest card's peak
    out["memory_peak_bytes"] = max(ranks.gather(
        torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0))
    out["attempted"], out["failed"] = steps, failed
    return out, got, traced


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
