#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100, and of its mesh
on four.

Run from the repository root with no arguments (one card: phases 1-10,
12 and 13):

    python3 chip_smoke.py

or on a machine with four cards (the probe, then phase 11 alone; with
fewer than four cards it exits non-zero):

    python3 chip_smoke.py --cards 4

Phases (any failure exits non-zero):
  1. probe: the card's name and power limit, CUDA and nvcc versions; build
     the kernels from ``gaussian_splatting_lightning_tpu_torch/csrc``.
  2. kernels against their plain PyTorch versions at 256x192 with 20k
     anisotropic splats, 16 and 32 px tiles, non-zero background: K1's
     (key, gauss) and tile ranges identical, K2 within 1e-4 and the same
     bits on a second run.
  3. the main path: the bench scene (1M splats, SH degree 3) through the
     port's PLY round trip, four 1920x1080 views through the serving render
     (``make_render``: captured on its first call, then replayed) with the
     budget from ``pair_budget``, each held bit for bit to the eager render
     (image, radii, depth, pairs); every kernel of the render (the
     preprocess pair's forward, K1, K2) must launch on every view. Then
     each kernel is held against its plain version (K2 also against its
     own second run, bit for bit) and timed on the bench view's own inputs,
     and ``stages_ms`` times the render's stages, the pair's forward beside
     the composed preprocess it replaces.
  4. the port's render CLI on a small COLMAP scene that the port writes.
  5. the training step: at 256x192 with 20k splats, the whole step's
     gradients on route "cuda" against route "plain"; then the bench scene
     at 1920x1080 trains for TRAIN_STEPS + 1 steps of ``make_train_step``
     under the same budget, eager (``capture=False``) and captured from the
     same start (a ``train_step:`` line each: loss finite, 0 dropped pairs,
     the preprocess pair, K1-K4 and Adam launched once and the photometric
     kernels four times per step, every parameter group moved;
     ``step_graph_check``: each captured loss within STEP_GRAPH_TOL
     of the eager one, each parameter and moment column after the last step
     within STEP_GRAPH_TOL of its largest |eager|). Then K3, K4 and K5 are
     held against their plain versions (K3 and K4 also against their own
     second runs, bit for bit; K5 bit for bit in both directions, its VJP
     launched on the unpadded cotangent as ``BlurValid.backward`` does) and
     timed on the bench step's own inputs, beside one-call library
     equivalents. The preprocess pair is held against its plain version on
     the trained leaves, the bench camera and K4's table gradient
     (``phase5_preprocess``: integer fields, visibility and the rect
     columns equal, the other float columns and fields within
     PREP_FLOAT_TOL of the plain value, every raw leaf's and the NDC
     offset's gradient within PREP_GRAD_TOL of the leaf's norm) and each
     direction timed beside its plain version and its byte bound;
     ``train_stages_ms`` splits the step and the ``graph:``
     line's profile lines give its device idle share. Each step's host
     syncs are counted (``torch.cuda.set_sync_debug_mode("warn")``).
  6. the training loop through the train CLI at 1920x1080, the operating
     point of ``configs/rehearsal_synthetic.yaml`` with its depth cut
     (``LOOP_SETS``): 24 orbit views of an 80k-splat GT scene rendered by
     the port, a COLMAP model with 20k noisy GT points, 600 steps with
     densify events at 200, 300 and 400, an opacity reset at 300, SH
     warm-up, validation and checkpoints at 300, and a start pair budget of
     half the init scene's estimate. Run 1 calls the CLI's ``main``
     in-process (step and event timers, host syncs, 20 steps profiled); run
     2 resumes its step-300 checkpoint through the module entry in a
     subprocess and must log the same losses. A ``train_loop:`` line holds
     the numbers (a quiet step's wall over LOOP_WINDOW, steps between two
     syncs: a captured step returns before the card has run it, so the
     host's time from one call to the next is its own); checks: finite
     losses, a budget growth and 0 dropped pairs at the last check, splats
     added at step 200, SH degree 3 in the final checkpoint, held-out PSNR
     1 dB above the init scene's, steps on no cadence and no capture syncing
     no more often than phase 5's bare step, every kernel launched. Then
     the CLI for 40 steps with the loss made NaN at step 30
     (``loop_rollback:``): one rollback to ckpt-00000020 on the captured
     step, finite losses after. The loop's step is the captured one (it
     captures at step 0 and on every SH degree step and budget change).
  7. the serving and evaluation CLIs in-process at 1920x1080, each with the
     launch counts set to 0 just before it: the scene generator (24 views of
     an 80k-splat ``clusters`` GT; 0 dropped pairs, the COLMAP model reads
     back), eval on phase 6's final PLY and held-out views (mean PSNR within
     0.1 dB of phase 6's step-600 validation, K1, K2 and K5 launched), a
     48-frame looped camera path with its GIF, the ``.splat`` export of
     phase 3's 1M-splat PLY (32 bytes per splat, records matching the PLY)
     and the view server on it; the oracle at 256x192 and the tiled route
     at 1080p against the kernel route (1e-4; neither launches a kernel),
     the tiled route's step gradients against the kernel route's, the render
     CLI's ``--use-oracle``, and ``profile_render`` at its default operating
     point (K1 and K2 in its 60-row table, a trace written). Eval also takes
     ``--lpips-weights`` (seeded random weights in the export layout):
     LPIPS per view and its time, LPIPS(x, x) = 0 exactly, and the card's
     LPIPS against the CPU's on one view at ``--downscale 0.25`` (1e-4
     relative). A ``serve:`` line holds the numbers.
  8. the view-batched step (``batch_views``) at full width: phase 5's scene
     and budget at 1920x1080 on the bench camera and phase 3's three orbit
     views, the first B of them for B in 1, 2, 4, BATCH_STEPS steps each (a
     ``train_step_batched:`` line each: host wall, CUDA-event time, ms per
     view, launches per step from ``torch.profiler``, K1-K4 and Adam once
     and the photometric kernels four times per step, 0 dropped pairs, peak
     memory). For each B the batched K1 and bins are identical to the plain version's per view, K2, K3 the
     bits of the single-view launches on each view and K4 within 1e-5 of
     its plain version at 1080p; K2 within 1e-4 and K3 within 1e-4 of their
     plain versions at 256x192 with 20k splats. The B = 4 step's gradients
     on route "cuda" are held to the mean of the four single-view steps'
     (1e-4 of each column's maximum), its screen-space gradients to the
     stacked single-view ones. Launches per step at B = 4 exceed B = 1's
     by at most BATCH_LAUNCH_GROWTH. A ``phase8:`` line holds the numbers.
     The timed steps are replays of the captured step; the eager step is
     timed beside them.
  9. the mesh (``parallel/``) at full width. (a) A 1x1 mesh on NCCL in this
     process: the captured sharded step (what ``Trainer(mesh=…)`` runs), the
     eager one (``capture=False``) and the captured one-process step,
     TRAIN_STEPS + 1 steps each from the same start on phase 5's bench view:
     the captured mesh step equal to the eager one bit for bit (every loss,
     the parameters, moments and statistics after the last step), one
     capture, K1-K4 and Adam once and K5 twice a replay, and within the
     mesh limits of the one-process step (first loss within 1e-5, Adam's
     first moments after step 0, (1 - beta1) times the gradients, within
     1e-4 of each column's largest |value|); each step timed (``mesh_1x1:``), then a
     ``graph:`` line of the captured mesh step against the eager one. (b)
     Four ranks sharing the card over gloo under
     ``torch.distributed.run`` (this script with ``--mesh-ranks``), meshes
     (1, 4) and (2, 2) on phase 8's first two views: each rank's sharded
     step against the one-process step on the same global batch (the same
     limits), 0 pairs dropped in every band (each band's ``num_pairs``
     printed), K1-K5 launched on every rank, on the (1, 4) mesh's bands 1
     and 3 (``tile_y_offset`` 9 and 27 at 1080p) every launch of the step
     held to its plain version on the same inputs (K1 identical, K2 within
     1e-4, K3 within 1e-4 and K4 within 1e-5 of each column's largest
     |plain|, K5 bit-identical both ways; ``band_kernels``), ``sharded_render``
     within 1e-4 of ``render_scene``, the wall per step (``mesh_rank`` lines, then
     ``mesh_ranks:``; four ranks sharing one card: not a scaling number).
     (c) After phase 7, the train CLI under torchrun with ``mesh_view=2,
     mesh_tile=2`` at phase 6's operating point cut to 60 steps (one
     densify event at threshold 0) against the one-process CLI at
     ``batch_views=2``: logged losses within 2e-4, the same alive counts
     (``mesh_cli_row:``). (d) The train CLI under torchrun with one rank,
     ``mesh_view=1, mesh_tile=1`` (a 1x1 NCCL mesh: the captured sharded
     step) with ``batch_views=2`` and exposure at (c)'s operating point,
     this script's ``--mesh-cli`` running the CLI's ``main`` on the rank
     with every graph's captures recorded (``record_loop``), against the
     one-process CLI with the same settings: logged losses within 2e-4, the
     same alive counts, 0 dropped pairs, the step and the exposure update
     captured at step 0, the steps' wall over a synced window
     (``mesh_nccl_cli_row:``).
  10. the measurement entry points, each a subprocess through its module
     entry (``python -m ...scripts.<name>``): the bench (its small and
     headline rungs, parity against the tiled route and the banded check;
     gates: the last line parses, the headline's pairs are BENCH_PAIRS and
     its budget 2,138,112, 0 dropped, finite rays/s, K1-K4 once and the
     photometric kernels four times a step, parity within the bench's
     1e-4, the banded check ok),
     ``bench_batched`` at its defaults (finite rows, 0 dropped) and
     ``benchmark_scaling --meshes 1x1,1x2`` (the 1x1 row on NCCL, 1x2
     skipped on one card, its eff columns null exactly when it dropped
     pairs or overflowed a tile). Then, in this process, one call of each
     entry point's work at the CLIs' sizes (the bench's small and headline
     rungs, its parity rung and banded check, bench_batched at B = 8) with
     every K1-K5 wrapper call recorded and held to its plain version on the
     same inputs (a ``bench_kernels:`` line; K1 and K5 identical, K2 and K3
     within 1e-4, K4 within 1e-5; K1-K4 called at least once on each path;
     the loss is the photometric kernels', so K5 need not be called). A
     ``phase10:`` line holds the numbers, with the headline's bound on the work its data needs
     (``counted_bound_ms``: the roofline's bytes, K2's and K3's evaluations
     up to each tile's early stop). The bench and ``bench_batched`` replay
     captured graphs; the kernel records run each path's work eagerly
     (``capture=False``), since a replay calls no wrapper. The headline's
     step is also timed in this process captured and eager, with the
     device's busy time and idle share.
  11. (``--cards 4`` only) the mesh on four cards, one NCCL rank per card,
     each part a ``torch.distributed.run`` job with a time limit (a rank
     that takes another decision hangs its job, which then fails). (a) The
     bench scene of phases 5 and 8 on phase 3's four views at 1920x1080,
     meshes (1, 4), (2, 2) and (4, 1) (this script with ``--mesh4-steps``):
     first the per-band budget (``band_tiling``: ``pair_budget``'s
     2,523,136 over the band count) with each band's pairs and drops, grown
     as the ``Trainer`` grows it while a band drops; then TRAIN_STEPS + 1
     steps captured and as many with ``capture=False`` from the same start:
     equal bit for bit on every rank (losses, parameters, the rank's ZeRO-1
     Adam rows, statistics), the same scene on every rank, one capture,
     K1-K4 and Adam once and K5 twice a replay, the first loss within 1e-5
     and the gradients within 1e-4 of the one-process step on the same four
     views, 0 pairs dropped; bands 1 and 3 of (1, 4) hold every K1-K5 call to its
     plain version (``BAND_TOL``); per rank the wall per step (synced; each
     step the slowest rank's), CUDA-event ms, device busy and idle share
     (NCCL's kernel time apart: it overlaps the compute), capture seconds
     and peak memory above what was held, beside the captured one-process
     step's wall on the four views (``mesh4_rank`` lines, ``mesh4_steps:``). (b) The train CLI on (2, 2) and (1, 4)
     (``--mesh4-cli``) at phase 6's point cut to 80 steps (MESH4_CLI_SETS:
     densify at 20 and 40, the opacity reset at 50, SH steps at 25, 50, 75,
     a budget check every 10 steps, checkpoints at 50 and 80): after every
     event, checkpoint, restore and at the end a digest of each rank's
     scene, all-gathered and equal; every rank capturing at the same steps;
     logged losses within 2e-4 and alive counts equal to the one-process
     CLI's at the same global batch; then (2, 2)'s step-50 checkpoint
     resumed on four ranks (losses within 1e-6 of the uninterrupted run)
     and in one process (2e-4) (``mesh4_cli_row``, ``mesh4_cli_resume:``).
     (c) ``benchmark_scaling --meshes 1x1,1x2,1x4,2x2`` on the cards (no
     shared card; eff columns null exactly when a row or the first drops)
     and ``scripts/dryrun_multichip.py`` on four NCCL ranks (its three OK
     lines; ``mesh4_scaling:``). Then each card's name and power limit.
     Without ``--cards 4`` one line says that phase 11 was not run.
  12. (after phase 5, on its scene, camera, budget and seeded target at
     1920x1080 with 32 px tiles) the rasterizer's precomputed inputs and
     scale modifier, and K5 at every window. (a) The derived render against
     the render given ``colors_precomp`` and ``cov3d_precomp`` derived from
     the same leaves (``sh_to_rgb``, ``build_cov3d``) beside junk SH (x 100
     + 3) and scales (x 7): image, depth, radii and stats identical, the L1
     gradient on the means and opacities within PRECOMP_TOL of the derived
     one's largest |value| (their bits printed), K1-K4 launched once each.
     (b) ``scale_modifier=0.5`` against scales x 0.5: identical renders. (c)
     Route "cuda" against "plain" with the tables as leaves: the image within
     K2_TOL, the gradients of <cotangent, render> (a seeded cotangent on
     image and depth) on both tables within K3_TOL of each column's largest
     |plain|. (d) K5 at each window of ``ssim.KERNEL_WINDOWS`` (sigma 1.5)
     and at window 7 with sigma 2.5 on the SSIM stack of (a)'s render
     (15, 1080 + w - 1, 1920 + w - 1): forward and VJP (on the unpadded
     cotangent) bit-identical to the plain version, each timed by CUDA
     events beside its byte bound; ``ssim`` at window 7 on the card equal to
     the plain version. A ``phase12:`` line holds the numbers.
  13. (after phase 12) Adam's kernel (``csrc/adam.cu``) alone at 1M and 3M
     splats, SH degree 3, dense: one in-place update from a seeded state
     against ``_adam_plain`` from the same state (every bit of p, m and v
     equal, one launch), then CUDA-event ms of the kernel, of the plain
     version's 84 launches and of ``torch.optim.Adam(fused=True)`` over the
     same six tensors (``library_ms``: a yardstick the port never calls),
     beside the byte bound (7 floats of 4 bytes a parameter, 1,652 B a
     splat). A ``phase13:`` line holds the numbers; the kernels' record
     gets an ``adam`` row with them (at 3M, and per size under ``sizes``).
  14. (after phase 13) the photometric loss's kernels (``csrc/photometric.cu``)
     alone on a seeded 1920x1080 RGB view (a fifth of its pixels equal to
     the target's): three launches forward and one backward; the four logs
     within PHOT_VALUE_TOL relatively and pred's gradient within
     PHOT_GRAD_TOL of its largest |value| of the composition
     (``plain=True``), the same bits on a second call; then the kernels'
     device ms forward (the derivative maps written) and backward
     (``torch.profiler``; an eager call's CUDA-event ms beside them), the
     composition's CUDA-event ms with K5 as the step ran it before
     (``plain_ms``), and the byte bound (pred and target read three times,
     the three derivative maps of each channel written and read, the
     gradient written: 52 bytes a pixel and channel). A ``phase14:`` line holds the numbers; the
     kernels' record gets a ``photometric`` row with them.

Phases 3, 5, 8 and 10 print a ``graph:`` line: the capture's seconds, and
for the captured and the eager path each the host wall and CUDA-event ms a
call, the device's busy ms and idle share (``torch.profiler``), its kernels
per call, the K1-K5 launches per call and the peak memory above what was
allocated before the first call (a capture's included). Phases 6, 7 and 8
run the captured path through the CLIs and ``make_train_step``, as users
run them.

Phase 6 also runs the train CLI with ``train.batch_views=4`` and exposure
for BATCHED_LOOP_STEPS steps across one densify event (a
``train_loop_batched:`` line: quiet-step wall and idle share, host syncs
per quiet step no more than the single-view loop's, view counts within 4
per step, finite losses, held-out PSNR above the init scene's).

Phases 3 and 6 keep their PLYs and scene in one temporary directory for
phase 7. The card's name and power limit come two lines before the last, the
kernels' JSON record (``max_abs_err`` is the largest |kernel - plain| over
the kernel's outputs; K1's outputs are integers; ``serve_launches`` holds
each phase-7 CLI's launches, ``batched_launches`` phase 8's per B,
``mesh_launches`` phase 9's over the 1x1 mesh's TRAIN_STEPS timed replays
and on each rank's first step of the (1, 4) and (2, 2) meshes,
``bench_launches`` phase 10's bench headline's per step,
``bench_err`` each phase-10 entry path's errors (null for the preprocess
pair, which neither the mesh nor the bench runs), and the ``blur`` row's
``windows`` phase 12's K5 rows per window)
on the line before the last, and
``{"ok": true, "device": {...}}`` last. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "gaussian_splatting_lightning_tpu_torch"
sys.path.insert(0, str(ROOT))

# the card's peaks and K2's operations per evaluation up to the kill
# decision, shared with the bench's roofline
from gaussian_splatting_lightning_tpu_torch.scripts.bench import (  # noqa: E402
    F32_FLOPS,
    HBM_BYTES_PER_S,
    K2_OPS_TO_KILL,
    PARITY_TOL,
    gpu_line,
    roofline_work,
)

BENCH_PAIRS = 2_094_637  # rect pairs of the bench scene at the bench camera
K2_TOL = 1e-4
F32_ISSUE = F32_FLOPS / 2  # f32 instructions per second, FMA or not
# a K2 evaluation that passes the kill adds the T test, w = alpha T, four
# FMA (8 flops), 1 - alpha and T (1 - alpha) (12 flops in 8 instructions)
K2_FLOPS_KEPT, K2_INSTR_KEPT = 12, 8
# K3 evaluates exactly the (pair, pixel) set K2 did, with K2's chain up to
# the kill decision; an evaluation that passes it adds the T test and
# w = alpha T (2), E = G . rgbz (7), prefix (2), suffix, 1 - alpha, E T,
# the divide and d_alpha (5), the clamp test and d_power (2), five moment
# products, four G w products and the T update (10), and one add into each
# of the ten pixel sums (10): 38 f32 operations
K3_FLOPS_KEPT = 38
# tolerances of the kernels against their plain versions, each a share of
# the largest |plain| of that output column: K3's per-pixel terms are
# rounded like the plain version's, its sums over up to 1024 pixels run in
# another order and the position rows cancel; K4 sums a few rows in another
# order. K5 rounds every product and sum in the plain version's order and
# must give its bits.
K3_TOL, K4_TOL = 1e-4, 1e-5
STEP_GRAD_TOL = 1e-4  # route "cuda" against "plain", share of each group's max
# captured steps against eager ones: each loss relative, each parameter and
# moment column after the last step as a share of its largest |eager|; the
# autograd of gathers and index_add_ add with atomics, so the last bit may
# differ from run to run
STEP_GRAPH_TOL = 1e-6
TRAIN_STEPS = 10
# the kernels of ``rasterize`` on activated tensors, which composes its
# preprocess (``scripts/profile_render.py``, ``scripts/bench.py``), and of a
# scene render on route "cuda" (``render_scene``), whose preprocess is the
# kernel pair's forward (``ops/preprocess.py``)
RASTER_KERNELS = ("expand_pairs", "composite_fwd")
RENDER_KERNELS = ("preprocess_fwd",) + RASTER_KERNELS
# the preprocess pair against its plain version at the bench step's size:
# float columns and fields relative to the plain value (both round every
# operation in the same order; cull_r2's log an ulp or two apart), each
# gradient as a share of its leaf's norm (the backward sums in another order)
PREP_FLOAT_TOL = 1e-6
PREP_GRAD_TOL = 1e-5
# the mesh step's kernels: its sharded preprocess composes the activations,
# so the preprocess kernel pair (ops/preprocess.py) never runs there
MESH_KERNELS = ("expand_pairs", "composite_fwd", "composite_bwd", "segment_sum", "blur")


def launched_kernels(launches: dict) -> dict:
    """The kernels that ran, with their counts (the composed paths, as the
    bench's and the mesh's, launch no preprocess kernel)."""
    return {k: n for k, n in launches.items() if n}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (after one warm-up)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def count_syncs():
    """Record the host syncs of the CUDA work inside the block: under
    ``torch.cuda.set_sync_debug_mode("warn")`` each one warns. Yields the
    list of caught warnings; ``n_syncs`` counts the syncs among them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode("default")


def n_syncs(caught) -> int:
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_render(render, wall_ms: float, reps: int = 5, unit: str = "render"):
    """Print the device's busy time per call of ``render`` from
    torch.profiler, its idle share of ``wall_ms`` (the call's time without
    the profiler), and the device time of the heaviest kernels; returns
    those numbers and every kernel's launches per call, or None when the
    profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            render()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        print("profile: device time not measured (the profiler saw no device "
              "activity)", flush=True)
        return
    rows.sort(key=lambda r: -r[1])
    nccl = [r for r in rows if "nccl" in r[0].lower()]
    row = {
        f"wall_ms_per_{unit}": wall_ms, f"device_busy_ms_per_{unit}": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        f"device_kernels_per_{unit}": sum(r[2] for r in rows),
        "top_kernels_ms": [[k[:80], ms, n] for k, ms, n in rows[:12]],
        # collectives: NCCL's kernels run on a stream of their own and wait
        # in the kernel for the slowest rank, so they overlap the compute
        f"device_nccl_ms_per_{unit}": sum(r[1] for r in nccl),
        "nccl_kernels_ms": [[k[:60], ms, n] for k, ms, n in nccl],
    }
    print("profile: " + json.dumps(row), flush=True)
    counts = {}
    for k, _, n in rows:
        counts[k] = counts.get(k, 0) + n
    return dict(row, launches_by_kernel=counts)


def wall_and_events(fn, reps: int):
    """(host wall ms, CUDA-event ms) per call of ``fn`` over ``reps`` calls
    in a row, synchronised at the end only."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, start.elapsed_time(end) / reps


def graph_side(fn, reps: int, unit: str, peak: int, kernel_launches: dict) -> dict:
    """One side of a ``graph:`` line: host wall and CUDA-event ms per call,
    the device's busy ms and idle share and its kernels per call from
    ``torch.profiler`` (a ``profile`` line), the K1-K5 launches per call, and
    ``peak``: the peak memory of the side's first calls (a capture's
    included) above what was allocated before them."""
    wall, event = wall_and_events(fn, reps)
    prof = profile_render(fn, wall, reps=3, unit=unit) or {}
    return {"wall_ms": wall, "event_ms": event,
            "busy_ms": prof.get(f"device_busy_ms_per_{unit}"),
            "idle_share": prof.get("device_idle_share"),
            "nccl_ms": prof.get(f"device_nccl_ms_per_{unit}"),
            "nccl_kernels_ms": prof.get("nccl_kernels_ms"),
            "device_launches": prof.get(f"device_kernels_per_{unit}"),
            "kernel_launches": kernel_launches, "peak_mem_added_bytes": peak}


def print_graph_line(phase: str, capture_s: float, captured: dict, eager: dict,
                     **extra) -> dict:
    row = dict({"phase": phase, "capture_s": capture_s, "captured": captured,
                "eager": eager}, **extra)
    print("graph: " + json.dumps(row), flush=True)
    return row


def probe():
    import torch

    from gaussian_splatting_lightning_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    release = re.search(r"release ([0-9.]+)", nvcc)
    print(f"probe: gpu={gpu_line()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvcc={release.group(1) if release else '?'}",
          flush=True)
    t0 = time.perf_counter()
    per = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for all kernels "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per.items())})", flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")


def _prep(scene, cam, w, h):
    """The composed preprocess: the plain version of the kernel pair's
    forward, and the mesh's and ``rasterize``'s own on activated tensors."""
    from gaussian_splatting_lightning_tpu_torch.ops.common import preprocess

    return preprocess(
        scene.params.xyz, scene.get_opacity(), scene.get_scales(),
        scene.get_rotation(), scene.get_features(), cam, w, h,
        scene.active_sh_degree, scene.max_sh_degree, alive=scene.alive,
    )


def warp_work(gfeat, bins, evals, gx, blk):
    """(pair, warp) evaluations of K2 and K3 and their cull: every pair a
    tile composites (up to its early stop, ``evals`` per tile) against each
    warp's 16x8 patch; how many of those the plain mirror of the kernels'
    cull box skips, and how many the 16 px rect alone would skip (0 at
    16 px tiles, which have no rect)."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.ops import rasterize

    n_tiles = bins.tile_count.shape[0]
    tile = torch.repeat_interleave(torch.arange(n_tiles, device="cuda"),
                                   bins.tile_count.long())
    first = torch.cumsum(bins.tile_count.long(), 0) - bins.tile_count.long()
    pos = torch.arange(tile.shape[0], device="cuda") - first[tile]
    composited = pos < evals[tile]
    tile, pos = tile[composited], pos[composited]
    rows = gfeat[bins.gauss_s[bins.tile_start[tile].long() + pos].long()]
    box = rasterize.pair_cull_box(rows, blk)
    cols = blk // rasterize.PATCH_W
    warp = torch.arange(blk * blk // (rasterize.PATCH_W * rasterize.PATCH_H), device="cuda")
    x0 = ((tile % gx) * blk)[:, None] + (warp % cols * rasterize.PATCH_W)[None]
    y0 = ((tile // gx) * blk)[:, None] + (warp // cols * rasterize.PATCH_H)[None]
    culled = rasterize.patch_culled(box[:, None, :], x0.float(), y0.float())
    rect_only = 0
    if blk != 16:
        sx, sy = (x0 // 16).float(), (y0 // 16).float()
        x_lo, x_hi, y_lo, y_hi = (rows[:, i:i + 1] for i in (
            rasterize.F_X0, rasterize.F_X1, rasterize.F_Y0, rasterize.F_Y1))
        outside = (sx < x_lo) | (sx >= x_hi) | (sy < y_lo) | (sy >= y_hi)
        rect_only = int(outside.sum())
    return culled.numel(), int(culled.sum()), rect_only


def compare_kernels(prep, w, h, blk, max_pairs, bg):
    """K1 and K2 against their plain versions on one view's inputs.

    Returns (k1_diff, k2_diff, ctx): the max |kernel - plain| of K1's
    (key, gauss) and of K2's output; ctx holds the inputs for timing."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.ops import binning, rasterize

    gx, gy = binning.grid_shape(w, h, blk, blk)
    n_tiles = gx * gy
    inp, _ = binning.expand_inputs(prep, gx, gy, 0, gy, blk)
    key_k, gauss_k = binning.expand_pairs(inp, max_pairs, gx, n_tiles, 0, blk)
    key_p, gauss_p = binning.expand_pairs_plain(inp, max_pairs, gx, n_tiles, 0, blk)
    torch.cuda.synchronize()
    k1_diff = max(int((key_k.long() - key_p.long()).abs().max()),
                  int((gauss_k.long() - gauss_p.long()).abs().max()))

    bins_k = binning.build_sorted_bins(prep, gx, gy, max_pairs, block=blk)
    bins_p = binning.build_sorted_bins(prep, gx, gy, max_pairs, block=blk, plain=True)
    for name, a, b in zip(bins_k._fields, bins_k, bins_p):
        if not torch.equal(a, b):
            fail(f"K1 block {blk}: build_sorted_bins field {name} differs "
                 "from the plain version's")

    gfeat = rasterize.feature_table(prep, w, h, blk)
    args = (gfeat, bins_k.gauss_s, bins_k.tile_start, bins_k.tile_count, bg, gx, blk)
    out_k = rasterize.composite_fwd(*args)
    out_again = rasterize.composite_fwd(*args)
    out_p, evals, kept = rasterize.composite_fwd_plain(*args, return_work=True)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out_k).all()):
        fail(f"K2 block {blk}: non-finite output")
    if not torch.equal(out_k, out_again):
        fail(f"K2 block {blk}: a second run gave other bits")
    k2_diff = float((out_k - out_p).abs().max())
    ctx = dict(inp=inp, max_pairs=max_pairs, gx=gx, n_tiles=n_tiles, blk=blk,
               args=args, bins=bins_k, evals=evals, kept=kept, n=prep.depth.shape[0])
    return k1_diff, k2_diff, ctx


def phase2():
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.ops import _build

    w, h = 256, 192
    scene = interop.synthetic_scene(20_000, 20_000, aniso=True, scale=0.01)
    cam = interop.camera(w, h)
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    prep = _prep(scene, cam, w, h)
    _build.reset_launch_counts()
    rows = []
    for blk in (16, 32):
        k1, k2, ctx = compare_kernels(prep, w, h, blk, 1 << 18, bg)
        rows.append({"block": blk, "pairs": int(ctx["bins"].tile_count.sum()),
                     "k1_max_abs_err": k1, "k2_max_abs_err": k2})
        if k1 != 0:
            fail(f"K1 block {blk}: (key, gauss) differ from the plain version's "
                 f"by up to {k1}")
        if not k2 <= K2_TOL:
            fail(f"K2 block {blk}: max |kernel - plain| = {k2} > {K2_TOL}")
    print("phase2_kernels: " + json.dumps(
        {"launches": dict(_build.launches), "checks": rows}), flush=True)


ORBIT = ((35.0, 0.0), (-60.0, 15.0), (150.0, -20.0))  # phase 3's three views


def orbit_poses(angles=ORBIT):
    """(3, 4) world-to-camera poses 4 units from the origin, looking at it:
    the bench camera's (identity rotation) and one per (yaw, pitch)."""
    import numpy as np

    def rot(yaw, pitch):
        a, b = math.radians(yaw), math.radians(pitch)
        ry = np.array([[math.cos(a), 0, -math.sin(a)], [0, 1, 0],
                       [math.sin(a), 0, math.cos(a)]])
        rx = np.array([[1, 0, 0], [0, math.cos(b), -math.sin(b)],
                       [0, math.sin(b), math.cos(b)]])
        return rx @ ry

    t = np.array([[0.0], [0.0], [4.0]])
    return [np.concatenate([np.eye(3), t], 1)] + [
        np.concatenate([rot(yaw, pitch), t], 1) for yaw, pitch in angles]


def orbit_cameras(w, h, angles=ORBIT):
    """The bench camera (``interop.camera``) and the views on its orbit."""
    from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera

    focal = w * 0.7
    return [make_camera(pose, focal, focal, w, h) for pose in orbit_poses(angles)]


def phase3(work: Path):
    """The render main path; the bench PLY stays in ``work`` for phase 7."""
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.models import load_ply, save_ply
    from gaussian_splatting_lightning_tpu_torch.ops import _build, binning, rasterize
    from gaussian_splatting_lightning_tpu_torch.ops.binning import expand_pairs, expand_pairs_plain
    from gaussian_splatting_lightning_tpu_torch.ops.budget import estimate_pairs, pair_budget
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.ops.preprocess import preprocess_scene
    from gaussian_splatting_lightning_tpu_torch.training.trainer import make_render, render_scene

    w, h, blk = 1920, 1080, 32
    made = interop.synthetic_scene(1_000_000, 1_000_000, sh_degree=3, scale=0.008)
    path = work / "bench_scene.ply"
    t0 = time.perf_counter()
    save_ply(made, path)
    scene = load_ply(path)
    print(f"ply round trip: {os.path.getsize(path)} bytes in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in ("xyz", "features_dc", "features_rest", "opacity", "scales", "quats"):
        if not torch.equal(getattr(made.params, name), getattr(scene.params, name)):
            fail(f"PLY round trip changed {name}")
    del made

    cams = orbit_cameras(w, h)
    est = estimate_pairs(scene, cams[0], w, h, blk)
    if est != BENCH_PAIRS:
        fail(f"estimate_pairs = {est}, expected {BENCH_PAIRS}")
    budget = pair_budget(scene, cams, w, h, blk)
    tiling = TilingConfig(max_pairs=budget, block=blk)
    bg = torch.zeros(3, device="cuda")
    print(f"main path: estimate_pairs(bench view) = {est}, pair_budget = {budget}",
          flush=True)

    for cam in cams:  # warm-up: library load, allocator, cuBLAS/cub state
        render_scene(scene, cam, w, h, bg, tiling)
    torch.cuda.synchronize()

    # eager renders: the reference of the captured ones, and their times
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    eager = []
    for cam in cams:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out, stats = render_scene(scene, cam, w, h, bg, tiling)
        torch.cuda.synchronize()
        eager.append((out, {k: int(v) for k, v in stats.items()},
                      (time.perf_counter() - t0) * 1e3))
    eager_peak = torch.cuda.max_memory_allocated() - held

    # the main path: the serving render, captured on its first call and
    # replayed on every view, held bit for bit to the eager render
    render = make_render(w, h, tiling)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    per_view = []
    for i, cam in enumerate(cams):
        before = dict(_build.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = render(scene, cam, bg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: _build.launches[k] - before[k] for k in RENDER_KERNELS}
        ref, ref_stats, eager_ms = eager[i]
        same = {f: torch.equal(getattr(out, f), getattr(ref, f))
                for f in ("image", "radii", "depth")}
        same["num_pairs"] = int(stats["num_pairs"]) == ref_stats["num_pairs"]
        row = {"view": i, "ms": ms, "eager_ms": eager_ms}
        row.update({k: int(v) for k, v in stats.items()
                    if k in ("num_pairs", "num_binned_pairs", "num_dropped_pairs")})
        row["launches"] = launched
        row["bits_equal_eager"] = same
        per_view.append(row)
        print("view: " + json.dumps(row), flush=True)
        if not all(same.values()):
            fail(f"view {i}: the captured render differs from the eager render: {same}")
        img = out.image
        if tuple(img.shape) != (3, h, w) or tuple(out.depth.shape) != (1, h, w):
            fail(f"view {i}: image {tuple(img.shape)} depth {tuple(out.depth.shape)}")
        if not (bool(torch.isfinite(img).all()) and bool(torch.isfinite(out.depth).all())):
            fail(f"view {i}: non-finite output")
        covered = float((img.abs().amax(dim=0) > 1e-3).float().mean())
        if covered < 0.05:
            fail(f"view {i}: only {covered:.3f} of pixels differ from the background")
        if row["num_dropped_pairs"] != 0:
            fail(f"view {i}: {row['num_dropped_pairs']} pairs dropped")
        if any(v < 1 for v in launched.values()):
            fail(f"view {i}: a kernel was not launched: {launched}")
    replay_peak = torch.cuda.max_memory_allocated() - held
    launches = {k: _build.launches[k] for k in RENDER_KERNELS}
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    dev_pairs = per_view[0]["num_pairs"]
    rel = abs(dev_pairs - BENCH_PAIRS) / BENCH_PAIRS
    print(f"bench view: device num_pairs {dev_pairs} vs {BENCH_PAIRS} "
          f"(difference {dev_pairs - BENCH_PAIRS}, {rel:.2e} relative)", flush=True)
    if rel > 1e-4:
        fail("device num_pairs is more than 0.01% off the host estimate")

    # each kernel against its plain version, and timed, on the bench view's
    # inputs: the preprocess as the render runs it, the kernel pair's forward
    with torch.no_grad():
        prep, _ = preprocess_scene(scene, cams[0], w, h, blk)
    k1, k2, ctx = compare_kernels(prep, w, h, blk, -(-budget // 128) * 128, bg)
    if k1 != 0:
        fail(f"K1 at 1080p: (key, gauss) differ from the plain version's by up to {k1}")
    if not k2 <= K2_TOL:
        fail(f"K2 at 1080p: max |kernel - plain| = {k2} > {K2_TOL}")
    inp, m = ctx["inp"], ctx["max_pairs"]
    k1_args = (inp, m, ctx["gx"], ctx["n_tiles"], 0, blk)
    k1_ms = cuda_time_ms(lambda: expand_pairs(*k1_args), 20)
    k1_plain_ms = cuda_time_ms(lambda: expand_pairs_plain(*k1_args), 5)
    # K1 reads each of its inputs once: per splat its offset, its order entry,
    # its row (x0, nx, y0, cull_r2) and its mean (4 + 4 + 16 + 8 bytes), and
    # the total (4 bytes); it writes each slot's key and gauss id (8 bytes)
    k1_bytes = sum(t.numel() * t.element_size() for t in inp) + m * 4 * 2
    k2_ms = cuda_time_ms(lambda: rasterize.composite_fwd(*ctx["args"]), 10)
    k2_plain_ms = cuda_time_ms(lambda: rasterize.composite_fwd_plain(*ctx["args"]), 1)
    binned = int(ctx["bins"].tile_count.sum())
    pix = blk * blk
    k2_bytes = ctx["n"] * 16 * 4 + binned * 4 + ctx["n_tiles"] * (8 + 4 * pix * 4) + 12
    evals = int(ctx["evals"].sum()) * pix
    kept = int(ctx["kept"].sum())
    k2_flops = evals * K2_OPS_TO_KILL[blk] + kept * K2_FLOPS_KEPT
    k2_bound = {"bytes": k2_bytes / HBM_BYTES_PER_S, "operations": k2_flops / F32_FLOPS}
    k2_by = max(k2_bound, key=k2_bound.get)
    # what a pixel-per-thread design without cull can reach: its kill chain
    # is rounded op by op, so only the four sums fuse, and each instruction
    # takes an issue slot
    k2_issue_ms = (evals * K2_OPS_TO_KILL[blk] + kept * K2_INSTR_KEPT) / F32_ISSUE * 1e3
    warps, culled, by_rect = warp_work(ctx["args"][0], ctx["bins"], ctx["evals"], ctx["gx"], blk)
    print(f"K2 work: {binned} binned pairs, {evals} pair-pixel evaluations "
          f"after early stop, {kept} of them past the kill, {k2_flops} flops, "
          f"{k2_bytes} bytes; f32 issue floor of a pixel-per-thread design without cull "
          f"{k2_issue_ms:.4f} ms; "
          f"{warps} (pair, warp) evaluations, {culled} of them skipped by the cull "
          f"({culled / max(warps, 1):.4f}), {by_rect} by the 16 px rect alone", flush=True)

    # where one bench-view render's time goes: each stage run alone (event
    # time, launch gaps included), then the device's busy share under the
    # profiler
    gx, gy = binning.grid_shape(w, h, blk, blk)
    stages = {
        "render_scene": cuda_time_ms(
            lambda: render_scene(scene, cams[0], w, h, bg, tiling), 10),
        "preprocess (the pair's forward, preprocess_scene)": cuda_time_ms(
            torch.no_grad()(lambda: preprocess_scene(scene, cams[0], w, h, blk)), 10),
        "preprocess, composed (its plain version, no table)": cuda_time_ms(
            lambda: _prep(scene, cams[0], w, h), 10),
        "build_sorted_bins": cuda_time_ms(
            lambda: binning.build_sorted_bins(prep, gx, gy, m, block=blk), 10),
        "expand_inputs (inside build_sorted_bins)": cuda_time_ms(
            lambda: binning.expand_inputs(prep, gx, gy, 0, gy, blk), 10),
        "expand_pairs (K1, inside build_sorted_bins)": k1_ms,
        "feature_table (plain version's; the pair's forward writes it)": cuda_time_ms(
            lambda: rasterize.feature_table(prep, w, h, blk), 10),
        "composite_fwd (K2)": k2_ms,
    }
    print("stages_ms: " + json.dumps(stages), flush=True)
    del eager
    eager_render = make_render(w, h, tiling, capture=False)
    per_render = {k: 1 for k in RENDER_KERNELS}
    print_graph_line(
        "3 render", render.captured.capture_s,
        graph_side(lambda: render(scene, cams[0], bg), 20, "render", replay_peak, per_render),
        graph_side(lambda: eager_render(scene, cams[0], bg), 20, "render", eager_peak,
                   per_render),
        bits_equal_eager=True)
    # K1's inputs alone: the device time of the tile rects and rows, the depth
    # sort and the slot offsets, apart from the host's launch gaps that the events include
    profile_render(lambda: binning.expand_inputs(prep, gx, gy, 0, gy, blk),
                   stages["expand_inputs (inside build_sorted_bins)"], unit="expand_inputs")
    return scene, budget, path, [
        {"name": "expand_pairs", "route": "cuda",
         "source": f"{PKG}/csrc/expand_pairs.cu",
         "replaces": "gaussian_splatting_lightning_tpu/ops/binning.py:174",
         "launches": launches["expand_pairs"], "max_abs_err": float(k1),
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         # no one PyTorch call computes the culled tile key of a slot:
         # torch.repeat_interleave gives only its owner
         "library_ms": None},
        {"name": "composite_fwd", "route": "cuda",
         "source": f"{PKG}/csrc/composite_fwd.cu",
         "replaces": "gaussian_splatting_lightning_tpu/ops/rasterize_pallas.py:138",
         "launches": launches["composite_fwd"], "max_abs_err": k2,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[k2_by] * 1e3, "bound_by": k2_by,
         "library_ms": None},
    ]


def phase4():
    """The render CLI end to end on a COLMAP scene the port writes."""
    import numpy as np
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera
    from gaussian_splatting_lightning_tpu_torch.data import colmap, image_io
    from gaussian_splatting_lightning_tpu_torch.models import save_ply
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import render_scene

    w, h, f = 160, 120, 112.0
    scene = interop.synthetic_scene(3000, 3000, aniso=True, scale=0.03, seed=5)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "images").mkdir()
        pose = np.array([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4]])
        cam = make_camera(pose, f, f, w, h)
        ref, _ = render_scene(scene, cam, w, h, torch.zeros(3, device="cuda"),
                              TilingConfig(max_pairs=1 << 16))
        gt = (np.moveaxis(ref.image.clamp(0, 1).cpu().numpy(), 0, -1) * 255 + 0.5)
        image_io.write_image(root / "images" / "view.png", gt.astype(np.uint8))
        colmap.write_reconstruction(
            root / "sparse" / "0", cameras={1: (w, h, f, f, w / 2, h / 2)},
            images={1: (np.array([1.0, 0, 0, 0]), pose[:, 3], 1, "view.png")},
        )
        save_ply(scene, root / "ckpt.ply")
        out = root / "triptych.png"
        cmd = [sys.executable, "-m", f"{PKG}.scripts.render", str(root / "ckpt.ply"),
               "--colmap", str(root), "--image-folder", str(root / "images"),
               "--out", str(out), "--device", "cuda"]
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        print("cli: " + " | ".join(res.stdout.strip().splitlines()), flush=True)
        if res.returncode != 0:
            fail(f"render CLI exited {res.returncode}: {res.stderr[-2000:]}")
        trip = image_io.read_image(out)
    if trip.shape != (h, 3 * w, 3):
        fail(f"CLI triptych has shape {trip.shape}")
    render = trip[:, w:2 * w].astype(np.int32)
    worst = int(np.abs(render - gt.astype(np.uint8).astype(np.int32)).max())
    print(f"cli: triptych {trip.shape}, render panel vs in-process render: "
          f"max {worst} levels of 255", flush=True)
    if worst > 1:
        fail("CLI render differs from the in-process render")


def col_err(kernel, plain) -> float:
    """Largest |kernel - plain| of any column over that column's largest
    |plain|."""
    scale = plain.abs().amax(dim=0).clamp_min(1e-30)
    return float(((kernel - plain).abs().amax(dim=0) / scale).max())


def copy_scene(scene):
    """A copy of ``scene`` for a train step to donate (the step writes its
    results into the tensors it is given)."""
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES

    return dataclasses.replace(
        scene, params=type(scene.params)(**{k: getattr(scene.params, k).clone()
                                            for k in PARAM_NAMES}),
        **{k: getattr(scene, k).clone()
           for k in ("alive", "max_radii2d", "grad_accum", "grad_count")})


def check_step_routes():
    """The whole step's gradients at 256x192 with 20k splats: route "cuda"
    (every kernel) against route "plain" (every plain version)."""
    import numpy as np
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training import trainer

    w, h = 256, 192
    scene = interop.synthetic_scene(20_000, 20_000, aniso=True, scale=0.01)
    cam = interop.camera(w, h)
    target = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(3, h, w)).astype(np.float32)).cuda()
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    grads = {}
    for route in ("cuda", "plain"):
        cfg = trainer.TrainConfig(rasterizer=route,
                                  tiling=TilingConfig(max_pairs=1 << 18, block=32))
        g, screen, _, _, logs, _ = trainer.step_gradients(cfg, scene, cam, w, h, target, bg)
        grads[route] = {k: getattr(g, k) for k in PARAM_NAMES}
        grads[route]["means2d_ndc_offset"] = screen
        grads[route]["loss"] = logs["loss"].reshape(1)
    errs = {}
    for k, b in grads["plain"].items():
        a = grads["cuda"][k]
        scale = float(b.abs().max())
        errs[k] = float((a - b).abs().max()) / scale if scale > 0 else float(a.abs().max())
    print("step_routes: " + json.dumps({"tolerance": STEP_GRAD_TOL, "rel_err": errs}),
          flush=True)
    bad = {k: v for k, v in errs.items() if not v <= STEP_GRAD_TOL}
    if bad:
        fail(f"step gradients on route cuda differ from route plain: {bad}")


def preprocess_pair(scene, cam, w, h, blk, g_table, launches):
    """The preprocess kernel pair against its plain version (the composed
    activations, ``preprocess`` and ``feature_table`` under autograd) on
    the bench step's size: the same raw leaves, zero NDC offset and camera,
    and ``g_table`` (K4's table gradient, which feeds only the rows the view
    sees) as the table's cotangent. Integer fields, visibility and the rect
    columns equal; the other table columns, p_pix, depth and cull_r2 within
    PREP_FLOAT_TOL of the plain value; every raw leaf's and the offset's
    gradient within PREP_GRAD_TOL of the leaf's norm; one launch of each
    kernel. Then each direction is timed beside its plain version (both
    under autograd, as the step runs them) and its byte bound. Returns the
    two rows of the ``kernels`` line."""
    import dataclasses
    import types

    import torch

    from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
        PARAM_NAMES,
        GaussianParams,
    )
    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.ops.preprocess import (
        PreprocessKernels,
        _camera_arrays,
        preprocess_scene,
        preprocess_scene_plain,
    )

    def run(fn):
        leaves = {k: getattr(scene.params, k).detach().requires_grad_() for k in PARAM_NAMES}
        live = dataclasses.replace(scene, params=GaussianParams(**leaves))
        off = torch.zeros(scene.capacity, 2, device=scene.device, requires_grad=True)
        prep, table = fn(live, cam, w, h, blk, False, off)
        inputs = list(leaves.values()) + [off]
        grads = torch.autograd.grad(table, inputs, g_table, retain_graph=True)
        return live, off, inputs, prep, table, dict(zip(list(PARAM_NAMES) + ["offset"], grads))

    def equal(a, b):  # NaN where both have it
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

    def rel(a, b):  # largest |a - b| / |b| over the finite b; inf if the NaNs differ
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return math.inf
        fin = torch.isfinite(b)
        d = (a - b)[fin].abs()
        return float((d / b[fin].abs().clamp_min(1e-30)).max()) if d.numel() else 0.0

    def of_norm(a, b):  # largest |a - b| over the leaf's norm, finite elements
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return math.inf
        fin = torch.isfinite(b)
        return float((a - b)[fin].abs().max() / b[fin].norm().clamp_min(1e-30))

    torch.cuda.synchronize()
    before = dict(_build.launches)
    live, off, inputs, pk, tk, gk = run(preprocess_scene)
    torch.cuda.synchronize()
    ran = {k: _build.launches[k] - before[k] for k in ("preprocess_fwd", "preprocess_bwd")}
    _, off_p, inputs_p, pp, tp, gp = run(preprocess_scene_plain)
    torch.cuda.synchronize()
    with torch.no_grad():
        ints = {f: equal(getattr(pk, f), getattr(pp, f))
                for f in ("radius", "radius_bin", "visible")}
        ints["rect"] = equal(tk[:, 10:], tp[:, 10:])
        floats = {f"col{c}": rel(tk[:, c], tp[:, c]) for c in range(10)}
        floats.update({f: rel(getattr(pk, f), getattr(pp, f))
                       for f in ("p_pix", "depth", "cull_r2")})
        grads = {k: of_norm(gk[k], gp[k]) for k in gk}
        fwd_abs = max(float(torch.nan_to_num((tk - tp).abs()).max()),
                      *(float(torch.nan_to_num((getattr(pk, f) - getattr(pp, f)).abs()).max())
                        for f in ("p_pix", "depth", "cull_r2")))
        bwd_abs = max(float(torch.nan_to_num((gk[k] - gp[k]).abs()).max()) for k in gk)
    del gp

    # times: each direction alone, the backward called as autograd calls it
    n, views = scene.capacity, 1
    par = live.params
    degree = min(int(scene.active_sh_degree), scene.max_sh_degree)
    bwd_ctx = types.SimpleNamespace(
        saved_tensors=(par.xyz, par.features_dc, par.features_rest, par.opacity, par.scales,
                       par.quats, off, *_camera_arrays(cam)),
        static=(w, h, degree, False, blk, 1.0, False))
    fwd_ms = cuda_time_ms(lambda: preprocess_scene(live, cam, w, h, blk, False, off), 20)
    bwd_ms = cuda_time_ms(lambda: PreprocessKernels.backward(bwd_ctx, g_table), 20)
    fwd_plain_ms = cuda_time_ms(lambda: preprocess_scene_plain(live, cam, w, h, blk, False,
                                                                off), 3)
    bwd_plain_ms = cuda_time_ms(
        lambda: torch.autograd.grad(tp, inputs_p, g_table, retain_graph=True), 3)
    # bytes a splat: the forward reads the raw parameters (59 floats at SH
    # degree 3), the offset and alive, and writes the table row and the
    # binning's fields (p_pix, depth, radius, radius_bin, cull_r2, visible);
    # the backward reads the parameters, the offset and the table gradient's
    # ten differentiable columns, and writes every parameter's gradient and
    # the offset's
    param_b = sum(getattr(par, k)[0].numel() for k in PARAM_NAMES) * 4
    fwd_bytes = n * (param_b + 1 + views * (8 + 64 + 8 + 4 * 4 + 1))
    bwd_bytes = n * (2 * param_b + views * (8 + 40 + 8))
    check = {"launches": ran, "equal": ints, "float_rel_err": floats, "float_tol": PREP_FLOAT_TOL,
             "grad_err_of_norm": grads, "grad_tol": PREP_GRAD_TOL,
             "bytes_per_splat": [fwd_bytes / n, bwd_bytes / n],
             "ms": [fwd_ms, bwd_ms], "plain_ms": [fwd_plain_ms, bwd_plain_ms]}
    print("phase5_preprocess: " + json.dumps(check), flush=True)
    if ran != {"preprocess_fwd": 1, "preprocess_bwd": 1}:
        fail(f"phase 5: the preprocess pair launched {ran}, want one each")
    if not all(ints.values()):
        fail(f"phase 5: the preprocess pair's integer fields differ: {ints}")
    if not max(floats.values()) <= PREP_FLOAT_TOL:
        fail(f"phase 5: the preprocess pair's floats differ: {floats}")
    if not max(grads.values()) <= PREP_GRAD_TOL:
        fail(f"phase 5: the preprocess pair's gradients differ: {grads}")
    common = {"route": "cuda", "source": f"{PKG}/csrc/preprocess.cu",
              "replaces": "none: gaussian_splatting_lightning_tpu/ops/common.py:47 (jnp)",
              "bound_by": "bytes", "library_ms": None}
    return [
        dict(common, name="preprocess_fwd", launches=launches["preprocess_fwd"],
             max_abs_err=fwd_abs, ms=fwd_ms, plain_ms=fwd_plain_ms,
             bound_ms=fwd_bytes / HBM_BYTES_PER_S * 1e3),
        dict(common, name="preprocess_bwd", launches=launches["preprocess_bwd"],
             max_abs_err=bwd_abs, ms=bwd_ms, plain_ms=bwd_plain_ms,
             bound_ms=bwd_bytes / HBM_BYTES_PER_S * 1e3),
    ]


def phase5(scene, budget):
    """The training step on the bench scene at 1080p, then K3, K4, K5 and
    the preprocess pair against their plain versions and timed on that
    step's inputs."""
    import dataclasses
    import types

    import numpy as np
    import torch
    import torch.nn.functional as F

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
        PARAM_NAMES,
        GaussianParams,
    )
    from gaussian_splatting_lightning_tpu_torch.ops import _build, binning, rasterize, ssim
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training import trainer
    from gaussian_splatting_lightning_tpu_torch.training.densify import accumulate_stats_
    from gaussian_splatting_lightning_tpu_torch.training.loss import photometric_loss
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import (
        adam_scalars,
        adam_update_,
        init_adam,
        make_lr_schedules,
        scalars_tensor,
    )

    check_step_routes()

    w, h, blk = 1920, 1080, 32
    cam = interop.camera(w, h)
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(3, h, w)).astype(np.float32)).cuda()
    bg = torch.zeros(3, device="cuda")
    tiling = TilingConfig(max_pairs=budget, block=blk)
    cfg = trainer.TrainConfig(tiling=tiling)
    # every kernel's count, K5's 0: the step's loss is the photometric kernels
    expected = dict(TRAIN_STEP_LAUNCHES, preprocess_fwd=1, preprocess_bwd=1, blur=0)
    start = {k: getattr(scene.params, k).clone() for k in PARAM_NAMES}
    # TRAIN_STEPS + 1 steps eager and captured, each from its own copy of
    # the start: step 0 warms up (captured: warm-up, capture, replay), the
    # rest are timed
    eager_fn = trainer.make_train_step(cfg, 1.0, w, h, capture=False)
    step_fn = trainer.make_train_step(cfg, 1.0, w, h)
    runs = {}
    for name, fn in (("eager", eager_fn), ("captured", step_fn)):
        state = {"scene": copy_scene(scene), "adam": init_adam(scene.params), "step": 0}

        def one_step(fn=fn, state=state):
            state["scene"], state["adam"], logs = fn(
                state["scene"], state["adam"], state["step"], cam, target, bg)
            state["step"] += 1
            return logs

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        losses = [float(one_step()["loss"])]
        torch.cuda.synchronize()
        if name == "captured":  # the main path's counts: the timed replays
            _build.reset_launch_counts()
        rows, syncs = [], []
        for _ in range(TRAIN_STEPS):
            before = dict(_build.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with count_syncs() as caught:
                logs = one_step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            syncs.append(n_syncs(caught))
            launched = {k: _build.launches[k] - before[k] for k in before}
            rows.append({"step": state["step"] - 1, "ms": ms, "loss": float(logs["loss"]),
                         "psnr": float(logs["psnr"]), "num_pairs": int(logs["num_pairs"]),
                         "dropped": int(logs["num_dropped_pairs"]),
                         "host_syncs": syncs[-1], "launches": launched})
            losses.append(rows[-1]["loss"])
            if not math.isfinite(rows[-1]["loss"]):
                fail(f"{name} train step {rows[-1]['step']}: loss {rows[-1]['loss']}")
            if rows[-1]["dropped"] != 0:
                fail(f"{name} train step {rows[-1]['step']}: {rows[-1]['dropped']} pairs dropped")
            if launched != expected:
                fail(f"{name} train step {rows[-1]['step']}: launches {launched}, "
                     f"expected {expected}")
        runs[name] = dict(state=state, one_step=one_step, rows=rows, losses=losses,
                          syncs=syncs, peak=torch.cuda.max_memory_allocated() - held)
    launches = dict(_build.launches)
    eager, captured = runs["eager"], runs["captured"]
    for row, ref in zip(captured["rows"], eager["rows"]):
        print("train_step: " + json.dumps(dict(row, eager_ms=ref["ms"], eager_loss=ref["loss"],
                                               eager_host_syncs=ref["host_syncs"])),
              flush=True)
    print(f"train path launches: {json.dumps(launches)}", flush=True)
    # the captured steps against the eager ones: every loss, then every
    # parameter and moment column after the last step
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(captured["losses"], eager["losses"]))
    state_err, bits = {}, {}
    for part in ("params", "mu", "nu"):
        for k in PARAM_NAMES:
            get = ((lambda st, k=k: getattr(st["scene"].params, k)) if part == "params"
                   else (lambda st, k=k, part=part: getattr(getattr(st["adam"], part), k)))
            a, b = get(captured["state"]), get(eager["state"])
            state_err[f"{part}.{k}"] = col_err(a.reshape(a.shape[0], -1),
                                               b.reshape(b.shape[0], -1))
            bits[f"{part}.{k}"] = torch.equal(a, b)
    step_check = {"loss_max_rel_err": loss_err, "state_col_err_max": max(state_err.values()),
                  "state_col_err": state_err, "bits_equal": bits,
                  "losses_bit_equal": captured["losses"] == eager["losses"],
                  "tolerance": STEP_GRAPH_TOL}
    print("step_graph_check: " + json.dumps(step_check), flush=True)
    if not (loss_err <= STEP_GRAPH_TOL and max(state_err.values()) <= STEP_GRAPH_TOL):
        fail(f"phase 5: {TRAIN_STEPS + 1} captured steps differ from eager: loss {loss_err}, "
             f"state {max(state_err.values())}")
    state, one_step = captured["state"], captured["one_step"]
    step_ms, step_syncs = [r["ms"] for r in captured["rows"]], captured["syncs"]
    scene = state["scene"]
    for k in PARAM_NAMES:
        moved = float((getattr(scene.params, k) - start[k]).abs().max())
        if not moved > 0:
            fail(f"parameter group {k} did not move in {TRAIN_STEPS + 1} steps")
    if not bool(torch.isfinite(scene.grad_accum).all()) or float(scene.grad_accum.max()) <= 0:
        fail("densification statistics did not accumulate")
    del start
    eager_wall = sorted(r["ms"] for r in eager["rows"])[TRAIN_STEPS // 2]
    wall = sorted(step_ms)[TRAIN_STEPS // 2]
    print_graph_line(
        "5 step", step_fn.captured.capture_s,
        dict(graph_side(one_step, 5, "step", captured["peak"], step_fn.captured.launches),
             step_wall_ms_median=wall),
        dict(graph_side(eager["one_step"], 5, "step", eager["peak"], expected),
             step_wall_ms_median=eager_wall),
        loss_max_rel_err=loss_err, state_col_err_max=max(state_err.values()))
    del runs, eager

    # the bench step's own inputs to K3, K4 and K5
    prep = _prep(scene, cam, w, h)
    gx, gy = binning.grid_shape(w, h, blk, blk)
    m = -(-budget // binning.CHUNK) * binning.CHUNK
    bins = binning.build_sorted_bins(prep, gx, gy, m, block=blk)
    gfeat = rasterize.feature_table(prep, w, h, blk)
    out = rasterize.composite_fwd(gfeat, bins.gauss_s, bins.tile_start, bins.tile_count,
                                  bg, gx, blk)
    out_r = out.clone().requires_grad_()
    img = rasterize._assemble_cf(out_r, gx, gy, w, h, blk)[0:3]
    stack, c1, c2 = ssim.ssim_stack(img.detach()[None], target[None])
    blurred = ssim.blur_valid(stack).requires_grad_()
    smap = ssim.ssim_from_blurred(blurred, c1, c2, 1)
    (ct_blur,) = torch.autograd.grad(smap.mean(), blurred)
    ct_blur = ct_blur.contiguous()  # K5's VJP input, read with a zero margin of 10
    loss, _ = photometric_loss(img, target, cfg.w_ssim)
    (grad_out,) = torch.autograd.grad(loss, out_r)
    grad_out = grad_out.contiguous()
    # the loss leaves the depth channel's cotangent at zero; a seeded one at
    # the colour cotangent's scale holds K3's 1/z column and depth term too
    depth_ct = np.random.default_rng(1).normal(size=tuple(grad_out[:, 3].shape))
    grad_out[:, 3] = (torch.from_numpy(depth_ct.astype(np.float32)).cuda()
                      * grad_out[:, :3].abs().max())

    k3_args = (gfeat, bins.gauss_s, bins.slot_s, bins.tile_start, bins.tile_count,
               out, grad_out, gx, blk, m)
    dk = rasterize.composite_bwd(*k3_args)
    dk_again = rasterize.composite_bwd(*k3_args)
    dp = rasterize.composite_bwd_plain(*k3_args)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(dk).all()):
        fail("K3 at 1080p: non-finite pair gradients")
    if not torch.equal(dk, dk_again):
        fail("K3 at 1080p: a second run gave other bits")
    if not torch.equal(dk.abs().sum(1) == 0, dp.abs().sum(1) == 0):
        fail("K3 at 1080p: the kernel and the plain version zero different rows")
    del dk_again
    k3_rel, k3_abs = col_err(dk, dp), float((dk - dp).abs().max())
    sk = rasterize.segment_sum(dk, bins.offsets, bins.ntiles, bins.order)
    sk_again = rasterize.segment_sum(dk, bins.offsets, bins.ntiles, bins.order)
    sp = rasterize.segment_sum_plain(dk, bins.offsets, bins.ntiles, bins.order)
    torch.cuda.synchronize()
    if not torch.equal(sk, sk_again):
        fail("K4 at 1080p: a second run gave other bits")
    if not torch.equal(sk.abs().sum(1) == 0, sp.abs().sum(1) == 0):
        fail("K4 at 1080p: the kernel and the plain version zero different rows")
    del sk_again
    ng = rasterize.NGRAD
    k4_rel, k4_abs = col_err(sk[:, :ng], sp[:, :ng]), float((sk - sp).abs().max())
    k5_abs = 0.0
    for x, margin in ((stack, 0), (ct_blur, ssim.HALO)):
        yk, yp = ssim.blur_valid(x, margin), ssim.blur_valid_plain(x, margin)
        torch.cuda.synchronize()
        k5_abs = max(k5_abs, float((yk - yp).abs().max()))
        if not torch.equal(yk, yp):
            fail(f"K5 at 1080p (margin {margin}): not bit-identical to the plain "
                 f"version, max |kernel - plain| = {k5_abs}")
    del yk, yp
    checks = {"K3": [k3_rel, K3_TOL, k3_abs], "K4": [k4_rel, K4_TOL, k4_abs],
              "K5": [0.0, "bit-identical", k5_abs]}
    print("phase5_kernels: " + json.dumps(
        {"[rel_err, tolerance, max_abs_err]": checks}), flush=True)
    for name, (rel, tol, _) in list(checks.items())[:2]:
        if not rel <= tol:
            fail(f"{name} at 1080p: error {rel} (share of the column maximum) > {tol}")
    pair_rows = preprocess_pair(scene, cam, w, h, blk, sk, launches)

    # times, bounds and one-call library equivalents
    k3_ms = cuda_time_ms(lambda: rasterize.composite_bwd(*k3_args), 10)
    k3_plain_ms = cuda_time_ms(lambda: rasterize.composite_bwd_plain(*k3_args), 1)
    _, evals_t, kept = rasterize.composite_fwd_plain(
        gfeat, bins.gauss_s, bins.tile_start, bins.tile_count, bg, gx, blk,
        return_work=True)
    pix, n, n_tiles = blk * blk, prep.depth.shape[0], gx * gy
    evals, kept = int(evals_t.sum()) * pix, int(kept.sum())
    binned = int(bins.tile_count.sum())
    k3_flops = evals * K2_OPS_TO_KILL[blk] + kept * K3_FLOPS_KEPT
    k3_bytes = n * 64 + binned * 8 + n_tiles * (8 + 2 * 4 * pix * 4) + m * ng * 4
    k3_bound = {"bytes": k3_bytes / HBM_BYTES_PER_S, "operations": k3_flops / F32_FLOPS}
    k3_by = max(k3_bound, key=k3_bound.get)

    seg_args = (dk, bins.offsets, bins.ntiles, bins.order)
    k4_ms = cuda_time_ms(lambda: rasterize.segment_sum(*seg_args), 20)
    k4_plain_ms = cuda_time_ms(lambda: rasterize.segment_sum_plain(*seg_args), 5)
    lengths = torch.clamp(torch.clamp(bins.offsets + bins.ntiles[bins.order.long()], max=m)
                          - bins.offsets, min=0).long()
    rows = int(lengths.sum())
    data = dk[:rows]
    seg_lib = torch.segment_reduce(data, "sum", lengths=lengths)
    k4_lib_ms = cuda_time_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths), 20)
    k4_lib_diff = float((seg_lib - sk[bins.order.long(), :ng]).abs().max())
    k4_bytes = rows * ng * 4 + n * 3 * 4 + n * rasterize.NFEAT * 4

    k5_ms = cuda_time_ms(lambda: ssim.blur_valid(stack), 20)
    # the VJP as the autograd function runs it: one launch on the unpadded
    # cotangent; beside it, what the kernel's zero margin saves: F.pad, then
    # a launch on the padded cotangent, and the pad alone
    vjp_ctx = types.SimpleNamespace(plain=False, taps=ssim.TAPS,
                                    needs_input_grad=(True, False, False))
    k5_vjp_ms = cuda_time_ms(lambda: ssim.BlurValid.backward(vjp_ctx, ct_blur), 20)
    ct_pad = F.pad(ct_blur, (ssim.HALO,) * 4).contiguous()
    k5_pad_route_ms = cuda_time_ms(
        lambda: ssim.blur_valid(F.pad(ct_blur, (ssim.HALO,) * 4).contiguous()), 20)
    k5_pad_ms = cuda_time_ms(lambda: F.pad(ct_blur, (ssim.HALO,) * 4).contiguous(), 20)
    k5_plain_ms = cuda_time_ms(lambda: ssim.blur_valid_plain(stack), 3)
    c = stack.shape[0]
    taps = torch.tensor(ssim.TAPS, device="cuda")
    weight = torch.outer(taps, taps).expand(c, 1, ssim.WINDOW, ssim.WINDOW).contiguous()
    conv = F.conv2d(stack[None], weight, groups=c)[0]
    k5_lib_ms = cuda_time_ms(lambda: F.conv2d(stack[None], weight, groups=c), 10)
    k5_lib_diff = float((conv - ssim.blur_valid(stack)).abs().max())
    k5_vjp_lib_ms = cuda_time_ms(lambda: F.conv2d(ct_pad[None], weight, groups=c), 10)
    del conv, ct_pad
    k5_bytes = (stack.numel() + c * (stack.shape[1] - ssim.HALO)
                * (stack.shape[2] - ssim.HALO)) * 4
    k5_vjp_bytes = (ct_blur.numel() + c * (ct_blur.shape[1] + ssim.HALO)
                    * (ct_blur.shape[2] + ssim.HALO)) * 4
    warps, culled, by_rect = warp_work(gfeat, bins, evals_t, gx, blk)
    print(f"K3 work: {binned} binned pairs, {evals} pair-pixel evaluations, {kept} "
          f"past the kill, {k3_flops} flops, {k3_bytes} bytes, {warps} (pair, warp) "
          f"evaluations, {culled} skipped by the cull ({by_rect} by the rect alone); "
          f"K4: {rows} rows summed over {n} ranks, longest segment "
          f"{int(lengths.max())} rows, {int((lengths > 128).sum())} ranks over 128 rows, "
          f"segment_reduce vs K4 max diff {k4_lib_diff:.3g}; K5: stack "
          f"{tuple(stack.shape)}, conv2d vs K5 max diff {k5_lib_diff:.3g}, "
          f"VJP as BlurValid.backward runs it {k5_vjp_ms:.4f} ms, "
          f"F.pad + launch on the padded cotangent {k5_pad_route_ms:.4f} ms "
          f"(F.pad alone {k5_pad_ms:.4f} ms)", flush=True)

    # where one step's time goes: each stage run alone (CUDA events)
    leaves = {k: getattr(scene.params, k).detach().requires_grad_() for k in PARAM_NAMES}
    offset = torch.zeros(scene.capacity, 2, device="cuda", requires_grad=True)
    live = dataclasses.replace(scene, params=GaussianParams(**leaves))

    def forward():
        return trainer.render_scene(live, cam, w, h, bg, tiling, means2d_ndc_offset=offset)

    fwd_out, _ = forward()
    loss, _ = photometric_loss(fwd_out.image, target, cfg.w_ssim)
    inputs = list(leaves.values()) + [offset]
    grads = torch.autograd.grad(loss, inputs, retain_graph=True)
    pgrads = GaussianParams(**dict(zip(PARAM_NAMES, grads)))
    scalars = scalars_tensor(adam_scalars(make_lr_schedules(cfg.optimizer, 1.0),
                                          cfg.optimizer, 5, state["adam"].count + 1), "cuda")
    radii = fwd_out.radii.detach()
    stages = {
        "train_step": cuda_time_ms(one_step, 3),
        "forward (render_scene, autograd on)": cuda_time_ms(forward, 5),
        "loss (photometric_loss: the photometric kernels' forward)": cuda_time_ms(
            lambda: photometric_loss(fwd_out.image, target, cfg.w_ssim), 5),
        "backward (autograd.grad)": cuda_time_ms(
            lambda: torch.autograd.grad(loss, inputs, retain_graph=True), 3),
        "  of which K3 composite_bwd": k3_ms,
        "  of which K4 segment_sum": k4_ms,
        "  K5 blur (forward, no longer in the step)": k5_ms,
        "  K5 blur (VJP, no longer in the step)": k5_vjp_ms,
        "adam_update_": cuda_time_ms(lambda: adam_update_(
            scene.params, pgrads, state["adam"], scalars, cfg.optimizer), 5),
        "accumulate_stats_": cuda_time_ms(
            lambda: accumulate_stats_(scene, radii, grads[-1]), 10),
    }
    wall = sorted(step_ms)[len(step_ms) // 2]
    print("train_stages_ms: " + json.dumps(
        dict(stages, step_wall_ms_median=wall, step_wall_ms=step_ms)), flush=True)
    del fwd_out, loss, grads, pgrads, leaves, live
    return max(step_syncs), [
        {"name": "composite_bwd", "route": "cuda",
         "source": f"{PKG}/csrc/composite_bwd.cu",
         "replaces": "gaussian_splatting_lightning_tpu/ops/rasterize_pallas.py:228",
         "launches": launches["composite_bwd"], "max_abs_err": k3_abs,
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[k3_by] * 1e3, "bound_by": k3_by, "library_ms": None},
        {"name": "segment_sum", "route": "cuda",
         "source": f"{PKG}/csrc/segment_sum.cu",
         "replaces": "gaussian_splatting_lightning_tpu/ops/rasterize_pallas.py:597",
         "launches": launches["segment_sum"], "max_abs_err": k4_abs,
         "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": k4_lib_ms},
        {"name": "blur", "route": "cuda", "source": f"{PKG}/csrc/blur.cu",
         "replaces": "gaussian_splatting_lightning_tpu/ops/ssim.py:67",
         "launches": launches["blur"], "max_abs_err": k5_abs,
         "ms": k5_ms, "plain_ms": k5_plain_ms,
         "bound_ms": k5_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": k5_lib_ms, "vjp_ms": k5_vjp_ms,
         "vjp_bound_ms": k5_vjp_bytes / HBM_BYTES_PER_S * 1e3,
         "vjp_library_ms": k5_vjp_lib_ms},
    ] + pair_rows


# phase 12: the rasterizer's precomputed inputs and scale modifier, and K5
# at every window it has an instance for, on phase 5's problem (the bench
# scene and camera at 1080p, its budget and seeded target, 32 px tiles)
PRECOMP_TOL = 1e-6  # derived against precomputed gradients, where the bits differ
JUNK_SH = (100.0, 3.0)  # sh * 100 + 3, and scales * 7: inputs a precomputed one replaces
JUNK_SCALE = 7.0


def phase12(scene, budget):
    """(a) the derived render against the one given the RGB and covariance
    it derives, beside junk SH and scales; (b) ``scale_modifier`` against
    scaled scales; (c) route "cuda" against "plain" with the precomputed
    inputs; (d) K5 at each window against its plain version, timed. Returns
    K5's rows per window for the ``kernels`` line."""
    import types

    import numpy as np
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core import sh as sh_lib
    from gaussian_splatting_lightning_tpu_torch.core import transforms as tf
    from gaussian_splatting_lightning_tpu_torch.ops import _build, ssim
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.ops.rasterize import rasterize

    w, h, blk = 1920, 1080, 32
    cam = interop.camera(w, h)
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(3, h, w)).astype(np.float32)).cuda()
    bg = torch.zeros(3, device="cuda")
    tiling = TilingConfig(max_pairs=budget, block=blk)
    deg, max_deg = scene.active_sh_degree, scene.max_sh_degree
    means, opac = scene.params.xyz.detach(), scene.get_opacity().detach()
    scales, quats = scene.get_scales().detach(), scene.get_rotation().detach()
    sh = scene.get_features().detach()
    junk_sh, junk_scales = sh * JUNK_SH[0] + JUNK_SH[1], scales * JUNK_SCALE

    def render(m, o, s, shs, plain=False, **kw):
        return rasterize(m, o, s, quats, shs, cam, w, h, bg, deg, config=tiling,
                         max_sh_degree=max_deg, alive=scene.alive, plain=plain, **kw)

    def l1(out):
        return (out.image - target).abs().mean()

    # (a) the same leaves twice: derived, and through the tables derived
    # from them (so the gradient on the means also flows through the colour)
    summary, counted, grads = {}, {}, {}
    for name in ("derived", "precomp"):
        m, o = means.clone().requires_grad_(), opac.clone().requires_grad_()
        _build.reset_launch_counts()
        if name == "derived":
            out, stats = render(m, o, scales, sh)
        else:
            rgb = sh_lib.sh_to_rgb(sh, m, cam.campos, deg, max_deg)
            cov6 = tf.build_cov3d(scales, quats)
            out, stats = render(m, o, junk_scales, junk_sh, colors_precomp=rgb,
                                cov3d_precomp=cov6)
        gm, go = torch.autograd.grad(l1(out), (m, o))
        torch.cuda.synchronize()
        counted[name] = dict(_build.launches)
        grads[name] = (out, {k: int(v) for k, v in stats.items()}, gm, go)
    (d_out, d_stats, d_gm, d_go), (p_out, p_stats, p_gm, p_go) = grads.values()
    same = {f: torch.equal(getattr(d_out, f), getattr(p_out, f))
            for f in ("image", "depth", "radii")}
    same["stats"] = d_stats == p_stats
    grad_err = {k: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for k, a, b in (("xyz", p_gm, d_gm), ("opacity", p_go, d_go))}
    want = {"expand_pairs": 1, "composite_fwd": 1, "composite_bwd": 1, "segment_sum": 1}
    summary["a"] = {"bits_equal": same, "grad_bits_equal": {
        "xyz": torch.equal(p_gm, d_gm), "opacity": torch.equal(p_go, d_go)},
        "grad_rel_err": grad_err, "tolerance": PRECOMP_TOL, "launches": counted["precomp"],
        "num_pairs": p_stats["num_pairs"], "dropped": p_stats["num_dropped_pairs"]}
    if not all(same.values()):
        fail(f"phase 12 (a): the precomputed inputs change the render: {same}")
    if not max(grad_err.values()) <= PRECOMP_TOL:
        fail(f"phase 12 (a): gradients differ from the derived render's: {grad_err}")
    if any(launched_kernels(counted[k]) != want for k in counted):
        fail(f"phase 12 (a): launches {counted}, expected {want} a render")
    if p_stats["num_dropped_pairs"] != 0:
        fail(f"phase 12 (a): {p_stats['num_dropped_pairs']} pairs dropped")
    image = d_out.image.detach()
    del grads, d_out, p_out, d_gm, d_go, p_gm, p_go

    # (b) the modifier against the scales it scales
    with torch.no_grad():
        mod, _ = render(means, opac, scales, sh, scale_modifier=0.5)
        half, _ = render(means, opac, scales * 0.5, sh)
    summary["b"] = {f: torch.equal(getattr(mod, f), getattr(half, f))
                    for f in ("image", "depth", "radii")}
    if not all(summary["b"].values()):
        fail(f"phase 12 (b): scale_modifier 0.5 differs from scales x 0.5: {summary['b']}")
    del mod, half

    # (c) route "cuda" against "plain" with the precomputed tables as leaves,
    # the gradients of <cotangent, render> for a seeded cotangent on image and
    # depth: the L1 loss's sign flips where the two routes' images straddle
    # the target, which moves whole pixels' terms, not rounding
    rgb0 = sh_lib.sh_to_rgb(sh, means, cam.campos, deg, max_deg)
    cov0 = tf.build_cov3d(scales, quats)
    ct = torch.from_numpy(np.random.default_rng(2).normal(size=(4, h, w)).astype(
        np.float32)).cuda()
    routes = {}
    for plain in (False, True):
        cp, cv = rgb0.clone().requires_grad_(), cov0.clone().requires_grad_()
        out, _ = render(means, opac, junk_scales, junk_sh, plain=plain, colors_precomp=cp,
                        cov3d_precomp=cv)
        dot = (out.image * ct[:3]).sum() + (out.depth * ct[3:]).sum()
        routes[plain] = (out.image.detach(),) + torch.autograd.grad(dot, (cp, cv))
    (ki, kc, kv), (pi, pc, pv) = routes[False], routes[True]
    summary["c"] = {"image_max_abs_err": float((ki - pi).abs().max()), "image_tol": K2_TOL,
                    "colors_precomp_col_err": col_err(kc, pc),
                    "cov3d_precomp_col_err": col_err(kv, pv), "grad_tol": K3_TOL}
    if not (summary["c"]["image_max_abs_err"] <= K2_TOL
            and summary["c"]["colors_precomp_col_err"] <= K3_TOL
            and summary["c"]["cov3d_precomp_col_err"] <= K3_TOL):
        fail(f"phase 12 (c): route cuda differs from plain: {summary['c']}")
    del routes, ki, kc, kv, pi, pc, pv

    # (d) K5 at every window on the SSIM stack of (a)'s render, both ways
    rows = {}
    for win, sigma in [(v, ssim.SIGMA) for v in ssim.KERNEL_WINDOWS] + [(7, 2.5)]:
        taps = ssim.window_taps(win, sigma)
        stack, c1, c2 = ssim.ssim_stack(image[None], target[None], win)
        blurred = ssim.blur_valid(stack, 0, taps).requires_grad_()
        (ct,) = torch.autograd.grad(ssim.ssim_from_blurred(blurred, c1, c2, 1).mean(), blurred)
        ct = ct.contiguous()
        err = 0.0
        for x, margin in ((stack, 0), (ct, win - 1)):
            yk = ssim.blur_valid(x, margin, taps)
            yp = ssim.blur_valid_plain(x, margin, taps)
            torch.cuda.synchronize()
            err = max(err, float((yk - yp).abs().max()))
            if not torch.equal(yk, yp):
                fail(f"phase 12 (d): K5 at window {win}, sigma {sigma}, margin {margin}: "
                     f"not bit-identical to the plain version ({err})")
        ctx = types.SimpleNamespace(plain=False, taps=taps, needs_input_grad=(True, False, False))
        c = stack.shape[0]
        out_px = c * (stack.shape[1] - win + 1) * (stack.shape[2] - win + 1)
        rows[f"{win}/{sigma}"] = {
            "window": win, "sigma": sigma, "stack": list(stack.shape), "max_abs_err": err,
            "ms": cuda_time_ms(lambda: ssim.blur_valid(stack, 0, taps), 20),
            "vjp_ms": cuda_time_ms(lambda: ssim.BlurValid.backward(ctx, ct), 20),
            "plain_ms": cuda_time_ms(lambda: ssim.blur_valid_plain(stack, 0, taps), 3),
            "bound_ms": (stack.numel() + out_px) * 4 / HBM_BYTES_PER_S * 1e3,
            "vjp_bound_ms": (ct.numel() + stack.numel()) * 4 / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
        del stack, blurred, ct, yk, yp
    got = ssim.ssim(image, target, window_size=7)
    want7 = ssim.ssim(image, target, True, window_size=7)
    summary["d"] = {"windows": rows, "ssim_w7": float(got), "ssim_w7_plain": float(want7)}
    if not torch.equal(got, want7):
        fail(f"phase 12 (d): ssim at window 7 on cuda {float(got)} against plain "
             f"{float(want7)}")
    print("phase12: " + json.dumps(summary), flush=True)
    return rows


# phase 6: configs/rehearsal_synthetic.yaml's operating point, depth cut
# (PERF.md section 4); widths are not cut: 1080p, SH degree 3, 24 views
LOOP_VIEWS, LOOP_GT, LOOP_INIT = 24, 80_000, 20_000
LOOP_SETS = {
    "train.num_iters": 600,
    "train.densify.densify_since": 100,
    "train.densify.densify_interval": 100,
    "train.densify.densify_until": 500,
    "train.densify.opacity_reset_interval": 300,
    "train.densify.sh_degree_step_interval": 100,
    "train.valid_interval": 300,
    "train.checkpoint_interval": 300,
    "train.log_interval": 50,
    "train.overflow_check_interval": 50,
}
LOOP_PROFILE = (160, 180)  # steps profiled: on no cadence
# steps timed between two syncs, unprofiled: on no cadence. A captured step
# returns before the card has run it, so the host's wall from one call to
# the next is its own time a step, not the step's
LOOP_WINDOW = (110, 140)
LOOP_LOSS_TOL = 1e-6  # run 2 (resumed at step 300) against run 1


class Tee(io.TextIOBase):
    """stdout that also keeps what was written."""

    def __init__(self):
        self.parts = []

    def write(self, text):
        sys.__stdout__.write(text)
        self.parts.append(text)
        return len(text)

    def flush(self):
        sys.__stdout__.flush()


# phase 13: Adam's kernel (csrc/adam.cu) alone at the benchmark cells' store
# sizes, SH degree 3; its byte bound reads p, g, m, v and writes p, m, v once
ADAM_ROWS = (1_000_000, 3_000_000)
ADAM_BYTES_PER_SPLAT = 7 * 59 * 4


def phase13() -> dict:
    """Adam's kernel at each of ``ADAM_ROWS``: one in-place update against
    ``_adam_plain`` from the same state (every bit of p, m and v), then
    CUDA-event ms of the kernel, of the plain version's 84 launches and of
    ``torch.optim.Adam(fused=True)`` over the same six tensors (the library
    yardstick only: the port never calls it), beside the byte bound.
    Prints a ``phase13:`` line and returns the kernel's row."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
        PARAM_NAMES,
        GaussianParams,
    )
    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.training import optimizer as opt

    cfg = opt.OptimizerConfig()
    sched = opt.make_lr_schedules(cfg, 1.0)
    values = opt.adam_scalars(sched, cfg, 15001, 15001)
    sizes, bad = {}, {}
    for rows in ADAM_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(rows)
        shapes = {"xyz": (rows, 3), "features_dc": (rows, 1, 3),
                  "features_rest": (rows, 15, 3), "opacity": (rows, 1), "scales": (rows, 3),
                  "quats": (rows, 4)}

        def rand(scale, shapes=shapes, gen=gen):
            return GaussianParams(**{k: torch.randn(s, generator=gen, device="cuda") * scale
                                     for k, s in shapes.items()})

        def copy(x):
            return GaussianParams(**{k: getattr(x, k).clone() for k in PARAM_NAMES})

        params, grads, mu = rand(1.0), rand(1e-2), rand(1e-3)
        nu = GaussianParams(**{k: v ** 2 for k, v in vars(rand(1e-3)).items()})
        state = opt.AdamState(count=15000, mu=mu, nu=nu)
        scalars = opt.scalars_tensor(values, "cuda")
        got_p, got = copy(params), opt.AdamState(count=15000, mu=copy(mu), nu=copy(nu))
        before = _build.launches["adam"]
        opt.adam_update_(got_p, grads, got, scalars, cfg)
        launched = _build.launches["adam"] - before
        want = copy(params), opt.AdamState(count=15000, mu=copy(mu), nu=copy(nu))
        opt._adam_plain(want[0], grads, want[1], scalars, cfg, None)
        want = (want[0], want[1].mu, want[1].nu)
        torch.cuda.synchronize()
        differ = {f"{part}.{k}": int((getattr(a, k).view(torch.int32)
                                      != getattr(b, k).view(torch.int32)).sum())
                  for part, a, b in zip("pmv", (got_p, got.mu, got.nu), want)
                  for k in PARAM_NAMES}
        del got_p, got, want
        ms = cuda_time_ms(lambda: opt.adam_update_(params, grads, state, scalars, cfg), 20)
        plain_ms = cuda_time_ms(lambda: opt._adam_plain(params, grads, state, scalars, cfg,
                                                        None), 5)
        leaves = [getattr(params, k).detach().clone().requires_grad_() for k in PARAM_NAMES]
        for leaf, k in zip(leaves, PARAM_NAMES):
            leaf.grad = getattr(grads, k).clone()
        library = torch.optim.Adam([{"params": [leaf], "lr": lr}
                                    for leaf, lr in zip(leaves, values)],
                                   betas=(cfg.beta1, cfg.beta2), eps=cfg.eps, fused=True)
        library_ms = cuda_time_ms(library.step, 20)
        bound_ms = rows * ADAM_BYTES_PER_SPLAT / HBM_BYTES_PER_S * 1e3
        sizes[str(rows)] = {"ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                            "plain_ms": plain_ms, "library_ms": library_ms,
                            "launches": launched, "bits_differ": sum(differ.values())}
        if launched != 1 or any(differ.values()):
            bad[rows] = {"launches": launched, "differ": {k: n for k, n in differ.items() if n}}
        del params, grads, mu, nu, state, leaves, library
        torch.cuda.empty_cache()
    print("phase13: " + json.dumps(sizes), flush=True)
    if bad:
        fail(f"phase 13: Adam's kernel against its plain version: {bad}")
    top = sizes[str(ADAM_ROWS[-1])]
    return {"name": "adam", "route": "cuda", "source": f"{PKG}/csrc/adam.cu",
            "replaces": "none (the JAX package's adam_update is jnp that XLA fuses)",
            "launches": top["launches"], "max_abs_err": 0.0, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"], "sizes": sizes}


# the photometric kernels against the composition (tests/test_torch_cuda_kernels.py):
# values relative (sums in another order), the gradient as a share of its
# largest |value| (the map's derivatives round apart from autograd's chain)
PHOT_VALUE_TOL, PHOT_GRAD_TOL = 1e-6, 1e-5
PHOT_BYTES_PER_ELEMENT = 4 * (2 + 2 + 3 + 3 + 2 + 1)


def phase14() -> dict:
    """The photometric loss's kernels alone at 1920x1080 against the
    composition; prints a ``phase14:`` line and returns their row."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.training import loss as tloss

    shape = (3, 1080, 1920)
    gen = torch.Generator(device="cuda").manual_seed(14)
    pred = torch.rand(shape, device="cuda", generator=gen)
    target = torch.rand(shape, device="cuda", generator=gen)
    pred = torch.where(torch.rand(shape, device="cuda", generator=gen) < 0.2, target, pred)
    names = ("loss", "recon", "ssim", "psnr")

    def run(plain):
        x = pred.clone().requires_grad_()
        _, logs = tloss.photometric_loss(x, target, 0.2, plain)
        (grad,) = torch.autograd.grad(logs["loss"], x)
        return [logs[k].detach() for k in names], grad

    _build.reset_launch_counts()
    got, grad = run(False)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    again, grad_again = run(False)
    want, want_grad = run(True)
    torch.cuda.synchronize()
    value_err = {k: float((a - b).abs() / b.abs()) for k, a, b in zip(names, got, want)}
    grad_err = float((grad - want_grad).abs().max() / want_grad.abs().max())
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again)) and torch.equal(
        grad, grad_again)
    max_abs = max([float((a - b).abs()) for a, b in zip(got, want)]
                  + [float((grad - want_grad).abs().max())])
    del again, grad_again, want, want_grad

    x = pred.clone().requires_grad_()

    def forward():
        return tloss.photometric_loss(x, target, 0.2)[0]

    loss = forward()
    call_fwd_ms = cuda_time_ms(forward, 20)
    call_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(loss, x, retain_graph=True), 20)
    # the kernels' own device time a call (an eager call's events also hold
    # the host's launch and autograd gaps)
    reps = 20
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.autograd.grad(forward(), x)
        torch.cuda.synchronize()
    kernel_ms = {}
    for ev in prof.key_averages():
        name = re.search(r"photometric_\w+", ev.key)
        if name:  # the forward pass's two instances share a name
            kernel_ms[name.group(0)] = (kernel_ms.get(name.group(0), 0.0)
                                        + ev.device_time_total / reps / 1e3)
    fwd_ms = sum(v for k, v in kernel_ms.items() if k != "photometric_bwd_kernel")
    bwd_ms = kernel_ms.get("photometric_bwd_kernel", 0.0)
    kernels = tloss.on_kernels
    tloss.on_kernels = lambda *a: False  # the composition with K5, as the step ran it
    try:
        plain_loss = forward()
        plain_fwd_ms = cuda_time_ms(forward, 5)
        plain_bwd_ms = cuda_time_ms(
            lambda: torch.autograd.grad(plain_loss, x, retain_graph=True), 5)
    finally:
        tloss.on_kernels = kernels
    bound_ms = pred.numel() * PHOT_BYTES_PER_ELEMENT / HBM_BYTES_PER_S * 1e3
    row = {"name": "photometric", "route": "cuda", "source": f"{PKG}/csrc/photometric.cu",
           "replaces": "none (the JAX package's loss is jnp around the blur kernel, "
                       "which XLA fuses)",
           "launches": launches["photometric"], "max_abs_err": max_abs,
           "ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "kernel_ms": kernel_ms,
           "call_fwd_ms": call_fwd_ms, "call_bwd_ms": call_bwd_ms,
           "plain_ms": plain_fwd_ms + plain_bwd_ms, "plain_fwd_ms": plain_fwd_ms,
           "plain_bwd_ms": plain_bwd_ms, "bound_ms": bound_ms, "bound_by": "bytes",
           "bound_share": bound_ms / (fwd_ms + bwd_ms), "library_ms": None,
           "value_rel_err": value_err, "grad_err": grad_err, "same_bits": same_bits}
    print("phase14: " + json.dumps(row), flush=True)
    if launches != dict.fromkeys(_build.SOURCES, 0) | {"photometric": 4}:
        fail(f"phase 14: the photometric loss launched {launches}")
    if not (max(value_err.values()) <= PHOT_VALUE_TOL and grad_err <= PHOT_GRAD_TOL
            and same_bits):
        fail(f"phase 14: the photometric kernels against the composition: {value_err}, "
             f"gradient {grad_err}, same bits {same_bits}")
    return row


def write_loop_scene(root, w, h):
    """The GT scene's 24 views rendered by the port as PNGs, and a COLMAP
    model: the orbit poses and 20,000 GT centres plus noise with the GT
    colours."""
    import numpy as np
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.sh import SH_C0
    from gaussian_splatting_lightning_tpu_torch.data import colmap, image_io
    from gaussian_splatting_lightning_tpu_torch.ops.budget import pair_budget
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import render_scene

    angles = [(15.0 * k, 10.0 * math.sin(k)) for k in range(1, LOOP_VIEWS)]
    poses, cams = orbit_poses(angles), orbit_cameras(w, h, angles)
    # splat scales around 0.01 (3-sigma radii ~10 px at 1080p): at 0.02 and
    # at the fixture's default 0.05 the splats overlap so much that the init
    # scene is near the best held-out fit 20k splats reach, and 600 steps
    # fit the train views past it (PERF.md section 6)
    gt = interop.synthetic_scene(LOOP_GT, LOOP_GT, sh_degree=3, aniso=True, seed=6,
                                 scale=0.01)
    tiling = TilingConfig(max_pairs=pair_budget(gt, cams, w, h))
    (root / "images").mkdir(parents=True)
    images = {}
    for i, (pose, cam) in enumerate(zip(poses, cams)):
        out, stats = render_scene(gt, cam, w, h, torch.zeros(3, device="cuda"), tiling)
        if int(stats["num_dropped_pairs"]):
            fail(f"phase 6: GT view {i} dropped pairs")
        img = (out.image.clamp(0, 1).permute(1, 2, 0) * 255 + 0.5).to(torch.uint8)
        name = f"view_{i:03d}.png"
        image_io.write_image(root / "images" / name, img.cpu().numpy())
        images[i + 1] = (colmap.rotmat_to_qvec(pose[:, :3]), pose[:, 3], 1, name)
    rng = np.random.default_rng(8)
    pick = torch.from_numpy(rng.choice(LOOP_GT, LOOP_INIT, replace=False)).cuda()
    xyz = (gt.params.xyz[pick].cpu().numpy()
           + rng.normal(size=(LOOP_INIT, 3)).astype(np.float32) * 0.02)
    rgb = np.clip(gt.params.features_dc[pick, 0].cpu().numpy() * SH_C0 + 0.5, 0, 1)
    focal = w * 0.7
    colmap.write_reconstruction(root / "sparse" / "0", {1: (w, h, focal, focal, w / 2, h / 2)},
                                images, xyz, rgb)
    return tiling.max_pairs


def phase6(bare_step_syncs: int, work: Path):
    """The training loop through the train CLI at 1080p. Run 1 calls the
    CLI's ``main`` in-process with timers on the step and the events, the
    host syncs counted and 20 steps profiled; run 2 resumes run 1's step-300
    checkpoint through the module entry in a subprocess and must log run 1's
    losses. The scene and the runs stay in ``work`` for phase 7. Returns run
    1's kernel launches, its run directory, the scene's directory and the
    step-600 held-out PSNR."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gaussian_splatting_lightning_tpu_torch.core.camera import camera_from_matrices
    from gaussian_splatting_lightning_tpu_torch.models import from_points
    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.ops.budget import pair_budget
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.scripts import train as train_cli
    from gaussian_splatting_lightning_tpu_torch.training import trainer as tr
    from gaussian_splatting_lightning_tpu_torch.training.config import load_config

    t_phase = time.perf_counter()
    w, h = 1920, 1080
    root = work / "scene"
    gt_budget = write_loop_scene(root, w, h)
    config = ROOT / "configs" / "rehearsal_synthetic.yaml"
    sets = dict(LOOP_SETS, **{"data.colmap_path": str(root),
                              "data.image_folder": str(root / "images")})
    cfg = load_config(str(config), [f"{k}={v}" for k, v in sets.items()])
    train_views, valid_views, xyz, rgb, _ = train_cli.load_views(cfg.data)
    init = from_points(xyz, rgb, capacity=len(xyz), sh_degree=cfg.sh_degree)

    def cams(views):
        return [camera_from_matrices(v.viewmatrix, v.projmatrix, v.campos, v.tanfovx,
                                     v.tanfovy) for v in views]

    est = pair_budget(init, cams(train_views), w, h)
    sets["train.tiling.max_pairs"] = max(8192, round(est / 2 / 8192) * 8192)
    # the init scene's held-out PSNR, as the trainer's validate measures it
    ev = tr.make_eval_step(dataclasses.replace(cfg.train, tiling=TilingConfig(
        max_pairs=pair_budget(init, cams(valid_views), w, h))), w, h)
    init_psnr = []
    for v, cam in zip(valid_views, cams(valid_views)):
        _, _, logs = ev(init, cam, torch.from_numpy(v.image).cuda(),
                        torch.from_numpy(v.background).cuda())
        if int(logs["num_dropped_pairs"]):
            fail("phase 6: the init scene's held-out render dropped pairs")
        init_psnr.append(float(logs["psnr"]))
    init_psnr = float(np.mean(init_psnr))
    del init, ev
    argv = ["-c", str(config), "--out-dir", str(work / "runs"), "--device", "cuda"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    print(f"loop scene: {LOOP_GT} GT splats, {len(train_views)} train / "
          f"{len(valid_views)} held-out views at {w}x{h}, {len(xyz)} init points, "
          f"GT pair budget {gt_budget}, init estimate {est}, start budget "
          f"{sets['train.tiling.max_pairs']}, init held-out PSNR {init_psnr:.3f}",
          flush=True)
    del train_views, valid_views

    # ---- run 1: the CLI in-process, instrumented -------------------
    rec = {"calls": {}, "events": [], "budget_at_save": {}, "last": -1, "prof": [],
           "captures": {}, "window": []}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def make_timed(*a, **k):
        step_fn = orig["make_train_step"](*a, **k)

        def timed(scene, adam, step, *rest, **kw):
            if step in LOOP_PROFILE and len(rec["prof"]) < 2:
                torch.cuda.synchronize()
                rec["prof"].append(time.perf_counter())
                (prof.start if len(rec["prof"]) == 1 else prof.stop)()
            if step in LOOP_WINDOW and len(rec["window"]) < 2:
                torch.cuda.synchronize()
                rec["window"].append(time.perf_counter())
            rec["calls"].setdefault(step, (time.perf_counter(), len(caught)))
            rec["last"] = step
            n = step_fn.captured.captures
            out = step_fn(scene, adam, step, *rest, **kw)
            if step_fn.captured.captures > n:  # a new key: this call captured
                rec["captures"][step] = step_fn.captured.capture_s
            return out

        return timed

    def timed(name, fn, method=False):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            step = a[0].step if method else rec["last"] + 1
            rec["events"].append({"event": name, "step": step,
                                  "ms": (time.perf_counter() - t0) * 1e3})
            if name == "densify_and_prune":
                rec["events"][-1]["stats"] = {k: int(v) for k, v in out[2].items()}
            if name == "save_checkpoint":
                rec["budget_at_save"][step] = a[0].cfg.tiling.max_pairs
            return out

        return wrapped

    orig = {"make_train_step": tr.make_train_step, "densify_step": tr.densify_step,
            "opacity_reset_step": tr.opacity_reset_step,
            "validate": tr.Trainer.validate, "save_checkpoint": tr.Trainer.save_checkpoint}
    tr.make_train_step = make_timed
    tr.densify_step = timed("densify_and_prune", orig["densify_step"])
    tr.opacity_reset_step = timed("reset_opacity", orig["opacity_reset_step"])
    tr.Trainer.validate = timed("validate", orig["validate"], method=True)
    tr.Trainer.save_checkpoint = timed("save_checkpoint", orig["save_checkpoint"],
                                       method=True)
    tee = Tee()
    _build.reset_launch_counts()
    t_run1 = time.perf_counter()
    try:
        with count_syncs() as caught, contextlib.redirect_stdout(tee):
            trainer = train_cli.main(argv)
    finally:
        for name in ("make_train_step", "densify_step", "opacity_reset_step"):
            setattr(tr, name, orig[name])
        tr.Trainer.validate = orig["validate"]
        tr.Trainer.save_checkpoint = orig["save_checkpoint"]
    run1_s = time.perf_counter() - t_run1
    launches = dict(_build.launches)
    # the loop's loss and validation run the photometric kernels, not K5
    if any(v < 1 for k, v in launches.items() if k != "blur"):
        fail(f"phase 6: a kernel was not launched by the training loop: {launches}")
    text = "".join(tee.parts)
    hist = {r["step"]: r for r in trainer.history}
    run_dir = trainer.out_dir
    del trainer
    torch.cuda.empty_cache()

    # ---- checks of run 1 -------------------------------------------
    bad = [s for s, r in hist.items() if not math.isfinite(r["loss"])]
    if bad or sorted(hist) != list(range(0, 600, 50)):
        fail(f"phase 6: logged steps {sorted(hist)}, non-finite loss at {bad}")
    growths = re.findall(r"\[tiling\] step (\d+): pair budget overflow, growing "
                         r"max_pairs to (\d+)", text)
    if not growths:
        fail("phase 6: the pair budget never grew")
    if hist[550]["num_dropped_pairs"] != 0:
        fail(f"phase 6: {hist[550]['num_dropped_pairs']} pairs dropped at the last check")
    alive = {s: int(r["n_gaussians"]) for s, r in sorted(hist.items())}
    if not alive[200] > alive[150]:
        fail(f"phase 6: no splats added by the step-200 densify event: {alive}")
    final = torch.load(run_dir / "ckpt-00000600" / "state.pt", map_location="cpu",
                       weights_only=True, mmap=True)
    if final["scene"]["active_sh_degree"] != 3:
        fail(f"phase 6: active SH degree {final['scene']['active_sh_degree']} in the "
             "final checkpoint")
    del final
    valid = [json.loads(x) for x in (run_dir / "valid_log.jsonl").read_text().splitlines()]
    final_psnr = valid[-1]["valid_psnr"]
    if valid[-1]["step"] != 600 or not final_psnr >= init_psnr + 1.0:
        fail(f"phase 6: held-out PSNR {final_psnr} at step {valid[-1]['step']}, init "
             f"{init_psnr}")

    # host syncs and wall time of the steps on no cadence and no capture (a
    # capture follows an SH degree step and a budget change, the JAX loop's
    # recompiles)
    calls = rec["calls"]
    if not rec["captures"] or 0 not in rec["captures"]:
        fail(f"phase 6: the train step captured at steps {sorted(rec['captures'])}")
    quiet = [t for t in range(30, 599) if t % 50 and (t + 1) % 100 and t + 1 in calls
             and t not in rec["captures"] and not any(
                 lo - 2 <= t <= hi + 1 for lo, hi in (LOOP_PROFILE, LOOP_WINDOW))]
    walls = [(calls[t + 1][0] - calls[t][0]) * 1e3 for t in quiet]
    syncs = [n_syncs(caught[calls[t][1]:calls[t + 1][1]]) for t in quiet]
    if max(syncs) > bare_step_syncs:
        fail(f"phase 6: a step on no cadence synced {max(syncs)} times, the bare step "
             f"{bare_step_syncs}")
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    window_ms = (rec["prof"][1] - rec["prof"][0]) * 1e3
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3

    # ---- run 2: resume at step 300 in a subprocess -----------------
    budget300 = rec["budget_at_save"][300]
    argv2 = argv + ["--resume", str(run_dir / "ckpt-00000300"), "--iters", "300",
                    "--set", f"train.tiling.max_pairs={budget300}",
                    "--set", "run_name=resume"]
    t_run2 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"{PKG}.scripts.train"] + argv2,
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    run2_s = time.perf_counter() - t_run2
    print("resume: " + " | ".join(res.stdout.strip().splitlines()[-6:]), flush=True)
    if res.returncode != 0:
        fail(f"phase 6: the resumed run exited {res.returncode}: {res.stderr[-2000:]}")
    (run2_dir,) = (run_dir.parent).glob("resume-*")
    hist2 = {r["step"]: r for r in map(json.loads, (run2_dir / "train_log.jsonl")
                                        .read_text().splitlines())}
    if sorted(hist2) != list(range(300, 600, 50)):
        fail(f"phase 6: the resumed run logged steps {sorted(hist2)}")
    loss_diff = max(abs(hist2[s]["loss"] - hist[s]["loss"]) / hist[s]["loss"]
                    for s in hist2)
    alive2 = {s: int(r["n_gaussians"]) for s, r in hist2.items()}

    host_ms = sorted(walls)[len(walls) // 2]
    steps = LOOP_PROFILE[1] - LOOP_PROFILE[0]
    wall = (rec["window"][1] - rec["window"][0]) * 1e3 / (LOOP_WINDOW[1] - LOOP_WINDOW[0])
    row = {
        "step_wall_ms_window": wall, "window_steps": list(LOOP_WINDOW),
        "host_ms_per_step_median": host_ms, "steps_timed": len(walls),
        "host_ms_per_step_min": min(walls), "host_ms_per_step_max": max(walls),
        # the profiler's host overhead stretches its window, so the idle
        # share is taken against the unprofiled window's wall a step
        "device_idle_share": 1.0 - busy_ms / steps / wall,
        "profiled_steps": list(LOOP_PROFILE), "device_busy_ms_per_step": busy_ms / steps,
        "wall_ms_per_step_profiled": window_ms / steps,
        "host_syncs_per_quiet_step": [min(syncs), max(syncs)],
        "bare_step_host_syncs": bare_step_syncs,
        "events": rec["events"], "budget_growths": [[int(a), int(b)] for a, b in growths],
        "budget_at_checkpoints": rec["budget_at_save"], "alive": alive,
        "alive_resumed": alive2, "init_psnr": init_psnr,
        "valid_psnr": {v["step"]: v["valid_psnr"] for v in valid},
        "resume_max_rel_loss_diff": loss_diff, "launches": launches,
        "captures_s_by_step": rec["captures"],
        "run1_s": run1_s, "run2_s": run2_s, "phase_s": time.perf_counter() - t_phase,
    }
    print("train_loop: " + json.dumps(row), flush=True)
    if not loss_diff <= LOOP_LOSS_TOL:
        fail(f"phase 6: the resumed run's losses differ from run 1's by {loss_diff} "
             f"relative (> {LOOP_LOSS_TOL})")
    loop_rollback(argv, work)
    loop_batched(argv, init_psnr, max(syncs), work)
    return launches, run_dir, root, final_psnr


ROLLBACK_STEP = 30  # a checked step after the step-20 checkpoint


def loop_rollback(argv, work: Path):
    """The NaN rollback on the captured step: the train CLI at phase 6's
    operating point cut to 40 steps with a checkpoint at 20, the step's loss
    made NaN at ROLLBACK_STEP; the loop must restore ckpt-00000020 (its
    scene copied into the graph's buffers) and train on with finite losses."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.scripts import train as train_cli
    from gaussian_splatting_lightning_tpu_torch.training import trainer as tr

    t0 = time.perf_counter()
    argv = list(argv)
    argv[argv.index("--out-dir") + 1] = str(work / "runs_rollback")
    for k, v in {"train.num_iters": 40, "train.checkpoint_interval": 20,
                 "train.log_interval": 5, "train.overflow_check_interval": 5,
                 "run_name": "rollback"}.items():
        argv += ["--set", f"{k}={v}"]
    orig, poisoned = tr.make_train_step, []

    def make_poisoned(*a, **k):
        step_fn = orig(*a, **k)

        def step(scene, adam, t, *rest, **kw):
            out = step_fn(scene, adam, t, *rest, **kw)
            if t == ROLLBACK_STEP and not poisoned:
                poisoned.append(t)
                out = out[:2] + (dict(out[2], loss=torch.tensor(float("nan"))),) + out[3:]
            return out

        step.captured = step_fn.captured
        return step

    tee = Tee()
    tr.make_train_step = make_poisoned
    try:
        with contextlib.redirect_stdout(tee):
            trainer = train_cli.main(argv)
    finally:
        tr.make_train_step = orig
    text = "".join(tee.parts)
    hist = trainer.history
    row = {"rollbacks": trainer._nan_rollbacks, "final_step": trainer.step,
           "captured": trainer._train_step.captured is not None,
           "logged": [[h["step"], h["loss"]] for h in hist],
           "seconds": time.perf_counter() - t0}
    print("loop_rollback: " + json.dumps(row), flush=True)
    if (trainer._nan_rollbacks != 1 or f"[recover] step {ROLLBACK_STEP}" not in text
            or not all(math.isfinite(h["loss"]) for h in hist) or trainer.step <= 20
            or not row["captured"]):
        fail(f"phase 6: the NaN rollback on the captured step: {row}")
    del trainer
    torch.cuda.empty_cache()


BATCHED_LOOP_STEPS = 250  # across the densify event at step 200
BATCHED_LOOP_SETS = {"train.batch_views": 4, "train.use_exposure": "true",
                     "train.num_iters": BATCHED_LOOP_STEPS, "run_name": "batched"}


def loop_batched(argv, init_psnr: float, single_syncs: int, work: Path):
    """Phase 6's operating point through the train CLI with four views per
    step and exposure, BATCHED_LOOP_STEPS steps: the quiet steps' wall,
    idle share and host syncs, the view counts, the losses and the held-out
    PSNR at the end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.scripts import train as train_cli
    from gaussian_splatting_lightning_tpu_torch.training import trainer as tr

    t_phase = time.perf_counter()
    argv = list(argv)
    argv[argv.index("--out-dir") + 1] = str(work / "runs_batched")
    for k, v in BATCHED_LOOP_SETS.items():
        argv += ["--set", f"{k}={v}"]
    calls, prof_t, captures, window = {}, [], {}, []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    orig = tr.make_train_step

    def make_timed(*a, **k):
        step_fn = orig(*a, **k)

        def timed(scene, adam, step, *rest, **kw):
            if step in LOOP_PROFILE and len(prof_t) < 2:
                torch.cuda.synchronize()
                prof_t.append(time.perf_counter())
                (prof.start if len(prof_t) == 1 else prof.stop)()
            if step in LOOP_WINDOW and len(window) < 2:
                torch.cuda.synchronize()
                window.append(time.perf_counter())
            calls.setdefault(step, (time.perf_counter(), len(caught)))
            n = step_fn.captured.captures
            out = step_fn(scene, adam, step, *rest, **kw)
            if step_fn.captured.captures > n:
                captures[step] = step_fn.captured.capture_s
            return out

        return timed

    tr.make_train_step = make_timed
    _build.reset_launch_counts()
    try:
        with count_syncs() as caught, contextlib.redirect_stdout(Tee()):
            trainer = train_cli.main(argv)
    finally:
        tr.make_train_step = orig
    launches = dict(_build.launches)
    hist = {r["step"]: r for r in trainer.history}
    run_dir, exposure = trainer.out_dir, trainer.exposure.params
    exposure_graph = trainer._exposure_update.captured
    exposure_graph = {"captures": exposure_graph.captures,
                      "capture_s": exposure_graph.capture_s}
    max_count = float(trainer.scene.grad_count.max())
    del trainer
    torch.cuda.empty_cache()
    steps = BATCHED_LOOP_STEPS
    bad = [s for s, r in hist.items() if not math.isfinite(r["loss"])]
    if bad or sorted(hist) != list(range(0, steps, 50)):
        fail(f"phase 6 (batched): logged steps {sorted(hist)}, non-finite loss at {bad}")
    # view counts restart at the densify event at step 200: four views a step since
    if not 0 < max_count <= 4 * (steps - 200):
        fail(f"phase 6 (batched): largest view count {max_count} after {steps - 200} steps")
    moved = float((exposure - torch.eye(3, 4, device=exposure.device)).abs().amax())
    valid = [json.loads(x) for x in (run_dir / "valid_log.jsonl").read_text().splitlines()]
    final_psnr = valid[-1]["valid_psnr"]
    if valid[-1]["step"] != steps or not final_psnr > init_psnr or not moved > 0:
        fail(f"phase 6 (batched): held-out PSNR {final_psnr} at step {valid[-1]['step']}, "
             f"init {init_psnr}; exposure moved {moved}")
    quiet = [t for t in range(30, steps - 1) if t % 50 and (t + 1) % 100 and t + 1 in calls
             and t not in captures and not any(
                 lo - 2 <= t <= hi + 1 for lo, hi in (LOOP_PROFILE, LOOP_WINDOW))]
    walls = [(calls[t + 1][0] - calls[t][0]) * 1e3 for t in quiet]
    syncs = [n_syncs(caught[calls[t][1]:calls[t + 1][1]]) for t in quiet]
    if max(syncs) > single_syncs:
        fail(f"phase 6 (batched): a quiet step synced {max(syncs)} times, the "
             f"single-view loop's {single_syncs}")
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0) / 1e3
    n_prof = LOOP_PROFILE[1] - LOOP_PROFILE[0]
    host_ms = sorted(walls)[len(walls) // 2]
    wall = (window[1] - window[0]) * 1e3 / (LOOP_WINDOW[1] - LOOP_WINDOW[0])
    row = {"views_per_step": 4, "steps": steps, "step_wall_ms_window": wall,
           "wall_ms_per_view": wall / 4, "host_ms_per_step_median": host_ms,
           "steps_timed": len(walls), "host_ms_per_step_min": min(walls),
           "host_ms_per_step_max": max(walls),
           "device_busy_ms_per_step": busy_ms / n_prof,
           "device_idle_share": 1.0 - busy_ms / n_prof / wall,
           "host_syncs_per_quiet_step": [min(syncs), max(syncs)],
           "single_view_loop_syncs": single_syncs, "max_view_count": max_count,
           "loss": {s: r["loss"] for s, r in sorted(hist.items())},
           "alive": {s: int(r["n_gaussians"]) for s, r in sorted(hist.items())},
           "init_psnr": init_psnr, "final_psnr": final_psnr,
           "exposure_max_move": moved, "launches": launches, "captures_s_by_step": captures,
           "exposure_graph": exposure_graph, "phase_s": time.perf_counter() - t_phase}
    print("train_loop_batched: " + json.dumps(row), flush=True)
    if exposure_graph["captures"] != 1:
        fail(f"phase 6 (batched): the exposure update captured {exposure_graph['captures']} "
             "times, not once")


# phase 7: the serving and evaluation entry points at 1920x1080
SERVE_VIEWS, SERVE_GT = 24, 80_000  # the JAX generator's default operating point
SERVE_FRAMES = 48
EVAL_PSNR_TOL = 0.1  # eval (render clipped to [0, 1]) against phase 6's validation
ORACLE_SPLATS = 2_000


LPIPS_CPU_TOL = 1e-4  # the card's LPIPS against the CPU's, relative


def write_lpips_weights(path: Path, seed: int = 0) -> Path:
    """Seeded random LPIPS-VGG weights in the export layout (no pretrained
    weights are in the repository): conv weights N(0, 0.05), biases
    N(0, 0.01), non-negative linear heads |N(0, 1)|."""
    import numpy as np

    from gaussian_splatting_lightning_tpu_torch.ops.lpips import TAPS, WIDTHS

    rng = np.random.default_rng(seed)
    w, in_ch = {}, 3
    for i, width in enumerate(WIDTHS):
        w[f"conv{i}_w"] = rng.normal(0, 0.05, size=(width, in_ch, 3, 3)).astype(np.float32)
        w[f"conv{i}_b"] = rng.normal(0, 0.01, size=(width,)).astype(np.float32)
        in_ch = width
    for j, tap in enumerate(TAPS):
        w[f"lin{j}_w"] = np.abs(rng.normal(0, 1, size=(WIDTHS[tap],))).astype(np.float32)
    np.savez(path, **w)
    return path


def check_lpips(res, npz: Path, ply: Path, scene_dir: Path) -> dict:
    """Eval's LPIPS rows; LPIPS(x, x) = 0 on a 1080p held-out image; one
    held-out view at ``--downscale 0.25`` rendered on the card and scored on
    the card and on the CPU."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.core.camera import camera_from_matrices
    from gaussian_splatting_lightning_tpu_torch.data.dataset import ColmapDataset
    from gaussian_splatting_lightning_tpu_torch.models import load_ply
    from gaussian_splatting_lightning_tpu_torch.ops.budget import pair_budget
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.ops.lpips import load_weights, lpips
    from gaussian_splatting_lightning_tpu_torch.training.trainer import render_scene

    per_view = [v["lpips"] for v in res["views"]]
    if not all(math.isfinite(x) and x > 0 for x in per_view):
        fail(f"phase 7: eval's LPIPS rows {per_view}")
    weights = load_weights(npz)
    w_cuda = {k: torch.from_numpy(v).cuda() for k, v in weights.items()}
    full = ColmapDataset(str(scene_dir), str(scene_dir / "images"), preload_data=False)[0]
    gt = torch.from_numpy(full.image).cuda()
    same = float(lpips(gt, gt, w_cuda))
    view = ColmapDataset(str(scene_dir), str(scene_dir / "images"), downscale=0.25,
                         preload_data=False)[0]
    h, w = view.image.shape[-2:]
    scene = load_ply(str(ply))
    cam = camera_from_matrices(view.viewmatrix, view.projmatrix, view.campos,
                               view.tanfovx, view.tanfovy)
    tiling = TilingConfig(max_pairs=pair_budget(scene, [cam], w, h))
    with torch.no_grad():
        out, _ = render_scene(scene, cam, w, h, torch.zeros(3, device="cuda"), tiling)
    image = out.image.clamp(0, 1)
    target = torch.from_numpy(view.image).cuda()
    card = float(lpips(image, target, w_cuda))
    cpu = float(lpips(image.cpu(), target.cpu(), weights))
    rel = abs(card - cpu) / abs(cpu)
    row = {"per_view": per_view, "mean": res["mean"]["lpips"],
           "ms_per_view_1080p": [v["lpips_ms"] for v in res["views"]],
           "lpips_x_x": same, "card_vs_cpu": [card, cpu, rel], "size_cpu_check": [w, h]}
    if same != 0.0 or not rel <= LPIPS_CPU_TOL:
        fail(f"phase 7: LPIPS(x, x) = {same}, card {card} against CPU {cpu} ({rel:.3g})")
    return row


def run_counted(fn, *args):
    """``fn(*args)`` with the launch counts set to 0 just before it; returns
    its result, the launches it made and its wall seconds."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, dict(_build.launches), time.perf_counter() - t0


def phase7(work: Path, run_dir: Path, scene_dir: Path, loop_psnr: float, bench_ply: Path):
    """The generator, eval, render-path, export, view and profiler CLIs on
    the card, in-process, each with the launch counts set to 0 just before
    it; then the oracle and the tiled route against the kernel route.
    Returns each CLI's kernel launches."""
    import threading
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.camera import camera_from_matrices
    from gaussian_splatting_lightning_tpu_torch.data.dataset import ColmapDataset
    from gaussian_splatting_lightning_tpu_torch.models import load_ply
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussian_splatting_lightning_tpu_torch.models.ply import read_gaussian_ply
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.ops.rasterize_reference import (
        rasterize_reference,
    )
    from gaussian_splatting_lightning_tpu_torch.ops.rasterize_tiled import rasterize_tiled
    from gaussian_splatting_lightning_tpu_torch.scripts import eval as eval_cli
    from gaussian_splatting_lightning_tpu_torch.scripts import export_splat as export_cli
    from gaussian_splatting_lightning_tpu_torch.scripts import make_synthetic_scene as gen_cli
    from gaussian_splatting_lightning_tpu_torch.scripts import profile_render as prof_cli
    from gaussian_splatting_lightning_tpu_torch.scripts import render as render_cli
    from gaussian_splatting_lightning_tpu_torch.scripts import render_path as path_cli
    from gaussian_splatting_lightning_tpu_torch.scripts import view as view_cli
    from gaussian_splatting_lightning_tpu_torch.training import trainer as tr
    from gaussian_splatting_lightning_tpu_torch.viewer import VIEWER_HTML

    t_phase = time.perf_counter()
    w, h = 1920, 1080
    ply = run_dir / "point_cloud-final.ply"
    launches, row = {}, {}

    def kernels_ran(name, counts, kernels):
        launches[name] = counts
        if any(counts[k] < 1 for k in kernels):
            fail(f"phase 7: {name} did not launch {kernels}: {counts}")

    # (a) the generator at the JAX generator's default operating point
    gen_dir = work / "gen"
    gen, counts, gen_s = run_counted(gen_cli.main, [
        "--out", str(gen_dir), "--n-views", str(SERVE_VIEWS), "--width", str(w),
        "--height", str(h), "--n-splats", str(SERVE_GT), "--device", "cuda"])
    kernels_ran("generator", counts, RENDER_KERNELS)
    pngs = sorted((gen_dir / "images").glob("*.png"))
    ds = ColmapDataset(str(gen_dir), str(gen_dir / "images"), preload_data=False)
    if len(pngs) != SERVE_VIEWS or len(ds) != SERVE_VIEWS:
        fail(f"phase 7: the generator wrote {len(pngs)} PNGs, {len(ds)} COLMAP views")
    if ds[SERVE_VIEWS - 1].image.shape != (3, h, w) or len(ds.reconstruction.points_xyz) != 20_000:
        fail("phase 7: the generated COLMAP model does not read back")
    if any(gen["dropped"]):
        fail(f"phase 7: generator views dropped pairs: {gen['dropped']}")
    row["generator"] = {"s_per_view": gen_s / SERVE_VIEWS, "seconds": gen_s,
                        "max_pairs": gen["max_pairs"], "render_ms": gen["render_ms"]}

    # (b) eval on phase 6's final scene and its held-out views, with LPIPS
    out_json = work / "eval.json"
    lpips_npz = write_lpips_weights(work / "lpips_vgg16.npz")
    res, counts, eval_s = run_counted(eval_cli.main, [
        str(ply), "--colmap", str(scene_dir), "--image-folder", str(scene_dir / "images"),
        "--holdout-every", "8", "--lpips-weights", str(lpips_npz), "--out", str(out_json),
        "--device", "cuda"])
    kernels_ran("eval", counts, RENDER_KERNELS + ("blur",))
    if json.loads(out_json.read_text()) != res or len(res["views"]) != 3:
        fail(f"phase 7: eval gave {len(res['views'])} views or a different --out file")
    psnr_diff = res["mean"]["psnr"] - loop_psnr
    if not abs(psnr_diff) <= EVAL_PSNR_TOL:
        fail(f"phase 7: eval PSNR {res['mean']['psnr']} vs phase 6's held-out {loop_psnr}")
    if not all(0.0 <= v["ssim"] <= 1.0 for v in res["views"]):
        fail(f"phase 7: SSIM outside [0, 1]: {res['views']}")
    row["eval"] = {"mean": res["mean"], "loop_psnr": loop_psnr, "psnr_diff": psnr_diff,
                   "render_ms": [v["render_ms"] for v in res["views"]], "seconds": eval_s}
    row["lpips"] = check_lpips(res, lpips_npz, ply, scene_dir)

    # (c) a looped camera path through the same scene, with a GIF
    frames_dir, gif = work / "path", work / "path.gif"
    res, counts, path_s = run_counted(path_cli.main, [
        str(ply), "--colmap", str(scene_dir), "--image-folder", str(scene_dir / "images"),
        "--n-frames", str(SERVE_FRAMES), "--loop", "--out", str(frames_dir), "--gif",
        str(gif), "--device", "cuda"])
    kernels_ran("render_path", counts, RENDER_KERNELS)
    n_png = len(list(frames_dir.glob("frame_*.png")))
    with Image.open(gif) as im:
        gif_frames, gif_size = im.n_frames, im.size
    if n_png != SERVE_FRAMES or gif_frames != SERVE_FRAMES or gif_size != (w, h):
        fail(f"phase 7: {n_png} PNG frames, a GIF of {gif_frames} frames at {gif_size}")
    if res["dropped_pairs"]:
        fail(f"phase 7: the camera path dropped {res['dropped_pairs']} pairs")
    ev = sorted(res["event_ms"])
    row["render_path"] = {"frame_ms_events_median": ev[len(ev) // 2],
                          "frame_ms_events_min": ev[0], "frame_ms_events_max": ev[-1],
                          "frame_wall": res["wall"], "max_pairs": res["max_pairs"],
                          "gif_bytes": os.path.getsize(gif), "seconds": path_s}

    # (d) export the 1M-splat bench PLY of phase 3
    splat = work / "bench.splat"
    n, _, export_s = run_counted(export_cli.main, [str(bench_ply), "--out", str(splat),
                                                  "--device", "cuda"])
    data = splat.read_bytes()
    if n != 1_000_000 or len(data) != 32 * 1_000_000:
        fail(f"phase 7: exported {n} splats in {len(data)} bytes")
    src = read_gaussian_ply(bench_ply)
    for k in (0, n - 1):  # the record's splat, found by its position
        rec = np.frombuffer(data[32 * k:32 * k + 24], np.float32)
        (hit,) = np.nonzero((src["xyz"] == rec[:3]).all(axis=1))
        if len(hit) != 1 or not np.array_equal(np.exp(src["scales"][hit[0]]), rec[3:6]):
            fail(f"phase 7: .splat record {k} matches no PLY splat's position and scale")
    row["export"] = {"splats": n, "bytes": len(data), "seconds": export_s}

    # (e) the view server on the exported file
    server, n_bytes = view_cli.make_server(str(splat), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        page = urllib.request.urlopen(url + "/", timeout=30).read()
        blob = urllib.request.urlopen(url + "/scene.splat", timeout=60).read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if page != VIEWER_HTML.read_bytes() or blob != data or n_bytes != len(data):
        fail("phase 7: the view server did not serve the viewer page and the .splat")
    if thread.is_alive():
        fail("phase 7: the view server did not stop")
    row["view"] = {"html_bytes": len(page), "splat_bytes": len(blob)}

    # (f) the oracle against the kernel route, and the render CLI on it
    ow, oh = 256, 192
    small = interop.synthetic_scene(ORACLE_SPLATS, ORACLE_SPLATS, aniso=True, seed=7)
    cam = interop.camera(ow, oh)
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    x = (small.params.xyz, small.get_opacity(), small.get_scales(), small.get_rotation(),
         small.get_features(), cam, ow, oh, bg, small.active_sh_degree)
    kw = dict(max_sh_degree=small.max_sh_degree, alive=small.alive)
    small_tiling = TilingConfig(max_pairs=1 << 18, tile_capacity=1024, chunk=64)
    with torch.no_grad():
        ref, _ = tr.resolve_rasterizer("cuda")(*x, config=small_tiling, **kw)
        oracle, counts, oracle_s = run_counted(lambda: rasterize_reference(*x, **kw))
    if any(counts.values()):
        fail(f"phase 7: the oracle launched kernels: {counts}")
    oracle_err = max(float((oracle.image - ref.image).abs().max()),
                     float((oracle.depth - ref.depth).abs().max()))
    if not oracle_err <= K2_TOL:
        fail(f"phase 7: the oracle differs from the kernel route by {oracle_err}")
    _, _, oracle_cli_s = run_counted(render_cli.main, [
        str(ply), "--colmap", str(scene_dir), "--image-folder", str(scene_dir / "images"),
        "--downscale", "0.125", "--use-oracle", "--out", str(work / "oracle.png"),
        "--device", "cuda"])
    row["oracle"] = {"max_abs_err": oracle_err, "ms_256x192": oracle_s * 1e3,
                     "render_cli_s": oracle_cli_s}

    # (g) the tiled route: one held-out view of phase 6's scene at 1080p ...
    scene = load_ply(str(ply))
    view = ColmapDataset(str(scene_dir), str(scene_dir / "images"), preload_data=False)[8]
    vcam = camera_from_matrices(view.viewmatrix, view.projmatrix, view.campos,
                                view.tanfovx, view.tanfovy)
    vbg = torch.zeros(3, device="cuda")
    tiling = TilingConfig(max_pairs=1 << 22, tile_capacity=4096, chunk=64)

    def tiled_render():
        return tr.render_scene(scene, vcam, w, h, vbg, tiling, rasterize_fn=rasterize_tiled)

    with torch.no_grad():
        # the device's share of a camera-path frame: the same render on the
        # path's budget, profiled, against the path's median host wall
        # (the captured render, as the path CLI replays it)
        path_render = tr.make_render(w, h, TilingConfig(max_pairs=row["render_path"]["max_pairs"]))
        profile_render(lambda: path_render(scene, vcam, vbg),
                       row["render_path"]["frame_wall"]["p50_ms"], unit="path_frame")
        del path_render
        ref, ref_stats = tr.render_scene(scene, vcam, w, h, vbg, tiling)
        tiled_render()  # warm-up: allocator
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        (tiled, stats), counts, tiled_s = run_counted(tiled_render)
        peak = torch.cuda.max_memory_allocated()
    if any(counts.values()) or int(ref_stats["num_dropped_pairs"]):
        fail(f"phase 7: tiled route launched {counts}, kernel route dropped pairs")
    tiled_err = max(float((tiled.image - ref.image).abs().max()),
                    float((tiled.depth - ref.depth).abs().max()))
    stats = {k: int(v) for k, v in stats.items()}
    if not tiled_err <= K2_TOL or stats["num_tile_overflow"] or stats["num_dropped_pairs"]:
        fail(f"phase 7: tiled route at 1080p: error {tiled_err}, stats {stats}")
    del scene, tiled, ref
    # ... and its gradients at 256x192 on the 2k scene
    target = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(3, oh, ow)).astype(np.float32)).cuda()
    grads = {}
    for route in ("cuda", "xla"):
        g, screen, *_ = tr.step_gradients(tr.TrainConfig(rasterizer=route, tiling=small_tiling),
                                          small, cam, ow, oh, target, bg)
        grads[route] = dict({k: getattr(g, k) for k in PARAM_NAMES}, means2d_ndc_offset=screen)
    grad_err = {}
    for k, b in grads["cuda"].items():
        a = grads["xla"][k]
        scale = float(b.abs().max())
        grad_err[k] = float((a - b).abs().max()) / scale if scale > 0 else float(a.abs().max())
    if not all(v <= STEP_GRAD_TOL for v in grad_err.values()):
        fail(f"phase 7: tiled-route gradients differ from the kernel route's: {grad_err}")
    row["tiled"] = {"max_abs_err_1080p": tiled_err, "ms_1080p": tiled_s * 1e3,
                    "peak_mem_bytes_1080p": peak, "mem_bytes_before": base_mem,
                    "stats_1080p": stats, "grad_rel_err": grad_err}

    # (h) the profiler CLI at its default operating point, and its trace; its
    # table runs to 60 rows, since K1 (~0.005 ms here) ranks below the top 20
    trace_dir = work / "trace"
    (rows, _), counts, prof_s = run_counted(prof_cli.main, ["--trace-dir", str(trace_dir),
                                                            "--top", "60"])
    kernels_ran("profile_render", counts, RASTER_KERNELS)
    names = " ".join(r[0] for r in rows)
    traces = list(trace_dir.glob("trace-*.json"))
    if "expand_pairs_kernel" not in names or "composite_fwd_kernel" not in names:
        fail(f"phase 7: the profiler's table lacks K1 or K2: {names[:500]}")
    if len(traces) != 1 or traces[0].stat().st_size == 0:
        fail(f"phase 7: trace files {traces}")
    row["profile_render"] = {"top": [[r[0][:60], r[1], r[2]] for r in rows[:6]],
                             "trace_bytes": traces[0].stat().st_size, "seconds": prof_s}
    row["launches"] = launches
    row["phase_s"] = time.perf_counter() - t_phase
    print("serve: " + json.dumps(row), flush=True)
    return launches


# phase 8: the view-batched step at full width (the bench scene at 1080p)
BATCH_SIZES = (1, 2, 4)
BATCH_STEPS = 10
# launches per step at B = 4 less those at B = 1, at most: K1-K5, the
# preprocess pair and Adam launch once a step at any B, so only the per-view
# PyTorch work adds launches (+92 on the card with Adam's kernel)
BATCH_LAUNCH_GROWTH = 100


def _prep_views(scene, cams, w, h):
    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras

    return _prep(scene, stack_cameras(cams), w, h)


def check_batched_kernels(scene, cams, w, h, blk, max_pairs, against_plain):
    """K1-K4 on a stack of ``cams`` against their plain versions, view by
    view. ``against_plain`` holds K2 and K3 to their plain versions (small
    shapes); otherwise to the single-view launches on each view, bit for bit
    (at 1080p, where the plain K2 and K3 cost seconds a view). Returns the
    largest errors, and the batched launches' inputs for timing."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.ops import binning, rasterize

    b = len(cams)
    stacked = _prep_views(scene, cams, w, h)
    gx, gy = binning.grid_shape(w, h, blk, blk)
    bins = binning.build_sorted_bins(stacked, gx, gy, max_pairs, block=blk)
    plain = binning.build_sorted_bins(stacked, gx, gy, max_pairs, block=blk, plain=True)
    for name, x, y in zip(bins._fields, bins, plain):
        if not torch.equal(x, y):
            fail(f"batched K1, B = {b}: bins field {name} differs from the plain version's")
    if int(bins.num_dropped.sum()):
        fail(f"batched K1, B = {b}: pairs dropped {bins.num_dropped.tolist()}")
    gfeat = rasterize.feature_table(stacked, w, h, blk)
    bg = torch.tensor([[0.1, 0.2, 0.3]] * b, device="cuda")
    fwd = (gfeat, bins.gauss_s, bins.tile_start, bins.tile_count, bg, gx, blk)
    out = rasterize.composite_fwd(*fwd)
    out_again = rasterize.composite_fwd(*fwd)
    gen = torch.Generator(device="cuda").manual_seed(5)
    grad_out = torch.randn(out.shape, device="cuda", generator=gen) * 1e-3
    bwd = (gfeat, bins.gauss_s, bins.slot_s, bins.tile_start, bins.tile_count, out,
           grad_out, gx, blk, max_pairs)
    dk = rasterize.composite_bwd(*bwd)
    dk_again = rasterize.composite_bwd(*bwd)
    seg = (dk, bins.offsets, bins.ntiles, bins.order)
    sk = rasterize.segment_sum(*seg)
    sk_again = rasterize.segment_sum(*seg)
    sp = rasterize.segment_sum_plain(*seg)
    torch.cuda.synchronize()
    if not (torch.equal(out, out_again) and torch.equal(dk, dk_again)
            and torch.equal(sk, sk_again)):
        fail(f"batched K2-K4, B = {b}: a second run gave other bits")
    errs = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    ng = rasterize.NGRAD
    for v in range(b):
        if against_plain:
            out_p = rasterize.composite_fwd_plain(*(x[v] for x in fwd[:5]), gx, blk)
            dp = rasterize.composite_bwd_plain(*(x[v] for x in bwd[:7]), gx, blk, max_pairs)
            errs["K2"] = max(errs["K2"], float((out[v] - out_p).abs().max()))
            errs["K3"] = max(errs["K3"], col_err(dk[v], dp))
            if not torch.equal(dk[v].abs().sum(1) == 0, dp.abs().sum(1) == 0):
                fail(f"batched K3, B = {b}, view {v}: other zero rows than the plain version")
        else:
            one = rasterize.composite_fwd(*(x[v] for x in fwd[:5]), gx, blk)
            d1 = rasterize.composite_bwd(*(x[v] for x in bwd[:7]), gx, blk, max_pairs)
            if not (torch.equal(out[v], one) and torch.equal(dk[v], d1)):
                fail(f"batched K2/K3, B = {b}, view {v}: not the single-view launch's bits")
        errs["K4"] = max(errs["K4"], col_err(sk[v, :, :ng], sp[v, :, :ng]))
    for name, tol in (("K2", K2_TOL), ("K3", K3_TOL), ("K4", K4_TOL)):
        if not errs[name] <= tol:
            fail(f"batched {name}, B = {b}: error {errs[name]} > {tol}")
    ctx = dict(inp=binning.expand_inputs(stacked, gx, gy, 0, gy, blk)[0], gx=gx,
               n_tiles=gx * gy, fwd=fwd, bwd=bwd, seg=seg)
    return errs, ctx


def batched_kernel_ms(ctx, max_pairs, blk):
    """Each batched kernel's time on the step's own inputs (CUDA events)."""
    from gaussian_splatting_lightning_tpu_torch.ops import binning, rasterize

    return {
        "expand_pairs": cuda_time_ms(lambda: binning.expand_pairs(
            ctx["inp"], max_pairs, ctx["gx"], ctx["n_tiles"], 0, blk), 10),
        "composite_fwd": cuda_time_ms(lambda: rasterize.composite_fwd(*ctx["fwd"]), 5),
        "composite_bwd": cuda_time_ms(lambda: rasterize.composite_bwd(*ctx["bwd"]), 5),
        "segment_sum": cuda_time_ms(lambda: rasterize.segment_sum(*ctx["seg"]), 10),
    }


def check_batched_gradients(scene, cams, w, h, tiling):
    """The B = 4 step's gradients on route "cuda" against the mean of the
    four single-view steps' (each column's maximum), its screen-space
    gradients against the stacked single-view ones, radii exactly."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussian_splatting_lightning_tpu_torch.training import trainer

    b = len(cams)
    gen = torch.Generator(device="cuda").manual_seed(7)
    targets = torch.rand((b, 3, h, w), device="cuda", generator=gen)
    bgs = torch.rand((b, 3), device="cuda", generator=gen)
    g, screen, _, radii, logs, _ = trainer.step_gradients(
        trainer.TrainConfig(tiling=tiling, batch_views=b), scene, stack_cameras(cams),
        w, h, targets, bgs)
    single = [trainer.step_gradients(trainer.TrainConfig(tiling=tiling), scene, cams[v],
                                     w, h, targets[v], bgs[v]) for v in range(b)]
    errs = {}
    for k in PARAM_NAMES:
        mean = sum(getattr(s[0], k) for s in single) / b
        errs[k] = col_err(getattr(g, k).reshape(mean.shape[0], -1),
                          mean.reshape(mean.shape[0], -1))
    errs["means2d_ndc_offset"] = max(col_err(screen[v], single[v][1]) for v in range(b))
    loss = sum(float(s[4]["loss"]) for s in single) / b
    errs["loss"] = abs(float(logs["loss"]) - loss) / loss
    if not all(torch.equal(radii[v], single[v][3]) for v in range(b)):
        fail("phase 8: the batched step's radii differ from the single-view steps'")
    bad = {k: v for k, v in errs.items() if not v <= STEP_GRAD_TOL}
    if bad:
        fail(f"phase 8: B = {b} step gradients differ from the single-view mean: {bad}")
    return errs


def phase8(scene, budget):
    """The view-batched train step at 1080p on phase 5's scene and budget."""
    import numpy as np
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training import trainer
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam

    t_phase = time.perf_counter()
    w, h, blk = 1920, 1080, 32
    cams = orbit_cameras(w, h)
    targets = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(len(cams), 3, h, w)).astype(np.float32)).cuda()
    tiling = TilingConfig(max_pairs=budget, block=blk)
    m = -(-budget // 128) * 128
    # every kernel's count, K5's 0: the step's loss is the photometric kernels
    expected = dict(TRAIN_STEP_LAUNCHES, preprocess_fwd=1, preprocess_bwd=1, blur=0)
    rows, launches, by_kernel, graphs = {}, {}, {}, {}
    for b in BATCH_SIZES:
        cfg = trainer.TrainConfig(tiling=tiling, batch_views=b)
        if b == 1:
            cam, img, bg = cams[0], targets[0], torch.zeros(3, device="cuda")
        else:
            cam, img, bg = stack_cameras(cams[:b]), targets[:b], torch.zeros(b, 3, device="cuda")

        def stepper(step_fn):
            state = {"scene": copy_scene(scene), "adam": init_adam(scene.params), "step": 0}

            def one_step():
                state["scene"], state["adam"], logs = step_fn(
                    state["scene"], state["adam"], state["step"], cam, img, bg)
                state["step"] += 1
                return logs

            return one_step

        # eager beside the captured step: its wall, events, busy time and peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        eager_step = stepper(trainer.make_train_step(cfg, 1.0, w, h, capture=False))
        eager_step()
        eager_side = graph_side(eager_step, 3, "step", 0, expected)
        eager_side["peak_mem_added_bytes"] = torch.cuda.max_memory_allocated() - held
        del eager_step
        torch.cuda.empty_cache()

        step_fn = trainer.make_train_step(cfg, 1.0, w, h)
        one_step = stepper(step_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        one_step()  # warm-up, capture, replay
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        step_ms, syncs = [], []
        for _ in range(BATCH_STEPS):
            before = dict(_build.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with count_syncs() as caught:
                logs = one_step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            syncs.append(n_syncs(caught))
            launched = {k: _build.launches[k] - before[k] for k in before}
            loss, dropped = float(logs["loss"]), int(logs["num_dropped_pairs"])
            if not math.isfinite(loss) or dropped or launched != expected:
                fail(f"phase 8, B = {b}: loss {loss}, {dropped} pairs dropped, "
                     f"launches {launched}")
        launches[b] = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated()
        wall = sorted(step_ms)[len(step_ms) // 2]
        event_ms = cuda_time_ms(one_step, 3)
        prof = profile_render(one_step, wall, reps=3, unit="step")
        if prof is None:
            fail(f"phase 8, B = {b}: the profiler saw no device activity")
        graphs[b] = {"capture_s": step_fn.captured.capture_s, "captured": {
            "wall_ms": wall, "event_ms": event_ms,
            "busy_ms": prof["device_busy_ms_per_step"],
            "idle_share": prof["device_idle_share"],
            "device_launches": prof["device_kernels_per_step"],
            "kernel_launches": step_fn.captured.launches,
            "peak_mem_added_bytes": peak - held},
            "eager": eager_side}
        del one_step, step_fn
        errs_1080, ctx = check_batched_kernels(scene, cams[:b], w, h, blk, m, False)
        kernel_ms = batched_kernel_ms(ctx, m, blk)
        del ctx
        small = interop.synthetic_scene(20_000, 20_000, aniso=True, scale=0.01)
        errs_small, _ = check_batched_kernels(small, orbit_cameras(256, 192)[:b], 256, 192,
                                              blk, 1 << 18, True)
        del small
        row = {"views": b, "step_wall_ms_median": wall, "step_wall_ms": step_ms,
               "wall_ms_per_view": wall / b, "step_event_ms": event_ms,
               "event_ms_per_view": event_ms / b,
               "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
               "device_idle_share": prof["device_idle_share"],
               "launches_per_step": prof["device_kernels_per_step"],
               "host_syncs": [min(syncs), max(syncs)], "kernel_launches": launches[b],
               "loss": float(logs["loss"]), "num_pairs": int(logs["num_pairs"]),
               "dropped": 0, "peak_mem_bytes": peak, "kernel_ms": kernel_ms,
               "kernel_err_1080p": errs_1080, "kernel_err_256x192": errs_small}
        print("train_step_batched: " + json.dumps(row), flush=True)
        rows[b] = row
        by_kernel[b] = prof["launches_by_kernel"]
        torch.cuda.empty_cache()
    ratio = rows[4]["launches_per_step"] / rows[1]["launches_per_step"]
    growth = rows[4]["launches_per_step"] - rows[1]["launches_per_step"]
    if not growth <= BATCH_LAUNCH_GROWTH:
        fail(f"phase 8: launches per step at B = 4 are {growth} more than at B = 1")
    grad_err = check_batched_gradients(scene, cams, w, h, tiling)
    # which kernels the four views launch more (or less) often than one
    names = set(by_kernel[1]) | set(by_kernel[4])
    launch_diff = sorted(((by_kernel[4].get(k, 0) - by_kernel[1].get(k, 0), k[:90])
                          for k in names), key=lambda x: -abs(x[0]))
    launch_diff = [d for d in launch_diff if d[0]]
    summary = {
        "ms_per_view_wall": {b: r["wall_ms_per_view"] for b, r in rows.items()},
        "ms_per_view_events": {b: r["event_ms_per_view"] for b, r in rows.items()},
        "launches_per_step": {b: r["launches_per_step"] for b, r in rows.items()},
        "launch_ratio_4_to_1": ratio, "launch_growth_4_over_1": growth,
        "launch_diff_4_vs_1": launch_diff,
        "peak_mem_bytes": {b: r["peak_mem_bytes"] for b, r in rows.items()},
        "grad_rel_err_b4_vs_single_mean": grad_err, "phase_s": time.perf_counter() - t_phase,
    }
    print("phase8: " + json.dumps(summary), flush=True)
    print("graph: " + json.dumps({"phase": "8 batched step", "by_views": graphs}), flush=True)
    return launches


# phase 9: the mesh (parallel/) at full width. One card cannot hold a
# multi-card mesh: (a) a 1x1 mesh on NCCL in this process, (b) four ranks
# sharing the card over gloo, (c) the train CLI on four such ranks
MESH_LOSS_TOL = 1e-5  # the sharded step's loss against the one-process step's
MESH_GRAD_TOL = 1e-4  # its gradients (Adam's first moments after step 0)
MESH_RENDER_TOL = 1e-4  # sharded_render against render_scene
MESH_CLI_TOL = 2e-4  # the CLI's logged losses, mesh against one process
MESH_SHAPES = ((1, 4), (2, 2))
MESH_TIMED_STEPS = 2
MESH_CLI_SETS = {
    "train.num_iters": 60, "train.densify.densify_since": 29,
    "train.densify.densify_interval": 30, "train.densify.densify_until": 31,
    "train.densify.densify_grad_threshold": 0.0, "train.log_interval": 10,
    "train.overflow_check_interval": 10, "train.checkpoint_interval": 60,
    "train.valid_interval": 1000,
}
SHARING = "four ranks sharing one card over gloo: not a scaling number"
# the (1, 4) bands whose launches are held to the plain versions on the
# same inputs: a middle band and the band across the image's bottom edge
MESH_CHECK_TILES = (1, 3)
# each wrapper (by its _build name): its module, its name, its plain version's
KERNEL_SITES = {
    "expand_pairs": ("binning", "expand_pairs", "expand_pairs_plain"),
    "composite_fwd": ("rasterize", "composite_fwd", "composite_fwd_plain"),
    "composite_bwd": ("rasterize", "composite_bwd", "composite_bwd_plain"),
    "segment_sum": ("rasterize", "segment_sum", "segment_sum_plain"),
    "blur": ("ssim", "blur_valid", "blur_valid_plain"),
}
BAND_TOL = {"expand_pairs": 0, "composite_fwd": K2_TOL, "composite_bwd": K3_TOL,
            "segment_sum": K4_TOL, "blur": 0}


@contextlib.contextmanager
def record_kernel_calls():
    """Record every K1-K5 wrapper call's arguments and result while the
    block runs; the wrappers launch and count as they do without it."""
    import importlib

    calls = {name: [] for name in KERNEL_SITES}
    patched = []
    for name, (mod_name, fn_name, _) in KERNEL_SITES.items():
        mod = importlib.import_module(f"{PKG}.ops.{mod_name}")
        orig = getattr(mod, fn_name)

        def recorder(*args, _orig=orig, _calls=calls[name], **kw):
            out = _orig(*args, **kw)
            _calls.append((args, kw, out))
            return out

        setattr(mod, fn_name, recorder)
        patched.append((mod, fn_name, orig))
    try:
        yield calls
    finally:
        for mod, fn_name, orig in patched:
            setattr(mod, fn_name, orig)


def band_kernel_errs(calls) -> dict:
    """Each recorded launch against its plain version on the same inputs:
    K1's keys and ids and K5's output as the largest |difference| (held to
    0), K2's largest |difference|, K3's and K4's each column's over its
    largest |plain|, view by view (K3's zero rows must match too). K2's row
    also counts its work as its bound does: (pair, pixel) evaluations up to
    each tile's early stop, and those past the kill."""
    import importlib

    import torch

    from gaussian_splatting_lightning_tpu_torch.ops.rasterize import NGRAD

    def per_view(x):
        return list(x) if x.dim() == 3 else [x]

    errs = {}
    for name, (mod_name, _, plain_name) in KERNEL_SITES.items():
        plain = getattr(importlib.import_module(f"{PKG}.ops.{mod_name}"), plain_name)
        worst, evaluations, kept = 0.0, 0, 0
        for args, kw, got in calls[name]:
            with torch.no_grad():
                if name == "composite_fwd":
                    want, evals, keep = plain(*args, **kw, return_work=True)
                    evaluations += int(evals.sum()) * args[6] ** 2
                    kept += int(keep.sum())
                else:
                    want = plain(*args, **kw)
            if name == "expand_pairs":
                err = max(float((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
                worst = max(worst, err)
                continue
            got = got.detach()  # a launch's output joins the autograd graph after it
            if name in ("composite_fwd", "blur"):
                err = float((got - want).abs().max())
            elif name == "composite_bwd":
                err = max(col_err(g, w) for g, w in zip(per_view(got), per_view(want)))
                if not torch.equal(got.abs().sum(-1) == 0, want.abs().sum(-1) == 0):
                    err = math.inf  # other zero rows than the plain version's
            else:
                err = max(col_err(g[:, :NGRAD], w[:, :NGRAD])
                          for g, w in zip(per_view(got), per_view(want)))
            worst = max(worst, err)
        errs[name] = {"calls": len(calls[name]), "err": worst}
        if name == "composite_fwd":
            errs[name].update(evaluations=evaluations, kept=kept)
    return errs


def moment_errs(got, want) -> dict:
    """``col_err`` of each Adam first-moment group ((1 - beta1) times the
    step's gradient after step 0)."""
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES

    cap = want.xyz.shape[0]
    return {k: col_err(getattr(got, k).reshape(cap, -1), getattr(want, k).reshape(cap, -1))
            for k in PARAM_NAMES}


TORCHRUN = ["-m", "torch.distributed.run", "--standalone"]


def run_group(args, timeout: int, what: str, stderr=subprocess.STDOUT):
    """``python args`` in its own process group, so that a timeout stops it
    and every process it started (SIGTERM first: torchrun's agent passes it
    on to its ranks, which run in sessions of their own); returns (rc,
    stdout, stderr or None)."""
    import signal

    proc = subprocess.Popen([sys.executable] + args, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=stderr, text=True, process_group=0)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        fail(f"{what}: {args[:6]} ran past {timeout} s:\n{out[-3000:]}\n{(err or '')[-3000:]}")
    return proc.returncode, out, err


def phase9_nccl(scene, budget):
    """(a) A 1x1 mesh on NCCL in this process: the captured sharded step
    (what ``Trainer(mesh=…)`` runs), the eager one (``capture=False``) and
    phase 5's captured one-process step, TRAIN_STEPS + 1 steps each from the
    same start on the bench view."""
    import socket

    from gaussian_splatting_lightning_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        shutdown,
    )

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    info = init_distributed("cuda", rank=0, world_size=1, init_method=f"tcp://localhost:{port}")
    mesh = None
    try:
        mesh = make_mesh(1, 1, info=info)
        if mesh.backend != "nccl":
            fail(f"phase 9: a 1x1 mesh on one card chose {mesh.backend}")
        row, graph_line, launches = nccl_runs(scene, budget, mesh)
    finally:
        shutdown(mesh)  # the steps' graphs go before the communicators they use
    print("mesh_1x1: " + json.dumps(row), flush=True)
    print_graph_line("9 mesh_1x1", **graph_line)
    if not row["loss_rel_err"] <= MESH_LOSS_TOL or row["dropped"]:
        fail(f"phase 9 (a): loss error {row['loss_rel_err']}, {row['dropped']} pairs dropped")
    bad = {k: v for k, v in row["grad_rel_err"].items() if not v <= MESH_GRAD_TOL}
    if bad:
        fail(f"phase 9 (a): the 1x1 mesh step's gradients differ: {bad}")
    if not all(row["captured_vs_eager_bits_equal"].values()):
        fail(f"phase 9 (a): the captured mesh step differs from the eager one: "
             f"{row['captured_vs_eager_bits_equal']}")
    want = {k: TRAIN_STEPS * n for k, n in MESH_STEP_LAUNCHES.items()}
    if launched_kernels(launches) != want or row["captures"] != 1:
        fail(f"phase 9 (a): {TRAIN_STEPS} replays launched {launches} (want {want}), "
             f"{row['captures']} captures")
    return launches


def nccl_runs(scene, budget, mesh):
    """Phase 9 (a)'s three runs on ``mesh``; returns the ``mesh_1x1:`` row,
    the ``graph:`` line's fields and the captured mesh step's launches over
    its TRAIN_STEPS timed replays. Every graph is gone when it returns."""
    import numpy as np
    import torch

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.parallel.shard import (
        make_sharded_train_step,
        shard_adam,
    )
    from gaussian_splatting_lightning_tpu_torch.training import trainer
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam

    w, h = 1920, 1080
    cam = interop.camera(w, h)
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(3, h, w)).astype(np.float32)).cuda()
    bg = torch.zeros(3, device="cuda")
    cfg = trainer.TrainConfig(tiling=TilingConfig(max_pairs=budget, block=32),
                              capacity=scene.capacity)
    steps = {"mesh": make_sharded_train_step(cfg, 1.0, w, h, mesh),
             "mesh_eager": make_sharded_train_step(cfg, 1.0, w, h, mesh, capture=False),
             "single": trainer.make_train_step(cfg, 1.0, w, h)}
    cams = stack_cameras([cam])
    runs = {}
    for name, fn in steps.items():
        adam = init_adam(scene.params)
        if name != "single":
            adam = shard_adam(adam, mesh)
            args = (cams, target[None], bg[None])
        else:
            args = (cam, target, bg)
        st = {"scene": copy_scene(scene), "adam": adam, "step": 0}  # each run its own

        def one_step(fn=fn, st=st, args=args):
            st["scene"], st["adam"], logs = fn(st["scene"], st["adam"], st["step"], *args)
            st["step"] += 1
            return logs

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        logs = one_step()
        torch.cuda.synchronize()
        # copies: the captured steps update their moments in place
        mu0 = {k: getattr(st["adam"].mu, k).clone() for k in PARAM_NAMES}
        losses, dropped = [float(logs["loss"])], int(logs["num_dropped_pairs"])
        _build.reset_launch_counts()
        walls = []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = one_step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(logs["loss"]))
            dropped += int(logs["num_dropped_pairs"])
        runs[name] = dict(st=st, one_step=one_step, mu0=mu0, losses=losses, walls=walls,
                          dropped=dropped, launches=dict(_build.launches),
                          peak=torch.cuda.max_memory_allocated() - held)
    cap, eag, one = runs["mesh"], runs["mesh_eager"], runs["single"]
    bits = {"losses": cap["losses"] == eag["losses"]}
    for part in ("params", "mu", "nu"):
        for k in PARAM_NAMES:
            get = ((lambda r, k=k: getattr(r["st"]["scene"].params, k)) if part == "params"
                   else (lambda r, k=k, part=part: getattr(getattr(r["st"]["adam"], part), k)))
            bits[f"{part}.{k}"] = torch.equal(get(cap), get(eag))
    for k in ("max_radii2d", "grad_accum", "grad_count"):
        bits[k] = torch.equal(getattr(cap["st"]["scene"], k), getattr(eag["st"]["scene"], k))
    cap_mu = type(scene.params)(**cap["mu0"])
    one_mu = type(scene.params)(**one["mu0"])
    row = {"backend": mesh.backend, "loss": cap["losses"][0],
           "loss_rel_err": abs(cap["losses"][0] - one["losses"][0]) / abs(one["losses"][0]),
           "loss_rel_err_11_steps": max(abs(a - b) / abs(b) for a, b in zip(cap["losses"],
                                                                             one["losses"])),
           "grad_rel_err": moment_errs(cap_mu, one_mu),
           "captured_vs_eager_bits_equal": bits,
           "dropped": sum(r["dropped"] for r in runs.values()),
           "captures": steps["mesh"].captured.captures,
           "step_wall_ms_median": {k: sorted(r["walls"])[TRAIN_STEPS // 2]
                                   for k, r in runs.items()},
           "step_wall_ms": {k: r["walls"] for k, r in runs.items()},
           "peak_mem_added_bytes": {k: r["peak"] for k, r in runs.items()},
           "launches": {k: r["launches"] for k, r in runs.items()}}
    del cap_mu, one_mu
    sides = {name: dict(graph_side(runs[name]["one_step"], 5, "step", runs[name]["peak"],
                                   runs[name]["launches"]),
                        step_wall_ms_median=row["step_wall_ms_median"][name])
             for name in ("mesh", "mesh_eager")}
    graph_line = dict(capture_s=steps["mesh"].captured.capture_s, captured=sides["mesh"],
                      eager=sides["mesh_eager"], one_process_step_wall_ms_median=(
                          row["step_wall_ms_median"]["single"]))
    launches = cap["launches"]
    del runs, steps, cap, eag, one
    torch.cuda.empty_cache()
    return row, graph_line, launches


def mesh_ranks(budget: int, out_path: str) -> int:
    """(b) One rank under torchrun: the one-process step and render on this
    rank, then for each mesh shape the sharded step (launch counts set to 0
    just before it), two timed steps and ``sharded_render``; rank 0 writes
    every rank's numbers to ``out_path``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
        PARAM_NAMES,
        GaussianParams,
    )
    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        sharded_render,
    )
    from gaussian_splatting_lightning_tpu_torch.parallel.shard import (
        make_sharded_train_step,
        shard_adam,
    )
    from gaussian_splatting_lightning_tpu_torch.training import trainer
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam

    info = init_distributed("cuda")
    w, h, blk, views = 1920, 1080, 32, 2
    scene = interop.synthetic_scene(1_000_000, 1_000_000, sh_degree=3, scale=0.008)
    cams = orbit_cameras(w, h)
    targets = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(len(cams), 3, h, w)).astype(np.float32))[:views].cuda()
    cams = cams[:views]
    bgs = torch.zeros(views, 3, device="cuda")
    whole_tiling = TilingConfig(max_pairs=budget, block=blk)
    # the reference of the sharded steps, eager: its job is values
    one = trainer.make_train_step(trainer.TrainConfig(tiling=whole_tiling, batch_views=views),
                                  1.0, w, h, capture=False)
    _, adam1, logs1 = one(copy_scene(scene), init_adam(scene.params), 0, stack_cameras(cams),
                          targets, bgs)
    ref_loss, ref_mu = float(logs1["loss"]), adam1.mu
    with torch.no_grad():
        ref_img, ref_stats = trainer.render_scene(scene, cams[0], w, h, bgs[0], whole_tiling)
    rows = {"rank": info.rank, "backend": info.backend,
            "ref_dropped": int(logs1["num_dropped_pairs"]) + int(ref_stats["num_dropped_pairs"])}
    del adam1
    for v, t in MESH_SHAPES:
        mesh = make_mesh(v, t, info=info)
        b = views // v
        local = slice(mesh.axis_index("view") * b, (mesh.axis_index("view") + 1) * b)
        # every band's budget is the whole image's: no band may drop pairs
        cfg = trainer.TrainConfig(tiling=TilingConfig(max_pairs=budget * t, block=blk),
                                  capacity=scene.capacity, batch_views=b)
        step = make_sharded_train_step(cfg, 1.0, w, h, mesh)
        adam = init_adam(scene.params)
        if step.sharded_adam:
            adam = shard_adam(adam, mesh)
        args = (stack_cameras(cams[local]), targets[local], bgs[local])
        check = (v, t) == (1, 4) and mesh.axis_index("tile") in MESH_CHECK_TILES
        torch.cuda.synchronize()
        mesh.barrier()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with record_kernel_calls() if check else contextlib.nullcontext() as calls:
            state = step(copy_scene(scene), adam, 0, *args)
            torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.launches)
        band_kernels = None
        if check:  # this band's launches against the plain versions
            k1_args = calls["expand_pairs"][0][0] if calls["expand_pairs"] else (None,) * 5
            band_kernels = {"tile_y_offset": k1_args[4], "want_offset":
                            mesh.axis_index("tile") * step.gy_local,
                            "band_max_pairs": k1_args[1], **band_kernel_errs(calls)}
            del calls, k1_args
        mu = state[1].mu
        if step.sharded_adam:
            mu = GaussianParams(**{k: mesh.all_gather(getattr(mu, k), "world")
                                   for k in PARAM_NAMES})
        grad_err = moment_errs(mu, ref_mu)
        del mu
        loss = float(state[2]["loss"])
        band = {k: [int(x) for x in val] for k, val in step.band_stats.items()}
        dropped = int(state[2]["num_dropped_pairs"])
        walls = []
        for i in range(1, 1 + MESH_TIMED_STEPS):
            torch.cuda.synchronize()
            mesh.barrier()
            t0 = time.perf_counter()
            state = step(state[0], state[1], i, *args)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        del state
        image, _, depth = sharded_render(scene, cams[0], w, h, bgs[0], mesh, whole_tiling)
        rows[f"{v}x{t}"] = {
            "view": mesh.axis_index("view"), "tile": mesh.axis_index("tile"),
            "loss": loss, "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
            "grad_rel_err": grad_err, "dropped": dropped, "band_num_pairs": band["num_pairs"],
            "band_dropped": band["num_dropped_pairs"], "launches": launches,
            "first_step_ms": first_ms, "step_wall_ms": walls,
            "render_err": float((image - ref_img.image).abs().max()),
            "render_depth_err": float((depth - ref_img.depth).abs().max()),
            "sharded_adam": step.sharded_adam, "band_kernels": band_kernels,
        }
        del image, depth
        torch.cuda.empty_cache()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, rows)
    if info.rank == 0:
        Path(out_path).write_text(json.dumps(every))
    dist.destroy_process_group()
    return 0


def phase9_ranks(budget: int, work: Path):
    """(b) Four ranks sharing the card over gloo, meshes (1, 4) and (2, 2):
    each rank's sharded step against the one-process step on the same global
    batch, its bands, its launches and its wall per step."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.ops import _build

    torch.cuda.empty_cache()
    out = work / "mesh_ranks.json"
    t0 = time.perf_counter()
    rc, text, _ = run_group(TORCHRUN + ["--nproc-per-node", "4", str(ROOT / "chip_smoke.py"),
                                        "--mesh-ranks", str(budget), str(out)], 400, "phase 9")
    if rc != 0 or not out.exists():
        fail(f"phase 9 (b): the ranks exited {rc}:\n{text[-12000:]}")
    ranks = json.loads(out.read_text())
    summary = {"note": SHARING, "backend": ranks[0]["backend"],
               "launch_s": time.perf_counter() - t0}
    launches = {}
    for shape in (f"{v}x{t}" for v, t in MESH_SHAPES):
        rows = [r[shape] for r in ranks]
        for r in ranks:
            print(f"mesh_rank {shape}: " + json.dumps(dict(r[shape], rank=r["rank"])),
                  flush=True)
        launches[shape] = [r["launches"] for r in rows]
        bad = [r["rank"] for r in ranks if not (
            r[shape]["loss_rel_err"] <= MESH_LOSS_TOL and r[shape]["dropped"] == 0
            and not any(r[shape]["band_dropped"])
            and all(e <= MESH_GRAD_TOL for e in r[shape]["grad_rel_err"].values())
            and r[shape]["render_err"] <= MESH_RENDER_TOL
            and r[shape]["render_depth_err"] <= MESH_RENDER_TOL
            and all(r[shape]["launches"][k] >= 1 for k in MESH_KERNELS))]
        if bad or any(r["ref_dropped"] for r in ranks):
            fail(f"phase 9 (b), mesh {shape}: ranks {bad} fail their checks")
        checked = {r["rank"]: r[shape]["band_kernels"] for r in ranks
                   if r[shape]["band_kernels"] is not None}
        want = len(MESH_CHECK_TILES) if shape == "1x4" else 0
        bad = {k: c for k, c in checked.items() if not (
            c["tile_y_offset"] == c["want_offset"] > 0
            and all(c[n]["calls"] >= (2 if n == "blur" else 1) and c[n]["err"] <= tol
                    for n, tol in BAND_TOL.items()))}
        if bad or len(checked) != want:
            fail(f"phase 9 (b), mesh {shape}: band kernels against plain {checked}")
        walls = [x for r in rows for x in r["step_wall_ms"]]
        summary[shape] = {
            "step_wall_ms_median": sorted(walls)[len(walls) // 2], "step_wall_ms": walls,
            "loss_rel_err_max": max(r["loss_rel_err"] for r in rows),
            "grad_rel_err_max": max(max(r["grad_rel_err"].values()) for r in rows),
            "render_err_max": max(r["render_err"] for r in rows),
            "band_num_pairs": {f"{r['view']},{r['tile']}": r["band_num_pairs"] for r in rows},
        }
        if checked:
            summary[shape]["band_kernels"] = checked
            band_errs = {n: max(c[n]["err"] for c in checked.values()) for n in BAND_TOL}
    print("mesh_ranks: " + json.dumps(summary), flush=True)
    return launches, band_errs


def phase9_cli(work: Path, scene_dir: Path, loop_run: Path):
    """(c) The train CLI under torchrun with mesh_view=2, mesh_tile=2 at
    phase 6's operating point cut to 60 steps (one densify event at
    threshold 0) against the one-process CLI at ``batch_views=2``."""
    from gaussian_splatting_lightning_tpu_torch.scripts import train as train_cli

    start = json.loads((loop_run / "config.json").read_text())["train"]["tiling"]["max_pairs"]
    sets = dict(LOOP_SETS, **MESH_CLI_SETS, **{
        "data.colmap_path": str(scene_dir), "data.image_folder": str(scene_dir / "images"),
        # phase 6 starts at half the init estimate and grows; here no budget
        # may grow or drop, so both runs start at four times the estimate
        "train.tiling.max_pairs": 8 * start})
    argv = ["-c", str(ROOT / "configs" / "rehearsal_synthetic.yaml"), "--device", "cuda"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    t0 = time.perf_counter()
    rc, text, _ = run_group(
        TORCHRUN + ["--nproc-per-node", "4", "-m", f"{PKG}.scripts.train"] + argv
        + ["--out-dir", str(work / "mesh_cli"), "--set", "mesh_view=2", "--set", "mesh_tile=2"],
        400, "phase 9")
    mesh_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"phase 9 (c): the mesh CLI exited {rc}:\n{text[-12000:]}")
    print("mesh_cli: " + " | ".join(text.strip().splitlines()[-4:]), flush=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(argv + ["--out-dir", str(work / "one_cli"),
                               "--set", "train.batch_views=2"])
    one_s = time.perf_counter() - t0
    logs = {}
    for name in ("mesh_cli", "one_cli"):
        (run,) = (work / name / "gs_tpu").iterdir()
        logs[name] = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
    m, o = logs["mesh_cli"], logs["one_cli"]
    diff = max(abs(a["loss"] - b["loss"]) / b["loss"] for a, b in zip(m, o))
    alive = [[int(a["n_gaussians"]), int(b["n_gaussians"])] for a, b in zip(m, o)]
    ms = [(b["elapsed_s"] - a["elapsed_s"]) * 1e3 / (b["step"] - a["step"])
          for a, b in zip(m[1:], m[2:])]
    row = {"note": SHARING, "steps": [r["step"] for r in m], "loss_max_rel_diff": diff,
           "alive_mesh_vs_one": alive, "dropped": [r["num_dropped_pairs"] for r in m + o],
           "mesh_ms_per_step_logged": ms, "mesh_run_s": mesh_s, "one_run_s": one_s}
    print("mesh_cli_row: " + json.dumps(row), flush=True)
    if [r["step"] for r in m] != [r["step"] for r in o] or len(m) != 6:
        fail(f"phase 9 (c): logged steps {[r['step'] for r in m]} and {[r['step'] for r in o]}")
    if not diff <= MESH_CLI_TOL or any(a != b for a, b in alive) or any(row["dropped"]):
        fail(f"phase 9 (c): losses differ by {diff}, alive {alive}, dropped {row['dropped']}")
    if not alive[-1][0] > alive[0][0]:
        fail(f"phase 9 (c): the densify event added no splats: {alive}")


# (d) the train CLI on a one-rank NCCL mesh under torchrun, with exposure
MESH_NCCL_CLI_SETS = {"train.batch_views": 2, "train.use_exposure": "true"}
MESH_NCCL_WINDOW = (41, 49)  # steps between the CLI's log reads at 40 and 50


@contextlib.contextmanager
def record_loop(window):
    """While the block runs a train CLI in this process: at which step each
    captured graph captured, by the graph's name, with the capture's seconds
    (``Captured`` sees every call of every graph), and the wall of the steps
    from ``window[0]`` to ``window[1]`` between two syncs (the host runs
    ahead of the card between the CLI's log reads)."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.training import trainer as tr
    from gaussian_splatting_lightning_tpu_torch.utils import graph

    rec = {"captures": {}, "window": [], "step": None}
    step_inputs, call = tr.Trainer._step_inputs, graph.Captured.__call__

    def recorded_inputs(self):
        if self.step in window and len(rec["window"]) < 2:
            torch.cuda.synchronize()
            rec["window"].append(time.perf_counter())
        rec["step"] = self.step
        return step_inputs(self)

    def recorded_call(self, *args):
        n = self.captures
        out = call(self, *args)
        if self.captures > n:
            rec["captures"].setdefault(self.name, {})[rec["step"]] = self.capture_s
        return out

    tr.Trainer._step_inputs, graph.Captured.__call__ = recorded_inputs, recorded_call
    try:
        yield rec
    finally:
        tr.Trainer._step_inputs, graph.Captured.__call__ = step_inputs, call


def loop_record(trainer, rec, launches) -> dict:
    """A recorded CLI run's numbers (``record_loop``)."""
    import torch

    hist = [{k: r[k] for k in ("step", "loss", "n_gaussians", "num_dropped_pairs")}
            for r in trainer.history]
    moved = float((trainer.exposure.params - torch.eye(3, 4, device=trainer.device))
                  .abs().amax())
    return {"backend": None if trainer.mesh is None else trainer.mesh.backend,
            "step": type(trainer._train_step).__name__, "history": hist,
            "captures_s_by_step": {name: {str(step): sec for step, sec in by_step.items()}
                                   for name, by_step in rec["captures"].items()},
            "exposure_max_move": moved,
            "window_steps": list(MESH_NCCL_WINDOW),
            "step_wall_ms_window": (rec["window"][1] - rec["window"][0]) * 1e3
            / (MESH_NCCL_WINDOW[1] - MESH_NCCL_WINDOW[0]), "launches": launches}


def mesh_cli_rank(out_path: str, argv) -> int:
    """(d) The train CLI's ``main`` on this rank under torchrun, recorded by
    ``record_loop``; writes the numbers to ``out_path``."""
    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.scripts import train as train_cli

    _build.reset_launch_counts()
    with record_loop(MESH_NCCL_WINDOW) as rec:
        trainer = train_cli.main(argv)  # it leaves the job (parallel.shutdown)
    Path(out_path).write_text(json.dumps(loop_record(trainer, rec, dict(_build.launches))))
    return 0


def phase9_cli_nccl(work: Path, scene_dir: Path, loop_run: Path):
    """(d) The train CLI under torchrun with one rank, ``mesh_view=1``,
    ``mesh_tile=1`` (a 1x1 mesh on NCCL: the captured sharded step), two
    views a step and exposure, at phase (c)'s operating point, against the
    one-process CLI with the same settings; both recorded by
    ``record_loop``."""
    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.scripts import train as train_cli

    start = json.loads((loop_run / "config.json").read_text())["train"]["tiling"]["max_pairs"]
    sets = dict(LOOP_SETS, **MESH_CLI_SETS, **MESH_NCCL_CLI_SETS, **{
        "data.colmap_path": str(scene_dir), "data.image_folder": str(scene_dir / "images"),
        "train.tiling.max_pairs": 8 * start})
    argv = ["-c", str(ROOT / "configs" / "rehearsal_synthetic.yaml"), "--device", "cuda"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    out = work / "nccl_cli.json"
    t0 = time.perf_counter()
    rc, text, _ = run_group(
        TORCHRUN + ["--nproc-per-node", "1", str(ROOT / "chip_smoke.py"), "--mesh-cli",
                    str(out)] + argv
        + ["--out-dir", str(work / "nccl_cli"), "--set", "mesh_view=1", "--set", "mesh_tile=1"],
        400, "phase 9 (d)")
    mesh_s = time.perf_counter() - t0
    if rc != 0 or not out.exists():
        fail(f"phase 9 (d): the one-rank mesh CLI exited {rc}:\n{text[-12000:]}")
    print("mesh_nccl_cli: " + " | ".join(text.strip().splitlines()[-4:]), flush=True)
    m = json.loads(out.read_text())
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    with record_loop(MESH_NCCL_WINDOW) as rec, contextlib.redirect_stdout(io.StringIO()):
        trainer = train_cli.main(argv + ["--out-dir", str(work / "one_nccl_cli")])
    o = loop_record(trainer, rec, dict(_build.launches))
    del trainer
    one_s = time.perf_counter() - t0
    mh, oh = m["history"], o["history"]
    diff = max(abs(a["loss"] - b["loss"]) / b["loss"] for a, b in zip(mh, oh))
    alive = [[int(a["n_gaussians"]), int(b["n_gaussians"])] for a, b in zip(mh, oh)]
    row = {"steps": [r["step"] for r in mh], "loss_max_rel_diff": diff,
           "alive_mesh_vs_one": alive, "dropped": [r["num_dropped_pairs"] for r in mh + oh],
           "mesh": {k: m[k] for k in m if k != "history"},
           "one": {k: o[k] for k in o if k != "history"}, "mesh_run_s": mesh_s,
           "one_run_s": one_s}
    print("mesh_nccl_cli_row: " + json.dumps(row), flush=True)
    if m["backend"] != "nccl" or m["step"] != "ShardedTrainStep":
        fail(f"phase 9 (d): the CLI ran {m['step']} on {m['backend']}")
    if [r["step"] for r in mh] != [r["step"] for r in oh] or len(mh) != 6:
        fail(f"phase 9 (d): logged steps {[r['step'] for r in mh]} and "
             f"{[r['step'] for r in oh]}")
    if not diff <= MESH_CLI_TOL or any(a != b for a, b in alive) or any(row["dropped"]):
        fail(f"phase 9 (d): losses differ by {diff}, alive {alive}, dropped {row['dropped']}")
    if not alive[-1][0] > alive[0][0] or not m["exposure_max_move"] > 0:
        fail(f"phase 9 (d): the densify event added no splats ({alive}) or the exposure "
             f"did not move ({m['exposure_max_move']})")
    for run, step_graph in ((m, "sharded_train_step"), (o, "train_step")):
        caps = run["captures_s_by_step"]
        if not all("0" in caps.get(name, {}) for name in (step_graph, "exposure_update")):
            fail(f"phase 9 (d): {step_graph} and the exposure update did not both capture "
                 f"at step 0: {caps}")
    if any(m["launches"][k] < 1 for k in MESH_KERNELS):
        fail(f"phase 9 (d): a kernel was not launched on the mesh: {m['launches']}")


# phase 10: the measurement entry points, each run as a user runs it
BENCH_BUDGET = 2_138_112  # BENCH_PAIRS + 2%, rounded up to 8192: the bench's budget
# the loss runs as the photometric kernels: three forward, one backward
BENCH_STEP_LAUNCHES = {"expand_pairs": 1, "composite_fwd": 1, "composite_bwd": 1,
                       "segment_sum": 1, "photometric": 4}
# a train step also updates with Adam's kernel
TRAIN_STEP_LAUNCHES = dict(BENCH_STEP_LAUNCHES, adam=1)
# the mesh's step keeps its band-local loss on K5 (forward and VJP)
MESH_STEP_LAUNCHES = {"expand_pairs": 1, "composite_fwd": 1, "composite_bwd": 1,
                      "segment_sum": 1, "blur": 2, "adam": 1}
BATCHED_VIEWS = [1, 2, 4, 8]
# the entry points' work recorded in this process, in the CLIs' shapes: the
# bench's two rungs, its parity rung (an L1 loss) and banded check
# (512x384, 100k splats), and bench_batched's largest batch; their losses
# run the photometric kernels, so K5 need not be called on any
ENTRY_PATHS = ("small-540p", "headline-1080p", "parity-512x384", "banded-512x384",
               "batched-B8")


def entry_kernel_errs() -> dict:
    """One call of each entry point's work (``ENTRY_PATHS``) in this
    process, from the same functions, seeds and sizes the CLIs use; every
    K1-K5 wrapper call recorded and held to its plain version on the same
    inputs (``band_kernel_errs``). Returns each path's errors and seconds."""
    import numpy as np
    import torch

    from gaussian_splatting_lightning_tpu_torch.scripts import (
        banded_check,
        bench,
        bench_batched,
    )
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam

    # each path's work runs eagerly (capture=False): the CLIs replay captured
    # graphs of the same functions, whose kernels launch only in the graph,
    # but the wrappers' calls, and so the inputs to hold each launch's
    # result against its plain version, are seen only when they run
    def bench_rung(w, h, n):
        grad_fn, args, _, _ = bench.bench_problem(w, h, n, capture=False)
        return lambda: grad_fn(*args)

    def batched():
        w, h, n = 512, 384, 100_000
        cams, budget = bench_batched.ring_problem(w, h, n)
        rng = np.random.default_rng(0)
        for b in BATCHED_VIEWS:  # the CLI's target draws, in its order
            step, scene, *inputs = bench_batched.batch_problem(cams, budget, b, w, h, n, rng,
                                                               capture=False)
        return lambda: step(scene, init_adam(scene.params), 0, *inputs)

    makers = dict(zip(ENTRY_PATHS, (
        lambda: bench_rung(960, 540, 250_000), lambda: bench_rung(1920, 1080, 1_000_000),
        lambda: lambda: bench.parity_gate(iters=1), lambda: banded_check.run_check,
        batched)))
    errs, seconds = {}, {}
    for name, make in makers.items():
        t0 = time.perf_counter()
        fn = make()
        torch.cuda.synchronize()
        with record_kernel_calls() as calls:
            fn()
            torch.cuda.synchronize()
        errs[name] = band_kernel_errs(calls)
        del calls, fn
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
    for name, e in errs.items():
        bad = {k: e[k] for k, tol in BAND_TOL.items() if not (
            e[k]["calls"] >= (0 if k == "blur" else 1)
            and e[k]["err"] <= tol)}
        if bad:
            fail(f"phase 10: {name}'s kernels against their plain versions: {bad}")
    return errs, seconds


def bench_graph_line() -> dict:
    """The bench headline's step in this process, captured (as ``bench.run``
    times it) and eager: wall, CUDA events, and the device's busy time and
    idle share by ``torch.profiler`` over the timed steps (a ``graph:``
    line)."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.scripts import bench

    sides, capture_s = {}, None
    for name, capture in (("captured", True), ("eager", False)):
        grad_fn, args, _, _ = bench.bench_problem(1920, 1080, 1_000_000, capture=capture)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        grad_fn(*args)
        if capture:  # the graph's own buffers back, as bench.run passes them
            args, capture_s = tuple(grad_fn.captured.inputs), grad_fn.captured.capture_s
        sides[name] = graph_side(lambda: grad_fn(*args), 10, "step",
                                 torch.cuda.max_memory_allocated() - held,
                                 BENCH_STEP_LAUNCHES)
        del grad_fn, args
        torch.cuda.empty_cache()
    return print_graph_line("10 bench headline", capture_s, sides["captured"], sides["eager"])


def run_cli(module: str, *args, timeout: int, phase: str = "phase 10"):
    """``python -m <port>.scripts.<module> args`` on the card; returns its
    stdout lines, its stderr and its wall seconds. A non-zero exit fails."""
    t0 = time.perf_counter()
    rc, out, err = run_group(["-m", f"{PKG}.scripts.{module}", *args], timeout,
                             f"{phase} ({module})", stderr=subprocess.PIPE)
    if rc != 0:
        fail(f"{phase}: {module} exited {rc}:\n{out[-3000:]}\n{err[-6000:]}")
    return out.strip().splitlines(), err, time.perf_counter() - t0


def last_json(lines, module: str) -> dict:
    try:
        return json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"phase 10: {module}'s last line is not JSON: {lines[-3:]}")


def phase10() -> dict:
    """The bench (its rungs, parity and banded check), the view-batched bench
    and the scaling harness, each as a subprocess through its module entry;
    then the entry points' kernel calls against their plain versions
    (``entry_kernel_errs``). Returns the bench headline's launches per step
    and each kernel's errors on each entry path."""
    import torch

    torch.cuda.empty_cache()
    lines, err, bench_s = run_cli("bench", timeout=600)
    head = last_json(lines, "bench")
    # the result lines; the banded check prints its own lines between them
    results = [json.loads(x) for x in lines if x.startswith('{"metric"')]
    if [r["extra"]["rung"] for r in results] != ["small-540p"] + ["headline-1080p"] * 2 \
            or not results[1]["extra"].get("provisional") or results[2] != head:
        fail(f"phase 10: the bench's result lines: {lines}")
    small = results[0]
    print("bench_small: " + json.dumps(small), flush=True)
    print("bench_result: " + lines[-1], flush=True)
    ex = head["extra"]
    parity = ex["parity_512x384_100k"]["routing_f32"]
    if ex["pairs"] != BENCH_PAIRS or ex["pair_budget"] != BENCH_BUDGET or ex["dropped_pairs"] \
            or small["extra"]["dropped_pairs"] or not math.isfinite(head["value"]):
        fail(f"phase 10: bench pairs {ex['pairs']}, budget {ex['pair_budget']}, dropped "
             f"{ex['dropped_pairs']}, value {head['value']}")
    if launched_kernels(ex["launches"]) != BENCH_STEP_LAUNCHES:
        fail(f"phase 10: the bench step launched {ex['launches']} per step")
    if not (parity["image_max_abs"] <= PARITY_TOL and parity["grad_max_rel"] <= PARITY_TOL):
        fail(f"phase 10: bench parity {parity}")
    if not ex["banded_check"]["ok"]:
        fail(f"phase 10: the banded check failed: {ex['banded_check']}\n{err[-3000:]}")

    lines, _, batched_s = run_cli("bench_batched", timeout=300)
    batched = last_json(lines, "bench_batched")
    rows = batched["rows"]
    if [r["batch_views"] for r in rows] != BATCHED_VIEWS or any(
            r["dropped_pairs"] or not all(math.isfinite(r[k]) for k in (
                "step_ms", "device_ms", "first_step_loss", "speedup_per_view"))
            for r in rows):
        fail(f"phase 10: bench_batched rows {rows}")

    lines, _, scaling_s = run_cli("benchmark_scaling", "--meshes", "1x1,1x2", timeout=300)
    scaling = last_json(lines, "benchmark_scaling")
    (one,) = [r for r in scaling["rows"] if r["mesh"] == "1x1"] or [None]
    if one is None or one["backend"] != "nccl" or one["shared_card"] or not (
            math.isfinite(one["step_ms"]) and math.isfinite(one["loss"])):
        fail(f"phase 10: benchmark_scaling's 1x1 row {one}")
    # no efficiency across a drop: a row that renders less has none
    full = one["dropped"] + one["tile_overflow"] == 0
    if any((one[k] is not None) != full for k in ("wall_eff", "flops_eff", "bytes_eff")):
        fail(f"phase 10: benchmark_scaling's 1x1 eff columns beside its drops: {one}")
    if torch.cuda.device_count() == 1 and (scaling["skipped"] != ["1x2"]
                                           or "skip 1x2: only 1 devices" not in lines):
        fail(f"phase 10: benchmark_scaling did not skip 1x2 on one card: {lines}")

    headline_graph = bench_graph_line()
    errs, checks_s = entry_kernel_errs()
    # the headline's bound on the work its data needs: the roofline's bytes,
    # and K2's and K3's evaluations up to each tile's early stop (as phases
    # 3 and 5 count them) in place of the roofline's unculled pairs x 32^2
    k2 = errs["headline-1080p"]["composite_fwd"]
    _, nbytes = roofline_work(ex["pairs"], 32, 1_000_000, 1920, 1080)
    ops = 2 * k2["evaluations"] * K2_OPS_TO_KILL[32] + k2["kept"] * (K2_FLOPS_KEPT
                                                                     + K3_FLOPS_KEPT)
    counted_ms = 1e3 * (nbytes / HBM_BYTES_PER_S + ops / F32_FLOPS)
    print("bench_kernels: " + json.dumps(errs), flush=True)
    summary = {
        "bench_s": bench_s, "rays_per_s": head["value"], "step_ms": ex["step_ms"],
        "device_ms": ex["device_ms"], "compile_s": ex["compile_s"],
        "roofline_hard_ms": ex["roofline_hard_ms"], "pct_of_roofline": ex["pct_of_roofline"],
        "counted_bound_ms": counted_ms, "pct_of_counted_bound": 100 * counted_ms / ex["step_ms"],
        "kernel_checks_s": checks_s,
        "small_rays_per_s": small["value"], "small_step_ms": small["extra"]["step_ms"],
        "parity": parity, "banded_check": ex["banded_check"],
        "batched_s": batched_s, "batched": {str(r["batch_views"]): {
            k: r[k] for k in ("step_ms", "ms_per_view", "device_ms", "speedup_per_view",
                              "peak_mem_bytes")} for r in rows},
        "scaling_s": scaling_s, "scaling_1x1": one, "scaling_skipped": scaling["skipped"],
        "headline_busy_ms": {k: headline_graph[k]["busy_ms"] for k in ("captured", "eager")},
        "headline_idle_share": {k: headline_graph[k]["idle_share"]
                                for k in ("captured", "eager")},
    }
    print("phase10: " + json.dumps(summary), flush=True)
    return ex["launches"], {name: {path: e[name] for path, e in errs.items()}
                            for name in BAND_TOL}


# phase 11: the mesh on four H100s, one NCCL rank per card, at full width
# (``--cards 4``): the problems of phases 3, 5, 6 and 10, no new sizes
MESH4_CARDS = 4
MESH4_SHAPES = ((1, 4), (2, 2), (4, 1))
MESH4_BUDGET = 2_523_136  # phase 3's pair_budget over its four views
MESH4_JOB_S = 900  # each torchrun job's limit: a rank-divergent decision hangs
# (b): phase 6's point (LOOP_SETS) cut to 80 steps across two densify events
# at threshold 0 (20 and 40), the opacity reset at 50, three SH degree
# steps, a budget check every 10 steps and checkpoints at 50 and 80
MESH4_CLI_SHAPES = ((2, 2), (1, 4))
MESH4_CLI_SETS = {
    "train.num_iters": 80, "train.densify.densify_since": 19,
    "train.densify.densify_interval": 20, "train.densify.densify_until": 41,
    "train.densify.densify_grad_threshold": 0.0,
    "train.densify.opacity_reset_interval": 50,
    "train.densify.sh_degree_step_interval": 25, "train.log_interval": 10,
    "train.overflow_check_interval": 10, "train.checkpoint_interval": 50,
    "train.valid_interval": 1000,
}
MESH4_RESUME = 50
MESH4_SCALING = "1x1,1x2,1x4,2x2"


def gpu_lines() -> list:
    """Every card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()


def placement(info) -> dict:
    """This rank's card and whether it allocated on any other card (each
    rank must set its device before its first allocation)."""
    import torch

    others = [d for d in range(torch.cuda.device_count()) if d != info.device.index
              and torch.cuda.memory_allocated(d)]
    return {"device": str(info.device), "current": torch.cuda.current_device(),
            "allocated_elsewhere": others}


def scene_digest(scene) -> str:
    """SHA-256 of a scene's parameters, alive mask and statistics."""
    import hashlib

    from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES

    h = hashlib.sha256()
    for t in [getattr(scene.params, k) for k in PARAM_NAMES] + [
            scene.alive, scene.max_radii2d, scene.grad_accum, scene.grad_count]:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh4_steps_rank(out_path: str) -> int:
    """(a) One NCCL rank under torchrun: for each mesh of MESH4_SHAPES the
    sharded step on the four views of phase 3 at the per-band budget
    (grown as the ``Trainer`` grows it while a band drops), MESH4 steps
    captured and eager from the same start against the one-process step;
    rank 0 writes every rank's numbers to ``out_path``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
    from gaussian_splatting_lightning_tpu_torch.ops.budget import pair_budget
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        shutdown,
    )
    from gaussian_splatting_lightning_tpu_torch.training import trainer
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam

    info = init_distributed("cuda")
    meshes = []
    try:
        w, h, blk = 1920, 1080, 32
        scene = interop.synthetic_scene(1_000_000, 1_000_000, sh_degree=3, scale=0.008)
        cams = orbit_cameras(w, h)
        budget = pair_budget(scene, cams, w, h, blk)
        targets = torch.from_numpy(np.random.default_rng(0).uniform(
            size=(len(cams), 3, h, w)).astype(np.float32)).cuda()
        bgs = torch.zeros(len(cams), 3, device="cuda")
        # the reference: the one-process step on the whole batch, eager; and
        # its captured step's wall on this card, the time the mesh divides
        cfg1 = trainer.TrainConfig(tiling=TilingConfig(max_pairs=budget, block=blk),
                                   batch_views=len(cams))
        one = trainer.make_train_step(cfg1, 1.0, w, h, capture=False)
        _, adam1, logs1 = one(copy_scene(scene), init_adam(scene.params), 0,
                              stack_cameras(cams), targets, bgs)
        ref = {"loss": float(logs1["loss"]), "dropped": int(logs1["num_dropped_pairs"]),
               "num_pairs": int(logs1["num_pairs"]), "budget": budget}
        ref_mu = adam1.mu
        del one, adam1, logs1
        one = trainer.make_train_step(cfg1, 1.0, w, h)
        st = [scene, init_adam(scene.params)]
        walls = []
        for i in range(1 + TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st[0], st[1], _ = one(st[0], st[1], i, stack_cameras(cams), targets, bgs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ref["captured_step_wall_ms_median"] = sorted(walls[1:])[TRAIN_STEPS // 2]
        del one, st
        torch.cuda.empty_cache()
        rows = {"rank": info.rank, "backend": info.backend, "ref": ref}
        for v, t in MESH4_SHAPES:
            meshes.append(make_mesh(v, t, info=info))
            rows[f"{v}x{t}"] = mesh4_shape(meshes[-1], scene, cams, targets, bgs, budget,
                                           ref, ref_mu)
            torch.cuda.empty_cache()
        rows["placement"] = placement(info)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, rows)
        if info.rank == 0:
            Path(out_path).write_text(json.dumps(every))
    finally:
        shutdown(*meshes)  # the steps' graphs go before the communicators
    return 0


def mesh4_shape(mesh, scene, cams, targets, bgs, budget, ref, ref_mu) -> dict:
    """(a) on one mesh: this rank's row (see ``mesh4_steps_rank``)."""
    import torch
    import torch.distributed as dist

    from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
    from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
        PARAM_NAMES,
        GaussianParams,
    )
    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.parallel.shard import (
        make_sharded_train_step,
        shard_adam,
    )
    from gaussian_splatting_lightning_tpu_torch.training import trainer
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam

    w, h = targets.shape[-1], targets.shape[-2]
    v, t = mesh.shape["view"], mesh.shape["tile"]
    b = len(cams) // v
    rows = slice(mesh.axis_index("view") * b, (mesh.axis_index("view") + 1) * b)
    args = (stack_cameras(cams[rows]), targets[rows], bgs[rows])

    def config(max_pairs):
        return trainer.TrainConfig(tiling=TilingConfig(max_pairs=max_pairs, block=32),
                                   capacity=scene.capacity, batch_views=b)

    def start():
        return {"scene": copy_scene(scene), "adam": shard_adam(init_adam(scene.params), mesh),
                "step": 0}

    def band(step):
        return {k: [int(x) for x in val] for k, val in step.band_stats.items()}

    # the JAX rule gives each band max_pairs / n_tile; where a band drops,
    # the Trainer doubles max_pairs (its check reads the drops summed over
    # the mesh) until none does
    growth, max_pairs = [], budget
    while True:
        probe = make_sharded_train_step(config(max_pairs), 1.0, w, h, mesh, capture=False)
        st = start()
        _, _, logs = probe(st["scene"], st["adam"], 0, *args)
        growth.append({"max_pairs": max_pairs, "band_max_pairs": probe.band_tiling.max_pairs,
                       "dropped": int(logs["num_dropped_pairs"]),
                       "num_pairs": int(logs["num_pairs"]), **band(probe)})
        del probe, st, logs
        if not growth[-1]["dropped"] or len(growth) == 4:
            break
        max_pairs *= 2
    cfg = config(max_pairs)
    steps = {"eager": make_sharded_train_step(cfg, 1.0, w, h, mesh, capture=False),
             "captured": make_sharded_train_step(cfg, 1.0, w, h, mesh)}
    check = (v, t) == (1, 4) and mesh.axis_index("tile") in MESH_CHECK_TILES
    runs, band_kernels = {}, None
    for name, fn in steps.items():
        st = start()

        def one_step(fn=fn, st=st):
            st["scene"], st["adam"], logs = fn(st["scene"], st["adam"], st["step"], *args)
            st["step"] += 1
            return logs

        torch.cuda.synchronize()
        mesh.barrier()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        record = check and name == "eager"
        with record_kernel_calls() if record else contextlib.nullcontext() as calls:
            logs = one_step()
            torch.cuda.synchronize()
        if record:  # this band's launches against the plain versions
            k1 = calls["expand_pairs"][0][0] if calls["expand_pairs"] else (None,) * 5
            band_kernels = {"tile_y_offset": k1[4], "band_max_pairs": k1[1],
                            "want_offset": mesh.axis_index("tile") * fn.gy_local,
                            **band_kernel_errs(calls)}
            del calls, k1
        losses, dropped = [float(logs["loss"])], int(logs["num_dropped_pairs"])
        bands = band(fn)
        # Adam's first moments after step 0, whole: (1 - beta1) x the gradient
        mu0 = GaussianParams(**{k: mesh.all_gather(getattr(st["adam"].mu, k), "world")
                                for k in PARAM_NAMES})
        _build.reset_launch_counts()
        walls = []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            mesh.barrier()
            t0 = time.perf_counter()
            logs = one_step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(logs["loss"]))
            dropped += int(logs["num_dropped_pairs"])
        runs[name] = dict(st=st, one_step=one_step, losses=losses, walls=walls, bands=bands,
                          dropped=dropped, launches=dict(_build.launches),
                          peak=torch.cuda.max_memory_allocated() - held,
                          grad_rel_err=moment_errs(mu0, ref_mu))
        del mu0
    cap, eag = runs["captured"], runs["eager"]
    bits = {"losses": cap["losses"] == eag["losses"]}
    for part in ("params", "mu", "nu"):
        for k in PARAM_NAMES:
            get = ((lambda r, k=k: getattr(r["st"]["scene"].params, k)) if part == "params"
                   else (lambda r, k=k, part=part: getattr(getattr(r["st"]["adam"], part), k)))
            bits[f"{part}.{k}"] = torch.equal(get(cap), get(eag))
    for k in ("max_radii2d", "grad_accum", "grad_count"):
        bits[k] = torch.equal(getattr(cap["st"]["scene"], k), getattr(eag["st"]["scene"], k))
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, scene_digest(cap["st"]["scene"]))
    # every step's wall is the slowest rank's
    walls = [None] * dist.get_world_size()
    dist.all_gather_object(walls, [cap["walls"], eag["walls"]])
    slowest = {side: [max(r[i][j] for r in walls) for j in range(TRAIN_STEPS)]
               for i, side in enumerate(("captured", "eager"))}
    sides = {name: graph_side(runs[name]["one_step"], 5, "step", runs[name]["peak"],
                              runs[name]["launches"]) for name in ("captured", "eager")}
    row = {
        "view": mesh.axis_index("view"), "tile": mesh.axis_index("tile"), "views": b,
        "gy_local": steps["captured"].gy_local, "growth": growth, "max_pairs": max_pairs,
        "band_max_pairs": steps["captured"].band_tiling.max_pairs,
        "band_num_pairs": cap["bands"]["num_pairs"],
        "band_dropped": cap["bands"]["num_dropped_pairs"],
        "dropped": cap["dropped"] + eag["dropped"],
        "loss": cap["losses"][0], "loss_rel_err": abs(cap["losses"][0] - ref["loss"])
        / abs(ref["loss"]), "grad_rel_err": cap["grad_rel_err"],
        "captured_vs_eager_bits_equal": bits, "scene_digests_equal": len(set(digests)) == 1,
        "captures": steps["captured"].captured.captures,
        "capture_s": steps["captured"].captured.capture_s,
        "step_wall_ms": {k: runs[k]["walls"] for k in runs},
        "slowest_rank_wall_ms": slowest,
        "slowest_rank_wall_ms_median": {k: sorted(x)[TRAIN_STEPS // 2]
                                        for k, x in slowest.items()},
        "graph": sides, "band_kernels": band_kernels}
    del runs, steps, cap, eag
    return row


def phase11_steps(work: Path) -> dict:
    """(a) The sharded step on four NCCL ranks for each mesh of
    MESH4_SHAPES; returns each mesh's launches per replay on every rank."""
    t0 = time.perf_counter()
    out = work / "mesh4_steps.json"
    rc, text, _ = run_group(TORCHRUN + ["--nproc-per-node", str(MESH4_CARDS),
                                        str(ROOT / "chip_smoke.py"), "--mesh4-steps",
                                        str(out)], MESH4_JOB_S, "phase 11 (a)")
    if rc != 0 or not out.exists():
        fail(f"phase 11 (a): the ranks exited {rc}:\n{text[-12000:]}")
    ranks = json.loads(out.read_text())
    summary = {"launch_s": time.perf_counter() - t0, "ref": ranks[0]["ref"]}
    bad = [r["rank"] for r in ranks if r["backend"] != "nccl" or r["ref"]["dropped"]
           or r["ref"]["budget"] != MESH4_BUDGET or r["placement"]["allocated_elsewhere"]
           or r["placement"]["current"] != r["rank"]]
    if bad:
        fail(f"phase 11 (a): ranks {bad}: backend, budget, reference drops or placement "
             f"{[(r['backend'], r['ref'], r['placement']) for r in ranks]}")
    launches = {}
    for shape in (f"{v}x{t}" for v, t in MESH4_SHAPES):
        rows = [dict(r[shape], rank=r["rank"]) for r in ranks]
        for r in rows:
            print(f"mesh4_rank {shape}: " + json.dumps(r), flush=True)
        want = {k: TRAIN_STEPS * n for k, n in MESH_STEP_LAUNCHES.items()}
        bad = {r["rank"]: r for r in rows if not (
            all(r["captured_vs_eager_bits_equal"].values()) and r["scene_digests_equal"]
            and r["captures"] == 1 and r["graph"]["captured"]["kernel_launches"] == want
            and r["loss_rel_err"] <= MESH_LOSS_TOL and r["dropped"] == 0
            and not any(r["band_dropped"])
            and all(e <= MESH_GRAD_TOL for e in r["grad_rel_err"].values()))}
        if bad:
            fail(f"phase 11 (a), mesh {shape}: ranks {sorted(bad)} fail their checks: "
                 f"{json.dumps(bad)[:6000]}")
        checked = {r["rank"]: r["band_kernels"] for r in rows if r["band_kernels"]}
        bad = {k: c for k, c in checked.items() if not (
            c["tile_y_offset"] == c["want_offset"] > 0
            and all(c[n]["calls"] >= (2 if n == "blur" else 1) and c[n]["err"] <= tol
                    for n, tol in BAND_TOL.items()))}
        if bad or len(checked) != (len(MESH_CHECK_TILES) if shape == "1x4" else 0):
            fail(f"phase 11 (a), mesh {shape}: band kernels against plain {checked}")
        launches[shape] = [{k: n // TRAIN_STEPS for k, n in
                            r["graph"]["captured"]["kernel_launches"].items()} for r in rows]
        side = {k: {s: [r["graph"][s][k] for r in rows] for s in ("captured", "eager")}
                for k in ("wall_ms", "event_ms", "busy_ms", "idle_share", "nccl_ms",
                          "peak_mem_added_bytes")}
        # the idle share of the compute: NCCL's kernels overlap it
        side["compute_idle_share"] = {s: [
            None if g["busy_ms"] is None else 1 - (g["busy_ms"] - g["nccl_ms"]) / g["wall_ms"]
            for g in (r["graph"][s] for r in rows)] for s in ("captured", "eager")}
        summary[shape] = {
            "growth": rows[0]["growth"], "max_pairs": rows[0]["max_pairs"],
            "band_max_pairs": rows[0]["band_max_pairs"],
            "band_num_pairs": {f"{r['view']},{r['tile']}": r["band_num_pairs"] for r in rows},
            "slowest_rank_wall_ms_median": rows[0]["slowest_rank_wall_ms_median"],
            "speedup_over_one_process": ranks[0]["ref"]["captured_step_wall_ms_median"]
            / rows[0]["slowest_rank_wall_ms_median"]["captured"],
            "nccl_kernels_ms_rank0": rows[0]["graph"]["captured"]["nccl_kernels_ms"],
            "capture_s": [r["capture_s"] for r in rows],
            "loss_rel_err_max": max(r["loss_rel_err"] for r in rows),
            "grad_rel_err_max": max(max(r["grad_rel_err"].values()) for r in rows),
            "launches_per_replay": launches[shape], **side}
        if checked:
            summary[shape]["band_kernels"] = checked
    print("mesh4_steps: " + json.dumps(summary), flush=True)
    return launches


def mesh4_cli_rank(out_path: str, argv) -> int:
    """(b) The train CLI's ``main`` on this rank under torchrun: every
    graph's captures by step (``record_loop``), and after every event
    (densify, opacity reset, SH degree step), checkpoint, restore and at the
    end of ``train`` a digest of the scene, all-gathered and compared at
    once (a rank that holds other bits stops the job). Writes this rank's
    numbers to ``out_path`` + ``.rank<r>.json``."""
    import torch.distributed as dist

    from gaussian_splatting_lightning_tpu_torch.ops import _build
    from gaussian_splatting_lightning_tpu_torch.scripts import train as train_cli
    from gaussian_splatting_lightning_tpu_torch.training import trainer as tr

    digests = []

    def check(self, what):
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, scene_digest(self.scene))
        digests.append({"step": self.step, "what": what, "equal": len(set(every)) == 1})
        if len(set(every)) != 1:
            raise RuntimeError(f"step {self.step} ({what}): the ranks' scenes differ: {every}")

    orig = {k: getattr(tr.Trainer, k) for k in ("maybe_densify", "save_checkpoint",
                                                 "restore_checkpoint", "train")}

    def maybe_densify(self):
        before = self.scene
        orig["maybe_densify"](self)
        if self.scene is not before:  # an event gave a new scene
            check(self, "event")

    def hook(name):
        def hooked(self, *args, **kw):
            out = orig[name](self, *args, **kw)
            check(self, name)
            return out
        return hooked

    patched = dict(maybe_densify=maybe_densify, **{k: hook(k) for k in (
        "save_checkpoint", "restore_checkpoint", "train")})
    _build.reset_launch_counts()
    try:
        for k, fn in patched.items():
            setattr(tr.Trainer, k, fn)
        with record_loop(()) as rec:
            trainer = train_cli.main(argv)  # it leaves the job (parallel.shutdown)
    finally:
        for k, fn in orig.items():
            setattr(tr.Trainer, k, fn)
    hist = [{k: r[k] for k in ("step", "loss", "n_gaussians", "num_dropped_pairs",
                               "num_pairs", "elapsed_s")} for r in trainer.history]
    Path(f"{out_path}.rank{trainer.mesh.rank}.json").write_text(json.dumps({
        "rank": trainer.mesh.rank, "backend": trainer.mesh.backend,
        "device": str(trainer.device), "step": type(trainer._train_step).__name__,
        "history": hist, "digests": digests,
        "captures_s_by_step": {name: {str(s): sec for s, sec in by_step.items()}
                               for name, by_step in rec["captures"].items()},
        "max_pairs": trainer.cfg.tiling.max_pairs, "launches": dict(_build.launches)}))
    return 0


def mesh4_cli(argv, out_dir: Path, shape, what: str, resume=None) -> list:
    """One torchrun job of the train CLI on four ranks (``mesh4_cli_rank``;
    ``resume``: the CLI's resume arguments); returns the ranks' records
    after the cross-rank checks."""
    from gaussian_splatting_lightning_tpu_torch.ops import _build

    v, t = shape
    out = out_dir / "rank"
    t0 = time.perf_counter()
    rc, text, _ = run_group(
        TORCHRUN + ["--nproc-per-node", str(MESH4_CARDS), str(ROOT / "chip_smoke.py"),
                    "--mesh4-cli", str(out)] + argv
        + ["--out-dir", str(out_dir), "--set", f"mesh_view={v}", "--set", f"mesh_tile={t}"]
        + (resume or []), MESH4_JOB_S, f"phase 11 (b) {what}")
    ranks = [json.loads(Path(f"{out}.rank{r}.json").read_text())
             for r in range(MESH4_CARDS) if Path(f"{out}.rank{r}.json").exists()]
    if rc != 0 or len(ranks) != MESH4_CARDS:
        fail(f"phase 11 (b) {what}: the ranks exited {rc}:\n{text[-12000:]}")
    r0 = ranks[0]
    bad = [r["rank"] for r in ranks if not (
        r["backend"] == "nccl" and r["step"] == "ShardedTrainStep"
        and r["device"] == f"cuda:{r['rank']}" and all(d["equal"] for d in r["digests"])
        and [d["step"] for d in r["digests"]] == [d["step"] for d in r0["digests"]]
        and r["captures_s_by_step"].keys() == r0["captures_s_by_step"].keys()
        and all(r["captures_s_by_step"][g].keys() == r0["captures_s_by_step"][g].keys()
                for g in r0["captures_s_by_step"])
        and same_logs(r["history"], r0["history"]) and r["max_pairs"] == r0["max_pairs"]
        and all(r["launches"][k] >= 1 for k in MESH_KERNELS))]
    if bad:
        fail(f"phase 11 (b) {what}: ranks {bad} differ or miss a check: "
             f"{json.dumps(ranks)[:6000]}")
    r0["job_s"] = time.perf_counter() - t0
    return ranks


def same_logs(a, b) -> bool:
    """Two ranks' logs equal but for the wall clock."""
    def drop(h):
        return [{k: v for k, v in r.items() if k != "elapsed_s"} for r in h]
    return drop(a) == drop(b)


def loss_diff(got, want) -> float:
    """The largest relative difference of two runs' losses at the steps both
    logged (the one-process run logs the same steps)."""
    want = {r["step"]: r["loss"] for r in want}
    return max(abs(r["loss"] - want[r["step"]]) / want[r["step"]] for r in got)


def phase11_cli(work: Path) -> dict:
    """(b) The train CLI under torchrun on four cards, meshes (2, 2) and
    (1, 4), at phase 6's point cut to 80 steps (MESH4_CLI_SETS), each
    against the one-process CLI with the same global batch; then the (2, 2)
    run's step-50 checkpoint resumed on four ranks and in one process."""
    import torch

    from gaussian_splatting_lightning_tpu_torch.core.camera import camera_from_matrices
    from gaussian_splatting_lightning_tpu_torch.models import from_points
    from gaussian_splatting_lightning_tpu_torch.ops.budget import pair_budget
    from gaussian_splatting_lightning_tpu_torch.scripts import train as train_cli
    from gaussian_splatting_lightning_tpu_torch.training.config import load_config

    w, h = 1920, 1080
    scene_dir = work / "scene"
    write_loop_scene(scene_dir, w, h)
    config = ROOT / "configs" / "rehearsal_synthetic.yaml"
    sets = dict(LOOP_SETS, **MESH4_CLI_SETS, **{
        "data.colmap_path": str(scene_dir), "data.image_folder": str(scene_dir / "images")})
    cfg = load_config(str(config), [f"{k}={v}" for k, v in sets.items()])
    train_views, _, xyz, rgb, _ = train_cli.load_views(cfg.data)
    init = from_points(xyz, rgb, capacity=len(xyz), sh_degree=cfg.sh_degree)
    est = pair_budget(init, [camera_from_matrices(v.viewmatrix, v.projmatrix, v.campos,
                                                  v.tanfovx, v.tanfovy) for v in train_views],
                      w, h)
    # phase 9 (c)'s budget: 8 x phase 6's start (half the init estimate); no
    # budget may drop, so that both runs render every pair
    sets["train.tiling.max_pairs"] = 8 * max(8192, round(est / 2 / 8192) * 8192)
    del init, train_views
    torch.cuda.empty_cache()
    argv = ["-c", str(config), "--device", "cuda"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]

    def one_process(name, views, *extra):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = train_cli.main(argv + ["--out-dir", str(work / name), "--set",
                                             f"train.batch_views={views}", *extra])
        hist = [{k: r[k] for k in ("step", "loss", "n_gaussians", "num_dropped_pairs")}
                for r in trainer.history]
        del trainer
        torch.cuda.empty_cache()
        return hist, time.perf_counter() - t0

    summary, runs = {"start_max_pairs": sets["train.tiling.max_pairs"]}, {}
    for v, t in MESH4_CLI_SHAPES:
        shape = f"{v}x{t}"
        ranks = mesh4_cli(argv, work / f"cli4_{shape}", (v, t), shape)
        one, one_s = one_process(f"cli1_{shape}", v)
        mesh_h = ranks[0]["history"]
        diff = loss_diff(mesh_h, one)
        by_step = [abs(a["loss"] - b["loss"]) / b["loss"] for a, b in zip(mesh_h, one)]
        alive = [[a["n_gaussians"], b["n_gaussians"]] for a, b in zip(mesh_h, one)]
        ms = [(b["elapsed_s"] - a["elapsed_s"]) * 1e3 / (b["step"] - a["step"])
              for a, b in zip(mesh_h[1:], mesh_h[2:])]
        row = {"steps": [r["step"] for r in mesh_h], "loss_max_rel_diff": diff,
               "loss_rel_diff_by_step": by_step,
               "alive_mesh_vs_one": alive, "max_pairs": ranks[0]["max_pairs"],
               "dropped": [r["num_dropped_pairs"] for r in mesh_h + one],
               "band_scaled_num_pairs": [r["num_pairs"] for r in mesh_h],
               "digests": [[d["step"], d["what"]] for d in ranks[0]["digests"]],
               "captures_s_by_step": ranks[0]["captures_s_by_step"],
               "mesh_ms_per_step_logged": ms, "mesh_job_s": ranks[0]["job_s"],
               "one_run_s": one_s}
        print(f"mesh4_cli_row {shape}: " + json.dumps(row), flush=True)
        if [r["step"] for r in mesh_h] != [r["step"] for r in one] or len(mesh_h) != 8:
            fail(f"phase 11 (b) {shape}: logged steps {row['steps']} and "
                 f"{[r['step'] for r in one]}")
        if not diff <= MESH_CLI_TOL or any(a != b for a, b in alive) or any(row["dropped"]):
            fail(f"phase 11 (b) {shape}: losses differ by {diff}, alive {alive}, dropped "
                 f"{row['dropped']}")
        events = [s for s, what in row["digests"] if what == "event"]
        n = {r["step"]: r["n_gaussians"] for r in mesh_h}
        if not (n[20] > n[10] and n[40] > n[30]) or events != [20, 25, 40, 50, 75]:
            fail(f"phase 11 (b) {shape}: events at {events}, alive {alive}")
        runs[shape] = (ranks, one)
        summary[shape] = {k: row[k] for k in ("loss_max_rel_diff", "mesh_job_s", "one_run_s")}
        summary[shape]["mesh_ms_per_step_logged"] = ms
    # the (2, 2) run's checkpoint, resumed on four ranks and in one process
    (mesh_run,) = (work / "cli4_2x2" / "gs_tpu").iterdir()
    resume = ["--resume", str(mesh_run / f"ckpt-{MESH4_RESUME:08d}"), "--iters",
              str(MESH4_CLI_SETS["train.num_iters"] - MESH4_RESUME)]
    ranks = mesh4_cli(argv, work / "cli4_resume", (2, 2), "resume", resume=resume)
    uninterrupted = runs["2x2"][0][0]["history"]
    resumed = ranks[0]["history"]
    one, _ = one_process("cli1_resume", 2, *resume)
    want_steps = [r["step"] for r in uninterrupted if r["step"] >= MESH4_RESUME]
    row = {"checkpoint": Path(resume[1]).name, "steps": [r["step"] for r in resumed],
           "four_ranks_loss_max_rel_diff": loss_diff(resumed, uninterrupted),
           "one_process_loss_max_rel_diff": loss_diff(one, uninterrupted),
           "digests": [[d["step"], d["what"]] for d in ranks[0]["digests"]]}
    print("mesh4_cli_resume: " + json.dumps(row), flush=True)
    if row["steps"] != want_steps or [r["step"] for r in one] != want_steps:
        fail(f"phase 11 (b) resume: steps {row['steps']}, one process "
             f"{[r['step'] for r in one]}, want {want_steps}")
    if not (row["four_ranks_loss_max_rel_diff"] <= LOOP_LOSS_TOL
            and row["one_process_loss_max_rel_diff"] <= MESH_CLI_TOL):
        fail(f"phase 11 (b) resume: {row}")
    summary["resume"] = {k: row[k] for k in ("four_ranks_loss_max_rel_diff",
                                             "one_process_loss_max_rel_diff")}
    print("mesh4_cli: " + json.dumps(summary), flush=True)
    return {shape: ranks[0]["launches"] for shape, (ranks, _) in runs.items()}


def phase11_scaling(work: Path) -> dict:
    """(c) The scaling harness over the four cards (its own operating point,
    route ``xla``) and ``dryrun_multichip.py`` on four NCCL ranks."""
    lines, _, scaling_s = run_cli("benchmark_scaling", "--meshes", MESH4_SCALING,
                                  timeout=MESH4_JOB_S, phase="phase 11 (c)")
    scaling = last_json(lines, "benchmark_scaling")
    rows = scaling["rows"]
    bad = [r for r in rows if r["backend"] != "nccl" or r["shared_card"] or not (
        math.isfinite(r["step_ms"]) and math.isfinite(r["loss"])) or any(
        (r[k] is not None) != (rows[0]["dropped"] + rows[0]["tile_overflow"]
                               + r["dropped"] + r["tile_overflow"] == 0)
        for k in ("wall_eff", "flops_eff", "bytes_eff"))]
    if [r["mesh"] for r in rows] != MESH4_SCALING.split(",") or scaling["skipped"] or bad:
        fail(f"phase 11 (c): benchmark_scaling rows {rows}, skipped {scaling['skipped']}")
    out = work / "dryrun.json"
    t0 = time.perf_counter()
    rc, text, _ = run_group(TORCHRUN + ["--nproc-per-node", str(MESH4_CARDS), "-m",
                                        f"{PKG}.scripts.dryrun_multichip", "--out", str(out)],
                            MESH4_JOB_S, "phase 11 (c) dryrun_multichip")
    dry_s = time.perf_counter() - t0
    lines = [x for x in text.splitlines() if x.startswith("dryrun_multichip")]
    for x in lines:
        print(x, flush=True)
    rec = json.loads(out.read_text()) if rc == 0 and out.exists() else {}
    if sum(x.startswith("dryrun_multichip OK") for x in lines) != 3 or (
            rec.get("backend"), rec.get("routes")) != ("nccl", ["cuda", "cuda"]):
        fail(f"phase 11 (c): dryrun_multichip exited {rc}:\n{text[-12000:]}")
    summary = {"scaling_s": scaling_s, "scaling": rows, "dryrun_s": dry_s, "dryrun": rec}
    print("mesh4_scaling: " + json.dumps(summary), flush=True)
    return summary


def phase11(work: Path):
    """The mesh on four cards: (a) the sharded step, (b) the train CLI, (c)
    the scaling harness and the dry run. Returns each (a) mesh's launches
    per replay on every rank, and each part's seconds."""
    t0 = time.perf_counter()
    launches = phase11_steps(work)
    t1 = time.perf_counter()
    phase11_cli(work)
    t2 = time.perf_counter()
    phase11_scaling(work)
    return launches, {"11a": t1 - t0, "11b": t2 - t1, "11c": time.perf_counter() - t2}


def main() -> int:
    if sys.argv[1:2] == ["--mesh-ranks"]:  # one rank of phase 9 (b), under torchrun
        return mesh_ranks(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--mesh-cli"]:  # the rank of phase 9 (d), under torchrun
        return mesh_cli_rank(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--mesh4-steps"]:  # one rank of phase 11 (a), under torchrun
        return mesh4_steps_rank(sys.argv[2])
    if sys.argv[1:2] == ["--mesh4-cli"]:  # one rank of phase 11 (b), under torchrun
        return mesh4_cli_rank(sys.argv[2], sys.argv[3:])
    if sys.argv[1:] not in ([], ["--cards", "1"], ["--cards", str(MESH4_CARDS)]):
        print(f"usage: python3 chip_smoke.py [--cards 1|{MESH4_CARDS}]", file=sys.stderr)
        return 2
    cards = int(sys.argv[2]) if sys.argv[1:] else 1
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script: run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cards:
        print(f"chip_smoke: --cards {cards} needs {cards} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - start
        return out

    timed("1 probe", probe)
    if cards == MESH4_CARDS:
        return four_cards(timed, seconds, t0)
    timed("2", phase2)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        scene, budget, bench_ply, kernels = timed("3", phase3, work)
        timed("4", phase4)
        bare_step_syncs, step_kernels = timed("5", phase5, scene, budget)
        kernels += step_kernels
        blur_windows = timed("12", phase12, scene, budget)
        kernels.append(timed("13", phase13))
        kernels.append(timed("14", phase14))
        batched_launches = timed("8", phase8, scene, budget)
        mesh_launches = {"1x1": timed("9a", phase9_nccl, scene, budget)}
        del scene
        rank_launches, band_errs = timed("9b", phase9_ranks, budget, work)
        mesh_launches.update(rank_launches)
        loop_launches, run_dir, scene_dir, loop_psnr = timed("6", phase6, bare_step_syncs,
                                                             work)
        serve_launches = timed("7", phase7, work, run_dir, scene_dir, loop_psnr, bench_ply)
        timed("9c", phase9_cli, work, scene_dir, run_dir)
        timed("9d", phase9_cli_nccl, work, scene_dir, run_dir)
        print(f"phase9: {sum(v for k, v in seconds.items() if k[0] == '9'):.1f} s", flush=True)
    bench_launches, bench_errs = timed("10", phase10)
    print("phases_s: " + json.dumps(seconds), flush=True)
    print(f"phase11: not run: the mesh on {MESH4_CARDS} cards, one rank per card, needs "
          f"python3 chip_smoke.py --cards {MESH4_CARDS} on a {MESH4_CARDS}-card machine",
          flush=True)
    for row in kernels:
        name = row["name"]
        row["loop_launches"] = loop_launches.get(name, 0)
        row["serve_launches"] = {cli: n.get(name, 0) for cli, n in serve_launches.items()}
        row["batched_launches"] = {str(b): n.get(name, 0) for b, n in batched_launches.items()}
        row["mesh_launches"] = {
            shape: (n.get(name, 0) if isinstance(n, dict) else [r.get(name, 0) for r in n])
            for shape, n in mesh_launches.items()}
        row["mesh_band_err"] = band_errs.get(row["name"])
        row["bench_launches"] = bench_launches.get(name, 0)
        row["bench_err"] = bench_errs.get(row["name"])
        if row["name"] == "blur":
            row["windows"] = blur_windows
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"gpu: {gpu_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def four_cards(timed, seconds, t0) -> int:
    """``--cards 4``: the probe (done) and phase 11 alone, then the cards'
    names and power limits and the contract's last line."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        launches, parts = timed("11", phase11, Path(tmp))
    seconds.update(parts)
    print("phases_s: " + json.dumps(seconds), flush=True)
    print("mesh4_launches: " + json.dumps(launches), flush=True)
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    for i, line in enumerate(gpu_lines()):
        print(f"gpu {i}: {line}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
