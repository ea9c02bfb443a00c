"""Profiling hooks: a ``torch.profiler`` trace context, span marks on the
card that survive CUDA-graph capture, host spans on the profiler's clock,
the reduction of a trace to the step's segments, and a wall-clock step
timer.

Counterpart of ``gaussian_splatting_lightning_tpu/utils/runtime.py``. Its
``setup_compilation_cache`` has no counterpart here: the port compiles
nothing per shape, and its kernels' build directory (``ops/_build.py``,
keyed by a hash of source and flags) is already the persistent cache.

Spans. A range recorded on the host is recorded once when a CUDA graph is
captured and never when it replays, so the step's device boundaries are
kernels: ``mark(name, like)`` launches the do-nothing kernel
``gs_span_<name>`` (``csrc/span_mark.cu``) on ``like``'s stream. Inside a
capture it becomes a node of the graph and fires on every replay, on the
device trace's clock, with no synchronise and no host read. Each mark
starts a segment that ends at the next mark; ``SPANS`` is the train step's
order. ``mark_backward(name, *tensors)`` passes tensors through an identity
whose backward marks ``name`` once every gradient of them is complete.
Marks and identities act only inside ``spanning()``: outside it ``mark``
launches nothing and the marker library is neither built nor loaded, and
the capture keys of the steps and the render hold whether spans are on, so
a graph captured with spans off is the graph without them. ``span(name)``
is a host range (``record_function``) while spans are on and a profiler is
active, and nothing else otherwise.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import re
import time
from pathlib import Path

import torch

# the marks of a train step in replay order; the C entry of
# csrc/span_mark.cu switches over this order
SPANS = ("preprocess", "binning", "composite", "loss", "loss_bwd", "composite_bwd",
         "preprocess_bwd", "adam", "stats", "end")
# the marks of the eval step and of the serving render: their sequences are
# told apart from a step's and left out of its segments
EVAL_SPANS = ("preprocess", "binning", "composite", "loss", "end")
RENDER_SPANS = ("preprocess", "binning", "composite", "end")
# the host spans of the loop and of the capture layer
HOST_SPANS = ("trainer.step", "trainer.log_read", "trainer.densify", "trainer.validate",
              "trainer.checkpoint", "graph.capture")
MARK_RE = re.compile(r"gs_span_([a-z_]+)")

_spanning = False  # read by autograd's backward threads too: not thread-local


@contextlib.contextmanager
def spanning(on: bool = True):
    """Spans on (or off) in the block; the previous setting after it."""
    global _spanning
    before, _spanning = _spanning, on
    try:
        yield
    finally:
        _spanning = before


def spans_on() -> bool:
    return _spanning


def mark(name: str, like) -> None:
    """Launch mark ``name`` on the stream of the CUDA tensor ``like`` while
    spans are on; nothing otherwise (nor for a CPU tensor or None)."""
    if not _spanning or like is None or not like.is_cuda:
        return
    from gaussian_splatting_lightning_tpu_torch.ops import _build

    lib = _build.load("span_mark")
    _build.raise_for(lib, "span_mark", lib.gs_span_mark(SPANS.index(name),
                                                        _build.stream_of(like)))


class _MarkBackward(torch.autograd.Function):
    """Identity forward; the backward marks ``name`` and passes the
    gradients on unchanged."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        mark(ctx.name, next((g for g in grads if g is not None), None))
        return (None,) + grads


def mark_backward(name: str, *tensors) -> tuple:
    """``tensors`` unchanged, through an identity whose backward marks
    ``name`` while spans are on; the same tensors with spans off."""
    if not _spanning:
        return tensors
    return _MarkBackward.apply(name, *tensors)


@contextlib.contextmanager
def span(name: str):
    """A host range ``name`` (one of ``HOST_SPANS``) on the profiler's clock while spans are on and
    a profiler is active; otherwise the checks alone. (The profiler also
    lays such a range over the device kernels it launched, as a device
    event of its own; with spans off no such event enters a trace.)"""
    if not (_spanning and torch.autograd._profiler_enabled()):
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the block with ``torch.profiler`` (CPU activity, plus CUDA
    activity when a card is present) and write a Chrome trace into
    ``log_dir``; yields the profiler, so the caller can also read its
    ``key_averages()`` or its raw events for ``span_segments``. A no-op
    yielding None when ``log_dir`` is None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    name = f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"
    prof.export_chrome_trace(str(Path(log_dir) / name))


def _overlap_ns(merged: list, starts: list, t0: int, t1: int) -> int:
    """Length of the merged intervals' part inside [t0, t1)."""
    total = 0
    i = max(bisect.bisect_right(starts, t0) - 1, 0)
    while i < len(merged) and merged[i][0] < t1:
        total += max(0, min(merged[i][1], t1) - max(merged[i][0], t0))
        i += 1
    return total


def _annotation(event) -> bool:
    """Whether a device event is the profiler's copy of a host range laid
    over the kernels it launched, rather than device work."""
    return event.name() in HOST_SPANS or bool(
        getattr(event, "is_user_annotation", lambda: False)())


def span_segments(events):
    """Each segment's device ms a step from a profiler's raw events
    (``prof.profiler.kineto_results.events()``): the union of the device
    intervals (marks left out) between consecutive marks, over the complete
    ``SPANS`` sequences; eval and render sequences are left out. Returns
    {"steps", "segment_ms", "covered"} (``covered``: the share of the
    device's busy time, marks left out, inside a segment), or None when no
    step is complete or a sequence is neither a step's, an eval's nor a
    render's (a mark missing, repeated or out of order)."""
    marks, work = [], []
    for e in events:
        if not str(e.device_type()).endswith("CUDA") or _annotation(e):
            continue
        s = e.start_ns()
        m = MARK_RE.search(e.name())
        if m:
            marks.append((s, m.group(1)))
        else:
            work.append((s, s + e.duration_ns()))
    marks.sort()
    seqs = []
    for t, name in marks:
        if name == SPANS[0]:
            seqs.append([(t, name)])
        elif not seqs:
            return None
        else:
            seqs[-1].append((t, name))
    windows = {name: [] for name in SPANS[:-1]}
    steps = 0
    for seq in seqs:
        names = tuple(n for _, n in seq)
        if names in (EVAL_SPANS, RENDER_SPANS):
            continue
        if names != SPANS:
            return None
        steps += 1
        for (t0, name), (t1, _) in zip(seq, seq[1:]):
            windows[name].append((t0, t1))
    if not steps:
        return None
    merged = []
    for s, e in sorted(work):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]
    busy = sum(e - s for s, e in merged)
    ns = {name: sum(_overlap_ns(merged, starts, t0, t1) for t0, t1 in w)
          for name, w in windows.items()}
    return {"steps": steps, "segment_ms": {k: v * 1e-6 / steps for k, v in ns.items()},
            "covered": sum(ns.values()) / busy if busy else 0.0}


class StepTimer:
    """Wall-clock step statistics (p50/p95/mean) with warmup skipping."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self.samples: list[float] = []
        self._seen = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.skip_first:
            self.samples.append(dt)

    def summary(self) -> dict:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "steps": n,
            "mean_ms": 1e3 * sum(s) / n,
            "p50_ms": 1e3 * s[n // 2],
            "p95_ms": 1e3 * s[min(n - 1, int(n * 0.95))],
        }
