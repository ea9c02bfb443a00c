"""Reduction of a stretch traced with the program's span marks on.

The port marks each boundary of its train step with a do-nothing kernel
``gs_span_<name>`` (``utils/runtime.mark``), a node of the captured graph
that fires on every replay; the loop marks its host work with
``record_function`` ranges (``trainer.step``, ``trainer.log_read``, ...).
Both lie on the profiler's clock. From the raw events this gives:

- each segment's device ms a step: the union of the device intervals
  (marks left out) between a mark and the next, over the complete
  sequences of ``SPANS`` (the eval step's and the render's sequences are
  left out; any other sequence, a mark missing, repeated or out of order,
  gives None rather than a wrong number);
- the share of the device's busy time (marks left out) inside a segment;
- the device idle inside each host span, in ms a step (the profiler's copy
  of a host range on the device is left out of the device's work);
- the marks' own device time, in us a step, and each kernel's device ms a
  step inside the segments (by the segment its start falls in).

The names and their order are the program's (``utils/runtime.SPANS``),
copied here so that the benchmark imports nothing of the program to read
a trace.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

SPANS = ("preprocess", "binning", "composite", "loss", "loss_bwd", "composite_bwd",
         "preprocess_bwd", "adam", "stats", "end")
EVAL_SPANS = ("preprocess", "binning", "composite", "loss", "end")
RENDER_SPANS = ("preprocess", "binning", "composite", "end")
HOST_SPANS = ("trainer.step", "trainer.log_read", "trainer.densify", "trainer.validate",
              "trainer.checkpoint", "graph.capture")
MARK_RE = re.compile(r"gs_span_([a-z_]+)")


@dataclass
class Spans:
    steps: int  # complete step sequences
    segment_ms: dict = field(default_factory=dict)  # segment -> device ms a step
    covered: float = 0.0  # share of the busy time (marks left out) inside a segment
    host_idle_ms: dict = field(default_factory=dict)  # host span -> device idle ms a step
    mark_us: float = 0.0  # the marks' own device time, us a step
    inside_ms: dict = field(default_factory=dict)  # kernel -> device ms a step in segments

    def ms(self, *segments) -> float:
        return sum(self.segment_ms[s] for s in segments)


def _merge(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap_ns(merged: list, starts: list, t0: int, t1: int) -> int:
    """Length of the merged intervals' part inside [t0, t1)."""
    total = 0
    i = max(bisect.bisect_right(starts, t0) - 1, 0)
    while i < len(merged) and merged[i][0] < t1:
        total += max(0, min(merged[i][1], t1) - max(merged[i][0], t0))
        i += 1
    return total


def _windows(marks: list):
    """(segment -> [(t0, t1)], complete steps) of the sorted ``marks``, or
    None when a sequence is neither a step's, an eval's nor a render's."""
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
    return windows, steps


def reduce(events) -> Spans | None:
    """``events``: the profiler's raw events (``kineto_results.events()``).
    None when the stretch holds no complete step or a broken sequence."""
    marks, mark_iv, work, host = [], [], [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if e.name() in HOST_SPANS or getattr(e, "is_user_annotation", lambda: False)():
                continue  # a host range laid over its kernels: no device work
            m = MARK_RE.search(e.name())
            if m:
                marks.append((s, m.group(1)))
                mark_iv.append((s, s + d))
            else:
                work.append((s, s + d, e.name()))
        elif e.name() in HOST_SPANS:
            host.append((s, s + d, e.name()))
    found = _windows(sorted(marks))
    if found is None or not found[1]:
        return None
    windows, steps = found
    merged = _merge((s, e) for s, e, _ in work)
    starts = [s for s, _ in merged]
    busy = sum(e - s for s, e in merged)
    ns = {name: sum(_overlap_ns(merged, starts, t0, t1) for t0, t1 in w)
          for name, w in windows.items()}

    every = sorted(w for ws in windows.values() for w in ws)
    w_starts = [t0 for t0, _ in every]
    inside: dict = {}
    for s, e, name in work:
        i = bisect.bisect_right(w_starts, s) - 1
        if i >= 0 and s < every[i][1]:
            inside[name] = inside.get(name, 0.0) + (e - s) * 1e-6 / steps

    # idle is idle of every device event, marks included
    allbusy = _merge([(s, e) for s, e, _ in work] + mark_iv)
    a_starts = [s for s, _ in allbusy]
    idle: dict = {}
    for s, e, name in host:
        gap = (e - s) - _overlap_ns(allbusy, a_starts, s, e)
        idle[name] = idle.get(name, 0.0) + gap * 1e-6 / steps
    return Spans(steps, {k: v * 1e-6 / steps for k, v in ns.items()},
                 sum(ns.values()) / busy if busy else 0.0, idle,
                 sum(e - s for s, e in mark_iv) * 1e-3 / steps, inside)
