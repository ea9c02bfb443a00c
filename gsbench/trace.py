"""Reduction of a ``torch.profiler`` trace to device busy time, kernel time
by name and the idle gaps with what the host was doing meanwhile.

The arithmetic is that of the port's chip smoke test (busy time from the
profiler's device events against the wall), here read from the raw events
so that overlapping kernels count once in the busy time.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

# the port's hand-written kernels, by their ``__global__`` names in csrc/
PORT_KERNELS = {
    "expand_pairs_kernel": "K1 expand_pairs",
    "composite_fwd_kernel": "K2 composite_fwd",
    "composite_bwd_kernel": "K3 composite_bwd",
    "segment_sum_kernel": "K4 segment_sum",
    "blur_valid_kernel": "K5 blur_valid",
}


def kernel_class(name: str) -> str:
    """``port`` (one of the five), ``nccl``, ``sort``, ``scan`` or ``torch``."""
    low = name.lower()
    if any(k in name for k in PORT_KERNELS):
        return "port"
    if "nccl" in low:
        return "nccl"
    if "sort" in low or "searchsorted" in low:
        return "sort"
    if "scan" in low:
        return "scan"
    return "torch"


def short_name(name: str) -> str:
    for k, label in PORT_KERNELS.items():
        if k in name:
            return label
    return name[:80]


@dataclass
class Trace:
    """Device events of a traced stretch of ``steps`` steps over ``wall_s``
    seconds of host time (the profiler's window)."""

    steps: int
    wall_s: float
    kernels: dict = field(default_factory=dict)  # full name -> [seconds, count]
    busy_s: float = 0.0  # union of every device event's interval
    idle_gaps: list = field(default_factory=list)  # [host label, seconds], longest first

    def per_step_ms(self, pred) -> float:
        """Device ms a step of the kernels whose full name satisfies ``pred``."""
        return sum(s for k, (s, _) in self.kernels.items() if pred(k)) * 1e3 / self.steps

    def launches_per_step(self) -> float:
        return sum(n for _, n in self.kernels.values()) / self.steps

    def top_ops(self, n: int = 10) -> list:
        by_label: dict = {}
        for k, (s, _) in self.kernels.items():
            label = short_name(k)
            by_label[label] = by_label.get(label, 0.0) + s
        return sorted(([k, v] for k, v in by_label.items()), key=lambda r: -r[1])[:n]


def _union(intervals) -> tuple:
    """(total length, merged intervals) of (start, end) pairs."""
    total, merged = 0, []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        total += e - s
    return total, merged


def reduce_events(events, steps: int, wall_s: float) -> Trace:
    """``events``: the profiler's raw events (``kineto_results.events()``)."""
    dev, host = [], []
    for e in events:
        kind = str(e.device_type())
        if kind.endswith("CUDA"):
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.duration_ns() > 0:
            host.append((e.start_ns(), e.duration_ns(), e.name()))
    tr = Trace(steps=steps, wall_s=wall_s)
    for s, e, name in dev:
        row = tr.kernels.setdefault(name, [0.0, 0])
        row[0] += (e - s) * 1e-9
        row[1] += 1
    busy, merged = _union((s, e) for s, e, _ in dev)
    tr.busy_s = busy * 1e-9
    tr.idle_gaps = _label_gaps(merged, host)
    return tr


SHORT_GAP_NS = 5_000  # gaps between back-to-back launches, not labelled


def _label_gaps(merged: list, host: list, n: int = 10) -> list:
    """The idle gaps between device activity, summed by the innermost host
    event under each gap's start (what the host was doing); gaps shorter
    than ``SHORT_GAP_NS`` are summed under one label."""
    host.sort()
    starts = [h[0] for h in host]
    by_label: dict = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        gap = nxt - end
        if gap <= 0:
            continue
        if gap < SHORT_GAP_NS:
            key = "gaps under 5 us between device ops"
            by_label[key] = by_label.get(key, 0.0) + gap * 1e-9
            continue
        label, best = "no host event", None
        i = bisect.bisect_right(starts, end)
        for j in range(i - 1, max(-1, i - 400), -1):
            s, d, name = host[j]
            if s + d >= end and (best is None or d < best):
                label, best = name, d
        by_label[label[:80]] = by_label.get(label[:80], 0.0) + gap * 1e-9
    return sorted(([k, v] for k, v in by_label.items()), key=lambda r: -r[1])[:n]


@contextlib.contextmanager
def profiled(box: dict):
    """Profile CPU and CUDA activity in the block; ``box["events"]`` holds
    the raw events afterwards."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    box["events"] = prof.profiler.kineto_results.events()
