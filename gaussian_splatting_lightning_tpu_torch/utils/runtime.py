"""Profiling hooks: a ``torch.profiler`` trace context and a wall-clock step
timer.

Counterpart of ``gaussian_splatting_lightning_tpu/utils/runtime.py``. Its
``setup_compilation_cache`` has no counterpart here: the port compiles
nothing per shape, and its kernels' build directory (``ops/_build.py``,
keyed by a hash of source and flags) is already the persistent cache.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the block with ``torch.profiler`` (CPU activity, plus CUDA
    activity when a card is present) and write a Chrome trace into
    ``log_dir``; yields the profiler, so the caller can also read its
    ``key_averages()``. A no-op yielding None when ``log_dir`` is None."""
    if not log_dir:
        yield None
        return
    import torch
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
