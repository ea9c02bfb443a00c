"""Capture and replay of CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package never dispatches its main path op by op: the train step,
the eval step, the bench's gradient and every serving CLI's render are each
one ``jax.jit`` program, the train step with the scene and Adam donated.
Here ``capture(fn)`` gives a ``Captured`` callable that records ``fn``'s
kernels once per key as a ``torch.cuda.CUDAGraph`` and replays the graph on
every later call with that key:

- ``graph_key`` is what keys the jit cache: the static arguments (a hashable
  value the caller builds: image size, ``TilingConfig``, SH degree, flags)
  and each tensor input's shape and dtype. It is pure Python, so it can be
  computed and compared without a card.
- Each tensor input is copied into the static input buffer the graph reads,
  unless it is that buffer: a donated input that the caller hands back.
  ``fn`` may update its inputs in place, as donation lets XLA do, so the
  outputs that alias them stay where they are across replays. Every other
  output is a static output tensor of the graph, valid until the next replay
  of any graph (all graphs draw on one memory pool).
- A call with a new key releases the graph of the old one, then warms up and
  captures anew; the pool keeps the old graph's memory for the new one.
- Before a capture, one eager call on a side stream, on the static input
  buffers (copied from the inputs again after it: a donating ``fn`` must
  not advance the caller's state), builds and loads the kernels
  (``ops/_build.py``) and runs any one-time set-up, such as K5's
  ``cudaFuncSetAttribute``, outside the capture.
- The warm-up and capture run inside the host span ``graph.capture``
  (``utils/runtime.span``).
- ``ops/_build.launches`` counts a launch where a wrapper makes it. A capture
  launches nothing, so the counts it records are taken back and added again
  on every replay: the counts stay the launches the card ran.
- Every capture may record NCCL collectives (the mesh step). The warm-up
  has then issued every collective the capture records, on every group, so
  each communicator exists before the capture (one may be created only at
  its first use, which cannot be captured); the card finishes the warm-up
  before the capture begins; and the capture runs in ``thread_local`` error
  mode, so that ProcessGroupNCCL's watchdog thread, which polls its
  collectives' events, does not invalidate it. Every rank captures the same
  collectives in the same order as long as its key changes where the other
  ranks' do. A graph that holds collectives must be released before its
  process group is destroyed: ``parallel.shutdown`` does both.

Only CUDA tensors are captured: a CPU input raises, and so does a failed
capture. Nothing here falls back to eager; callers run eagerly only where
they are asked to (``capture=False``) or on the CPU.
"""

from __future__ import annotations

import time
from typing import Callable, Hashable, NamedTuple, Sequence

import torch

from gaussian_splatting_lightning_tpu_torch.ops import _build
from gaussian_splatting_lightning_tpu_torch.utils import runtime

_pool = None
_anchor = None


def _memory_pool():
    """The one memory pool every captured graph allocates from. A one-op
    graph captured into it first and never released keeps it alive: the
    caching allocator refuses a capture into a pool that still holds blocks
    but no live graph (once every graph of a key was released)."""
    global _pool, _anchor
    if _pool is None:
        pool = torch.cuda.graph_pool_handle()
        anchor, x = torch.cuda.CUDAGraph(), torch.zeros(1, device="cuda")
        with torch.cuda.graph(anchor, pool=pool):
            x.add_(1)
        _pool, _anchor = pool, (anchor, x)
    return _pool


def graph_key(static: Hashable, tensors: Sequence[torch.Tensor]) -> tuple:
    """The cache key of a call: ``static`` and each tensor's shape and dtype
    (the JAX jit cache's key: static arguments and abstract shapes)."""
    return (static,) + tuple((tuple(t.shape), str(t.dtype)) for t in tensors)


class _Entry(NamedTuple):
    key: tuple
    graph: torch.cuda.CUDAGraph
    inputs: list  # static input buffers, in the call's order
    outputs: object  # what ``fn`` returned during the capture
    launches: dict  # kernel launches per replay, by name


class Captured:
    """``fn(static, *tensors)`` captured once per key and replayed; see the
    module docstring. ``capture_s`` holds the seconds of the last warm-up
    plus capture, ``captures`` how many captures were made."""

    def __init__(self, fn: Callable, name: str | None = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")
        self.captures = 0
        self.capture_s = 0.0
        self._entry: _Entry | None = None

    @property
    def inputs(self) -> list | None:
        """The current graph's static input buffers (None before a capture)."""
        return None if self._entry is None else self._entry.inputs

    @property
    def launches(self) -> dict:
        """Kernel launches per replay of the current graph."""
        return {} if self._entry is None else dict(self._entry.launches)

    def release(self) -> None:
        """Drop the current graph (the next call captures anew)."""
        self._entry = None

    def __call__(self, static: Hashable, *tensors: torch.Tensor):
        for i, t in enumerate(tensors):
            if not t.is_cuda:
                raise ValueError(
                    f"capture of {self.name}: input {i} is on {t.device}; only CUDA "
                    "tensors are captured (run eagerly on the CPU)")
        key = graph_key(static, tensors)
        entry = self._entry
        if entry is None or entry.key != key:
            self._entry = None  # release the old graph before the new capture
            with runtime.span("graph.capture"):
                entry = self._entry = self._capture(key, static, tensors)
        else:
            for buf, t in zip(entry.inputs, tensors):
                if t.data_ptr() != buf.data_ptr() or t.stride() != buf.stride():
                    buf.copy_(t)
        entry.graph.replay()
        for name, n in entry.launches.items():
            _build.launches[name] += n
        return entry.outputs

    def _capture(self, key, static, tensors) -> _Entry:
        t0 = time.perf_counter()
        inputs = [t.detach().clone(memory_format=torch.contiguous_format) for t in tensors]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(static, *inputs)
        torch.cuda.current_stream().wait_stream(side)
        for buf, t in zip(inputs, tensors):  # undo what a donating warm-up wrote
            buf.copy_(t)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        before = dict(_build.launches)
        stream = torch.cuda.current_stream()
        try:
            with torch.cuda.graph(graph, pool=_memory_pool(), capture_error_mode="thread_local"):
                outputs = self.fn(static, *inputs)
        except Exception as err:
            _recover(stream)
            first = f" (after: {err.__context__})" if err.__context__ is not None else ""
            raise RuntimeError(f"CUDA graph capture of {self.name} failed: {err}{first}") from err
        finally:
            recorded = {k: _build.launches[k] - n for k, n in before.items()}
            _build.launches.update(before)
        torch.cuda.synchronize()
        self.captures += 1
        self.capture_s = time.perf_counter() - t0
        return _Entry(key, graph, inputs, outputs,
                      {k: n for k, n in recorded.items() if n})


def _recover(stream) -> None:
    """After a failed capture: back on the caller's stream, and a new pool
    for the next capture. The capture context does neither when ending the
    invalidated capture raises: it leaves its own stream current and the
    allocator still routing to the old pool, which then refuses another
    capture."""
    global _pool, _anchor
    torch.cuda.set_stream(stream)
    _pool = _anchor = None


def capture(fn: Callable, name: str | None = None) -> Captured:
    """``fn(static, *tensors)`` as a ``Captured`` callable: the first call
    with a key warms up, captures and replays; later calls with that key
    copy their inputs in and replay."""
    return Captured(fn, name)
