"""Runtime helpers: the profiler trace context, the switch of the span
marks that survive CUDA-graph capture and the reduction of a trace to the
step's segments (``runtime.py``), and the step timer."""

from gaussian_splatting_lightning_tpu_torch.utils.runtime import (  # noqa: F401
    StepTimer,
    span_segments,
    spanning,
    trace,
)
