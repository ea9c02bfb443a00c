"""Runtime helpers: the profiler trace context and the step timer."""

from gaussian_splatting_lightning_tpu_torch.utils.runtime import (  # noqa: F401
    StepTimer,
    trace,
)
