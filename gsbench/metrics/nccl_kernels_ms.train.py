"""Device ms a step of rank 0's NCCL kernels (``trace.kernel_class``
``nccl``): the mesh's collectives and the wait inside them for the slower
band or view group; None where none ran, as in one process."""

from gsbench.trace import kernel_class


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.per_step_ms(lambda k: kernel_class(k) == "nccl")
    return ms if ms > 0 else None
