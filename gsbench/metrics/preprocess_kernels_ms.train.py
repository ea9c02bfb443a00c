"""Device ms a step of the preprocess kernel pair (``preprocess_fwd_kernel``
and ``preprocess_bwd_kernel``, ``csrc/preprocess.cu``); None where neither
ran, as on a program that composes its preprocess from PyTorch operations."""

KERNELS = ("preprocess_fwd_kernel", "preprocess_bwd_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.per_step_ms(lambda k: any(name in k for name in KERNELS))
    return ms if ms > 0 else None
