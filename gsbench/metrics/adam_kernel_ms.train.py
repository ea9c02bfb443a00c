"""Device ms a step of Adam's kernel (``adam_update_kernel``,
``csrc/adam.cu``); None where it did not run, as on a program that updates
with PyTorch's elementwise operations."""

KERNEL = "adam_update_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.per_step_ms(lambda k: KERNEL in k)
    return ms if ms > 0 else None
