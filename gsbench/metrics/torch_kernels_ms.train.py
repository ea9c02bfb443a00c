"""Device ms a step of every operation that is not one of the port's five
kernels, a sort, a scan or NCCL: preprocess and its autograd, the loss's
elementwise work, Adam, the statistics, fills and copies."""

from gsbench.trace import kernel_class


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.per_step_ms(lambda k: kernel_class(k) == "torch")
