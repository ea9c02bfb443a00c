"""Device operations (kernels, copies, fills) a traced step runs."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.launches_per_step()
