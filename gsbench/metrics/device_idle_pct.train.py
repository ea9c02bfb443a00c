"""1 - the device's busy time (every device event, overlaps counted once)
over the wall of the traced steps, in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.wall_s)
