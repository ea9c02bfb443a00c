"""1 - the device's busy time (every device event, overlaps counted once;
on a mesh the ranks' mean, as the line's ``device.busy_s``) over the wall of
the traced steps (rank 0's), in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.trace.wall_s)
