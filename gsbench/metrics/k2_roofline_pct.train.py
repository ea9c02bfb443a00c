"""K2's least time for the traced steps' contributing evaluations
(``counts.k2_least_s``) over its device time, in percent."""

from gsbench import counts


def read(ctx):
    if not ctx.work:
        return None
    ms = ctx.trace.per_step_ms(lambda k: "composite_fwd_kernel" in k)
    if ms <= 0:
        return None
    s = ctx.trace.steps
    least = counts.k2_least_s(ctx.work["kept"] / s, ctx.work["visible"] / s,
                              ctx.pixels_per_step)
    return 100.0 * least * 1e3 / ms
