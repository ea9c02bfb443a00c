"""The step's share of the card's peak: the least time of the work the
traced steps needed (``counts.step_work``, divided evenly over the cards)
over the measured time of a step (the window's wall over its steps)."""

from gsbench import counts


def read(ctx):
    if not ctx.work:
        return None
    s = ctx.trace.steps
    work = counts.step_work(ctx.work["kept"] / s, ctx.work["visible"] / s, ctx.params,
                            ctx.capacity, ctx.pixels_per_step)
    least = counts.least_s(work["flops"] / ctx.chips, work["bytes"] / ctx.chips)
    return 100.0 * least / ctx.step_s
