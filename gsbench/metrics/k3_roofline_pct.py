"""K3's least time for the traced steps' contributing evaluations
(``counts.k3_least_s``) over its device time, in percent: on a mesh rank
0's, its view group's views and its band's rows of them."""

from gsbench import counts


def read(ctx):
    if not ctx.work:
        return None
    ms = ctx.trace.per_step_ms(lambda k: "composite_bwd_kernel" in k)
    if ms <= 0:
        return None
    s = ctx.trace.steps
    own = ctx.work["rank0"]  # the traced rank's share: the whole on one card
    least = counts.k3_least_s(own["kept"] / s, own["visible"] / s, own["pixels"] / s)
    return 100.0 * least * 1e3 / ms
