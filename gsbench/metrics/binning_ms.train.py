"""Device ms a step of the binning: K1 (``expand_pairs_kernel``), the sorts,
the searches and the scans."""

from gsbench.trace import kernel_class


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.per_step_ms(
        lambda k: "expand_pairs_kernel" in k or kernel_class(k) in ("sort", "scan"))
