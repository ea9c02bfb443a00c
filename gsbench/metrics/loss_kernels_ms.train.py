"""Device ms a step of the photometric loss's kernels (every kernel whose
name holds ``photometric_``, ``csrc/photometric.cu``: the forward's three
and the backward); None where none ran, as on a program that composes its
loss from PyTorch operations and the blur kernel."""

PREFIX = "photometric_"


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.per_step_ms(lambda k: PREFIX in k)
    return ms if ms > 0 else None
