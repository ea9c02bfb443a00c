"""The work a training step needs, the card's peaks and the least times that
follow from them.

Each count is of what the step's inputs require, whatever computes them, so
no implementation of the same step can do less:

- the (pixel, splat) evaluations that contribute to an image: alpha above
  1/255 and the pixel's transmittance still above 1e-4 before the splat.
  A renderer must evaluate at least these, forward, and again backward,
  where each of them feeds every gradient of its splat. Evaluations that
  are killed, or that come after a pixel's stop, are not counted, though a
  renderer has to find out that they are;
- the projection and the SH colour of each visible splat, forward and
  backward;
- Adam's update of every parameter;
- bytes: each parameter, gradient and Adam moment read once and written
  once, each rendered image and its gradient written once and read once,
  each target read once. Nothing of the binning and no intermediate is
  counted.

The floating-point operations per item are lower bounds taken from the
arithmetic itself (an exponential counts as one):
``FWD_EVAL_FLOPS``: the offset (2), the conic's quadratic form (8), the
exponential, the opacity product and the clamp (3), the weight alpha T (1),
three colour channels (6) and the transmittance update (2);
``BWD_EVAL_FLOPS``: the same alpha recomputed (13), the colour's gradient
(6), alpha's gradient from the colour behind it (6), the exponent's (3),
and the gradients of the 2D mean and the conic (12);
``SPLAT_FLOPS``: the degree-3 SH colour (16 coefficients x 3 channels, one
FMA each: 96) and the EWA projection (about 100), forward, and twice that
backward;
``ADAM_FLOPS``: two moment updates (6), the bias corrections, square root,
division and step (5) per parameter.
"""

from __future__ import annotations

F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

FWD_EVAL_FLOPS = 22
BWD_EVAL_FLOPS = 40
SPLAT_FLOPS = 3 * (96 + 100)
ADAM_FLOPS = 11
SPLAT_ROW_BYTES = 9 * 4  # 2D mean, conic, opacity, colour of one splat
PIXEL_BYTES = 3 * 4  # one RGB pixel in f32


def least_s(flops: float, nbytes: float) -> float:
    """The least time of ``flops`` and ``nbytes`` on one card."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)


def step_work(kept_evals: float, visible: float, params: int, capacity: int,
              pixels: float) -> dict:
    """Operations and bytes of one step: ``kept_evals`` contributing
    evaluations and ``visible`` visible splats summed over the step's views,
    ``params`` parameters (floats) and ``capacity`` splats in the store,
    ``pixels`` rendered pixels over the views."""
    flops = (kept_evals * (FWD_EVAL_FLOPS + BWD_EVAL_FLOPS) + visible * SPLAT_FLOPS
             + params * ADAM_FLOPS)
    # parameters, gradients: read and written; two moments: read and written
    nbytes = 4 * params * (2 + 2 + 4)
    # the image and its gradient written and read, the target read
    nbytes += pixels * PIXEL_BYTES * 5
    # the densification statistics (three per splat) read and written
    nbytes += 3 * 4 * capacity * 2
    return {"flops": flops, "bytes": nbytes}


def k2_least_s(kept_evals: float, visible: float, pixels: float) -> float:
    """Forward compositing: every contributing evaluation, each visible
    splat's row read once, the image written once."""
    return least_s(kept_evals * FWD_EVAL_FLOPS,
                   visible * SPLAT_ROW_BYTES + pixels * PIXEL_BYTES)


def k3_least_s(kept_evals: float, visible: float, pixels: float) -> float:
    """Backward compositing: every contributing evaluation again, each
    visible splat's row read and its gradient written once, the image's
    gradient read once."""
    return least_s(kept_evals * BWD_EVAL_FLOPS,
                   2 * visible * SPLAT_ROW_BYTES + pixels * PIXEL_BYTES)
