"""The photometric loss kernels' arithmetic, routing and checks, on the CPU.

- ``kernel_plain`` below is the arithmetic of ``csrc/photometric.cu`` in
  plain PyTorch: the moments' sums, the centred moments blurred with zero
  padding, each pixel's SSIM and its three derivative maps, the outputs,
  and pred's gradient as the backward kernel forms it (the same blur of the
  maps, then 2 y1 and y2 and the L1 and PSNR terms). It is held to the
  composition of ``training/loss.py`` and autograd through it, for one view
  and for a stack of two (per view and joint), at odd sizes, on constant,
  smooth and noisy images and with pixels equal between pred and target
  (sign(0) = 0). In float64 both are exact to about 1e-15, so 1e-10 of
  the largest gradient shows the two compute the same function. In float32
  the values agree within 1e-6 relatively (sums in another order); the
  gradient is held to the float64 composition's: no further from it than
  twice the float32 composition's own distance, or 1e-6 of its largest
  |element|. On smooth images both lie ~2.5e-5 of the largest |element|
  from it (each variance b(y^2) - b(y)^2 cancels most of its digits where
  the image hardly varies) and ~1e-5 from each other; elsewhere ~2e-7.
- Routing: CPU tensors, ``plain=True`` and a target that needs a gradient
  take the composition and count no ``photometric`` launch.
- The wrapper's checks (``ops/photometric.py`` ``plan``) and its launch
  geometry, which must match the constants of ``csrc/photometric.cu``.

The kernels against the composition on the card:
``tests/test_torch_cuda_kernels.py`` (``-k photometric``).
"""

import math
import re
import types

import pytest
import torch
import torch.nn.functional as F

from gaussian_splatting_lightning_tpu_torch.ops import _build
from gaussian_splatting_lightning_tpu_torch.ops import photometric as phot
from gaussian_splatting_lightning_tpu_torch.ops import ssim as tssim
from gaussian_splatting_lightning_tpu_torch.training import loss as tloss

W_SSIM = 0.2


def kernel_plain(pred, target, w_ssim, per_view, cots):
    """The kernels' forward outputs (loss, recon, ssim, psnr) and pred's
    gradient for the cotangents ``cots`` of the four outputs, in the
    kernels' arithmetic (``csrc/photometric.cu``)."""
    p4 = pred if pred.dim() == 4 else pred[None]
    t4 = target if target.dim() == 4 else target[None]
    v, c, h, w = p4.shape
    n_view = c * h * w
    pad = tssim.WINDOW // 2
    c1 = p4.sum(dim=(1, 2, 3)) / n_view
    c2 = t4.sum(dim=(1, 2, 3)) / n_view
    # outside the image pred and target read as 0, so y as -c
    y1 = F.pad(p4, (pad,) * 4) - c1[:, None, None, None]
    y2 = F.pad(t4, (pad,) * 4) - c2[:, None, None, None]
    stack = torch.stack([y1, y2, y1 * y1, y2 * y2, y1 * y2], dim=1)  # (v, 5, c, ...)
    blurred = tssim.blur_valid_plain(stack.reshape(v * 5 * c, h + 2 * pad, w + 2 * pad))
    by1, by2, b11, b22, b12 = blurred.reshape(v, 5, c, h, w).unbind(1)
    mu1 = by1 + c1[:, None, None, None]
    mu2 = by2 + c2[:, None, None, None]
    s1, s2, s12 = b11 - by1 * by1, b22 - by2 * by2, b12 - by1 * by2
    a1, a2 = 2.0 * (mu1 * mu2) + tssim.C1, 2.0 * s12 + tssim.C2
    d1, d2 = mu1 * mu1 + mu2 * mu2 + tssim.C1, s1 + s2 + tssim.C2
    den = d1 * d2
    smap = (a1 * a2) / den
    g_mu1 = (2.0 * mu2 * a2 - smap * (2.0 * mu1 * d2)) / den
    g_s1 = -smap / d2
    g_s12 = 2.0 * a1 / den
    t1 = g_mu1 - 2.0 * by1 * g_s1 - by2 * g_s12
    d = p4 - t4
    sums = torch.stack([d.abs().sum(dim=(1, 2, 3)), (d * d).sum(dim=(1, 2, 3)),
                        smap.sum(dim=(1, 2, 3))])
    if not per_view:
        sums = sums.sum(dim=1, keepdim=True)
    n_out = n_view if per_view else v * n_view
    recon, mse, l_ssim = sums[0] / n_out, sums[1] / n_out, 1.0 - sums[2] / n_out
    loss = recon * (1.0 - w_ssim) + l_ssim * w_ssim
    psnr = 10.0 * torch.log10(1.0 / torch.where(mse < 1e-12, 1e-12, mse))
    outs = [x if per_view else x[0] for x in (loss, recon, l_ssim, psnr)]
    # the backward: per view coefficients, then the blur of the maps
    g = [torch.zeros(v, dtype=pred.dtype) if ct is None else ct.expand(v) for ct in cots]
    mse_v = mse.expand(v)
    gs = -(g[0] * w_ssim + g[2]) / n_out
    ga = (g[0] * (1.0 - w_ssim) + g[1]) / n_out
    gb = torch.where(mse_v >= 1e-12, g[3] * (-10.0 / (math.log(10.0) * mse_v)) * (2.0 / n_out),
                     0.0)
    maps = torch.stack([t1, g_s1, g_s12], dim=1).reshape(v * 3 * c, h, w)
    bt1, bt11, bt12 = tssim.blur_valid_plain(maps, pad).reshape(v, 3, c, h, w).unbind(1)
    y1i, y2i = p4 - c1[:, None, None, None], t4 - c2[:, None, None, None]
    grad = (gs[:, None, None, None] * (bt1 + 2.0 * y1i * bt11 + y2i * bt12)
            + ga[:, None, None, None] * torch.sign(d) + gb[:, None, None, None] * d)
    return outs, grad.reshape(pred.shape)


def composed(pred, target, per_view, cots):
    """The composition's outputs and autograd's gradient of pred."""
    pred = pred.detach().requires_grad_()
    fn = tloss.photometric_losses if per_view else tloss.photometric_loss
    _, logs = fn(pred, target, W_SSIM)
    outs = [logs[k] for k in ("loss", "recon", "ssim", "psnr")]
    total = sum((ct * o).sum() for ct, o in zip(cots, outs) if ct is not None)
    (grad,) = torch.autograd.grad(total, pred)
    return [o.detach() for o in outs], grad


def images(kind, shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    if kind == "constant":
        pred = torch.full(shape, 0.37, dtype=dtype)
        target = torch.full(shape, 0.52, dtype=dtype)
    elif kind == "smooth":
        h, w = shape[-2:]
        yy = torch.linspace(0, 3, h, dtype=dtype)[:, None]
        xx = torch.linspace(0, 5, w, dtype=dtype)[None, :]
        base = 0.5 + 0.3 * torch.sin(yy + xx) * torch.cos(0.7 * xx)
        pred = base.expand(shape).clone()
        target = (base + 0.02 * torch.cos(2 * yy - xx)).expand(shape).clone()
    else:
        pred = torch.rand(shape, generator=gen, dtype=dtype)
        target = torch.rand(shape, generator=gen, dtype=dtype)
    if kind == "equal_pixels":
        # every other pixel of pred equal to the target's: sign(0) = 0
        mask = torch.rand(shape, generator=gen) < 0.5
        pred = torch.where(mask, target, pred)
    return pred, target


def cotangents(per_view, views, dtype, seed, all_outputs):
    """The loss's cotangent (1 or per view), and random ones of the logs."""
    gen = torch.Generator().manual_seed(seed)
    shape = (views,) if per_view else ()
    cots = [torch.ones(shape, dtype=dtype) + torch.rand(shape, generator=gen, dtype=dtype)]
    for _ in range(3):
        cots.append(torch.randn(shape, generator=gen, dtype=dtype) if all_outputs else None)
    return cots


# (views or None for one (C, H, W) image, per view, height, width)
LAYOUTS = {"one_37x53": (None, False, 37, 53), "one_64x96": (None, False, 64, 96),
           "stack2_per_view_37x53": (2, True, 37, 53),
           "stack2_joint_64x96": (2, False, 64, 96)}
KINDS = ("constant", "smooth", "noisy", "equal_pixels")


def _case(layout, kind, dtype, all_outputs):
    views, per_view, h, w = LAYOUTS[layout]
    shape = (3, h, w) if views is None else (views, 3, h, w)
    pred, target = images(kind, shape, dtype, seed=h * w)
    cots = cotangents(per_view, views or 1, dtype, seed=h + w, all_outputs=all_outputs)
    return pred, target, per_view, cots


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_kernel_arithmetic_equals_the_composition_in_float64(layout, kind):
    """Same function: every output and pred's gradient, with cotangents on
    all four outputs, to 1e-10 of the largest value."""
    pred, target, per_view, cots = _case(layout, kind, torch.float64, all_outputs=True)
    got, got_grad = kernel_plain(pred, target, W_SSIM, per_view, cots)
    want, want_grad = composed(pred, target, per_view, cots)
    for name, a, b in zip(("loss", "recon", "ssim", "psnr"), got, want):
        assert a.shape == b.shape, name
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12), (name, a, b)
    scale = float(want_grad.abs().max())
    assert scale > 0
    assert float((got_grad - want_grad).abs().max()) <= 1e-10 * scale


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_kernel_arithmetic_in_float32_is_as_close_as_the_composition(layout, kind):
    """The loss's own cotangent, as the train step sends it: values within
    1e-6 relatively of the composition's; the gradient no further from the
    float64 composition's than twice the float32 composition's own
    distance, or 1e-6 of its largest |element|."""
    pred, target, per_view, cots = _case(layout, kind, torch.float32, all_outputs=False)
    got, got_grad = kernel_plain(pred, target, W_SSIM, per_view, cots)
    want, want_grad = composed(pred, target, per_view, cots)
    for name, a, b in zip(("loss", "recon", "ssim", "psnr"), got, want):
        assert torch.allclose(a, b, rtol=1e-6, atol=0.0), (name, a, b)
    _, truth = composed(pred.double(), target.double(), per_view,
                        [None if c is None else c.double() for c in cots])
    scale = float(truth.abs().max())
    own = float((want_grad.double() - truth).abs().max())
    assert float((got_grad.double() - truth).abs().max()) <= max(2 * own, 1e-6 * scale)


def test_sign_of_zero_difference_adds_no_l1_gradient():
    """Where pred equals the target the L1 term adds nothing: with only the
    L1 log's cotangent, the gradient is 0 exactly there."""
    pred, target = images("equal_pixels", (3, 21, 30), torch.float64, seed=4)
    cots = [None, torch.tensor(1.0, dtype=torch.float64), None, None]
    _, grad = kernel_plain(pred, target, W_SSIM, False, cots)
    _, want = composed(pred, target, False, cots)
    same = pred == target
    assert same.any() and not grad[same].any() and not want[same].any()
    assert torch.equal(grad != 0, ~same)


def _refuse(*args, **kwargs):
    raise AssertionError("the kernels' wrapper ran")


@pytest.mark.parametrize("route", ["cpu", "plain", "target_grad"])
@pytest.mark.parametrize("per_view", [False, True], ids=["one", "per_view"])
def test_composition_routes(monkeypatch, route, per_view):
    """CPU tensors, ``plain`` and a target that needs a gradient run the
    composition: the wrapper is never called, no launch is counted, and the
    target's gradient flows where it is asked for."""
    monkeypatch.setattr(phot, "photometric", _refuse)
    shape = (2, 3, 20, 27) if per_view else (3, 20, 27)
    pred, target = images("noisy", shape, torch.float32, seed=1)
    pred.requires_grad_()
    if route == "target_grad":
        target.requires_grad_()
    fn = tloss.photometric_losses if per_view else tloss.photometric_loss
    before = dict(_build.launches)
    loss, logs = fn(pred, target, W_SSIM, route == "plain")
    assert set(logs) == {"loss", "recon", "ssim", "psnr"}
    loss.sum().backward()
    assert dict(_build.launches) == before
    assert pred.grad is not None and bool(torch.isfinite(pred.grad).all())
    assert (target.grad is not None) == (route == "target_grad")


def _fake(device, requires_grad=False):
    return types.SimpleNamespace(device=torch.device(device), requires_grad=requires_grad)


def test_kernel_route_is_cuda_default_and_a_fixed_target():
    assert tloss.on_kernels(_fake("cuda"), _fake("cuda"), False)
    assert tloss.on_kernels(_fake("cuda:1"), _fake("cuda:1"), False)
    assert not tloss.on_kernels(_fake("cuda"), _fake("cuda"), True)
    assert not tloss.on_kernels(_fake("cuda"), _fake("cuda", requires_grad=True), False)
    assert not tloss.on_kernels(_fake("cpu"), _fake("cpu"), False)


def _bad_inputs():
    ok = torch.zeros(3, 8, 9)
    return {
        "pred_float64": (ok.double(), ok, False, "float64"),
        "target_float64": (ok, ok.double(), False, "float64"),
        "two_devices": (ok, torch.zeros(3, 8, 9, device="meta"), False, "meta"),
        "rank_2": (ok[0], ok[0], False, "rank"),
        "rank_5": (ok[None, None], ok[None, None], False, "rank"),
        "per_view_rank_3": (ok, ok, True, "rank"),
        "shapes_differ": (ok, torch.zeros(3, 8, 10), False, "differ"),
        "empty": (torch.zeros(3, 0, 9), torch.zeros(3, 0, 9), False, "empty"),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_refuses_what_the_kernels_do_not_take(case):
    pred, target, per_view, match = _bad_inputs()[case]
    with pytest.raises(ValueError, match=match):
        phot.plan(pred, target, per_view)
    with pytest.raises(ValueError, match=match):
        phot.photometric(pred, target, W_SSIM, per_view)


def test_wrapper_refuses_cpu_tensors_and_a_target_that_needs_a_gradient():
    pred, target = images("noisy", (3, 8, 9), torch.float32, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        phot.photometric(pred, target, W_SSIM, False)
    with pytest.raises(ValueError, match="target"):
        phot.photometric(pred, target.requires_grad_(), W_SSIM, False)


@pytest.mark.parametrize("shape,per_view", [
    ((3, 1080, 1920), False), ((3, 540, 1920), False), ((2, 3, 1080, 1920), True),
    ((2, 3, 37, 53), False), ((1, 1, 1, 1), True), ((3, 34, 244), False),
    ((3, 35, 245), False)], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple)
    else str(v))
def test_launch_geometry_covers_the_image(shape, per_view):
    geo = phot.plan(torch.empty(shape), torch.empty(shape), per_view)
    v, c, h, w = (1,) * (4 - len(shape)) + shape
    assert (geo.views, geo.channels, geo.height, geo.width) == (v, c, h, w)
    # every output row and column lies in exactly one block
    assert (geo.strips - 1) * phot.STRIP_OUT < w <= geo.strips * phot.STRIP_OUT
    assert (geo.row_blocks - 1) * phot.ROWS_OUT < h <= geo.row_blocks * phot.ROWS_OUT
    assert geo.ssim_partials == c * geo.strips * geo.row_blocks
    assert geo.out_shape == ((v,) if per_view else ())
    if shape == (3, 1080, 1920):
        assert (geo.strips, geo.row_blocks, geo.ssim_partials) == (8, 32, 768)


def test_geometry_matches_the_kernel_source():
    """``ops/photometric.py``'s constants are those of the CUDA source."""
    src = (_build.SRC_DIR / _build.SOURCES["photometric"]).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    win, threads, cycles = const("kWin"), const("kThreads"), const("kCycles")
    assert win == tssim.WINDOW and len(tssim.TAPS) == win
    assert phot.STRIP_OUT == 4 * ((threads - (win - 1)) // 4)
    assert phot.ROWS_OUT == cycles * win - (win - 1)
    assert phot.MAPS == const("kMaps")
    assert re.search(r"constexpr int kMomentBlocks = kThreads;", src)
    assert phot.MOMENT_BLOCKS == threads
