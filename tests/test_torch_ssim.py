"""The port's SSIM (K5's plain version on the CPU) against the JAX package's
``ops/ssim.py``: the blur forward and VJP against ``_blur_valid`` (XLA conv
at HIGHEST precision) and ``_blur_valid_pallas(interpret=True)``, ``ssim``'s
value and gradient, each at windows 3, 7, 11 and 15; the taps K5 is given;
even windows refused; the smooth high-resolution case where the uncentered
form loses ~7 digits, and ``psnr``.

Tolerances: the blur is w^2 f32 products summed in another order than the
JAX conv (vertical then horizontal taps, serially), a few ulp of values
<= 1: 2e-6 absolute. SSIM's value within 1e-6 and its gradient within 1e-4
of the gradient's largest magnitude (the map divides by local variances as
small as C2 = 9e-4, which amplifies those ulps).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussian_splatting_lightning_tpu_torch.ops import ssim as tssim

# the JAX package's ops/__init__ exports the function ``ssim`` under the
# module's name, so the module is fetched by its full name
jssim = importlib.import_module("gaussian_splatting_lightning_tpu.ops.ssim")

RNG = np.random.default_rng(17)


def stack(c=15, hp=40, wp=57):
    return RNG.uniform(-1.0, 1.0, size=(c, hp, wp)).astype(np.float32)


# (window, sigma): the default, both ends of K5's instances, a wide sigma
WINDOWS = [(3, 0.8), (7, 1.5), (11, 1.5), (15, 2.5)]


@pytest.mark.parametrize("window,sigma", WINDOWS, ids=lambda v: str(v))
@pytest.mark.parametrize("jax_blur", ["xla", "pallas_interpret"])
def test_blur_forward_and_vjp_match_jax(jax_blur, window, sigma):
    x = stack()
    out = (15, 41 - window, 58 - window)
    ct = RNG.normal(size=out).astype(np.float32)
    if jax_blur == "xla":
        def fn(v):
            return jssim._blur_valid(v, window, sigma)
    else:
        def fn(v):
            return jssim._blur_valid_pallas(v, window, sigma, interpret=True)
    jy, vjp = jax.vjp(fn, jnp.asarray(x)[None])
    (jdx,) = vjp(jnp.asarray(ct)[None])

    taps = tssim.window_taps(window, sigma)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tssim.BlurValid.apply(tx, False, taps)
    ty.backward(torch.from_numpy(ct))
    assert ty.shape == out
    np.testing.assert_allclose(np.asarray(jy)[0], ty.detach().numpy(), atol=2e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(jdx)[0], tx.grad.numpy(), atol=2e-6, rtol=0)
    # CPU tensors take the plain version
    assert torch.equal(ty, tssim.blur_valid(tx, 0, taps))


@pytest.mark.parametrize("shape", [(15, 11, 57), (3, 23, 18), (2, 37, 31), (1, 11, 11)],
                         ids=lambda s: "x".join(map(str, s)))
def test_blur_margin_equals_padding_then_blur(shape):
    """The plain blur read with a zero margin of 10 (the VJP's route) equals
    the blur of the cotangent zero-padded by 10 in memory, to the bit, and
    so does ``BlurValid``'s backward; widths 1, 2 and 3 mod 4 and one-row
    inputs."""
    ct = RNG.normal(size=shape).astype(np.float32)
    padded = np.zeros((shape[0], shape[1] + 20, shape[2] + 20), np.float32)
    padded[:, 10:-10, 10:-10] = ct
    want = tssim.blur_valid_plain(torch.from_numpy(padded))
    got = tssim.blur_valid_plain(torch.from_numpy(ct), tssim.HALO)
    assert got.shape == (shape[0], shape[1] + 10, shape[2] + 10)
    assert torch.equal(got, want)
    x = torch.zeros(got.shape, requires_grad=True)
    tssim.BlurValid.apply(x, False).backward(torch.from_numpy(ct))
    assert torch.equal(x.grad, want)


def test_taps_are_the_jax_window():
    np.testing.assert_array_equal(np.asarray(tssim.TAPS, np.float32),
                                  jssim._gaussian_window(11, 1.5))


@pytest.mark.parametrize("window,sigma", WINDOWS + [(5, 1.0), (9, 1.5), (13, 2.0)],
                         ids=lambda v: str(v))
def test_kernel_taps_are_the_jax_window(window, sigma):
    """The f32 taps K5's entry copies into its launch argument are JAX's
    ``_gaussian_window(w, sigma)`` to the bit, and K5 has an instance for
    every odd window from 3 to 15."""
    arr = tssim.kernel_taps(tssim.window_taps(window, sigma))
    got = np.frombuffer(arr, dtype=np.float32)
    np.testing.assert_array_equal(got, jssim._gaussian_window(window, sigma))
    assert window in tssim.KERNEL_WINDOWS


@pytest.mark.parametrize("window", [4, 10, 0])
def test_even_window_raises(window):
    """An even window is not symmetric, so the blur's VJP would not be its
    adjoint (JAX's Pallas VJP is off by 0.6 at window 4) and the map would
    be a pixel too large: ``ssim``, ``ssim_map`` and ``BlurValid`` refuse it
    on any device, before any blur."""
    a = torch.from_numpy(RNG.uniform(size=(1, 3, 20, 24)).astype(np.float32))
    with pytest.raises(ValueError, match="odd"):
        tssim.ssim(a, a, window_size=window)
    with pytest.raises(ValueError, match="odd"):
        tssim.ssim_map(a, a, True, window_size=window)
    if window:
        taps = tuple(float(t) for t in jssim._gaussian_window(window, 1.5))
        with pytest.raises(ValueError, match="odd"):
            tssim.BlurValid.apply(torch.zeros(2, 30, 30), False, taps)


@pytest.mark.parametrize("window,sigma", WINDOWS, ids=lambda v: str(v))
@pytest.mark.parametrize("shape", [(3, 48, 64), (2, 3, 33, 21)])
def test_ssim_value_and_gradient_match_jax(shape, window, sigma):
    a = RNG.uniform(size=shape).astype(np.float32)
    b = np.clip(a + RNG.normal(scale=0.1, size=shape), 0, 1).astype(np.float32)
    jv, (jga, jgb) = jax.value_and_grad(jssim.ssim, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b), window, sigma)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    tv = tssim.ssim(ta, tb, window_size=window, sigma=sigma)
    tv.backward()
    assert abs(float(jv) - float(tv.detach())) <= 1e-6
    for jg, tg in ((jga, ta.grad), (jgb, tb.grad)):
        jg = np.asarray(jg)
        assert np.abs(jg - tg.numpy()).max() <= 1e-4 * np.abs(jg).max()


def test_ssim_map_matches_jax():
    a = RNG.uniform(size=(1, 3, 24, 40)).astype(np.float32)
    b = RNG.uniform(size=(1, 3, 24, 40)).astype(np.float32)
    jm = np.asarray(jssim.ssim_map(jnp.asarray(a), jnp.asarray(b)))
    tm = tssim.ssim_map(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert tm.shape == a.shape
    np.testing.assert_allclose(jm, tm, atol=1e-5, rtol=0)


def test_ssim_smooth_highres_matches_jax():
    """The centered variances keep SSIM in [-1, 1] on a smooth 640x960
    render (local variance ~1e-8 against blur(x^2) ~ 0.25), and identical
    smooth images score 1."""
    from scipy.ndimage import zoom

    rng = np.random.default_rng(5)
    base = rng.uniform(0.2, 0.8, size=(3, 17, 30)).astype(np.float32)
    img = zoom(base, (1, 640 / 17, 960 / 30), order=1).astype(np.float32)
    tgt = np.clip(img + rng.normal(scale=0.03, size=img.shape), 0, 1).astype(np.float32)
    want = float(jssim.ssim(jnp.asarray(img), jnp.asarray(tgt)))
    ti = torch.from_numpy(img).requires_grad_()
    got = tssim.ssim(ti, torch.from_numpy(tgt))
    got.backward()
    got = float(got.detach())
    assert -1.0 <= got <= 1.0
    assert got == pytest.approx(want, abs=1e-5)
    assert bool(torch.isfinite(ti.grad).all())
    same = tssim.ssim(torch.from_numpy(img), torch.from_numpy(img))
    assert float(same) == pytest.approx(1.0, abs=1e-4)


def test_psnr_matches_jax():
    a = RNG.uniform(size=(3, 20, 30)).astype(np.float32)
    b = RNG.uniform(size=(3, 20, 30)).astype(np.float32)
    assert float(tssim.psnr(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(
        float(jssim.psnr(jnp.asarray(a), jnp.asarray(b))), abs=1e-5)
    assert float(tssim.psnr(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(120.0)
