"""Differentiable SSIM and PSNR, with the separable blur as kernel K5.

Counterpart of ``gaussian_splatting_lightning_tpu/ops/ssim.py``: a Gaussian
window (11 taps, sigma 1.5 unless asked otherwise), C1 = 0.01^2,
C2 = 0.03^2, zero padding, mean over pixels and channels. The five blurred
quantities (x, y, x^2, y^2, xy of the centered images) are one 5C-channel
VALID blur, K5 (``csrc/blur.cu``, one instance per odd window in
``KERNEL_WINDOWS``; the taps are a launch argument); ``BlurValid`` is its
autograd function, whose backward is the same blur of the cotangent read
with a zero margin of window - 1 (the window is symmetric), launched on the
unpadded cotangent.

Windows must be odd. An even window is not symmetric about its centre, so
the same blur of the cotangent is not the blur's adjoint, and the padded map
would be one pixel larger than the image; the JAX package accepts even
windows and returns exactly those wrong gradients and shapes, the port
refuses them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from gaussian_splatting_lightning_tpu_torch.ops import _build

C1 = 0.01 ** 2
C2 = 0.03 ** 2
WINDOW = 11  # the default window and sigma (the JAX package's)
SIGMA = 1.5
HALO = WINDOW - 1
KERNEL_WINDOWS = tuple(range(3, 16, 2))  # the windows K5 has an instance for


def gaussian_window(size: int = WINDOW, sigma: float = SIGMA) -> np.ndarray:
    """(size,) f32 normalised Gaussian taps, computed in float64 as the JAX
    package does."""
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def window_taps(window_size: int = WINDOW, sigma: float = SIGMA) -> tuple:
    """The blur's taps for an odd ``window_size``, as Python floats (each an
    f32 value); raises ``ValueError`` for an even or non-positive window."""
    if window_size < 1 or window_size % 2 == 0:
        raise ValueError(
            f"SSIM window_size must be odd and positive, got {window_size}: an even "
            "window is not symmetric about its centre, so the blur's VJP (the same "
            "blur of the cotangent) would not be its adjoint")
    return tuple(float(t) for t in gaussian_window(window_size, sigma))


TAPS = window_taps()


@functools.lru_cache(maxsize=16)
def kernel_taps(taps: tuple) -> ctypes.Array:
    """The f32 array K5's entry copies into its launch argument."""
    return (ctypes.c_float * len(taps))(*taps)


def blur_valid_plain(x: torch.Tensor, margin: int = 0, taps: tuple = TAPS) -> torch.Tensor:
    """Plain PyTorch version of K5: (C, Hp, Wp) embedded in ``margin`` zeros
    on every side, then blurred VALID by the w = len(taps) window ->
    (C, Hp + 2 margin - w + 1, Wp + 2 margin - w + 1); vertical taps then
    horizontal, summed in tap order (K5's order)."""
    if margin:
        x = F.pad(x, (margin,) * 4)
    win = len(taps)
    h, w = x.shape[1] - win + 1, x.shape[2] - win + 1
    mid = x[:, 0:h] * taps[0]
    for k in range(1, win):
        mid = mid + x[:, k:k + h] * taps[k]
    out = mid[:, :, 0:w] * taps[0]
    for k in range(1, win):
        out = out + mid[:, :, k:k + w] * taps[k]
    return out


def blur_valid(x: torch.Tensor, margin: int = 0, taps: tuple = TAPS) -> torch.Tensor:
    """K5 wrapper: launches ``csrc/blur.cu`` on CUDA tensors, runs the plain
    version on CPU tensors. (C, Hp, Wp) f32 read with a zero margin of
    ``margin`` and blurred by the w = len(taps) window -> (C, Hp + 2 margin
    - w + 1, Wp + 2 margin - w + 1); the margin is never materialised on the
    card. A window without a kernel instance raises."""
    if x.device.type == "cpu":
        return blur_valid_plain(x, margin, taps)
    _build.check_tensor(x, "x", torch.float32, x.device)
    halo = len(taps) - 1
    if x.dim() != 3 or margin < 0 or min(x.shape[1:]) + 2 * margin <= halo:
        raise ValueError(f"x must be (C, Hp, Wp) with Hp, Wp + 2 margin > {halo}, "
                         f"got {tuple(x.shape)} and margin {margin}")
    c, hp, wp = x.shape
    out = torch.empty(c, hp + 2 * margin - halo, wp + 2 * margin - halo,
                      dtype=torch.float32, device=x.device)
    lib = _build.load("blur")
    p = _build.ptr
    rc = lib.gs_blur_valid(p(x), p(out), c, hp, wp, margin, len(taps), kernel_taps(taps),
                           _build.stream_of(out))
    _build.check(lib, "blur", rc)
    return out


class BlurValid(torch.autograd.Function):
    """VALID blur with K5 in both directions: the adjoint of a VALID
    correlation with a symmetric window is the same correlation of the
    cotangent read with a zero margin of the halo. ``plain`` runs the plain
    version on any device; ``taps`` (an odd count; default the 11-tap
    window) may be left out."""

    @staticmethod
    def forward(ctx, x, plain, taps=TAPS):
        if len(taps) % 2 == 0:
            raise ValueError(f"BlurValid needs an odd, symmetric window, got {len(taps)} taps")
        ctx.plain, ctx.taps = plain, taps
        return (blur_valid_plain if plain else blur_valid)(x, 0, taps)

    @staticmethod
    def backward(ctx, ct):
        blur = blur_valid_plain if ctx.plain else blur_valid
        dx = blur(ct.contiguous(), len(ctx.taps) - 1, ctx.taps)
        return (dx,) + (None,) * (len(ctx.needs_input_grad) - 1)


def ssim_stack(img1: torch.Tensor, img2: torch.Tensor, window_size: int = WINDOW):
    """The blur's input: (B * 5C, H + w - 1, W + w - 1) stack of the
    zero-padded, centred x, y, x^2, y^2 and xy (w = ``window_size``), and
    the two centres.

    Variances are taken on globally centred inputs (centred on each image's
    detached mean): exact for any constant shift, and in f32 the uncentred
    form loses about 7 digits on smooth renders. The images are zero-padded
    first and shifted after, so pixels outside the image read as 0. Each of
    the B images is centred on its own mean, as ``vmap`` of the JAX loss
    centres each view in the view-batched step (the JAX ``ssim_map`` called
    on a batch takes one mean for all, which differs only in rounding)."""
    if img1.shape[0] == 1:
        c1 = img1.mean().detach()
        c2 = img2.mean().detach()
    else:
        c1 = img1.mean(dim=(1, 2, 3), keepdim=True).detach()
        c2 = img2.mean(dim=(1, 2, 3), keepdim=True).detach()
    r = window_size // 2
    y1 = F.pad(img1, (r, r, r, r)) - c1
    y2 = F.pad(img2, (r, r, r, r)) - c2
    stacked = torch.cat([y1, y2, y1 * y1, y2 * y2, y1 * y2], dim=1)
    b, c5, hp, wp = stacked.shape
    return stacked.reshape(b * c5, hp, wp).contiguous(), c1, c2


def ssim_from_blurred(blurred: torch.Tensor, c1, c2, batch: int) -> torch.Tensor:
    """The SSIM map (B, C, H, W) from the blurred stack (B * 5C, H, W)."""
    by1, by2, b11, b22, b12 = blurred.reshape(batch, -1, *blurred.shape[1:]).chunk(5, dim=1)
    mu1 = by1 + c1
    mu2 = by2 + c2
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = b11 - by1 * by1
    sigma2_sq = b22 - by2 * by2
    sigma12 = b12 - by1 * by2
    return ((2.0 * mu12 + C1) * (2.0 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, plain: bool = False, *,
             window_size: int = WINDOW, sigma: float = SIGMA) -> torch.Tensor:
    """Per-pixel SSIM map, (B, C, H, W) -> (B, C, H, W), zero padding; one
    5C-channel blur (``ssim_stack``) between the two halves. An even
    ``window_size`` raises ``ValueError``."""
    taps = window_taps(window_size, sigma)
    stacked, c1, c2 = ssim_stack(img1, img2, window_size)
    return ssim_from_blurred(BlurValid.apply(stacked, plain, taps), c1, c2, img1.shape[0])


def ssim(img1: torch.Tensor, img2: torch.Tensor, plain: bool = False, *,
         window_size: int = WINDOW, sigma: float = SIGMA) -> torch.Tensor:
    """Mean SSIM between two (B, C, H, W) or (C, H, W) images in [0, 1]."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    return ssim_map(img1, img2, plain, window_size=window_size, sigma=sigma).mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         dim=None) -> torch.Tensor:
    """Peak signal-to-noise ratio; over ``dim`` only, e.g. per view."""
    sq = (img1 - img2) ** 2
    mse = torch.mean(sq) if dim is None else torch.mean(sq, dim=dim)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))
