"""LPIPS (Learned Perceptual Image Patch Similarity), VGG16 backbone.

Counterpart of ``gaussian_splatting_lightning_tpu/ops/lpips.py``: the
LPIPS-VGG forward as the original lpips package computes it,

    d(x, y) = sum_l mean_hw( w_l * || phi_l(x)/||phi_l(x)|| -
                                     phi_l(y)/||phi_l(y)|| ||^2 )

with phi_l the VGG16 activations at relu1_2 / relu2_2 / relu3_3 / relu4_3 /
relu5_3, each unit-normalised over channels per pixel (eps 1e-10), and w_l
the trained non-negative 1x1 "linear" heads. The weights come from an
``.npz`` in the JAX package's layout (``scripts/export_lpips_weights.py``):

    conv{i}_w : (out, in, kh, kw) float32, i = 0..12  (VGG16 conv stack)
    conv{i}_b : (out,) float32
    lin{j}_w  : (C_j,) float32, j = 0..4              (LPIPS linear heads)

All convs are 3x3, SAME padding; a 2x2/2 max-pool follows each block but
the last (VGG16 'D'). The JAX package computes the convolutions and pools
with ``lax.conv_general_dilated`` and ``reduce_window``, outside any Pallas
kernel; here they are ``F.conv2d`` and ``F.max_pool2d``, in f32: cuDNN's
TF32 is switched off for these calls only.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 cfg 'D': channel width per conv, with pool positions between blocks
WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
# conv index AFTER which each block ends (feature tap points, 0-based)
TAPS = (1, 3, 6, 9, 12)
_POOL_AFTER = frozenset(TAPS[:-1])

# lpips scaling layer constants (input in [-1, 1])
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def load_weights(path) -> Dict[str, np.ndarray]:
    """Load and validate an LPIPS-VGG weight archive (see module docstring);
    the JAX loader's checks and messages."""
    data = dict(np.load(path))
    for i, width in enumerate(WIDTHS):
        w = data.get(f"conv{i}_w")
        b = data.get(f"conv{i}_b")
        if w is None or b is None:
            raise ValueError(f"{path}: missing conv{i}_w / conv{i}_b")
        if w.shape[0] != width or b.shape != (width,):
            raise ValueError(
                f"{path}: conv{i} shape {w.shape}/{b.shape} does not match "
                f"VGG16 width {width}"
            )
    for j, tap in enumerate(TAPS):
        lin = data.get(f"lin{j}_w")
        if lin is None or lin.shape != (WIDTHS[tap],):
            raise ValueError(
                f"{path}: lin{j}_w missing or wrong shape "
                f"(want ({WIDTHS[tap]},))"
            )
    return data


def _vgg_taps(x: torch.Tensor, weights: Dict[str, torch.Tensor]):
    """x (N, 3, H, W) in [-1, 1] -> the five tap activations."""
    shift = torch.tensor(SHIFT, dtype=x.dtype, device=x.device)[None, :, None, None]
    scale = torch.tensor(SCALE, dtype=x.dtype, device=x.device)[None, :, None, None]
    h = (x - shift) / scale
    taps = []
    for i in range(len(WIDTHS)):
        h = F.relu(F.conv2d(h, weights[f"conv{i}_w"], weights[f"conv{i}_b"], padding=1))
        if i in TAPS:
            taps.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, 2, 2)
    return taps


def _unit_normalize(t: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(t * t, dim=1, keepdim=True))
    return t / (norm + eps)


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full f32 inside the block (its default on the
    card is TF32), the caller's setting restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def lpips(image: torch.Tensor, target: torch.Tensor, weights) -> torch.Tensor:
    """LPIPS distance between images in [0, 1].

    image/target: (3, H, W) or (N, 3, H, W), channel first, range [0, 1], on
    any device; ``weights``: the dict of :func:`load_weights` (numpy arrays
    or tensors). Returns a 0-dim tensor (one image) or (N,) distances.
    """
    single = image.dim() == 3
    if single:
        image, target = image[None], target[None]
    dev = image.device
    w = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                            dtype=torch.float32).to(dev)
         for k, v in weights.items()}
    x = image.to(torch.float32) * 2.0 - 1.0  # lpips works in [-1, 1]
    y = target.to(torch.float32) * 2.0 - 1.0
    with _no_tf32():
        tx = _vgg_taps(x, w)
        ty = _vgg_taps(y, w)
    total = torch.zeros(x.shape[0], dtype=x.dtype, device=dev)
    for j, (a, b) in enumerate(zip(tx, ty)):
        diff = _unit_normalize(a) - _unit_normalize(b)
        lin = w[f"lin{j}_w"][None, :, None, None]
        # the non-negative 1x1 conv is a channel-weighted sum of squares
        total = total + torch.mean(torch.sum(lin * diff * diff, dim=1), dim=(1, 2))
    return total[0] if single else total
