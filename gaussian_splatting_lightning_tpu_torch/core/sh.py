"""Real spherical-harmonics evaluation, degrees 0-4.

Counterpart of ``gaussian_splatting_lightning_tpu/core/sh.py``. Behavioral
spec: the reference's ``gs_lightning/utils/sh.py:41-98`` (apply_sh), with the
degree-4 band evaluated only for ``degree >= 4``.

Layout: ``sh`` is ``(..., K, 3)`` — coefficient-major, channel-minor. SH
degree 3 evaluates K = 16 coefficients.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = (-0.4886025119029199, 0.4886025119029199, -0.4886025119029199)
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def _band_basis(dirs: torch.Tensor, band: int) -> torch.Tensor:
    """Basis functions for one SH band. dirs (..., 3) -> (..., 2*band+1)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    if band == 0:
        return torch.full(dirs.shape[:-1] + (1,), SH_C0, dtype=dirs.dtype,
                          device=dirs.device)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, zx = x * y, y * z, z * x
    if band == 1:
        terms = [SH_C1[0] * y, SH_C1[1] * z, SH_C1[2] * x]
    elif band == 2:
        terms = [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * zx,
            SH_C2[4] * (xx - yy),
        ]
    elif band == 3:
        terms = [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    elif band == 4:
        terms = [
            SH_C4[0] * xy * (xx - yy),
            SH_C4[1] * yz * (3.0 * xx - yy),
            SH_C4[2] * xy * (7.0 * zz - 1.0),
            SH_C4[3] * yz * (7.0 * zz - 3.0),
            SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            SH_C4[5] * zx * (7.0 * zz - 3.0),
            SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            SH_C4[7] * zx * (xx - 3.0 * yy),
            SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    else:
        raise ValueError(f"SH band {band} unsupported (max 4)")
    return torch.stack(terms, dim=-1)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Evaluate SH colors at the static ``degree``. sh (..., K, 3), dirs
    (..., 3) unit -> (..., 3)."""
    if not 0 <= degree <= 4:
        raise ValueError(f"degree must be in [0, 4], got {degree}")
    return eval_sh_banded(sh, dirs, degree, degree)


def eval_sh_banded(
    sh: torch.Tensor, dirs: torch.Tensor, degree: int, max_degree: int
) -> torch.Tensor:
    """Evaluate SH colors. sh (..., K, 3), dirs (..., 3) unit -> (..., 3).

    Bands above the live ``degree`` are skipped; ``max_degree`` bounds the
    coefficients read, as in the JAX function whose degree may be traced.
    """
    degree = int(degree)
    if not 0 <= max_degree <= 4:
        raise ValueError(f"max_degree must be in [0, 4], got {max_degree}")
    result = SH_C0 * sh[..., 0, :]
    offset = 1
    for band in range(1, min(degree, max_degree) + 1):
        n = 2 * band + 1
        basis = _band_basis(dirs, band)  # (..., n)
        coeffs = sh[..., offset: offset + n, :]  # (..., n, 3)
        result = result + (basis[..., :, None] * coeffs).sum(dim=-2)
        offset += n
    return result


def sh_to_rgb(
    sh: torch.Tensor,
    points: torch.Tensor,
    campos: torch.Tensor,
    degree,
    max_degree: int | None = None,
) -> torch.Tensor:
    """SH -> clamped RGB along the view direction.

    Spec: reference ``render_tools.py:118-131`` (computeColorFromSH):
    normalize(points - campos), eval, +0.5, clamp_min 0.
    """
    direction = points - campos[..., None, :]  # (B, 3) campos: (B, N, 3)
    direction = direction / torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    if max_degree is None:
        max_degree = int(degree)
    rgb = eval_sh_banded(sh, direction, degree, max_degree)
    return torch.clamp_min(rgb + 0.5, 0.0)


def rgb_to_sh0(rgb):
    """Reference ``utils/sh.py:100-101``."""
    return (rgb - 0.5) / SH_C0


def sh0_to_rgb(sh0):
    return sh0 * SH_C0 + 0.5
