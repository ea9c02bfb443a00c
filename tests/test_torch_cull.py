"""The cull of K2 and K3 is conservative: ``rasterize.pair_cull_box``, the
plain version of the kernels' ``cull_box``, never lets a warp skip a patch in
which ``rasterize._pair_alpha`` (the kill chain as the kernels round it) keeps
a pixel. A skipped evaluation is then one the plain versions kill, so the
kernels' alphas and T stay bit-identical whatever they skip.
"""

import math
import re
from pathlib import Path

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gaussian_splatting_lightning_tpu_torch.ops import rasterize as rz

PW, PH = rz.PATCH_W, rz.PATCH_H


def _conic(s1, s2, theta):
    """f32 conic (ca, cb, cc) of the 2D covariance R diag(s1^2, s2^2) R^T
    dilated by 0.3 px^2, as ``preprocess`` makes it."""
    r = np.array([[math.cos(theta), -math.sin(theta)], [math.sin(theta), math.cos(theta)]])
    cov = r @ np.diag([s1 * s1, s2 * s2]) @ r.T + 0.3 * np.eye(2)
    inv = np.linalg.inv(cov)
    return np.float32(inv[0, 0]), np.float32(inv[0, 1]), np.float32(inv[1, 1])


def _row(mx, my, conic, op, rect=(0.0, 1e4, 0.0, 1e4)):
    f = torch.zeros(1, rz.NFEAT, dtype=torch.float32)
    f[0, rz.F_PX], f[0, rz.F_PY] = float(mx), float(my)
    f[0, rz.F_CA], f[0, rz.F_CB], f[0, rz.F_CC] = (float(v) for v in conic)
    f[0, rz.F_OP] = float(op)
    f[0, rz.F_X0:rz.F_Y1 + 1] = torch.tensor(rect, dtype=torch.float32)
    return f


def _patches(f, block, reach):
    """(culled, kept) per patch of the kernels' grid within ``reach`` px of
    the centre: whether the warp test skips it, whether ``_pair_alpha``
    keeps any of its pixels."""
    mx, my = float(f[0, rz.F_PX]), float(f[0, rz.F_PY])
    xs = torch.arange(math.floor((mx - reach) / PW), math.floor((mx + reach) / PW) + 1) * PW
    ys = torch.arange(math.floor((my - reach) / PH), math.floor((my + reach) / PH) + 1) * PH
    x0, y0 = (g.reshape(-1).float() for g in torch.meshgrid(xs, ys, indexing="ij"))
    local = torch.arange(PW * PH)
    px = x0[:, None] + (local % PW).float()[None]
    py = y0[:, None] + (local // PW).float()[None]
    n = x0.shape[0]
    rows = f.expand(n, rz.NFEAT)
    on = torch.ones(n, dtype=torch.bool)
    _, _, _, _, keep = rz._pair_alpha(rows, px, py, torch.floor(px * 0.0625),
                                      torch.floor(py * 0.0625), on, block)
    culled = rz.patch_culled(rz.pair_cull_box(f, block), x0, y0)
    return culled, keep.any(dim=1)


splat = st.tuples(
    st.floats(0.05, 40.0), st.floats(0.05, 40.0), st.floats(0.0, math.pi),
    st.floats(0.9 / 255.0, 1.0), st.floats(0.0, 1024.0), st.floats(0.0, 1024.0),
)


@settings(max_examples=200, deadline=None)
@given(splat, st.sampled_from([16, 32]), st.integers(-3, 3), st.integers(-3, 3),
       st.integers(0, 4), st.integers(0, 4))
def test_cull_never_skips_a_kept_pixel(s, block, rx0, ry0, rw, rh):
    s1, s2, theta, op, mx, my = s
    sx, sy = math.floor(mx / 16), math.floor(my / 16)
    rect = (sx + rx0, sx + rx0 + rw, sy + ry0, sy + ry0 + rh)  # may be empty
    f = _row(mx, my, _conic(s1, s2, theta), op, rect)
    culled, kept = _patches(f, block, 4.0 * max(s1, s2) + 2 * PW)
    assert not bool((culled & kept).any())


@settings(max_examples=200, deadline=None)
@given(splat, st.integers(-4, 4), st.integers(0, 1), st.integers(-3, 3))
def test_cull_keeps_patches_with_a_pixel_at_the_threshold(s, ulps, vertical, offset):
    """op chosen so that a pixel on a patch edge has alpha within a few ulp
    of 1/255: the patch that holds it is kept whenever that pixel is."""
    s1, s2, theta, _, mx, my = s
    conic = _conic(s1, s2, theta)
    # a pixel on a patch edge near the ellipse's rim along one axis
    r = 2.0 * max(s1, s2)
    if vertical:
        ex, ey = math.floor(mx) + offset, (math.floor((my + r) / PH) + 1) * PH - 1
    else:
        ex, ey = (math.floor((mx + r) / PW) + 1) * PW - 1, math.floor(my) + offset
    probe = _row(mx, my, conic, 1.0)
    e = torch.tensor([[float(ex)]])
    g = torch.tensor([[float(ey)]])
    _, _, raw, _, _ = rz._pair_alpha(probe, e, g, e, g, torch.ones(1, dtype=torch.bool), 16)
    if not float(raw) > 0:
        return
    op = np.float32(1.0 / 255.0) / np.float32(float(raw))
    op = float(np.float32(op * (1.0 + ulps * 2.0 ** -23)))
    if not 0 < op <= 1.0:
        return
    f = _row(mx, my, conic, op)
    culled, kept = _patches(f, 16, 4.0 * max(s1, s2) + 2 * PW)
    assert not bool((culled & kept).any())


def test_cull_skips_far_patches_and_keeps_the_centre():
    f = _row(200.3, 100.7, _conic(3.0, 1.5, 0.4), 0.8)
    culled, kept = _patches(f, 16, 96.0)
    assert bool(kept.any()) and not bool((culled & kept).any())
    # the box is tight: at most a ring of one patch beyond the kept ones
    assert float(culled.float().mean()) > 0.8
    box = rz.pair_cull_box(f, 16)[0]
    assert float(box[1] - box[0]) < 2 * 3.0 * 3.4 + 1.0


def test_cull_edge_cases():
    # op below 1/255 by more than the margin: nothing is kept anywhere and
    # every patch is skipped
    f = _row(50.0, 50.0, _conic(4.0, 4.0, 0.0), 0.99 / 255.0)
    culled, kept = _patches(f, 16, 48.0)
    assert bool(culled.all()) and not bool(kept.any())
    # a conic whose rounding is not bounded gets no box: never skipped
    thin = _row(50.0, 50.0, (1.0, 0.99999, 1.0), 0.9)
    culled, _ = _patches(thin, 16, 48.0)
    assert not bool(culled.any())
    # NaN features give no box either, and at 32 px the rect still applies
    nan = _row(50.0, 50.0, (float("nan"), 0.0, 1.0), 0.9, rect=(2.0, 4.0, 0.0, 8.0))
    culled, _ = _patches(nan, 32, 96.0)
    box = rz.pair_cull_box(nan, 32)[0]
    assert torch.equal(box, torch.tensor([32.0, 63.0, 0.0, 127.0]))
    assert bool(culled.any()) and not bool(culled.all())


def _cuda_source(name):
    return (Path(rz.__file__).resolve().parents[1] / "csrc" / name).read_text()


def _cull_box_text(src):
    start = src.index("__device__ __forceinline__ float4 cull_box(")
    return src[start:src.index("\n}\n", start)]


def test_kernels_share_the_plain_versions_margin():
    """K2 and K3 carry one cull_box, with the margin of pair_cull_box."""
    fwd, bwd = _cuda_source("composite_fwd.cu"), _cuda_source("composite_bwd.cu")
    assert _cull_box_text(fwd) == _cull_box_text(bwd)
    want = {"kTauRel": rz.CULL_TAU_REL, "kTauAbs": rz.CULL_TAU_ABS,
            "kMaxAspect": rz.CULL_MAX_ASPECT, "kPadRel": rz.CULL_PAD_REL,
            "kPadAbs": rz.CULL_PAD_ABS, "kPadPos": rz.CULL_PAD_POS}
    for src in (fwd, bwd):
        got = dict(re.findall(r"\b(k\w+) = ([0-9.e+-]+)f\b", src))
        for name, value in want.items():
            assert np.float32(got[name]) == np.float32(value), name
