"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 (``csrc/expand_pairs.cu``) must give the plain version's ``(key, gauss)``
and sorted bins exactly, also on synthetic layouts at the edges of its
1024-slot runs; K2 (``csrc/composite_fwd.cu``) must agree within
1e-4 max-abs. K3 (``csrc/composite_bwd.cu``) within 1e-4 of each gradient
column's largest magnitude (its per-pixel terms equal the plain version's;
the sums over up to 1024 pixels run in another order and the position rows
cancel); K4 (``csrc/segment_sum.cu``) within 1e-5 of each column's largest
magnitude (sums of a few rows in another order), and the same bits on a
second run; K5 (``csrc/blur.cu``) bit-identical in both directions (both
round every product and sum in the same order). The preprocess pair
(``csrc/preprocess.cu``) against its plain version, the composed
activations, ``preprocess`` and ``feature_table`` under autograd: integer
and boolean fields equal, float columns within 1e-6 relatively (both round
every operation in the same order), gradients within 1e-5 of each splat's
scale (the backward sums in another order); a captured train step runs
the pair once a replay and never the composition. Adam's kernel
(``csrc/adam.cu``) against ``_adam_plain`` on the card: the same bits of
every parameter and moment, in place (``adam_update_``) and through the
copying ``adam_update``, dense and sparse, at
1,001 and at 1M rows (ragged tails) at SH degree 3 and 0, with one gradient
a group and with the mesh's column slices of one (rows, 59) table, and over
two replays of a captured graph with different scalars. The photometric
loss's kernels (``csrc/photometric.cu``) against the composition of
``training/loss.py`` on the card: the four logs within 1e-6 relatively, the
gradient within 1e-5 of its largest |element|, the same bits on a second
call, three launches forward and one backward; at 1080p, at an odd size, on
a non-contiguous 540-row slice and on stacks of two views (per view and
joint); smooth images against the float64 composition. These tests need an NVIDIA
GPU and ``nvcc``; elsewhere they skip with a reason. On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q

K2 and K3 skip (pair, warp) evaluations by a cull box; the near-threshold
and uneven-tile cases below hold that cull to the plain versions, and every
K2 and K3 case also checks that a second run gives the same bits.

This file imports no JAX: the machine with the card has none.
"""

import dataclasses
import math

import pytest
import torch

import numpy as np

from gaussian_splatting_lightning_tpu_torch import interop
from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES, GaussianParams
from gaussian_splatting_lightning_tpu_torch.ops import _build, binning, rasterize, ssim
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig, preprocess
from gaussian_splatting_lightning_tpu_torch.ops.preprocess import (
    preprocess_scene,
    preprocess_scene_plain,
)
from gaussian_splatting_lightning_tpu_torch.ops.adam import adam_groups
from gaussian_splatting_lightning_tpu_torch.training import optimizer, trainer
# pytest puts tests/ on sys.path; a package named "tests" elsewhere on the
# path may shadow this directory's as a package
from torch_adam_cases import adam_case, bits_differ, clone_state
from torch_expand_layouts import EXPAND_LAYOUTS, GX, GY, expand_case
from torch_preprocess_cases import cameras as edge_cameras
from torch_preprocess_cases import cotangent as edge_cotangent
from torch_preprocess_cases import edge_scene, inside_camera, inside_scene

pytestmark = pytest.mark.cuda

W, H = 128, 96
MAX_PAIRS = 1 << 16
K2_TOL = 1e-4


def _scene_prep(scene):
    cam = interop.camera(W, H)
    return preprocess(
        scene.params.xyz, scene.get_opacity(), scene.get_scales(),
        scene.get_rotation(), scene.get_features(), cam, W, H,
        scene.active_sh_degree, scene.max_sh_degree, alive=scene.alive,
    )


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return interop.synthetic_scene(4000, 4096, aniso=True, scale=0.03, seed=11)


@pytest.fixture(scope="module")
def prep(scene):
    return _scene_prep(scene)


@pytest.fixture(scope="module")
def dense_prep():
    # large opaque splats: tiles saturate and the early stop cuts work
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return _scene_prep(interop.synthetic_scene(4000, 4096, scale=0.3, opacity=3.0, seed=12))


def col_err(kernel, plain) -> float:
    """Largest |kernel - plain| of any column over that column's largest
    |plain| (0 for an all-zero column that the kernel also leaves zero)."""
    scale = plain.abs().amax(dim=0).clamp_min(1e-30)
    return float(((kernel - plain).abs().amax(dim=0) / scale).max())


def _bwd_inputs(prep, block, early_stop, max_pairs=MAX_PAIRS, seed=0):
    gx, gy = binning.grid_shape(W, H, block, block)
    bins = binning.build_sorted_bins(prep, gx, gy, max_pairs, block=block)
    gfeat = rasterize.feature_table(prep, W, H, block)
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    out = rasterize.composite_fwd(gfeat, bins.gauss_s, bins.tile_start, bins.tile_count,
                                  bg, gx, block, early_stop=early_stop)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grad_out = torch.randn(out.shape, device="cuda", generator=gen)
    args = (gfeat, bins.gauss_s, bins.slot_s, bins.tile_start, bins.tile_count, out,
            grad_out, gx, block, max_pairs, 0, early_stop)
    return args, bins


CASES = {
    # name: (block, max_pairs, tile_y_offset, grid_y_local)
    "block16": (16, MAX_PAIRS, 0, None),
    "block32": (32, MAX_PAIRS, 0, None),
    "overflow": (32, 2048, 0, None),
    "band": (16, MAX_PAIRS, 1, 3),
}


@pytest.mark.parametrize("case", sorted(CASES) + list(EXPAND_LAYOUTS))
def test_expand_pairs_kernel_is_exact(prep, case):
    if case in CASES:
        blk, max_pairs, tyoff, gyl = CASES[case]
        gx, gy = binning.grid_shape(W, H, blk, blk)
        n_tiles = gx * (gyl or gy)
        inp, _ = binning.expand_inputs(prep, gx, gy, tyoff, gyl or gy, blk)
    else:
        *arrays, max_pairs = expand_case(case)
        inp = binning.ExpandInputs(*(torch.from_numpy(a).cuda() for a in arrays))
        blk, gx, n_tiles, tyoff = 32, GX, GX * GY, 0
    before = _build.launches["expand_pairs"]
    key, gauss = binning.expand_pairs(inp, max_pairs, gx, n_tiles, tyoff, blk)
    assert _build.launches["expand_pairs"] == before + 1
    key_p, gauss_p = binning.expand_pairs_plain(inp, max_pairs, gx, n_tiles, tyoff, blk)
    torch.cuda.synchronize()
    assert key.shape == (max_pairs,)
    assert torch.equal(key, key_p) and torch.equal(gauss, gauss_p)
    if case not in CASES:
        return

    bins = binning.build_sorted_bins(prep, gx, gy, max_pairs, tyoff, gyl, block=blk)
    plain = binning.build_sorted_bins(prep, gx, gy, max_pairs, tyoff, gyl, block=blk,
                                      plain=True)
    for name, a, b in zip(bins._fields, bins, plain):
        assert torch.equal(a, b), name
    assert (int(bins.num_dropped) > 0) == (case == "overflow")


@pytest.mark.parametrize("block", [16, 32])
def test_composite_fwd_kernel_matches_plain(prep, block):
    gx, gy = binning.grid_shape(W, H, block, block)
    bins = binning.build_sorted_bins(prep, gx, gy, MAX_PAIRS, block=block)
    gfeat = rasterize.feature_table(prep, W, H, block)
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    args = (gfeat, bins.gauss_s, bins.tile_start, bins.tile_count, bg, gx, block)
    before = _build.launches["composite_fwd"]
    out = rasterize.composite_fwd(*args)
    assert _build.launches["composite_fwd"] == before + 1
    plain = rasterize.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == (gx * gy, rasterize.NOUT, block * block)
    assert bool(torch.isfinite(out).all())
    assert float((out - plain).abs().max()) <= K2_TOL
    # the render is not all background
    assert float((out[:, :3] - bg[None, :, None]).abs().max()) > 0.1


def test_wrappers_refuse_what_the_kernels_do_not_take(prep):
    gx, gy = binning.grid_shape(W, H, 32, 32)
    bins = binning.build_sorted_bins(prep, gx, gy, MAX_PAIRS, block=32)
    gfeat = rasterize.feature_table(prep, W, H, 32)
    bg = torch.zeros(3, device="cuda")
    with pytest.raises(ValueError):  # wrong dtype
        rasterize.composite_fwd(gfeat.double(), bins.gauss_s, bins.tile_start,
                                bins.tile_count, bg, gx, 32)
    with pytest.raises(ValueError):  # not contiguous
        rasterize.composite_fwd(gfeat, bins.gauss_s[::2], bins.tile_start,
                                bins.tile_count, bg, gx, 32)
    with pytest.raises(ValueError):  # a tile edge the kernel has no block for
        rasterize.composite_fwd(gfeat, bins.gauss_s, bins.tile_start,
                                bins.tile_count, bg, gx, 8)
    out = rasterize.composite_fwd(gfeat, bins.gauss_s, bins.tile_start,
                                  bins.tile_count, bg, gx, 32)
    with pytest.raises(ValueError):  # a cotangent of the wrong shape
        rasterize.composite_bwd(gfeat, bins.gauss_s, bins.slot_s, bins.tile_start,
                                bins.tile_count, out, out[:, :3].contiguous(), gx, 32,
                                MAX_PAIRS)
    dpair = torch.zeros(MAX_PAIRS, rasterize.NGRAD, device="cuda")
    with pytest.raises(ValueError):  # int64 offsets
        rasterize.segment_sum(dpair, bins.offsets.long(), bins.ntiles, bins.order)
    with pytest.raises(ValueError):  # float64 blur input
        ssim.blur_valid(torch.zeros(2, 20, 20, device="cuda", dtype=torch.float64))
    inp, _ = binning.expand_inputs(prep, gx, gy, 0, gy, 32)
    with pytest.raises(ValueError):  # a row of three columns
        binning.expand_pairs(inp._replace(rows=inp.rows[:, :3].contiguous()),
                             MAX_PAIRS, gx, gx * gy, 0, 32)
    with pytest.raises(ValueError):  # int64 offsets
        binning.expand_pairs(inp._replace(offsets=inp.offsets.long()),
                             MAX_PAIRS, gx, gx * gy, 0, 32)


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("early_stop", [False, True], ids=["no_stop", "early_stop"])
def test_composite_bwd_kernel_matches_plain(prep, dense_prep, block, early_stop):
    args, _ = _bwd_inputs(dense_prep if early_stop else prep, block, early_stop)
    before = _build.launches["composite_bwd"]
    dk = rasterize.composite_bwd(*args)
    assert _build.launches["composite_bwd"] == before + 1
    dp = rasterize.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    assert dk.shape == (MAX_PAIRS, rasterize.NGRAD)
    assert bool(torch.isfinite(dk).all())
    assert float(dp.abs().max()) > 0
    assert col_err(dk, dp) <= 1e-4
    # the same pairs got a row: rows never composited stay exactly zero
    assert torch.equal(dk.abs().sum(1) == 0, dp.abs().sum(1) == 0)


@pytest.mark.parametrize("max_pairs", [MAX_PAIRS, 2048], ids=["budget", "dropped"])
def test_segment_sum_kernel_matches_plain(prep, max_pairs):
    gx, gy = binning.grid_shape(W, H, 32, 32)
    bins = binning.build_sorted_bins(prep, gx, gy, max_pairs, block=32)
    assert (int(bins.num_dropped) > 0) == (max_pairs == 2048)
    # every row non-zero, so a range that reaches one row too far shows
    gen = torch.Generator(device="cuda").manual_seed(1)
    dpair = torch.randn(max_pairs, rasterize.NGRAD, device="cuda", generator=gen)
    before = _build.launches["segment_sum"]
    sk = rasterize.segment_sum(dpair, bins.offsets, bins.ntiles, bins.order)
    assert _build.launches["segment_sum"] == before + 1
    again = rasterize.segment_sum(dpair, bins.offsets, bins.ntiles, bins.order)
    sp = rasterize.segment_sum_plain(dpair, bins.offsets, bins.ntiles, bins.order)
    torch.cuda.synchronize()
    assert torch.equal(sk, again)
    assert sk.shape == (prep.depth.shape[0], rasterize.NFEAT)
    assert col_err(sk[:, :rasterize.NGRAD], sp[:, :rasterize.NGRAD]) <= 1e-5
    assert not sk[:, rasterize.NGRAD:].any()
    assert torch.equal(sk.abs().sum(1) == 0, sp.abs().sum(1) == 0)


def segment_layout(n=3001, seed=0, long_rows=5000):
    """A synthetic K4 input in numpy, (dpair, offsets, ntiles, order), with
    ``offsets`` the exclusive cumsum of ``ntiles[order]``: one rank of
    ``long_rows`` rows, ranks of 129-600 rows (summed by a whole block, some
    over several chunks), one at the first and one at the last rank of a
    256-rank block, runs of empty ranks, the budget M (odd, so 10 M floats
    end mid-quad) cutting a rank in its middle, ranks past it; n is not a
    multiple of 256."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 5, n)  # in depth order
    rows[rng.random(n) < 0.3] = 0
    rows[300:340] = 0
    rows[700:703] = 0
    rows[rng.choice(n, 8, replace=False)] = rng.integers(129, 600, 8)
    rows[512], rows[767], rows[1000] = 200, 130, long_rows
    cut = n - 50 + int(np.argmax(rows[n - 50:] >= 3))
    rows[cut] = max(rows[cut], 3)
    offsets = np.concatenate([[0], np.cumsum(rows)[:-1]])
    max_pairs = int(offsets[cut]) + int(rows[cut]) // 2
    max_pairs += 1 - max_pairs % 2
    order = rng.permutation(n)
    ntiles = np.empty(n, np.int64)
    ntiles[order] = rows
    dpair = rng.normal(size=(max_pairs, rasterize.NGRAD)).astype(np.float32)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return dpair, i32(offsets), i32(ntiles), i32(order)


def test_segment_sum_kernel_on_a_synthetic_layout():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    args = [torch.from_numpy(a).cuda() for a in segment_layout()]
    sk = rasterize.segment_sum(*args)
    again = rasterize.segment_sum(*args)
    sp = rasterize.segment_sum_plain(*args)
    torch.cuda.synchronize()
    assert col_err(sk[:, :rasterize.NGRAD], sp[:, :rasterize.NGRAD]) <= 1e-5
    assert not sk[:, rasterize.NGRAD:].any()
    assert torch.equal(sk.abs().sum(1) == 0, sp.abs().sum(1) == 0)
    assert int((sp.abs().sum(1) == 0).sum()) > 300  # empty and past-budget ranks
    assert torch.equal(sk, again)


# (C, H, W) outputs: widths 1, 2 and 3 mod 4, several strips, one output
# row, a ragged last strip of rows; the input adds the window's halo
BLUR_OUTS = [(15, 30, 47), (3, 1, 522), (2, 126, 1025), (1, 290, 1108), (4, 1, 1)]
# every window K5 has an instance for, and sigma 2.5 at window 7
BLUR_WINDOWS = [(w, 1.5) for w in ssim.KERNEL_WINDOWS] + [(7, 2.5)]


@pytest.mark.parametrize("window,sigma", BLUR_WINDOWS, ids=lambda v: str(v))
@pytest.mark.parametrize("out", BLUR_OUTS, ids=lambda s: "x".join(map(str, s)))
def test_blur_kernel_is_bit_identical_to_plain(out, window, sigma):
    """Forward on x and the VJP's launch on the unpadded cotangent (a zero
    margin of window - 1) against the plain version, to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    taps, halo = ssim.window_taps(window, sigma), window - 1
    gen = torch.Generator(device="cuda").manual_seed(7)
    c, h, w = out
    x = torch.rand(c, h + halo, w + halo, device="cuda", generator=gen) * 2 - 1
    ct = torch.randn(c, h, w, device="cuda", generator=gen)
    for inp, margin in ((x, 0), (ct, halo)):
        before = _build.launches["blur"]
        yk = ssim.blur_valid(inp, margin, taps)
        assert _build.launches["blur"] == before + 1
        yp = ssim.blur_valid_plain(inp, margin, taps)
        torch.cuda.synchronize()
        assert yk.shape == yp.shape
        assert torch.equal(yk, yp), float((yk - yp).abs().max())


@pytest.mark.parametrize("window,sigma", BLUR_WINDOWS, ids=lambda v: str(v))
def test_blur_kernel_matches_plain_forward_and_vjp(window, sigma):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    taps = ssim.window_taps(window, sigma)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.rand(15, 107, 141, device="cuda", generator=gen) * 2 - 1).requires_grad_()
    ct = torch.randn(15, 108 - window, 142 - window, device="cuda", generator=gen)
    before = _build.launches["blur"]
    y = ssim.BlurValid.apply(x, False, taps)
    (dx,) = torch.autograd.grad(y, x, ct)
    assert _build.launches["blur"] == before + 2  # forward and VJP
    xp = x.detach().requires_grad_()
    yp = ssim.BlurValid.apply(xp, True, taps)
    (dxp,) = torch.autograd.grad(yp, xp, ct)
    torch.cuda.synchronize()
    assert y.shape == ct.shape and dx.shape == x.shape
    assert torch.equal(y.detach(), yp.detach())
    assert torch.equal(dx, dxp)


def test_ssim_window_on_the_card_equals_plain():
    """``ssim`` at window 7 through K5 against the plain version; a window
    without a K5 instance raises rather than falling back."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.rand(3, 70, 90, device="cuda", generator=gen)
    b = torch.rand(3, 70, 90, device="cuda", generator=gen)
    got = ssim.ssim(a, b, window_size=7)
    want = ssim.ssim(a, b, True, window_size=7)
    assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="no K5 instance"):
        ssim.ssim(a, b, window_size=17)
    with pytest.raises(ValueError, match="odd"):
        ssim.ssim(a, b, window_size=10)


# The photometric loss's kernels (csrc/photometric.cu) against the
# composition on the card (``plain=True``: the same functions with the
# blur's plain version). Values within 1e-6 relatively: the sums run in
# another order, the rest is the same arithmetic. The gradient within 1e-5
# of the composition's largest |element|: the kernel forms the SSIM map's
# derivatives as quotients that round apart from autograd's chain (on random
# images both lie ~2e-7 of it from the float64 composition, see
# tests/test_torch_loss.py). A fifth of the pixels equal between pred and
# target (sign(0)). Cases: (shape, rows of a slice or None, per view).
PHOT_CASES = {"1080p": ((3, 1080, 1920), None, False),
              "odd_301x517": ((3, 301, 517), None, False),
              "slice_540_rows": ((3, 1080, 1920), 540, False),
              "stack2_per_view": ((2, 3, 270, 481), None, True),
              "stack2_joint": ((2, 3, 270, 481), None, False)}
PHOT_LOGS = ("loss", "recon", "ssim", "psnr")


def _phot_images(shape, rows, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pred = torch.rand(shape, device="cuda", generator=gen)
    target = torch.rand(shape, device="cuda", generator=gen)
    pred = torch.where(torch.rand(shape, device="cuda", generator=gen) < 0.2, target, pred)
    if rows is not None:  # a non-contiguous slice, as the half-batch fault passes
        pred, target = pred[..., :rows, :], target[..., :rows, :]
    return pred, target


def _phot_run(pred, target, per_view, plain):
    """The four logs and pred's gradient of the loss (summed over views)."""
    from gaussian_splatting_lightning_tpu_torch.training.loss import (
        photometric_loss,
        photometric_losses,
    )

    x = pred.detach().requires_grad_()
    _, logs = (photometric_losses if per_view else photometric_loss)(x, target, 0.2, plain)
    (grad,) = torch.autograd.grad(logs["loss"].sum(), x)
    return [logs[k].detach() for k in PHOT_LOGS], grad


@pytest.mark.parametrize("case", list(PHOT_CASES))
def test_photometric_kernels_match_the_composition(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    shape, rows, per_view = PHOT_CASES[case]
    pred, target = _phot_images(shape, rows, seed=len(case))
    assert rows is None or not pred.is_contiguous()
    _build.reset_launch_counts()
    got, grad = _phot_run(pred, target, per_view, False)
    torch.cuda.synchronize()
    # three launches forward, one backward, and no K5
    assert dict(_build.launches) == dict.fromkeys(_build.SOURCES, 0) | {"photometric": 4}
    again, grad_again = _phot_run(pred, target, per_view, False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(grad, grad_again)
    _build.reset_launch_counts()
    want, want_grad = _phot_run(pred, target, per_view, True)
    torch.cuda.synchronize()
    assert not any(_build.launches.values())
    for name, a, b in zip(PHOT_LOGS, got, want):
        assert a.shape == b.shape == ((shape[0],) if per_view else ()), name
        rel = float(((a - b).abs() / b.abs()).max())
        assert rel <= 1e-6, (name, rel)
    assert grad.shape == want_grad.shape == pred.shape
    scale = float(want_grad.abs().max())
    assert float((grad - want_grad).abs().max()) <= 1e-5 * scale


def test_photometric_kernels_on_smooth_images_as_close_as_the_composition():
    """Smooth 1080p images, where each variance b(y^2) - b(y)^2 cancels most
    of its digits and the float32 composition itself lies ~2.5e-5 of the
    largest gradient from the float64 one: the kernels' values and gradient
    no further from the float64 composition than twice the float32
    composition, or 1e-6 of the largest |value|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    yy = torch.arange(1080, device="cuda", dtype=torch.float64)[:, None]
    xx = torch.arange(1920, device="cuda", dtype=torch.float64)[None, :]
    base = 0.5 + 0.3 * torch.sin(yy / 200 + xx / 300) * torch.cos(xx / 500)
    pred64 = torch.stack([base, base * 0.9, base * 0.8 + 0.1])
    target64 = pred64 + 0.02 * torch.cos(yy / 100 - xx / 150)
    pred, target = pred64.float(), target64.float()
    got, grad = _phot_run(pred, target, False, False)
    want, want_grad = _phot_run(pred, target, False, True)
    truth, truth_grad = _phot_run(pred64, target64, False, True)
    for name, a, b, t in zip(PHOT_LOGS, got, want, truth):
        bound = max(2 * abs(float(b) - float(t)), 1e-6 * abs(float(t)))
        assert abs(float(a) - float(t)) <= bound, (name, float(a), float(b), float(t))
    own = float((want_grad.double() - truth_grad).abs().max())
    err = float((grad.double() - truth_grad).abs().max())
    assert err <= max(2 * own, 1e-6 * float(truth_grad.abs().max())), (err, own)


@pytest.mark.parametrize("block", [16, 32])
def test_pair_composite_kernels_match_plain(prep, block):
    gx, gy = binning.grid_shape(W, H, block, block)
    bins = binning.build_sorted_bins(prep, gx, gy, MAX_PAIRS, block=block)
    gfeat = rasterize.feature_table(prep, W, H, block).detach()
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    ct = torch.randn(gx * gy, rasterize.NOUT, block * block, device="cuda")
    grads = []
    for plain in (False, True):
        g = gfeat.clone().requires_grad_()
        out = rasterize.PairComposite.apply(g, bins, bg, gx, block, MAX_PAIRS, 0, True, plain)
        (grad,) = torch.autograd.grad(out, g, ct)
        grads.append(grad[:, :rasterize.NGRAD])
    assert col_err(*grads) <= 1e-4


def test_train_step_gradients_cuda_match_plain(scene):
    """The whole step's gradients on route "cuda" against route "plain":
    within 1e-4 of each parameter group's largest gradient."""
    tiling = TilingConfig(max_pairs=MAX_PAIRS, block=32)
    cam = interop.camera(W, H)
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(3, H, W)).astype(np.float32)).cuda()
    bg = torch.zeros(3, device="cuda")
    out = {}
    for route in ("cuda", "plain"):
        cfg = trainer.TrainConfig(rasterizer=route, tiling=tiling)
        out[route] = trainer.step_gradients(cfg, scene, cam, W, H, target, bg)
    for k in PARAM_NAMES:
        a, b = getattr(out["cuda"][0], k), getattr(out["plain"][0], k)
        scale = float(b.abs().max())
        if scale == 0:
            assert not a.any(), k
            continue
        assert float((a - b).abs().max()) <= 1e-4 * scale, k
    a, b = out["cuda"][1], out["plain"][1]
    assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _check_pair_kernels(gfeat, gauss_s, slot_s, tile_start, tile_count, gx, block,
                        max_pairs, early_stop, seed=0):
    """K2 and K3 against their plain versions on the same inputs: K2 within
    1e-4, K3 within 1e-4 of each column's largest magnitude with the same
    zero rows, and each kernel giving the same bits on a second run."""
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    fwd = (gfeat, gauss_s, tile_start, tile_count, bg, gx, block, 0, early_stop)
    out = rasterize.composite_fwd(*fwd)
    again = rasterize.composite_fwd(*fwd)
    plain = rasterize.composite_fwd_plain(*fwd)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out - plain).abs().max()) <= K2_TOL
    assert torch.equal(out, again)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grad_out = torch.randn(out.shape, device="cuda", generator=gen)
    bwd = (gfeat, gauss_s, slot_s, tile_start, tile_count, out, grad_out, gx, block,
           max_pairs, 0, early_stop)
    dk = rasterize.composite_bwd(*bwd)
    dk2 = rasterize.composite_bwd(*bwd)
    dp = rasterize.composite_bwd_plain(*bwd)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dk).all()) and float(dp.abs().max()) > 0
    assert col_err(dk, dp) <= 1e-4
    assert torch.equal(dk.abs().sum(1) == 0, dp.abs().sum(1) == 0)
    assert torch.equal(dk, dk2)


@pytest.mark.parametrize("block", [16, 32])
def test_pair_kernels_are_deterministic(prep, block):
    args, _ = _bwd_inputs(prep, block, True)
    gfeat, gauss_s, slot_s, tile_start, tile_count, out, grad_out = args[:7]
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    fwd = (gfeat, gauss_s, tile_start, tile_count, bg, args[7], block)
    outs = [rasterize.composite_fwd(*fwd) for _ in range(3)]
    grads = [rasterize.composite_bwd(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert all(torch.equal(grads[0], g) for g in grads[1:])


@pytest.mark.parametrize("block", [16, 32])
def test_pair_kernels_near_the_threshold(prep, block):
    """Opacities set so that, for most splats, a pixel on the patch edge
    nearest to its centre (a column edge for half of them, a row edge for
    the others) has alpha within 4 ulp of 1/255: a cull that is not
    conservative drops it where the plain version keeps it."""
    gx, gy = binning.grid_shape(W, H, block, block)
    bins = binning.build_sorted_bins(prep, gx, gy, MAX_PAIRS, block=block)
    gfeat = rasterize.feature_table(prep, W, H, block).detach().clone()
    n = gfeat.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    mx, my = gfeat[:, rasterize.F_PX], gfeat[:, rasterize.F_PY]
    side = torch.randint(0, 2, (n,), device="cuda", generator=gen).float()
    column = torch.arange(n, device="cuda") % 2 == 0
    # x = 16 k - 1 or 16 k (y = 8 k - 1 or 8 k): the last or first pixel of a patch
    ex = torch.where(column, torch.round(mx / rasterize.PATCH_W) * rasterize.PATCH_W - side,
                     torch.floor(mx))
    ey = torch.where(column, torch.floor(my),
                     torch.round(my / rasterize.PATCH_H) * rasterize.PATCH_H - side)
    probe = gfeat.clone()
    probe[:, rasterize.F_OP] = 1.0
    on = torch.ones(n, dtype=torch.bool, device="cuda")
    _, _, raw, _, _ = rasterize._pair_alpha(probe, ex[:, None], ey[:, None],
                                            ex[:, None], ey[:, None], on, 16)
    ulps = torch.randint(-4, 5, (n,), device="cuda", generator=gen).float()
    op = (rasterize.ALPHA_THRESHOLD / raw[:, 0]) * (1.0 + ulps * 2.0 ** -23)
    near = (raw[:, 0] > 0) & (op <= 1.0) & torch.isfinite(op)
    assert int(near.sum()) > n // 3
    gfeat[:, rasterize.F_OP] = torch.where(near, op, gfeat[:, rasterize.F_OP])
    for early_stop in (False, True):
        _check_pair_kernels(gfeat, bins.gauss_s, bins.slot_s, bins.tile_start,
                            bins.tile_count, gx, block, MAX_PAIRS, early_stop)


def _uneven_bins(block, seed=3):
    """One tile with 3001 pairs of splats centred on it, one with 256 and one
    with 37 pairs of splats anywhere, every other tile empty; rects of one to
    three subtiles around each centre."""
    rng = np.random.default_rng(seed)
    gx, gy = binning.grid_shape(W, H, block, block)
    n_tiles, n, big = gx * gy, 4000, gx + 1
    counts = np.zeros(n_tiles, np.int32)
    counts[big], counts[n_tiles - 1], counts[0] = 3001, 256, 37
    mx, my = rng.uniform(0, W, n), rng.uniform(0, H, n)
    ox, oy = (big % gx) * block, (big // gx) * block
    mx[:3001] = ox + rng.uniform(-8, block + 8, 3001)
    my[:3001] = oy + rng.uniform(-8, block + 8, 3001)
    s1, s2 = rng.uniform(0.5, 6.0, n), rng.uniform(0.5, 6.0, n)
    th = rng.uniform(0, math.pi, n)
    c, s = np.cos(th), np.sin(th)
    cxx = c * c * s1 * s1 + s * s * s2 * s2 + 0.3
    cyy = s * s * s1 * s1 + c * c * s2 * s2 + 0.3
    cxy = c * s * (s1 * s1 - s2 * s2)
    det = cxx * cyy - cxy * cxy
    f = np.zeros((n, rasterize.NFEAT), np.float32)
    f[:, rasterize.F_PX], f[:, rasterize.F_PY] = mx, my
    f[:, rasterize.F_CA], f[:, rasterize.F_CB], f[:, rasterize.F_CC] = cyy / det, -cxy / det, cxx / det
    f[:, rasterize.F_OP] = rng.uniform(0.02, 0.6, n)
    f[:, rasterize.F_R:rasterize.F_IZ] = rng.uniform(0, 1, (n, 3))
    f[:, rasterize.F_IZ] = rng.uniform(0.1, 1.0, n)
    sx, sy = np.floor(mx / 16), np.floor(my / 16)
    f[:, rasterize.F_X0] = sx - rng.integers(0, 2, n)
    f[:, rasterize.F_X1] = sx + 1 + rng.integers(0, 2, n)
    f[:, rasterize.F_Y0] = sy - rng.integers(0, 2, n)
    f[:, rasterize.F_Y1] = sy + 1 + rng.integers(0, 2, n)
    gauss = np.concatenate([rng.integers(3001, n, 37), rng.permutation(3001),
                            rng.integers(0, n, 256)]).astype(np.int32)
    total = int(counts.sum())
    max_pairs = -(-total // 128) * 128
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    slot = rng.permutation(max_pairs)[:total].astype(np.int32)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return (cuda(f), cuda(gauss), cuda(slot), cuda(start), cuda(counts), gx,
            max_pairs)


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("early_stop", [False, True], ids=["no_stop", "early_stop"])
def test_pair_kernels_on_uneven_tiles(scene, block, early_stop):
    gfeat, gauss_s, slot_s, tile_start, tile_count, gx, max_pairs = _uneven_bins(block)
    _check_pair_kernels(gfeat, gauss_s, slot_s, tile_start, tile_count, gx, block,
                        max_pairs, early_stop, seed=4)


def test_oracle_and_tiled_routes_match_cuda_route(scene):
    """The readable oracle and the tiled route (plain PyTorch on the card)
    against the kernel route: image and inverse depth within K2's 1e-4,
    launching no kernel; the tiled route's step gradients within 1e-4 of
    each parameter group's largest gradient."""
    from gaussian_splatting_lightning_tpu_torch.ops.rasterize_reference import (
        rasterize_reference,
    )
    from gaussian_splatting_lightning_tpu_torch.ops.rasterize_tiled import rasterize_tiled

    cam = interop.camera(W, H)
    bg = torch.zeros(3, device="cuda")
    x = (scene.params.xyz, scene.get_opacity(), scene.get_scales(), scene.get_rotation(),
         scene.get_features(), cam, W, H, bg, scene.active_sh_degree)
    kw = dict(max_sh_degree=scene.max_sh_degree, alive=scene.alive)
    tiling = TilingConfig(max_pairs=MAX_PAIRS, tile_capacity=1024, chunk=64)
    want, _ = trainer.resolve_rasterizer("cuda")(*x, config=tiling, **kw)
    _build.reset_launch_counts()
    oracle = rasterize_reference(*x, **kw)
    tiled, stats = rasterize_tiled(*x, config=tiling, **kw)
    torch.cuda.synchronize()
    assert not any(_build.launches.values()), _build.launches
    assert int(stats["num_tile_overflow"]) == 0 and int(stats["num_dropped_pairs"]) == 0
    for got in (oracle, tiled):
        assert float((got.image - want.image).abs().max()) <= K2_TOL
        assert float((got.depth - want.depth).abs().max()) <= K2_TOL

    target = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(3, H, W)).astype(np.float32)).cuda()
    out = {route: trainer.step_gradients(trainer.TrainConfig(rasterizer=route, tiling=tiling),
                                         scene, cam, W, H, target, bg)
           for route in ("cuda", "xla")}
    for k in PARAM_NAMES:
        a, b = getattr(out["xla"][0], k), getattr(out["cuda"][0], k)
        scale = float(b.abs().max())
        if scale == 0:
            assert not a.any(), k
            continue
        assert float((a - b).abs().max()) <= 1e-4 * scale, k
    a, b = out["xla"][1], out["cuda"][1]
    assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# ---- the view axis (the view-batched train step) --------------------------

def _view_stack(scene):
    """Three views whose pair streams differ: the bench camera, one that
    sees no splat (it looks away), and a closer one zoomed in, with
    thousands of pairs fewer than the bench view; preprocessed as one stack
    and one at a time."""
    from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera, stack_cameras

    cams = [make_camera(np.concatenate([np.eye(3), [[0.0], [0.0], [z]]], 1), W * f, W * f,
                        W, H) for z, f in ((4.0, 0.7), (-4.0, 0.7), (3.0, 1.4))]
    args = (scene.params.xyz, scene.get_opacity(), scene.get_scales(),
            scene.get_rotation(), scene.get_features())
    kw = dict(alive=scene.alive)
    single = [preprocess(*args, c, W, H, scene.active_sh_degree, scene.max_sh_degree, **kw)
              for c in cams]
    stacked = preprocess(*args, stack_cameras(cams), W, H, scene.active_sh_degree,
                         scene.max_sh_degree, **kw)
    return stacked, single


@pytest.mark.parametrize("block", [16, 32])
def test_batched_kernels_match_plain_per_view(scene, block):
    """K1-K4 with B = 3 views in one launch each against the plain versions
    view by view: K1 and the bins identical, K2 within 1e-4, K3 within 1e-4
    and K4 within 1e-5 of each column's largest |plain|, the same zero rows,
    and K2-K4 the same bits on a second run. One view has no pairs; under
    the budget chosen, the bench view drops pairs and the others do not."""
    stacked, single = _view_stack(scene)
    gx, gy = binning.grid_shape(W, H, block, block)
    full = [int(binning.build_sorted_bins(p, gx, gy, MAX_PAIRS, block=block).num_pairs)
            for p in single]
    assert full[1] == 0 and full[0] > full[2] + 512 > 512
    # a budget between the bench view's pairs and the close view's
    budget = -(-((full[0] + full[2]) // 2) // 128) * 128
    counts = dict(_build.launches)
    bins = binning.build_sorted_bins(stacked, gx, gy, budget, block=block)
    assert _build.launches["expand_pairs"] == counts["expand_pairs"] + 1
    plain = binning.build_sorted_bins(stacked, gx, gy, budget, block=block, plain=True)
    for name, a, b in zip(bins._fields, bins, plain):
        assert torch.equal(a, b), name
    assert bins.num_dropped.tolist() == [full[0] - budget, 0, 0]
    assert bins.num_pairs.tolist() == full
    for v, p in enumerate(single):  # the stack's view v is the single view's bins
        one = binning.build_sorted_bins(p, gx, gy, budget, block=block)
        for name, a, b in zip(bins._fields, bins, one):
            assert torch.equal(a[v], b), (v, name)

    gfeat = rasterize.feature_table(stacked, W, H, block)
    bg = torch.tensor([[0.1, 0.2, 0.3], [0.5, 0.5, 0.5], [0.0, 0.3, 1.0]], device="cuda")
    fwd = (gfeat, bins.gauss_s, bins.tile_start, bins.tile_count, bg, gx, block)
    counts = dict(_build.launches)
    out = rasterize.composite_fwd(*fwd)
    assert _build.launches["composite_fwd"] == counts["composite_fwd"] + 1
    again = rasterize.composite_fwd(*fwd)
    out_p = rasterize.composite_fwd_plain(*fwd)
    gen = torch.Generator(device="cuda").manual_seed(2)
    grad_out = torch.randn(out.shape, device="cuda", generator=gen)
    bwd = (gfeat, bins.gauss_s, bins.slot_s, bins.tile_start, bins.tile_count, out,
           grad_out, gx, block, budget)
    dk = rasterize.composite_bwd(*bwd)
    assert _build.launches["composite_bwd"] == counts["composite_bwd"] + 1
    dk2 = rasterize.composite_bwd(*bwd)
    dp = rasterize.composite_bwd_plain(*bwd)
    seg = (dk, bins.offsets, bins.ntiles, bins.order)
    sk = rasterize.segment_sum(*seg)
    assert _build.launches["segment_sum"] == counts["segment_sum"] + 1
    sk2 = rasterize.segment_sum(*seg)
    sp = rasterize.segment_sum_plain(*seg)
    torch.cuda.synchronize()
    assert out.shape == (3, gx * gy, rasterize.NOUT, block * block)
    assert dk.shape == (3, budget, rasterize.NGRAD)
    assert sk.shape == (3, stacked.depth.shape[1], rasterize.NFEAT)
    assert torch.equal(out, again) and torch.equal(dk, dk2) and torch.equal(sk, sk2)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(dk).all())
    assert float((out - out_p).abs().max()) <= K2_TOL
    # the empty view composites the background alone and has no gradient rows
    assert torch.equal(out[1, :, :3], bg[1][None, :, None].expand(gx * gy, 3, block * block))
    assert not dk[1].any() and not sk[1].any()
    for v in (0, 2):
        assert col_err(dk[v], dp[v]) <= 1e-4
        assert torch.equal(dk[v].abs().sum(1) == 0, dp[v].abs().sum(1) == 0)
        ng = rasterize.NGRAD
        assert col_err(sk[v, :, :ng], sp[v, :, :ng]) <= 1e-5
        assert torch.equal(sk[v].abs().sum(1) == 0, sp[v].abs().sum(1) == 0)


@pytest.mark.parametrize("block", [16, 32])
def test_batched_entries_at_one_view_give_the_single_view_bits(prep, block):
    """A stack of one view through K1-K4 gives the bits of the single-view
    entry (the same kernel code on grid row or column 0)."""
    stack1 = type(prep)(*(getattr(prep, f)[None] for f in prep.__dataclass_fields__))
    gx, gy = binning.grid_shape(W, H, block, block)
    bins = binning.build_sorted_bins(prep, gx, gy, MAX_PAIRS, block=block)
    bins1 = binning.build_sorted_bins(stack1, gx, gy, MAX_PAIRS, block=block)
    for name, a, b in zip(bins._fields, bins, bins1):
        assert torch.equal(a, b[0]), name
    gfeat = rasterize.feature_table(prep, W, H, block)
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    out = rasterize.composite_fwd(gfeat, bins.gauss_s, bins.tile_start, bins.tile_count,
                                  bg, gx, block)
    out1 = rasterize.composite_fwd(gfeat[None], bins1.gauss_s, bins1.tile_start,
                                   bins1.tile_count, bg[None], gx, block)
    gen = torch.Generator(device="cuda").manual_seed(4)
    grad_out = torch.randn(out.shape, device="cuda", generator=gen)
    dk = rasterize.composite_bwd(gfeat, bins.gauss_s, bins.slot_s, bins.tile_start,
                                 bins.tile_count, out, grad_out, gx, block, MAX_PAIRS)
    dk1 = rasterize.composite_bwd(gfeat[None], bins1.gauss_s, bins1.slot_s,
                                  bins1.tile_start, bins1.tile_count, out1,
                                  grad_out[None], gx, block, MAX_PAIRS)
    sk = rasterize.segment_sum(dk, bins.offsets, bins.ntiles, bins.order)
    sk1 = rasterize.segment_sum(dk1, bins1.offsets, bins1.ntiles, bins1.order)
    torch.cuda.synchronize()
    assert torch.equal(out, out1[0]) and torch.equal(dk, dk1[0]) and torch.equal(sk, sk1[0])


def test_batched_expand_pairs_on_uneven_runs():
    """K1 with three synthetic layouts of different pair totals stacked
    under one budget of 4096 slots a view: 17,801 pairs (past the budget),
    1,500 (inside a 1024-slot run) and none, against the plain version."""
    cases = [expand_case(n) for n in ("big_rect", "total_in_a_run", "total_zero")]
    n = max(c[0].shape[0] for c in cases)
    max_pairs = 4096
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    views = []
    for *arrays, _ in cases:
        offsets, order, rows, p_pix, total = arrays
        pad = n - offsets.shape[0]
        # padding splats own no slot: offsets at the total, rank past the rest
        offsets = np.concatenate([offsets, np.full(pad, total, offsets.dtype)])
        order = np.concatenate([order, np.arange(order.shape[0], n, dtype=order.dtype)])
        rows = np.concatenate([rows, np.zeros((pad, rows.shape[1]), rows.dtype)])
        p_pix = np.concatenate([p_pix, np.zeros((pad, 2), p_pix.dtype)])
        views.append((offsets, order, rows, p_pix, total))
    inp = binning.ExpandInputs(*(torch.from_numpy(np.stack(x)).cuda() for x in zip(*views)))
    key, gauss = binning.expand_pairs(inp, max_pairs, GX, GX * GY, 0, 32)
    key_p, gauss_p = binning.expand_pairs_plain(inp, max_pairs, GX, GX * GY, 0, 32)
    torch.cuda.synchronize()
    assert key.shape == (3, max_pairs)
    assert torch.equal(key, key_p) and torch.equal(gauss, gauss_p)
    assert inp.total.tolist() == [17801, 1500, 0]
    assert bool((key[2] == GX * GY).all()) and not gauss[2].any()


# ---- the preprocess kernel pair (csrc/preprocess.cu) ----------------------

PREP_N = 5000
# name: (scene, max SH degree, active degree, antialias, views, tile edge,
# scale modifier); "edge" is ``edge_scene`` under ``edge_cameras``, "inside"
# the benchmark's cloud seen from distance 2 (``inside_scene``, degree 3,
# under ``inside_camera``, one view; the cell ``train-1080p-3m``)
PREP_CASES = {
    **{f"deg{d}{'-aa' if aa else ''}": ("edge", max(d, 3), d, aa, 1, 32, 1.0)
       for d in range(5) for aa in (False, True)},
    "views4": ("edge", 3, 3, False, 4, 32, 1.0),
    "views4-aa": ("edge", 3, 3, True, 4, 32, 1.0),
    "views4-deg0": ("edge", 3, 0, False, 4, 32, 1.0),
    "block16-modifier": ("edge", 3, 3, False, 1, 16, 0.5),
    "inside-the-cloud": ("inside", 3, 3, False, 1, 32, 1.0),
}


def _prep_run(fn, scene, cam, views, block, aa, sm, ct):
    """``fn``'s (Preprocessed, table) and the gradients of ``(table * ct).sum()``
    in every raw leaf and the NDC offset, by name."""
    leaves = {k: getattr(scene.params, k).detach().requires_grad_() for k in PARAM_NAMES}
    live = dataclasses.replace(scene, params=GaussianParams(**leaves))
    off = torch.zeros(((views,) if views > 1 else ()) + (scene.capacity, 2), device="cuda",
                      requires_grad=True)
    prep, table = fn(live, cam, W, H, block, aa, off, sm)
    grads = torch.autograd.grad((table * ct).sum(), list(leaves.values()) + [off])
    return prep, table, dict(zip(list(PARAM_NAMES) + ["offset"], grads))


def _nan_equal(a, b) -> bool:
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _float_err(a, b) -> float:
    """Largest |a - b| / |b| over the finite elements of ``b`` (0 where both
    are 0); inf where the NaN patterns differ."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return math.inf
    fin = torch.isfinite(b)
    d = (a - b)[fin].abs()
    return float((d / b[fin].abs().clamp_min(1e-30)).max()) if d.numel() else 0.0


def _grad_err(a, b) -> float:
    """Largest |a - b| over the L2 norm of ``b`` (the leaf's norm), both
    over the finite elements; inf where the NaN patterns differ (with
    antialiasing a splat exactly on the camera plane has a NaN opacity
    scale, and 0 times it is NaN on both sides)."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return math.inf
    fin = torch.isfinite(b)
    return float((a - b)[fin].abs().max() / b[fin].norm().clamp_min(1e-30))


def _row_err(a, b) -> float:
    """Each splat's largest |a - b| over the larger of its largest |b| and
    the median splat's, the worst over the splats; inf where the NaN
    patterns differ. For a cotangent on every row: splats behind or on the
    camera plane then get gradients up to 1e16, which would swamp a norm."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return math.inf

    def rows(x):  # one row a splat; a view's splat for the (B, N, 2) offset
        x = torch.nan_to_num(x)
        return x.reshape(-1, 2) if x.dim() == 3 and x.shape[-1] == 2 else x.reshape(
            x.shape[0], -1)

    a, b = rows(a), rows(b)
    row = b.abs().amax(dim=1)
    scale = torch.maximum(row, row.median()).clamp_min(1e-30)
    return float(((a - b).abs().amax(dim=1) / scale).max())


@pytest.mark.parametrize("case", list(PREP_CASES))
def test_preprocess_kernels_match_plain(case):
    """The kernel pair against its plain version (the composed activations,
    ``preprocess`` and ``feature_table`` under autograd) on ``edge_scene``,
    and on the benchmark's cloud from inside it with rows in the near band,
    behind the camera and off screen beside those on screen: radius,
    radius_bin, visible and the rect columns equal; every float
    column, p_pix and depth within 1e-6 of the plain value (equal so far:
    both round every operation in the same order), cull_r2 too (its log
    rounds an ulp or two apart); under a seeded cotangent on the rows of the
    splats each view sees (what K4 gives) every raw leaf's and the offset's
    gradient with the same NaNs and within 1e-5 of the leaf's norm; under one on every
    row the same NaNs and each splat's gradient within 1e-4 of its own
    scale (``_row_err``); one launch of each kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    kind, mx, deg, aa, views, block, sm = PREP_CASES[case]
    if kind == "inside":
        scene, cam = inside_scene(PREP_N, seed=3, device="cuda"), inside_camera("cuda")
    else:
        scene = edge_scene(PREP_N, mx, deg, seed=10 * mx + deg, device="cuda")
        cam = edge_cameras(views, "cuda")
    ct = edge_cotangent(((views,) if views > 1 else ()) + (PREP_N, rasterize.NFEAT), 0, "cuda")
    counts = dict(_build.launches)
    pk, tk, gk = _prep_run(preprocess_scene, scene, cam, views, block, aa, sm, ct)
    torch.cuda.synchronize()
    assert _build.launches["preprocess_fwd"] == counts["preprocess_fwd"] + 1
    assert _build.launches["preprocess_bwd"] == counts["preprocess_bwd"] + 1
    pp_, tp, gp = _prep_run(preprocess_scene_plain, scene, cam, views, block, aa, sm, ct)
    assert tk.shape == tp.shape and pk.visible.dtype == torch.bool
    assert int(pp_.visible.sum()) > PREP_N // 3  # the ordinary splats are seen
    if kind == "inside":  # the rows this scene is for
        z, r, (x, y) = pp_.depth, pp_.radius, pp_.p_pix.unbind(-1)
        off = pp_.visible & ((x + r < 0) | (x - r >= W) | (y + r < 0) | (y - r >= H))
        assert int((z <= 0).sum()) > 0 and int(((z > 0) & (z <= 0.2)).sum()) > 0
        assert int(off.sum()) > 0 and int((pp_.visible & ~off).sum()) > 0
    for f in ("radius", "radius_bin", "visible"):
        assert _nan_equal(getattr(pk, f), getattr(pp_, f)), f
    assert _nan_equal(tk[..., 10:], tp[..., 10:])
    for c in range(10):
        assert _float_err(tk[..., c], tp[..., c]) <= 1e-6, c
    for f in ("p_pix", "depth", "cull_r2"):
        assert _float_err(getattr(pk, f), getattr(pp_, f)) <= 1e-6, f
    for k in gk:
        assert _row_err(gk[k], gp[k]) <= 1e-4, k
    seen = ct * pp_.visible[..., None]
    gk = _prep_run(preprocess_scene, scene, cam, views, block, aa, sm, seen)[2]
    gp = _prep_run(preprocess_scene_plain, scene, cam, views, block, aa, sm, seen)[2]
    for k in gk:
        assert _grad_err(gk[k], gp[k]) <= 1e-5, k


def test_preprocess_kernels_without_an_offset_and_under_no_grad(scene):
    """The render's and the eval step's call: no offset, no autograd."""
    cam = interop.camera(W, H)
    with torch.no_grad():
        pk, tk = preprocess_scene(scene, cam, W, H, 32)
        pp_, tp = preprocess_scene_plain(scene, cam, W, H, 32)
    torch.cuda.synchronize()
    assert tk.grad_fn is None
    assert torch.equal(pk.visible, pp_.visible) and torch.equal(pk.radius, pp_.radius)
    for c in range(rasterize.NFEAT):
        assert _float_err(tk[:, c], tp[:, c]) <= 1e-6, c


def test_captured_train_step_runs_the_preprocess_kernels(scene, monkeypatch):
    """A captured train step on route "cuda" launches each kernel of the
    pair once a replay and never the composed preprocess or feature table;
    its first loss is within 1e-5 of the plain route's eager step's."""
    from gaussian_splatting_lightning_tpu_torch.ops import preprocess as prep_mod
    from gaussian_splatting_lightning_tpu_torch.training.optimizer import init_adam

    def refuse(*args, **kwargs):
        raise AssertionError("the composed preprocess ran on route cuda")

    cam = interop.camera(W, H)
    gen = torch.Generator(device="cuda").manual_seed(5)
    target = torch.rand(3, H, W, device="cuda", generator=gen)
    bg = torch.zeros(3, device="cuda")
    tiling = TilingConfig(max_pairs=MAX_PAIRS, block=32)
    plain = trainer.make_train_step(trainer.TrainConfig(rasterizer="plain", tiling=tiling),
                                    1.0, W, H, capture=False)
    want = [float(plain(_clone(scene), init_adam(scene.params), 0, cam, target, bg)[2]["loss"])]
    for name in ("preprocess", "feature_table"):
        monkeypatch.setattr(rasterize, name, refuse)
    monkeypatch.setattr(prep_mod, "preprocess_scene_plain", refuse)
    step = trainer.make_train_step(trainer.TrainConfig(tiling=tiling), 1.0, W, H)
    state, adam = _clone(scene), init_adam(scene.params)
    for t in range(3):
        _build.reset_launch_counts()
        state, adam, logs = step(state, adam, t, cam, target, bg)[:3]
        torch.cuda.synchronize()
        runs = 2 if t == 0 else 1  # the first call warms up, captures and replays
        assert _build.launches["preprocess_fwd"] == _build.launches["preprocess_bwd"] == runs
        assert _build.launches["expand_pairs"] == runs
        if t == 0:
            assert abs(float(logs["loss"]) - want[0]) <= 1e-5 * abs(want[0])
    assert step.captured.captures == 1


def _clone(scene):
    return dataclasses.replace(
        scene, params=GaussianParams(**{k: getattr(scene.params, k).clone()
                                        for k in PARAM_NAMES}),
        alive=scene.alive.clone(), max_radii2d=scene.max_radii2d.clone(),
        grad_accum=scene.grad_accum.clone(), grad_count=scene.grad_count.clone())


ADAM_SIZES = {"1001_sh3": (1001, 3), "1001_sh0": (1001, 0), "1m_sh3": (1 << 20, 3)}


def _adam_sched():
    return optimizer.make_lr_schedules(optimizer.OptimizerConfig(), 2.3)


def _adam_scalars(count):
    """The scalars of Adam step ``count`` at training step 15000 + count."""
    cfg = optimizer.OptimizerConfig()
    return optimizer.scalars_tensor(optimizer.adam_scalars(_adam_sched(), cfg, 15000 + count,
                                                           count), "cuda")


def _adam_bits_differ(got, want):
    return {f"{i}/{k}": n for i, (a, b) in enumerate(zip(got, want)) for k in PARAM_NAMES
            if (n := bits_differ(getattr(a, k), getattr(b, k)))}


@pytest.mark.parametrize("size", list(ADAM_SIZES))
@pytest.mark.parametrize("grads", ["contiguous", "strided"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("in_place", [False, True], ids=["out_of_place", "in_place"])
def test_adam_kernel_is_bit_identical_to_plain(size, grads, sparse, in_place):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rows, degree = ADAM_SIZES[size]
    params, g, state, visible = adam_case(rows, degree, grads, "cuda", seed=rows + degree)
    visible = visible if sparse else None
    cfg = optimizer.OptimizerConfig()
    table = adam_groups([tuple(getattr(x, k) for x in (params, g, state.mu, state.nu, params,
                                                       state.mu, state.nu))
                         for k in PARAM_NAMES])
    # an empty group (features_rest at degree 0) launches no block on either path
    paths = [d.path for d in table if d.rows * d.width]
    assert paths == ["vec4" if grads == "contiguous" else "scalar"] * len(paths)
    for count in (1, 15001):  # bias corrections far from 1 and near it
        scalars = _adam_scalars(count)
        want_p, want_state = clone_state(params, state)
        optimizer._adam_plain(want_p, g, want_state, scalars, cfg, visible)
        want = (want_p, want_state.mu, want_state.nu)
        kept = clone_state(params, state)
        before = _build.launches["adam"]
        if in_place:
            p, st = clone_state(params, state)
            optimizer.adam_update_(p, g, st, scalars, cfg, visible)
            got = (p, st.mu, st.nu)
        else:
            # the copying wrapper, at the step and count that give ``scalars``
            prior = optimizer.AdamState(count - 1, state.mu, state.nu)
            got_p, new = optimizer.adam_update(params, g, prior, _adam_sched(), cfg,
                                               15000 + count, visible)
            got = (got_p, new.mu, new.nu)
        torch.cuda.synchronize()
        assert _build.launches["adam"] == before + 1
        assert not _adam_bits_differ(got, want)
        # out of place leaves the inputs as they were
        assert not _adam_bits_differ((params, state.mu, state.nu),
                                     (kept[0], kept[1].mu, kept[1].nu))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_adam_kernel_replays_each_steps_scalars_in_a_captured_graph(sparse):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    params, g, state, visible = adam_case(1001, 3, "contiguous", "cuda", seed=9)
    visible = visible if sparse else None
    cfg = optimizer.OptimizerConfig()
    ref = clone_state(params, state)
    scalars = _adam_scalars(1)
    warm = clone_state(params, state)  # loads the library before the capture
    optimizer.adam_update_(warm[0], g, warm[1], scalars, cfg, visible)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        optimizer.adam_update_(params, g, state, scalars, cfg, visible)
    for count in (2, 15001):
        new = _adam_scalars(count)
        scalars.copy_(new)
        graph.replay()
        optimizer._adam_plain(ref[0], g, ref[1], new, cfg, visible)
        torch.cuda.synchronize()
        assert not _adam_bits_differ((params, state.mu, state.nu),
                                     (ref[0], ref[1].mu, ref[1].nu)), count
