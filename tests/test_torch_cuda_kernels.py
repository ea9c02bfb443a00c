"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 (``csrc/expand_pairs.cu``) must give the plain version's ``(key, gauss)``
and sorted bins exactly; K2 (``csrc/composite_fwd.cu``) must agree within
1e-4 max-abs. K3 (``csrc/composite_bwd.cu``) within 1e-4 of each gradient
column's largest magnitude (its per-pixel terms equal the plain version's;
the sums over up to 1024 pixels run in another order and the position rows
cancel); K4 (``csrc/segment_sum.cu``) within 1e-5 of each column's largest
magnitude (sums of a few rows in another order); K5 (``csrc/blur.cu``)
within 1e-6 of the largest output (both round every product and sum in the
same order). These tests need an NVIDIA GPU and ``nvcc``; elsewhere they
skip with a reason. On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q

This file imports no JAX: the machine with the card has none.
"""

import pytest
import torch

import numpy as np

from gaussian_splatting_lightning_tpu_torch import interop
from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
from gaussian_splatting_lightning_tpu_torch.ops import _build, binning, rasterize, ssim
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig, preprocess
from gaussian_splatting_lightning_tpu_torch.training import trainer

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


@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_pairs_kernel_is_exact(prep, case):
    blk, max_pairs, tyoff, gyl = CASES[case]
    gx, gy = binning.grid_shape(W, H, blk, blk)
    n_tiles = gx * (gyl or gy)
    inp, _ = binning.expand_inputs(prep, gx, gy, tyoff, gyl or gy, blk)
    before = _build.launches["expand_pairs"]
    key, gauss = binning.expand_pairs(inp, max_pairs, gx, n_tiles, tyoff, blk)
    assert _build.launches["expand_pairs"] == before + 1
    key_p, gauss_p = binning.expand_pairs_plain(inp, max_pairs, gx, n_tiles, tyoff, blk)
    torch.cuda.synchronize()
    assert torch.equal(key, key_p) and torch.equal(gauss, gauss_p)

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
    sp = rasterize.segment_sum_plain(dpair, bins.offsets, bins.ntiles, bins.order)
    torch.cuda.synchronize()
    assert sk.shape == (prep.depth.shape[0], rasterize.NFEAT)
    assert col_err(sk[:, :rasterize.NGRAD], sp[:, :rasterize.NGRAD]) <= 1e-5
    assert not sk[:, rasterize.NGRAD:].any()
    assert torch.equal(sk.abs().sum(1) == 0, sp.abs().sum(1) == 0)


def test_blur_kernel_matches_plain_forward_and_vjp():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.rand(15, 107, 141, device="cuda", generator=gen) * 2 - 1).requires_grad_()
    ct = torch.randn(15, 97, 131, device="cuda", generator=gen)
    before = _build.launches["blur"]
    y = ssim.BlurValid.apply(x, False)
    (dx,) = torch.autograd.grad(y, x, ct)
    assert _build.launches["blur"] == before + 2  # forward and VJP
    xp = x.detach().requires_grad_()
    yp = ssim.BlurValid.apply(xp, True)
    (dxp,) = torch.autograd.grad(yp, xp, ct)
    torch.cuda.synchronize()
    assert y.shape == (15, 97, 131) and dx.shape == x.shape
    y, yp = y.detach(), yp.detach()
    assert float((y - yp).abs().max()) <= 1e-6 * float(yp.abs().max())
    assert float((dx - dxp).abs().max()) <= 1e-6 * float(dxp.abs().max())


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
