"""The port's ``preprocess`` against the JAX package's, field by field.

An anisotropic scene with a partly dead ``alive`` mask, the same numbers on
both sides, on the CPU. Floats at rtol=1e-5, atol=1e-6; ``visible`` and the
integer-valued radii exactly.

The kernel pair's wrapper (``ops/preprocess.preprocess_scene``) on CPU
tensors against the composition it replaces on the card, bit for bit, and
the train step against ``rasterize`` as it was before its tail became
``rasterize_prepared``, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES, GaussianParams
from gaussian_splatting_lightning_tpu_torch.ops import binning
from gaussian_splatting_lightning_tpu_torch.ops.common import (
    Preprocessed,
    RenderOutput,
    TilingConfig,
    preprocess,
)
from gaussian_splatting_lightning_tpu_torch.ops.preprocess import preprocess_scene
from gaussian_splatting_lightning_tpu_torch.ops.rasterize import (
    PairComposite,
    _assemble_cf,
    feature_table,
)
from gaussian_splatting_lightning_tpu_torch.training import trainer
from gaussian_splatting_lightning_tpu_torch.utils import runtime
from tests.torch_parity import cameras, jax_prep, jax_scene, port_scene
from tests.torch_preprocess_cases import H, W, cotangent, edge_scene
from tests.torch_preprocess_cases import cameras as edge_cameras

EXACT = ("visible", "radius", "radius_bin")


@pytest.mark.parametrize("antialias", [False, True])
def test_preprocess_matches_jax(antialias):
    w, h = 128, 96
    js = jax_scene(900, 1000, seed=4, aniso=True, dead_every=7)
    jc, tc = cameras(w, h)
    ts = port_scene(js)
    jp = jax_prep(js, jc, w, h, antialias)
    tp = preprocess(
        ts.params.xyz, ts.get_opacity(), ts.get_scales(), ts.get_rotation(),
        ts.get_features(), tc, w, h, ts.active_sh_degree, ts.max_sh_degree,
        antialias=antialias, alive=ts.alive,
    )
    assert not bool(tp.visible[::7][:900 // 7].any())  # dead splats are culled
    for f in dataclasses.fields(Preprocessed):
        a, b = np.asarray(getattr(jp, f.name)), getattr(tp, f.name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        if f.name in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=f.name)


# ---- the preprocess kernel pair's wrapper on the CPU ----------------------

def _leaves(scene):
    """The scene with fresh leaves, the leaves by name."""
    leaves = {k: getattr(scene.params, k).detach().requires_grad_() for k in PARAM_NAMES}
    return dataclasses.replace(scene, params=GaussianParams(**leaves)), leaves


@pytest.mark.parametrize("views", [1, 2])
def test_preprocess_scene_on_cpu_is_the_composition(views):
    """``ops/preprocess.preprocess_scene`` on CPU tensors is the plain
    version: the same table, fields and raw-leaf gradients, bit for bit, as
    the activations, ``preprocess`` and ``feature_table`` composed here."""
    n = 600
    scene = edge_scene(n, 3, 3, seed=2)
    cam = edge_cameras(views)
    lead = (views,) if views > 1 else ()
    ct = cotangent(lead + (n, 16), 1)
    out = []
    for composed in (False, True):
        live, leaves = _leaves(scene)
        off = torch.zeros(lead + (n, 2), requires_grad=True)
        if composed:
            prep = preprocess(
                live.params.xyz, live.get_opacity(), live.get_scales(), live.get_rotation(),
                live.get_features(), cam, W, H, live.active_sh_degree, live.max_sh_degree,
                True, live.alive, off)
            table = feature_table(prep, W, H, 32)
        else:
            prep, table = preprocess_scene(live, cam, W, H, 32, True, off)
        grads = torch.autograd.grad((table * ct).sum(), list(leaves.values()) + [off])
        out.append((prep, table, grads))
    (pa, ta, ga), (pb, tb, gb) = out

    def same(a, b):  # bit for bit; the on-plane splats' NaNs where both have them
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)

    assert ta.shape == lead + (n, 16)
    same(ta, tb)
    for f in dataclasses.fields(Preprocessed):
        same(getattr(pa, f.name), getattr(pb, f.name))
    for a, b in zip(ga, gb):
        same(a, b)


def _rasterize_before(means3d, opacities, scales, quats, sh, camera, width, height,
                      background, sh_degree, config=None, max_sh_degree=None,
                      antialias=False, alive=None, means2d_ndc_offset=None,
                      tile_y_offset=0, grid_y_local=None, early_stop=True, prep=None,
                      plain=False, scale_modifier=1.0, colors_precomp=None,
                      cov3d_precomp=None):
    """``ops/rasterize.rasterize`` as it was before its tail became
    ``rasterize_prepared``, statement for statement."""
    config = config or TilingConfig()
    blk = config.resolve_block("cuda")
    if prep is None:
        prep = preprocess(
            means3d, opacities, scales, quats, sh, camera, width, height,
            sh_degree, max_sh_degree, antialias, alive, means2d_ndc_offset,
            scale_modifier=scale_modifier, colors_precomp=colors_precomp,
            cov3d_precomp=cov3d_precomp,
        )
    views = prep.depth.shape[0] if prep.depth.dim() == 2 else None
    grid_x, grid_y = binning.grid_shape(width, height, blk, blk)
    banded = grid_y_local is not None
    gy = grid_y_local if banded else grid_y
    max_pairs = -(-config.max_pairs // binning.CHUNK) * binning.CHUNK
    runtime.mark("binning", prep.depth)
    bins = binning.build_sorted_bins(
        prep, grid_x, grid_y, max_pairs, tile_y_offset, gy, block=blk, plain=plain)
    runtime.mark("composite", prep.depth)
    fields = ("p_pix", "depth", "conic", "rgb", "opacity")
    table_in = dataclasses.replace(prep, **dict(zip(fields, runtime.mark_backward(
        "preprocess_bwd", *(getattr(prep, f) for f in fields)))))
    gfeat = feature_table(table_in, width, height, blk)
    bg = torch.as_tensor(background, dtype=torch.float32).to(gfeat.device)
    if views is None:
        bg = bg.reshape(3)
    else:
        bg = bg.reshape(-1, 3).expand(views, 3).contiguous()
    out = PairComposite.apply(gfeat, bins, bg, grid_x, blk, max_pairs,
                              tile_y_offset, early_stop, plain)
    out_h = gy * blk if banded else height
    imgd = _assemble_cf(out, grid_x, gy, width, out_h, blk)
    stats = {
        "num_pairs": bins.num_pairs,
        "num_dropped_pairs": bins.num_dropped,
        "max_tile_count": torch.max(bins.tile_count),
        "num_tile_overflow": torch.zeros((), dtype=torch.int32, device=gfeat.device),
        "num_visible": torch.sum(prep.visible.to(torch.int32)),
        "num_binned_pairs": torch.sum(bins.tile_count),
    }
    if views is not None:
        stats.update(num_pairs=torch.max(bins.num_pairs),
                     num_dropped_pairs=torch.sum(bins.num_dropped),
                     num_pairs_per_view=bins.num_pairs,
                     num_dropped_pairs_per_view=bins.num_dropped)
    render = RenderOutput(image=imgd[..., 0:3, :, :], radii=prep.radius,
                          depth=imgd[..., 3:4, :, :])
    return render, stats


@pytest.mark.parametrize("route,views", [("cuda", 1), ("plain", 1), ("cuda", 2)])
def test_train_step_unchanged_by_the_rasterizer_tail(route, views, monkeypatch):
    """The train step's gradients, logs, radii and stats on the CPU are
    bit for bit those of ``rasterize`` before its tail was factored out."""
    scene = edge_scene(700, 3, 3, seed=3)
    cam = edge_cameras(views)
    lead = (views,) if views > 1 else ()
    gen = torch.Generator().manual_seed(4)
    image = torch.rand(lead + (3, H, W), generator=gen)
    bg = torch.rand(lead + (3,), generator=gen)
    cfg = trainer.TrainConfig(rasterizer=route, batch_views=views,
                              tiling=TilingConfig(max_pairs=1 << 15, block=32))
    out = []
    for before in (False, True):
        if before:
            monkeypatch.setattr(trainer, "rasterize", _rasterize_before)
        out.append(trainer.step_gradients(cfg, scene, cam, W, H, image, bg))
    (ga, sa, _, ra, la, sta), (gb, sb, _, rb, lb, stb) = out
    assert float(la["loss"]) > 0 and int(sta["num_pairs"]) > 0
    for f in dataclasses.fields(ga):
        assert torch.equal(getattr(ga, f.name), getattr(gb, f.name)), f.name
    assert torch.equal(sa, sb) and torch.equal(ra, rb)
    assert la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)
    # the stats have since gained num_on_screen, the splats with a pair
    assert sta.keys() - {"num_on_screen"} == stb.keys()
    assert all(torch.equal(sta[k], stb[k]) for k in stb)
    assert 0 < int(sta["num_on_screen"]) <= int(sta["num_visible"])
