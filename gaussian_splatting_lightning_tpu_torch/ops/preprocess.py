"""The splats' preprocess as one kernel pair (``csrc/preprocess.cu``): the
scene's raw parameters in, the compositor's feature table and the binning's
fields out, and the gradient of every raw parameter back.

``preprocess_scene`` is what ``training/trainer.render_scene`` runs on the
``cuda`` route with CUDA tensors: one autograd function whose forward is
``preprocess_fwd_kernel`` and whose backward is ``preprocess_bwd_kernel``.
Its plain version, ``preprocess_scene_plain``, is the composition the port
had before: the scene's activations (``models/gaussians.py``),
``ops/common.preprocess`` and ``ops/rasterize.feature_table`` under autograd.
CPU tensors take the plain version; the ``plain`` and ``xla`` routes, the
oracle, precomputed colours or covariances and an externally computed
``Preprocessed`` (the mesh's sharded preprocess) never reach this module.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_splatting_lightning_tpu_torch.ops import _build, binning
from gaussian_splatting_lightning_tpu_torch.ops.common import (
    ALPHA_THRESHOLD,
    Preprocessed,
    preprocess,
)
from gaussian_splatting_lightning_tpu_torch.ops.rasterize import (
    F_B,
    F_CA,
    F_CC,
    F_OP,
    F_R,
    NFEAT,
    feature_table,
)

# opacity / ALPHA_THRESHOLD on CUDA tensors is PyTorch's multiplication by
# the f32 reciprocal of the f32 scalar; the kernel multiplies by this
INV_ALPHA = float(np.float32(1.0) / np.float32(ALPHA_THRESHOLD))


def preprocess_scene_plain(scene, camera, width: int, height: int, block: int,
                           antialias: bool = False, means2d_ndc_offset=None,
                           scale_modifier: float = 1.0):
    """The kernels' plain version: (``Preprocessed``, feature table) from the
    scene's activations through ``preprocess`` and ``feature_table``."""
    prep = preprocess(
        scene.params.xyz, scene.get_opacity(), scene.get_scales(), scene.get_rotation(),
        scene.get_features(), camera, width, height, scene.active_sh_degree,
        scene.max_sh_degree, antialias, scene.alive, means2d_ndc_offset,
        scale_modifier=scale_modifier,
    )
    return prep, feature_table(prep, width, height, block)


def _camera_arrays(camera):
    """The camera's tensors as the kernels read them: (B, 4, 4), (B, 4, 4),
    (B, 3), (B,), (B,), contiguous f32."""
    return (camera.viewmatrix.reshape(-1, 4, 4).contiguous(),
            camera.projmatrix.reshape(-1, 4, 4).contiguous(),
            camera.campos.reshape(-1, 3).contiguous(),
            camera.tanfovx.reshape(-1).contiguous(),
            camera.tanfovy.reshape(-1).contiguous())


class PreprocessKernels(torch.autograd.Function):
    """Forward ``preprocess_fwd_kernel``: the raw leaves to the ([B,] N,
    NFEAT) table (differentiable) and the binning's fields (p_pix, depth,
    radius, radius_bin, visible, cull_r2; not differentiable). Backward
    ``preprocess_bwd_kernel``: the table's gradient to each leaf's and the
    NDC offset's."""

    @staticmethod
    def forward(ctx, xyz, dc, rest, opacity, scales, quats, offset, alive, view, proj,
                campos, tanx, tany, static):
        width, height, degree, antialias, block, scale_modifier, stacked = static
        dev = xyz.device
        n, views = xyz.shape[0], view.shape[0]
        for name, t in (("xyz", xyz), ("features_dc", dc), ("features_rest", rest),
                        ("opacity", opacity), ("scales", scales), ("quats", quats),
                        ("viewmatrix", view), ("projmatrix", proj), ("campos", campos),
                        ("tanfovx", tanx), ("tanfovy", tany)):
            _build.check_tensor(t, name, torch.float32, dev)
        if quats.data_ptr() % 16:
            raise ValueError("preprocess: quats must start on a 16-byte boundary")
        if offset is not None:
            _build.check_tensor(offset, "means2d_ndc_offset", torch.float32, dev)
            if offset.numel() != views * n * 2 or offset.data_ptr() % 8:
                raise ValueError(f"preprocess: the offset must be an 8-byte aligned "
                                 f"([B,] N, 2) array, got {tuple(offset.shape)}")
        _build.check_tensor(alive, "alive", torch.bool, dev)
        lead = (views,) if stacked else ()
        table = torch.empty(lead + (n, NFEAT), dtype=torch.float32, device=dev)
        p_pix = torch.empty(lead + (n, 2), dtype=torch.float32, device=dev)
        depth, radius, radius_bin, cull_r2 = (
            torch.empty(lead + (n,), dtype=torch.float32, device=dev) for _ in range(4))
        visible = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
        g16x, g16y = binning.grid_shape(width, height, 16, 16)
        lib = _build.load("preprocess_fwd")
        p = _build.ptr
        opt = (lambda t: None if t is None else p(t))
        rc = lib.gs_preprocess_fwd(
            p(xyz), p(dc), p(rest), p(opacity), p(scales), p(quats), opt(offset), p(alive),
            p(view), p(proj), p(campos), p(tanx), p(tany), p(table), p(p_pix), p(depth),
            p(radius), p(radius_bin), p(visible), p(cull_r2), n, views, width, height, degree,
            rest[0].numel() if n else 0, int(antialias), int(block != 16), g16x, g16y,
            scale_modifier, INV_ALPHA, _build.stream_of(table),
        )
        _build.check(lib, "preprocess_fwd", rc)
        ctx.mark_non_differentiable(p_pix, depth, radius, radius_bin, visible, cull_r2)
        ctx.save_for_backward(xyz, dc, rest, opacity, scales, quats, offset, view, proj,
                              campos, tanx, tany)
        ctx.static = static
        return table, p_pix, depth, radius, radius_bin, visible, cull_r2

    @staticmethod
    def backward(ctx, g_table, *_):
        xyz, dc, rest, opacity, scales, quats, offset, view, proj, campos, tanx, tany = (
            ctx.saved_tensors)
        width, height, degree, antialias, _, scale_modifier, _ = ctx.static
        g_table = g_table.contiguous()
        if g_table.data_ptr() % 16:
            g_table = g_table.clone()
        grads = [torch.empty_like(t) for t in (xyz, dc, rest, opacity, scales, quats)]
        d_offset = None if offset is None else torch.empty_like(offset)
        lib = _build.load("preprocess_bwd")
        p = _build.ptr
        n = xyz.shape[0]
        rc = lib.gs_preprocess_bwd(
            p(xyz), p(dc), p(rest), p(opacity), p(scales), p(quats),
            None if offset is None else p(offset), p(view), p(proj), p(campos), p(tanx),
            p(tany), p(g_table), *(p(g) for g in grads),
            None if d_offset is None else p(d_offset), n, view.shape[0], width, height,
            degree, rest[0].numel() if n else 0, int(antialias), scale_modifier,
            _build.stream_of(g_table),
        )
        _build.check(lib, "preprocess_bwd", rc)
        return (*grads, d_offset) + (None,) * 7


def preprocess_scene(scene, camera, width: int, height: int, block: int,
                     antialias: bool = False, means2d_ndc_offset=None,
                     scale_modifier: float = 1.0):
    """(``Preprocessed``, ([B,] N, NFEAT) feature table) of ``scene`` seen by
    ``camera`` (one view or a stack), differentiable in the scene's raw
    parameters and in ``means2d_ndc_offset``. CUDA tensors launch the kernel
    pair; CPU tensors run ``preprocess_scene_plain``. The ``Preprocessed``
    fields conic, rgb and opacity are views of the table."""
    if scene.device.type == "cpu":
        return preprocess_scene_plain(scene, camera, width, height, block, antialias,
                                      means2d_ndc_offset, scale_modifier)
    par = scene.params
    degree = min(int(scene.active_sh_degree), scene.max_sh_degree)
    static = (width, height, degree, bool(antialias), block, float(scale_modifier),
              camera.views is not None)
    table, p_pix, depth, radius, radius_bin, visible, cull_r2 = PreprocessKernels.apply(
        par.xyz, par.features_dc, par.features_rest, par.opacity, par.scales, par.quats,
        means2d_ndc_offset, scene.alive, *_camera_arrays(camera), static)
    prep = Preprocessed(
        p_pix=p_pix, depth=depth, conic=table[..., F_CA:F_CC + 1],
        rgb=table[..., F_R:F_B + 1], opacity=table[..., F_OP], radius=radius,
        visible=visible, radius_bin=radius_bin, cull_r2=cull_r2,
    )
    return prep, table
