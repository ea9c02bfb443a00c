"""The photometric loss and its gradient as CUDA kernels (``csrc/photometric.cu``).

``photometric`` returns ``(loss, recon, ssim, psnr)`` of ``training/loss.py``
(loss = (1 - w) L1 + w (1 - SSIM) at the default 11-tap window) for CUDA
tensors, three launches forward and one backward (``PhotometricLoss``);
``training/loss.py`` routes ``photometric_loss`` and ``photometric_losses``
here and keeps its composition, the plain version, for everything else.
``plan`` checks the inputs and gives the launch geometry from their dtypes,
devices and shapes alone, so the CPU tests reach it.

Per view (``per_view``: a (V, C, H, W) stack, one output per view, as
``photometric_losses``) or joint (a (C, H, W) image or a (V, C, H, W) stack,
one output, as ``photometric_loss``); in both, each view is centred on its
own mean, as ``ssim_stack`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from gaussian_splatting_lightning_tpu_torch.ops import _build
from gaussian_splatting_lightning_tpu_torch.ops.ssim import TAPS, kernel_taps

STRIP_OUT = 244  # csrc/photometric.cu kStripOut: output columns a block
ROWS_OUT = 34  # kRowsOut: output rows a block
MOMENT_BLOCKS = 256  # kMomentBlocks: moment partials a view
MAPS = 3  # kMaps: derivative maps a channel, saved for the backward


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch geometry of one call."""

    views: int
    channels: int
    height: int
    width: int
    per_view: bool

    @property
    def strips(self) -> int:
        return -(-self.width // STRIP_OUT)

    @property
    def row_blocks(self) -> int:
        return -(-self.height // ROWS_OUT)

    @property
    def ssim_partials(self) -> int:
        """SSIM partials of each view: one a block of the blur pass."""
        return self.channels * self.row_blocks * self.strips

    @property
    def out_shape(self) -> tuple:
        return (self.views,) if self.per_view else ()


def plan(pred: torch.Tensor, target: torch.Tensor, per_view: bool) -> Plan:
    """Check what the kernels take and return their geometry; raises
    ValueError on another dtype, tensors on two devices, a rank other than
    4 (``per_view``) or 3 or 4 (joint), shapes that differ, or an empty
    image."""
    for name, t in (("pred", pred), ("target", target)):
        if t.dtype != torch.float32:
            raise ValueError(f"photometric: {name} is {t.dtype}, not float32")
    if pred.device != target.device:
        raise ValueError(f"photometric: pred on {pred.device}, target on {target.device}")
    ranks = (4,) if per_view else (3, 4)
    if pred.dim() not in ranks:
        raise ValueError(f"photometric: pred must have rank {' or '.join(map(str, ranks))} "
                         f"((V,) C, H, W), got shape {tuple(pred.shape)}")
    if pred.shape != target.shape:
        raise ValueError(f"photometric: pred {tuple(pred.shape)} and target "
                         f"{tuple(target.shape)} differ")
    if pred.numel() == 0:
        raise ValueError(f"photometric: empty images {tuple(pred.shape)}")
    v, c, h, w = (1,) * (4 - pred.dim()) + tuple(pred.shape)
    return Plan(v, c, h, w, per_view)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


class PhotometricLoss(torch.autograd.Function):
    """(loss, recon, ssim, psnr) of contiguous CUDA ``pred`` and ``target``
    by the forward kernels; pred's gradient by the backward kernel from the
    derivative maps the forward saves (written only when ``grad`` is set)."""

    @staticmethod
    def forward(ctx, pred, target, w_ssim, geo, grad):
        dev = pred.device
        outs = [torch.empty(geo.out_shape, dtype=torch.float32, device=dev) for _ in range(4)]
        moments = torch.empty(geo.views, MOMENT_BLOCKS, 4, dtype=torch.float32, device=dev)
        parts = torch.empty(geo.views, geo.ssim_partials, dtype=torch.float32, device=dev)
        stats = torch.empty(geo.views, 4, dtype=torch.float32, device=dev)
        maps = (torch.empty(geo.views, geo.channels, MAPS, geo.height, geo.width,
                            dtype=torch.float32, device=dev) if grad else None)
        area = geo.channels * geo.height * geo.width
        vec = int(area % 4 == 0 and _aligned(pred, target))
        lib = _build.load("photometric")
        p = _build.ptr
        # ctypes rounds each double to float as PyTorch rounds a Python scalar
        rc = lib.gs_photometric_fwd(
            p(pred), p(target), p(moments), p(parts), None if maps is None else p(maps),
            *[p(o) for o in outs], p(stats), geo.views, geo.channels, geo.height, geo.width,
            geo.strips, geo.row_blocks, int(not geo.per_view), vec, w_ssim, 1.0 - w_ssim,
            kernel_taps(TAPS), _build.stream_of(pred))
        _build.check(lib, "photometric", rc, kernels=3)
        if grad:
            ctx.save_for_backward(pred, target, maps, stats)
        ctx.w_ssim, ctx.geo = w_ssim, geo
        ctx.set_materialize_grads(False)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cots):
        pred, target, maps, stats = ctx.saved_tensors
        geo = ctx.geo
        ptrs = [None if g is None else _build.ptr(g) for g in cots]
        strides = [0 if g is None or g.dim() == 0 else g.stride(0) for g in cots]
        dpred = torch.empty_like(pred)
        lib = _build.load("photometric")
        p = _build.ptr
        rc = lib.gs_photometric_bwd(
            p(pred), p(target), p(maps), p(stats), *ptrs, *strides, p(dpred), geo.views,
            geo.channels, geo.height, geo.width, geo.strips, geo.row_blocks,
            int(not geo.per_view), ctx.w_ssim, 1.0 - ctx.w_ssim, kernel_taps(TAPS),
            _build.stream_of(dpred))
        _build.check(lib, "photometric", rc)
        return dpred, None, None, None, None


def photometric(pred: torch.Tensor, target: torch.Tensor, w_ssim: float, per_view: bool):
    """(loss, recon, ssim, psnr) of ``training/loss.py`` by the kernels:
    0-dim tensors joint, (V,) per view. Inputs that are not contiguous are
    copied; anything else the kernels do not take raises ValueError (see
    ``plan``): CPU tensors too, and a target that needs a gradient (the
    kernels give pred's alone)."""
    geo = plan(pred, target, per_view)
    if target.requires_grad:
        raise ValueError("photometric: the kernels give no gradient of the target")
    if pred.device.type != "cuda":
        raise ValueError(f"photometric: the kernels need CUDA tensors, got {pred.device}")
    grad = torch.is_grad_enabled() and pred.requires_grad
    return PhotometricLoss.apply(pred.contiguous(), target.contiguous(),
                                 float(w_ssim), geo, grad)
