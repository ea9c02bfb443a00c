"""Training loss: L1/SSIM mix and PSNR.

Counterpart of ``gaussian_splatting_lightning_tpu/training/loss.py``:
loss = (1 - w_ssim) L1 + w_ssim (1 - SSIM), w_ssim = 0.2 by default.

On CUDA tensors, unless ``plain`` or the target needs a gradient, both
functions run the loss and its backward as kernels (``ops/photometric.py``);
everything else runs the composition below, their plain version.
"""

from __future__ import annotations

import torch

from gaussian_splatting_lightning_tpu_torch.ops import photometric
from gaussian_splatting_lightning_tpu_torch.ops.ssim import psnr, ssim, ssim_map


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def on_kernels(pred: torch.Tensor, target: torch.Tensor, plain: bool) -> bool:
    """Whether the loss runs as ``ops/photometric.py``'s kernels."""
    return pred.device.type == "cuda" and not plain and not target.requires_grad


def photometric_loss(pred: torch.Tensor, target: torch.Tensor,
                     w_ssim: float = 0.2, plain: bool = False):
    """Returns (loss, logs dict). ``plain`` runs the composition, with SSIM's
    blur as its plain version, on any device."""
    if on_kernels(pred, target, plain):
        loss, recon, loss_ssim, p = photometric.photometric(pred, target, w_ssim, False)
        return loss, {"loss": loss, "recon": recon, "ssim": loss_ssim, "psnr": p}
    recon = l1_loss(pred, target)
    loss_ssim = 1.0 - ssim(pred, target, plain)
    loss = recon * (1.0 - w_ssim) + loss_ssim * w_ssim
    return loss, {
        "loss": loss,
        "recon": recon,
        "ssim": loss_ssim,
        "psnr": psnr(pred, target),
    }


def photometric_losses(pred: torch.Tensor, target: torch.Tensor,
                       w_ssim: float = 0.2, plain: bool = False):
    """``photometric_loss`` of each view of a (B, 3, H, W) stack: (loss (B,),
    logs of (B,) tensors), as ``vmap`` of the JAX loss gives them. Each
    view's SSIM is centred on its own mean; the blur runs once for all
    views, forward and backward."""
    if on_kernels(pred, target, plain):
        loss, recon, loss_ssim, p = photometric.photometric(pred, target, w_ssim, True)
        return loss, {"loss": loss, "recon": recon, "ssim": loss_ssim, "psnr": p}
    views = (1, 2, 3)
    recon = torch.mean(torch.abs(pred - target), dim=views)
    loss_ssim = 1.0 - ssim_map(pred, target, plain).mean(dim=views)
    loss = recon * (1.0 - w_ssim) + loss_ssim * w_ssim
    return loss, {
        "loss": loss,
        "recon": recon,
        "ssim": loss_ssim,
        "psnr": psnr(pred, target, dim=views),
    }
