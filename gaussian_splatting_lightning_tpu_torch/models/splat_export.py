"""Export a trained scene to the web-viewer ``.splat`` format.

Counterpart of ``gaussian_splatting_lightning_tpu/models/splat_export.py``,
byte for byte: the format of the browser viewers descended from
antimatter15/splat, 32 bytes per splat,

    float32[3] position | float32[3] scale (linear)
    uint8[4]   RGBA      | uint8[4]   rotation (normalized quat * 128 + 128)

sorted by descending opacity x volume so viewers can stream front-loaded
importance. The scene is copied to the host once; the rest is numpy.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatting_lightning_tpu_torch.core.sh import SH_C0


def scene_to_splat_bytes(scene) -> bytes:
    """Serialize the alive splats of a GaussianScene to .splat bytes."""
    p = scene.params
    alive = scene.alive.cpu().numpy()
    xyz = p.xyz.detach().cpu().numpy().astype(np.float32)[alive]
    scales = np.exp(p.scales.detach().cpu().numpy().astype(np.float32))[alive]
    quats = p.quats.detach().cpu().numpy().astype(np.float32)[alive]
    sh0 = p.features_dc.detach().cpu().numpy().astype(np.float32)[alive][:, 0]
    opacity = 1.0 / (
        1.0 + np.exp(-p.opacity.detach().cpu().numpy().astype(np.float32)[alive, 0])
    )

    order = np.argsort(-(opacity * scales.prod(axis=1)), kind="stable")
    xyz, scales, quats, sh0, opacity = (
        xyz[order], scales[order], quats[order], sh0[order], opacity[order]
    )

    rgb = np.clip(0.5 + SH_C0 * sh0, 0.0, 1.0)
    rgba = np.concatenate([rgb, opacity[:, None]], axis=1)
    rgba_u8 = np.clip(rgba * 255.0 + 0.5, 0, 255).astype(np.uint8)

    qn = quats / np.maximum(np.linalg.norm(quats, axis=1, keepdims=True), 1e-12)
    rot_u8 = np.clip(qn * 128.0 + 128.0, 0, 255).astype(np.uint8)

    rec = np.zeros(len(xyz), dtype=np.dtype([
        ("position", np.float32, 3),
        ("scale", np.float32, 3),
        ("rgba", np.uint8, 4),
        ("rot", np.uint8, 4),
    ]))
    rec["position"] = xyz
    rec["scale"] = scales
    rec["rgba"] = rgba_u8
    rec["rot"] = rot_u8
    return rec.tobytes()


def save_splat(scene, path) -> int:
    """Write the scene as .splat; returns the number of splats written."""
    data = scene_to_splat_bytes(scene)
    with open(path, "wb") as f:
        f.write(data)
    return len(data) // 32
