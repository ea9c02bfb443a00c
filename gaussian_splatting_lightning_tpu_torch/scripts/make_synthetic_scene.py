"""Synthetic COLMAP scene generator.

Counterpart of the JAX package's ``scripts/make_synthetic_scene.py`` (the
same numpy draws in the same order): a procedural ground-truth splat set
rendered by the port (``render_scene``, the CUDA kernels) from an orbit of
cameras, written as a standard COLMAP binary model (cameras.bin /
images.bin / points3D.bin, ``data/colmap.write_reconstruction``) plus PNG
images, so the training path runs end to end on it, including
densification from a sparse noisy SfM-like point cloud. Three GT styles:
``clusters`` (volumetric random splats), ``textured`` (opaque
procedural-texture surfaces) and ``hard`` (sub-splat texture detail,
view-dependent colour, thin structures). The pair budget starts at 2^20 and
doubles, re-rendering the view, whenever a view drops pairs. On the card
the render replays a captured graph per budget
(``training/trainer.make_render``), as the JAX generator jits it once per
budget.

Usage:
    python -m gaussian_splatting_lightning_tpu_torch.scripts.make_synthetic_scene \
        --out /tmp/scene --n-views 24 --width 1920 --height 1080 \
        --n-splats 80000 [--style clusters|textured|hard] [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from gaussian_splatting_lightning_tpu_torch.models.gaussians import (
    initial_arrays,
    scene_from_arrays,
)

# the JAX generator's literal, shorter than ``core.sh.SH_C0``: the point
# colours written to points3D.bin round through it
SH0_TO_RGB = 0.28209479177


def _gt_scene(xyz, rgb, sh_degree, device, active_sh_degree=0, **fields):
    """GaussianScene of the GT arrays, every splat alive: sh0 from ``rgb``
    (``initial_arrays``), then the named parameter ``fields`` replaced. The
    JAX generator builds it with ``from_points``, whose KNN scales every
    style overwrites, so they are not computed here."""
    n = len(xyz)
    d = initial_arrays(xyz, rgb, sh_degree, np.zeros((n, 3), np.float32))
    d.update({k: np.asarray(v, np.float32) for k, v in fields.items()})
    return scene_from_arrays(**d, alive=np.ones(n, bool),
                             active_sh_degree=active_sh_degree, device=device)


def make_gt_scene(n_splats: int, sh_degree: int, seed: int, device="cuda"):
    """Procedural ground truth: colored Gaussian clusters in a ball plus a
    ground slab — garden-like screen statistics (many small anisotropic
    splats at mixed depths), self-consistent by construction."""
    rng = np.random.default_rng(seed)
    n_clusters = 96
    centers = rng.normal(size=(n_clusters, 3)).astype(np.float32)
    centers *= np.array([1.6, 0.7, 1.6], np.float32)
    base_rgb = rng.uniform(0.15, 0.95, size=(n_clusters, 3)).astype(np.float32)
    cluster_of = rng.integers(0, n_clusters, size=n_splats)
    n_ground = n_splats // 5
    cluster_of[:n_ground] = -1

    xyz = centers[cluster_of] + rng.normal(size=(n_splats, 3)).astype(
        np.float32
    ) * rng.uniform(0.05, 0.35, size=(n_splats, 1)).astype(np.float32)
    # ground slab
    xyz[:n_ground, 0] = rng.uniform(-2.5, 2.5, n_ground)
    xyz[:n_ground, 2] = rng.uniform(-2.5, 2.5, n_ground)
    xyz[:n_ground, 1] = -1.2 + rng.normal(scale=0.02, size=n_ground)

    rgb = np.clip(
        base_rgb[cluster_of]
        + rng.normal(scale=0.08, size=(n_splats, 3)).astype(np.float32),
        0.02, 0.98,
    )
    rgb[:n_ground] = np.clip(
        np.array([0.35, 0.45, 0.25], np.float32)
        + rng.normal(scale=0.05, size=(n_ground, 3)).astype(np.float32),
        0.02, 0.98,
    )

    log_s = rng.normal(
        loc=np.log(0.02), scale=0.5, size=(n_splats, 3)
    ).astype(np.float32)
    log_s[:n_ground, 1] -= 2.0  # flat ground splats
    op_logit = rng.normal(loc=1.5, scale=1.0, size=(n_splats, 1)).astype(
        np.float32
    )
    quats = rng.normal(size=(n_splats, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return _gt_scene(xyz, rgb, sh_degree, device, scales=log_s, opacity=op_logit,
                     quats=quats)


def _value_noise(u, v, rng, octaves=5, base_freq=4):
    """Multi-octave smooth value noise on [0,1]^2 -> [0,1]; the procedural
    texture for surface splats (spatially coherent, so held-out views are
    determined by geometry+texture rather than memorized — VERDICT r2 #4)."""
    out = np.zeros_like(u, dtype=np.float64)
    amp, norm = 1.0, 0.0
    for o in range(octaves):
        f = base_freq * (2 ** o)
        g = rng.uniform(0.0, 1.0, (f + 1, f + 1))
        ui = np.clip(u * f, 0, f - 1e-6)
        vi = np.clip(v * f, 0, f - 1e-6)
        i0 = ui.astype(int)
        j0 = vi.astype(int)
        fu = ui - i0
        fv = vi - j0
        fu = fu * fu * (3 - 2 * fu)
        fv = fv * fv * (3 - 2 * fv)
        n = (
            g[i0, j0] * (1 - fu) * (1 - fv)
            + g[i0 + 1, j0] * fu * (1 - fv)
            + g[i0, j0 + 1] * (1 - fu) * fv
            + g[i0 + 1, j0 + 1] * fu * fv
        )
        out += amp * n
        norm += amp
        amp *= 0.55
    return (out / norm).astype(np.float32)


def _surface_color(u, v, rng, palette):
    """3-channel procedural texture: palette blend of 2 noise fields plus a
    fine-detail luminance octave."""
    a = _value_noise(u, v, rng, octaves=5)
    b = _value_noise(u, v, rng, octaves=4, base_freq=7)
    lum = 0.75 + 0.5 * (_value_noise(u, v, rng, octaves=2, base_freq=23) - 0.5)
    c0, c1, c2 = palette
    rgb = (
        c0[None, :] * a[:, None]
        + c1[None, :] * (1.0 - a)[:, None]
        + c2[None, :] * (b[:, None] - 0.5) * 0.6
    ) * lum[:, None]
    return np.clip(rgb, 0.03, 0.97).astype(np.float32)


def _normal_quat(normals):
    """wxyz quats rotating +z to each normal (for tangent-flat splats)."""
    z = np.array([0.0, 0.0, 1.0])
    n = normals / np.linalg.norm(normals, axis=1, keepdims=True)
    axis = np.cross(np.broadcast_to(z, n.shape), n)
    s = np.linalg.norm(axis, axis=1)
    c = n @ z
    q = np.zeros((len(n), 4), np.float32)
    ok = s > 1e-8
    half = np.arctan2(s[ok], c[ok]) * 0.5
    q[ok, 0] = np.cos(half)
    q[ok, 1:] = axis[ok] / s[ok, None] * np.sin(half)[:, None]
    q[~ok, 0] = 1.0  # n ~ +z (or -z: symmetric splat, identity is fine)
    return q


def make_gt_scene_textured(seed: int, device="cuda"):
    """Opaque *surface* ground truth: a textured ground plane, spheres and a
    box, all built from tangent-flat high-opacity splats with procedural
    texture. Unlike the volumetric cluster scene (whose novel views are
    underdetermined — BASELINE.md round 2), these surfaces make held-out
    PSNR a real generalization metric (VERDICT r2 missing #4 / next #5)."""
    rng = np.random.default_rng(seed)
    xyz_l, rgb_l, quat_l, scale_l = [], [], [], []

    def add(xyz, rgb, quats, scales):
        xyz_l.append(xyz.astype(np.float32))
        rgb_l.append(rgb.astype(np.float32))
        quat_l.append(quats.astype(np.float32))
        scale_l.append(scales.astype(np.float32))

    # ground plane y=-1.2 over [-4.5, 4.5]^2, jittered grid (big enough to
    # fill the frame below the horizon from the elevated orbit cameras)
    gn = 210
    gx, gz = np.meshgrid(np.linspace(0, 1, gn), np.linspace(0, 1, gn))
    u, v = gx.ravel(), gz.ravel()
    spacing = 9.0 / gn
    x = (u - 0.5) * 9.0 + rng.normal(scale=spacing * 0.15, size=gn * gn)
    z = (v - 0.5) * 9.0 + rng.normal(scale=spacing * 0.15, size=gn * gn)
    y = -1.2 + 0.05 * np.sin(x * 2.1) * np.cos(z * 1.7)  # gentle relief
    pal = (np.array([0.45, 0.52, 0.28]), np.array([0.62, 0.55, 0.38]),
           np.array([0.25, 0.3, 0.2]))
    rgb = _surface_color(u, v, rng, pal)
    nrm = np.stack([-0.105 * np.cos(x * 2.1) * np.cos(z * 1.7),
                    np.ones_like(x),
                    0.085 * np.sin(x * 2.1) * np.sin(z * 1.7)], 1)
    sc = np.full((gn * gn, 3), spacing * 0.75)
    sc[:, 2] = spacing * 0.06  # thin along the normal (local z)
    add(np.stack([x, y, z], 1), rgb, _normal_quat(nrm), sc)

    # spheres (fibonacci-sampled surfaces)
    spheres = [
        ((-1.1, -0.45, 0.6), 0.75, (np.array([0.7, 0.25, 0.2]),
                                    np.array([0.9, 0.75, 0.3]),
                                    np.array([0.3, 0.1, 0.1]))),
        ((1.2, -0.35, -0.4), 0.85, (np.array([0.2, 0.35, 0.7]),
                                  np.array([0.7, 0.8, 0.9]),
                                  np.array([0.1, 0.15, 0.3]))),
        ((0.1, -0.75, -1.4), 0.45, (np.array([0.75, 0.6, 0.2]),
                                    np.array([0.4, 0.2, 0.5]),
                                    np.array([0.2, 0.2, 0.1]))),
    ]
    for center, rad, spal in spheres:
        m = int(22000 * rad * rad)
        k = np.arange(m, dtype=np.float64)
        phi = np.arccos(1 - 2 * (k + 0.5) / m)
        theta = np.pi * (1 + 5 ** 0.5) * k
        n = np.stack([np.sin(phi) * np.cos(theta), np.cos(phi),
                      np.sin(phi) * np.sin(theta)], 1)
        pts = np.asarray(center) + rad * n
        su = (theta / (2 * np.pi)) % 1.0
        sv = phi / np.pi
        rgb = _surface_color(su, sv, rng, spal)
        sp = rad * np.sqrt(4 * np.pi / m)  # mean point spacing on the sphere
        sc = np.full((m, 3), sp * 0.8)
        sc[:, 2] = sp * 0.08
        add(pts, rgb, _normal_quat(n), sc)

    # box (5 visible faces), axis-aligned at (0.2,-0.9,1.5), half-extents
    bc = np.array([0.2, -0.9, 1.5])
    he = np.array([0.55, 0.3, 0.4])
    bpal = (np.array([0.55, 0.3, 0.55]), np.array([0.85, 0.8, 0.75]),
            np.array([0.2, 0.1, 0.2]))
    fn = 46
    fu, fv = np.meshgrid(np.linspace(0, 1, fn), np.linspace(0, 1, fn))
    fu, fv = fu.ravel(), fv.ravel()
    faces = [  # (axis, sign)
        (0, 1), (0, -1), (1, 1), (2, 1), (2, -1),
    ]
    for axis, sign in faces:
        a1, a2 = [i for i in range(3) if i != axis]
        pts = np.zeros((fn * fn, 3))
        pts[:, axis] = sign * he[axis]
        pts[:, a1] = (fu - 0.5) * 2 * he[a1]
        pts[:, a2] = (fv - 0.5) * 2 * he[a2]
        pts += bc
        nrm = np.zeros((fn * fn, 3))
        nrm[:, axis] = sign
        rgb = _surface_color(fu, fv, rng, bpal)
        sp = 2 * max(he[a1], he[a2]) / fn
        sc = np.full((fn * fn, 3), sp * 0.8)
        sc[:, 2] = sp * 0.08
        add(pts, rgb, _normal_quat(nrm), sc)

    xyz = np.concatenate(xyz_l)
    rgb = np.concatenate(rgb_l)
    quats = np.concatenate(quat_l)
    scales = np.concatenate(scale_l)
    n_total = len(xyz)

    op_logit = np.full((n_total, 1), 6.0, np.float32)  # opacity ~0.9975
    scene = _gt_scene(xyz, rgb, 0, device, scales=np.log(scales), opacity=op_logit,
                      quats=quats)
    print(f"textured GT: {n_total} surface splats "
          f"(ground {gn * gn}, spheres+box {n_total - gn * gn})")
    return scene


def make_gt_scene_hard(seed: int, device="cuda"):
    """Discriminating ground truth (VERDICT r4 next #4): opaque surfaces
    whose achievable held-out PSNR sits in the realistic 25-35 dB band —
    sub-splat-scale texture detail, view-dependent color on SH bands 1-2,
    and thin structures (poles + wires) that stress densification and
    anti-aliasing. A GT a framework can ace cannot expose quality
    regressions; this one can."""
    rng = np.random.default_rng(seed)
    xyz_l, rgb_l, quat_l, scale_l = [], [], [], []

    def add(xyz, rgb, quats, scales):
        xyz_l.append(xyz.astype(np.float32))
        rgb_l.append(rgb.astype(np.float32))
        quat_l.append(quats.astype(np.float32))
        scale_l.append(scales.astype(np.float32))

    def sharp_color(u, v, palette):
        base = _surface_color(u, v, rng, palette)
        # sub-splat-scale detail octave: spatial frequency well above the
        # GT splat spacing, so exact reconstruction is impossible and the
        # achievable PSNR lands in the realistic band
        fine = _value_noise(u, v, rng, octaves=2, base_freq=61) - 0.5
        return np.clip(base * (1.0 + 0.55 * fine[:, None]), 0.02, 0.98)

    # ground plane with strong relief + high-frequency texture
    gn = 300
    gx, gz = np.meshgrid(np.linspace(0, 1, gn), np.linspace(0, 1, gn))
    u, v = gx.ravel(), gz.ravel()
    spacing = 9.0 / gn
    x = (u - 0.5) * 9.0 + rng.normal(scale=spacing * 0.15, size=gn * gn)
    z = (v - 0.5) * 9.0 + rng.normal(scale=spacing * 0.15, size=gn * gn)
    relief = 0.09 * np.sin(x * 3.1) * np.cos(z * 2.6)
    y = -1.2 + relief
    pal = (np.array([0.45, 0.52, 0.28]), np.array([0.62, 0.55, 0.38]),
           np.array([0.25, 0.3, 0.2]))
    rgb = sharp_color(u, v, pal)
    nrm = np.stack([-0.28 * np.cos(x * 3.1) * np.cos(z * 2.6),
                    np.ones_like(x),
                    0.23 * np.sin(x * 3.1) * np.sin(z * 2.6)], 1)
    sc = np.full((gn * gn, 3), spacing * 0.75)
    sc[:, 2] = spacing * 0.06
    add(np.stack([x, y, z], 1), rgb, _normal_quat(nrm), sc)

    # five textured spheres
    spheres = [
        ((-1.4, -0.45, 0.7), 0.75), ((1.3, -0.3, -0.5), 0.9),
        ((0.1, -0.8, -1.5), 0.4), ((-0.4, -0.55, -0.2), 0.55),
        ((1.7, -0.75, 1.3), 0.45),
    ]
    pals = [
        (np.array([0.7, 0.25, 0.2]), np.array([0.9, 0.75, 0.3]),
         np.array([0.3, 0.1, 0.1])),
        (np.array([0.2, 0.35, 0.7]), np.array([0.7, 0.8, 0.9]),
         np.array([0.1, 0.15, 0.3])),
        (np.array([0.75, 0.6, 0.2]), np.array([0.4, 0.2, 0.5]),
         np.array([0.2, 0.2, 0.1])),
        (np.array([0.25, 0.6, 0.5]), np.array([0.85, 0.9, 0.7]),
         np.array([0.1, 0.25, 0.2])),
        (np.array([0.6, 0.45, 0.7]), np.array([0.9, 0.85, 0.9]),
         np.array([0.25, 0.15, 0.3])),
    ]
    for (center, rad), spal in zip(spheres, pals):
        m = int(30000 * rad * rad)
        k = np.arange(m, dtype=np.float64)
        phi = np.arccos(1 - 2 * (k + 0.5) / m)
        theta = np.pi * (1 + 5 ** 0.5) * k
        n = np.stack([np.sin(phi) * np.cos(theta), np.cos(phi),
                      np.sin(phi) * np.sin(theta)], 1)
        pts = np.asarray(center) + rad * n
        su = (theta / (2 * np.pi)) % 1.0
        sv = phi / np.pi
        rgb = sharp_color(su, sv, spal)
        sp = rad * np.sqrt(4 * np.pi / m)
        sc = np.full((m, 3), sp * 0.8)
        sc[:, 2] = sp * 0.08
        add(pts, rgb, _normal_quat(n), sc)

    # two boxes
    boxes = [
        (np.array([0.3, -0.9, 1.6]), np.array([0.55, 0.3, 0.4]),
         (np.array([0.55, 0.3, 0.55]), np.array([0.85, 0.8, 0.75]),
          np.array([0.2, 0.1, 0.2]))),
        (np.array([-1.9, -1.0, -1.1]), np.array([0.35, 0.2, 0.5]),
         (np.array([0.3, 0.5, 0.6]), np.array([0.75, 0.7, 0.55]),
          np.array([0.15, 0.2, 0.25]))),
    ]
    fn = 60
    fu, fv = np.meshgrid(np.linspace(0, 1, fn), np.linspace(0, 1, fn))
    fu, fv = fu.ravel(), fv.ravel()
    for bc, he, bpal in boxes:
        for axis, sign in [(0, 1), (0, -1), (1, 1), (2, 1), (2, -1)]:
            a1, a2 = [i for i in range(3) if i != axis]
            pts = np.zeros((fn * fn, 3))
            pts[:, axis] = sign * he[axis]
            pts[:, a1] = (fu - 0.5) * 2 * he[a1]
            pts[:, a2] = (fv - 0.5) * 2 * he[a2]
            pts += bc
            nrm = np.zeros((fn * fn, 3))
            nrm[:, axis] = sign
            rgb = sharp_color(fu, fv, bpal)
            sp = 2 * max(he[a1], he[a2]) / fn
            sc = np.full((fn * fn, 3), sp * 0.8)
            sc[:, 2] = sp * 0.08
            add(pts, rgb, _normal_quat(nrm), sc)

    # thin structures: a ring of poles with sagging wires between them —
    # sub-pixel-width geometry at viewing distance (densify + AA stress)
    n_poles = 14
    pole_tops = []
    for i in range(n_poles):
        ang = 2 * np.pi * i / n_poles
        px0, pz0 = 2.9 * np.cos(ang), 2.9 * np.sin(ang)
        ytop = 0.5 + 0.15 * np.sin(ang * 3)
        pole_tops.append((px0, ytop, pz0))
        m = 900
        t = rng.uniform(0, 1, m)
        th = rng.uniform(0, 2 * np.pi, m)
        r0 = 0.025
        py = -1.2 + t * (ytop + 1.2)
        pts = np.stack([px0 + r0 * np.cos(th), py, pz0 + r0 * np.sin(th)], 1)
        nrm = np.stack([np.cos(th), np.zeros(m), np.sin(th)], 1)
        shade = 0.25 + 0.25 * _value_noise(t, th / (2 * np.pi), rng,
                                           octaves=3, base_freq=9)
        rgb = np.stack([shade * 1.1, shade * 0.8, shade * 0.6], 1)
        sc = np.full((m, 3), 0.035)
        sc[:, 2] = 0.006
        add(pts, np.clip(rgb, 0.02, 0.98), _normal_quat(nrm), sc)

    for i in range(n_poles):
        a = np.asarray(pole_tops[i])
        b = np.asarray(pole_tops[(i + 1) % n_poles])
        m = 260
        t = np.linspace(0, 1, m)
        pts = a[None] * (1 - t[:, None]) + b[None] * t[:, None]
        pts[:, 1] -= 0.18 * np.sin(np.pi * t)  # sag
        rgb = np.full((m, 3), 0.12)
        q = np.zeros((m, 4), np.float32)
        q[:, 0] = 1.0
        sc = np.full((m, 3), 0.012)
        add(pts, rgb, q, sc)

    xyz = np.concatenate(xyz_l)
    rgb = np.concatenate(rgb_l)
    quats = np.concatenate(quat_l)
    scales = np.concatenate(scale_l)
    n_total = len(xyz)

    # view-dependent color: smooth per-splat SH bands 1-2 (band 3 zero) —
    # a reconstruction with wrong SH>=2 gradients cannot fit these
    f_rest = np.zeros((n_total, 15, 3), np.float32)
    f_rest[:, 0:3, :] = rng.normal(scale=0.12, size=(n_total, 3, 3))
    f_rest[:, 3:8, :] = rng.normal(scale=0.06, size=(n_total, 5, 3))
    op_logit = np.full((n_total, 1), 6.0, np.float32)
    scene = _gt_scene(xyz, rgb, 3, device, active_sh_degree=3, scales=np.log(scales),
                      opacity=op_logit, quats=quats, features_rest=f_rest)
    print(f"hard GT: {n_total} surface splats, SH bands 1-2 live, "
          f"{n_poles} poles + wires")
    return scene


def orbit_pose(i: int, n: int, radius: float, seed: int = 0,
               heights=(0.45, 1.1), target=(0.0, 0.0, 0.0)):
    """world->cam [R|t] rows for camera i on a two-height orbit ring."""
    ang = 2.0 * np.pi * i / n
    height = heights[i % len(heights)]
    pos = np.array(
        [radius * np.cos(ang), height, radius * np.sin(ang)], np.float64
    )
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], 0)  # world->cam rows
    t = -R @ pos
    return R, t


def main(argv=None):
    """Write the scene; returns the final pair budget and, per view, the
    pairs its kept render dropped and its render time in ms."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-views", type=int, default=24)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--n-splats", type=int, default=80_000)
    ap.add_argument("--n-points", type=int, default=20_000)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--fov-deg", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--style", default="clusters",
        choices=["clusters", "textured", "hard"],
        help="clusters: volumetric random splats (screen-stat proxy); "
        "textured: opaque procedural-texture surfaces (held-out PSNR is a "
        "real generalization metric); hard: texture detail below the splat "
        "scale, view-dependent colour and thin structures",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    import torch

    from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera
    from gaussian_splatting_lightning_tpu_torch.data.colmap import (
        rotmat_to_qvec,
        write_reconstruction,
    )
    from gaussian_splatting_lightning_tpu_torch.data.image_io import write_image
    from gaussian_splatting_lightning_tpu_torch.device import resolve_device
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.trainer import make_render

    device = resolve_device(args.device)
    out = Path(args.out)
    (out / "images").mkdir(parents=True, exist_ok=True)

    w, h = args.width, args.height
    fx = fy = (w * 0.5) / np.tan(np.radians(args.fov_deg) * 0.5)
    print(f"GT scene: {args.n_views} views {w}x{h} style={args.style}")
    if args.style == "textured":
        gt = make_gt_scene_textured(seed=args.seed, device=device)
        args.n_splats = gt.capacity
    elif args.style == "hard":
        gt = make_gt_scene_hard(seed=args.seed, device=device)
        args.n_splats = gt.capacity
    else:
        gt = make_gt_scene(args.n_splats, sh_degree=0, seed=args.seed, device=device)

    cameras = {1: (w, h, fx, fy, w / 2.0, h / 2.0)}
    images = {}
    dropped, render_ms = [], []
    max_pairs = 1 << 20
    rng = np.random.default_rng(args.seed + 1)
    bg = torch.zeros(3, device=device)
    render = make_render(w, h, TilingConfig(max_pairs=max_pairs))
    pose_kw = {}
    if args.style in ("textured", "hard"):
        # elevated ring looking at the ground plane: the textured surfaces
        # fill the frame (black background would inflate held-out PSNR)
        pose_kw = dict(heights=(1.7, 2.8), target=(0.0, -1.0, 0.0))
    for i in range(args.n_views):
        R, t = orbit_pose(i, args.n_views, args.radius, **pose_kw)
        cam = make_camera(np.concatenate([R, t[:, None]], 1), fx, fy, w, h, device=device)
        t0 = time.perf_counter()
        while True:  # adaptive budget: re-render on overflow
            out_r, stats = render(gt, cam, bg)
            n_dropped = int(stats["num_dropped_pairs"])  # waits for the render
            if n_dropped == 0:
                break
            max_pairs *= 2
            render = make_render(w, h, TilingConfig(max_pairs=max_pairs))
            print(f"  overflow at view {i}: growing pair budget to {max_pairs}")
        render_ms.append((time.perf_counter() - t0) * 1e3)
        dropped.append(n_dropped)
        img8 = (torch.clamp(out_r.image, 0.0, 1.0).permute(1, 2, 0) * 255.0 + 0.5
                ).to(torch.uint8).cpu().numpy()
        name = f"frame_{i:04d}.png"
        write_image(out / "images" / name, img8)
        images[i + 1] = (rotmat_to_qvec(R), t, 1, name)
        print(f"  rendered {name} ({render_ms[-1]:.1f} ms)")

    # SfM-like sparse point cloud: noisy subsample of GT splat centers
    sel = rng.choice(args.n_splats, size=min(args.n_points, args.n_splats),
                     replace=False)
    pts = gt.params.xyz.cpu().numpy()[sel] + rng.normal(
        scale=0.01, size=(len(sel), 3)
    ).astype(np.float32)
    cols = gt.params.features_dc.cpu().numpy()[sel, 0] * SH0_TO_RGB + 0.5
    write_reconstruction(out / "sparse" / "0", cameras, images, pts,
                         np.clip(cols, 0, 1), error=0.5)
    print(f"wrote COLMAP model + {args.n_views} images under {out}")
    return {"max_pairs": max_pairs, "dropped": dropped, "render_ms": render_ms}


if __name__ == "__main__":
    main()
