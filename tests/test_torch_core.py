"""The port's core math (camera, transforms, SH) against the JAX package.

Inputs are made from a seed with numpy and fed to both sides on the CPU;
floats agree at rtol=1e-5, atol=1e-6 (float32, same op order), integer
outputs exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussian_splatting_lightning_tpu.core import camera as jcam
from gaussian_splatting_lightning_tpu.core import sh as jsh
from gaussian_splatting_lightning_tpu.core import transforms as jtf
from gaussian_splatting_lightning_tpu_torch.core import camera as tcam
from gaussian_splatting_lightning_tpu_torch.core import sh as tsh
from gaussian_splatting_lightning_tpu_torch.core import transforms as ttf

RTOL, ATOL = 1e-5, 1e-6


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=RTOL, atol=ATOL)


def _pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return np.concatenate([R, rng.normal(size=(3, 1))], 1)


def _splats(n=400, seed=3):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 1.5
    means[:, 2] += 4.0
    means[0] = [0.05, -0.02, 1e-2]  # a splat just off the camera plane
    scales = np.exp(rng.uniform(-4, -1, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    return means, scales, quats, opac


def _cams(w=128, h=96):
    pose = np.concatenate([np.eye(3), [[0.0], [0.0], [0.0]]], 1)
    jc = jcam.make_camera(pose, 90.0, 92.0, w, h)
    tc = tcam.make_camera(pose, 90.0, 92.0, w, h, device="cpu")
    return jc, tc


def test_camera_matrices_match():
    rng = np.random.default_rng(0)
    pose = _pose(rng)
    np.testing.assert_array_equal(
        jcam.get_projection_matrix(80.0, 70.0, 128, 96, 0.01, 100.0),
        tcam.get_projection_matrix(80.0, 70.0, 128, 96, 0.01, 100.0),
    )
    jc = jcam.make_camera(pose, 80.0, 70.0, 128, 96)
    tc = tcam.make_camera(pose, 80.0, 70.0, 128, 96, device="cpu")
    for f in ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy"):
        close(getattr(jc, f), getattr(tc, f))
        assert getattr(tc, f).dtype == torch.float32
    args = [np.asarray(getattr(jc, f)) for f in
            ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy")]
    tc2 = tcam.camera_from_matrices(*args, device="cpu")
    for f, a in zip(("viewmatrix", "projmatrix", "campos"), args):
        np.testing.assert_array_equal(getattr(tc2, f).numpy(), a)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the error path needs a CPU-only one")
    pose = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    with pytest.raises(RuntimeError, match="cuda"):
        tcam.make_camera(pose, 80.0, 70.0, 128, 96)


def test_quat_cov3d_match():
    means, scales, quats, _ = _splats()
    close(jtf.quat_to_rotmat(jnp.asarray(quats)), ttf.quat_to_rotmat(torch.from_numpy(quats)))
    close(jtf.normalize_quat(jnp.asarray(quats * 3)),
          ttf.normalize_quat(torch.from_numpy(quats * 3)))
    close(jtf.build_cov3d(jnp.asarray(scales), jnp.asarray(quats), 1.3),
          ttf.build_cov3d(torch.from_numpy(scales), torch.from_numpy(quats), 1.3))


@pytest.mark.parametrize("antialias", [False, True])
def test_projection_conic_radius_match(antialias):
    means, scales, quats, opac = _splats()
    jc, tc = _cams()
    w, h = 128, 96
    fx, fy = (w * 0.5) / jc.tanfovx, (h * 0.5) / jc.tanfovy
    tfx, tfy = (w * 0.5) / tc.tanfovx, (h * 0.5) / tc.tanfovy
    jcov = jtf.build_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    tcov = ttf.build_cov3d(torch.from_numpy(scales), torch.from_numpy(quats))
    j2 = jtf.project_cov3d_ewa(jnp.asarray(means), jcov, jc.viewmatrix, fx, fy,
                               jc.tanfovx, jc.tanfovy)
    t2 = ttf.project_cov3d_ewa(torch.from_numpy(means), tcov, tc.viewmatrix, tfx,
                               tfy, tc.tanfovx, tc.tanfovy)
    close(j2, t2)
    jout = jtf.conic_and_radius(j2, antialias)
    tout = ttf.conic_and_radius(t2, antialias)
    for name, a, b in zip(("conic", "radius", "valid", "opacity_scale", "lam_max"),
                          jout, tout):
        assert np.isfinite(b.numpy()).all(), name
        if name in ("radius", "valid"):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
        else:
            close(a, b)
    jr = jtf.tight_radius(jnp.asarray(opac), jout[4], 1.0 / 255.0)
    tr = ttf.tight_radius(torch.from_numpy(opac), tout[4], 1.0 / 255.0)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    assert np.isfinite(tr.numpy()).all()


def test_ndc_pix_and_tile_rect_match():
    means, _, _, _ = _splats()
    jc, tc = _cams()
    jndc = jtf.apply_projection(jnp.asarray(means), jc.projmatrix)
    tndc = ttf.apply_projection(torch.from_numpy(means), tc.projmatrix)
    close(jndc, tndc)
    jpix = jtf.ndc_to_pix(jndc, 128, 96)
    tpix = ttf.ndc_to_pix(tndc, 128, 96)
    close(jpix, tpix)
    assert np.isfinite(tpix.numpy()).all()
    rng = np.random.default_rng(1)
    pix = rng.uniform(-40, 170, size=(500, 2)).astype(np.float32)
    rad = np.ceil(rng.uniform(0, 60, size=500)).astype(np.float32)
    for blk in (16, 32):
        jr = jtf.tile_rect(jnp.asarray(pix), jnp.asarray(rad), 8, 6, blk, blk)
        tr = ttf.tile_rect(torch.from_numpy(pix), torch.from_numpy(rad), 8, 6, blk, blk)
        for a, b in zip(jr, tr):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_banded_match(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(size=(300, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    j = jsh.eval_sh_banded(jnp.asarray(sh), jnp.asarray(dirs), jnp.int32(degree), 3)
    t = tsh.eval_sh_banded(torch.from_numpy(sh), torch.from_numpy(dirs), degree, 3)
    close(j, t)
    campos = np.array([0.1, -0.2, -3.0], np.float32)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    close(jsh.sh_to_rgb(jnp.asarray(sh), jnp.asarray(pts), jnp.asarray(campos), degree),
          tsh.sh_to_rgb(torch.from_numpy(sh), torch.from_numpy(pts),
                        torch.from_numpy(campos), degree))
    assert tsh.num_sh_coeffs(degree) == jsh.num_sh_coeffs(degree)
    rgb = rng.uniform(size=(10, 3)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jsh.rgb_to_sh0(rgb)), tsh.rgb_to_sh0(rgb))
    sh0 = torch.from_numpy(sh[:, 0])
    close(jsh.sh0_to_rgb(jnp.asarray(sh[:, 0])), tsh.sh0_to_rgb(sh0))


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_match(degree):
    """``eval_sh`` at its static degree against the JAX function (its einsum
    sums each band in another order: the core tolerance, f32), and the
    degree's range refused as JAX refuses it."""
    rng = np.random.default_rng(10 + degree)
    sh = rng.normal(size=(2, 150, (degree + 1) ** 2, 3)).astype(np.float32)
    dirs = rng.normal(size=(2, 150, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    close(jsh.eval_sh(jnp.asarray(sh), jnp.asarray(dirs), degree),
          tsh.eval_sh(torch.from_numpy(sh), torch.from_numpy(dirs), degree))
    for bad in (-1, 5):
        with pytest.raises(ValueError, match="degree must be in"):
            tsh.eval_sh(torch.from_numpy(sh), torch.from_numpy(dirs), bad)
        with pytest.raises(ValueError, match="degree must be in"):
            jsh.eval_sh(jnp.asarray(sh), jnp.asarray(dirs), bad)


def test_cov3d_to_matrix_match():
    """The symmetric matrix of a covariance's upper triangle: the JAX
    function's bits, for a stack and for one covariance."""
    _, scales, quats, _ = _splats()
    cov = jtf.build_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    for c in (np.array(cov).reshape(4, 100, 6), np.array(cov)[0]):
        want = np.asarray(jtf.cov3d_to_matrix(jnp.asarray(c)))
        got = ttf.cov3d_to_matrix(torch.from_numpy(c))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), np.swapaxes(got.numpy(), -1, -2))
