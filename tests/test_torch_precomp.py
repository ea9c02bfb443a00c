"""The rasterizer's precomputed inputs and scale modifier (the N1
rasterizer's ``colors_precomp``, ``cov3D_precomp`` and ``scale_modifier``)
on the port's three routes, against the JAX package.

- Junk SH and scales plus the precomputed RGB and covariance reproduce the
  derived render on every route (the JAX package's
  ``test_precomp_inputs_match_derived``, within its 1e-6).
- Each route against its JAX counterpart with the precomputed inputs (and a
  modifier of 0.7, unused beside a precomputed covariance), and with the
  modifier alone: image, depth and radii, and the gradients of
  <cotangent, render> on every input. Route "plain" (``rasterize`` on CPU
  tensors: the kernels' plain versions) against ``rasterize_pallas`` in
  interpret mode, the tiled route and the oracle against theirs. Tolerances
  are those of ``test_torch_rasterize.py`` (image and depth 2e-5, plain
  route) and ``test_torch_tiled.py`` / ``test_torch_oracle.py`` (1e-5), and
  for gradients ``test_torch_rasterize_bwd.py``'s early-stop share, 1e-4 of
  the largest |JAX gradient|. A replaced input gets no gradient: JAX returns
  zeros there, the port leaves it ``None``.
- A stack of two views with precomputed colours, one (N, 3) table for both,
  against two single-view JAX renders; its gradient is the sum of theirs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussian_splatting_lightning_tpu.core import transforms as jtf
from gaussian_splatting_lightning_tpu.core.camera import make_camera as jax_make_camera
from gaussian_splatting_lightning_tpu.ops.rasterize_pallas import rasterize_pallas
from gaussian_splatting_lightning_tpu.ops.rasterize_reference import (
    rasterize_reference as jax_oracle,
)
from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import TilingConfig as JaxTiling
from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import rasterize_tiled as jax_tiled
from gaussian_splatting_lightning_tpu_torch.core import sh as tsh
from gaussian_splatting_lightning_tpu_torch.core import transforms as ttf
from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera, stack_cameras
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.ops.rasterize import rasterize
from gaussian_splatting_lightning_tpu_torch.ops.rasterize_reference import rasterize_reference
from gaussian_splatting_lightning_tpu_torch.ops.rasterize_tiled import rasterize_tiled
from gaussian_splatting_lightning_tpu_torch.scripts.bench_batched import ring_pose

W, H, N = 96, 64, 600
BG = np.array([0.1, 0.2, 0.3], np.float32)
MAX_PAIRS = 1 << 14
TILED = dict(max_pairs=1 << 14, tile_capacity=512, chunk=32)
IMAGE_TOL = {"plain": 2e-5, "xla": 1e-5, "oracle": 1e-5}
GRAD_TOL = 1e-4
ROUTES = ("plain", "xla", "oracle")
INPUTS = ("means3d", "opacities", "scales", "quats", "sh", "colors_precomp",
          "cov3d_precomp")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions are loops of small ops: threads only add overhead,
    # and the test workers already share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(seed=5, n=N):
    """Activated splat parameters (SH degree 1), a precomputed RGB table in
    [0, 1] and a covariance table built from other scales, from a seed."""
    rng = np.random.default_rng(seed)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.04, 0.15, size=(n, 3)).astype(np.float32)
    x = {
        "means3d": (rng.normal(size=(n, 3)) * 1.2).astype(np.float32),
        "opacities": rng.uniform(0.2, 0.9, size=(n,)).astype(np.float32),
        "scales": scales,
        "quats": quats / np.linalg.norm(quats, axis=1, keepdims=True),
        "sh": (rng.normal(size=(n, 4, 3)) * 0.3).astype(np.float32),
        "colors_precomp": rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32),
    }
    other = scales * rng.uniform(0.6, 1.5, size=(n, 3)).astype(np.float32)
    x["cov3d_precomp"] = np.array(jtf.build_cov3d(jnp.asarray(other),
                                                    jnp.asarray(x["quats"])))
    return x


def pose(i=0):
    return ring_pose(i, 5) if i else np.concatenate(
        [np.eye(3), np.asarray([[0.0], [0.0], [4.0]])], 1)


def jax_cam(i=0):
    return jax_make_camera(pose(i), W * 0.7, W * 0.7, W, H)


def port_cam(i=0):
    return make_camera(pose(i), W * 0.7, W * 0.7, W, H, device="cpu")


def jax_render(route, x, cam, **kw):
    """(image, depth, radii) of a JAX route; ``x`` holds jnp arrays."""
    args = (x["means3d"], x["opacities"], x["scales"], x["quats"], x["sh"], cam, W, H,
            jnp.asarray(BG), jnp.asarray(1))
    if route == "plain":
        out, _ = rasterize_pallas(*args, config=JaxTiling(max_pairs=MAX_PAIRS, block=32,
                                                          pair_grad_bf16=False),
                                  max_sh_degree=1, interpret=True, **kw)
    elif route == "xla":
        out, _ = jax_tiled(*args, config=JaxTiling(**TILED), max_sh_degree=1, **kw)
    else:
        out = jax_oracle(*args, max_sh_degree=1, **kw)
    return out.image, out.depth, out.radii


def port_render(route, x, cam, **kw):
    """(image, depth, radii) of the port's route; ``x`` holds tensors."""
    args = (x["means3d"], x["opacities"], x["scales"], x["quats"], x["sh"], cam, W, H,
            torch.from_numpy(BG), 1)
    if route == "plain":
        out, _ = rasterize(*args, config=TilingConfig(max_pairs=MAX_PAIRS, block=32),
                           max_sh_degree=1, **kw)
    elif route == "xla":
        out, _ = rasterize_tiled(*args, config=TilingConfig(**TILED), max_sh_degree=1, **kw)
    else:
        out = rasterize_reference(*args, max_sh_degree=1, **kw)
    return out.image, out.depth, out.radii


@pytest.mark.parametrize("route", ROUTES)
def test_precomp_inputs_match_derived(route):
    """Feeding the RGB evaluated from the SH and the covariance built from
    scales and quats, with junk SH and scales beside them, reproduces the
    derived render: the precomputed inputs replace those quantities."""
    x = {k: torch.from_numpy(v) for k, v in make_inputs(3, 300).items()}
    cam = port_cam()
    base = port_render(route, x, cam)
    rgb = tsh.sh_to_rgb(x["sh"], x["means3d"], cam.campos, 1, 1)
    cov6 = ttf.build_cov3d(x["scales"], x["quats"], 1.0)
    junk = dict(x, sh=x["sh"] * 100.0 + 3.0, scales=x["scales"] * 7.0)
    via = port_render(route, junk, cam, colors_precomp=rgb, cov3d_precomp=cov6)
    for a, b in zip(via, base):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    assert float((base[0] - torch.from_numpy(BG)[:, None, None]).abs().max()) > 0.1


CASES = {
    # both tables, and a modifier that a precomputed covariance leaves unused
    "precomp": ({"scale_modifier": 0.7, "colors_precomp": True, "cov3d_precomp": True},
                ("means3d", "opacities", "colors_precomp", "cov3d_precomp")),
    # the modifier on the derived covariance
    "modifier": ({"scale_modifier": 0.7}, ("means3d", "opacities", "scales", "quats", "sh")),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("route", ROUTES)
def test_route_matches_jax(route, case):
    kw, live = CASES[case]
    x = make_inputs()
    ct_img = np.random.default_rng(1).normal(size=(3, H, W)).astype(np.float32)
    ct_dep = np.random.default_rng(2).normal(size=(1, H, W)).astype(np.float32)
    given = list(INPUTS[:5]) + [k for k in INPUTS[5:] if kw.get(k)]
    mod = {"scale_modifier": kw["scale_modifier"]}

    def split(xs):  # the five positional inputs, and the precomputed keywords
        return {k: xs[k] for k in INPUTS[:5]}, {k: xs[k] for k in INPUTS[5:] if k in xs}

    def jax_loss(xs):
        pos, pre = split(xs)
        img, dep, radii = jax_render(route, pos, jax_cam(), **mod, **pre)
        return jnp.sum(img * ct_img) + jnp.sum(dep * ct_dep), (img, dep, radii)

    grad_fn = jax.value_and_grad(jax_loss, has_aux=True)
    if route != "plain":
        grad_fn = jax.jit(grad_fn)
    (_, (jimg, jdep, jradii)), jg = grad_fn({k: jnp.asarray(x[k]) for k in given})

    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in given}
    pos, pre = split(leaves)
    img, dep, radii = port_render(route, pos, port_cam(), **mod, **pre)
    ((img * torch.from_numpy(ct_img)).sum() + (dep * torch.from_numpy(ct_dep)).sum()).backward()

    tol = IMAGE_TOL[route]
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), atol=tol, rtol=0)
    np.testing.assert_allclose(dep.detach().numpy(), np.asarray(jdep), atol=tol, rtol=0)
    np.testing.assert_array_equal(radii.detach().numpy(), np.asarray(jradii))
    assert float(img.detach().std()) > 0.01  # the splats are in view
    for k in given:
        want = np.asarray(jg[k])
        if k not in live:  # replaced: zeros in JAX, no gradient in the port
            assert not want.any() and leaves[k].grad is None, k
            continue
        scale = float(np.abs(want).max())
        assert scale > 0, k
        err = float(np.abs(leaves[k].grad.numpy() - want).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def test_stacked_views_with_precomputed_colors_match_jax():
    """Route "plain" on a stack of two views, one (N, 3) colour table for
    both, against two single-view ``rasterize_pallas`` renders in interpret
    mode: each view's image, depth and radii, and the colour table's
    gradient as the sum of the two views'."""
    x = make_inputs(7)
    cts = np.random.default_rng(4).normal(size=(2, 3, H, W)).astype(np.float32)
    keep = ("means3d", "opacities", "scales", "quats", "sh")
    jcols = jnp.asarray(x["colors_precomp"])
    want, jgrad = [], np.zeros_like(x["colors_precomp"])
    for v in range(2):
        def jax_loss(cols, v=v):
            img, dep, radii = jax_render("plain", {k: jnp.asarray(x[k]) for k in keep},
                                         jax_cam(v), colors_precomp=cols)
            return jnp.sum(img * cts[v]), (img, dep, radii)

        (_, out), g = jax.value_and_grad(jax_loss, has_aux=True)(jcols)
        want.append(out)
        jgrad += np.asarray(g)

    cols = torch.from_numpy(x["colors_precomp"]).requires_grad_()
    tx = {k: torch.from_numpy(x[k]) for k in keep}
    out, stats = rasterize(tx["means3d"], tx["opacities"], tx["scales"], tx["quats"], tx["sh"],
                           stack_cameras([port_cam(0), port_cam(1)]), W, H,
                           torch.from_numpy(BG), 1,
                           config=TilingConfig(max_pairs=MAX_PAIRS, block=32),
                           max_sh_degree=1, colors_precomp=cols)
    assert out.image.shape == (2, 3, H, W) and out.radii.shape == (2, N)
    (out.image * torch.from_numpy(cts)).sum().backward()
    assert int(stats["num_dropped_pairs"]) == 0
    for v, (jimg, jdep, jradii) in enumerate(want):
        np.testing.assert_allclose(out.image[v].detach().numpy(), np.asarray(jimg),
                                   atol=IMAGE_TOL["plain"], rtol=0)
        np.testing.assert_allclose(out.depth[v].detach().numpy(), np.asarray(jdep),
                                   atol=IMAGE_TOL["plain"], rtol=0)
        np.testing.assert_array_equal(out.radii[v].numpy(), np.asarray(jradii))
    assert float(np.abs(jgrad).max()) > 0
    assert float(np.abs(cols.grad.numpy() - jgrad).max()) <= GRAD_TOL * float(np.abs(jgrad).max())
