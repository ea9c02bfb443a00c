"""The port's readable oracle rasterizer against the JAX package's.

``rasterize_reference`` (dense tile x splat membership, batched tiles)
matches JAX's on the same scene and camera: image, inverse depth and radii
within 1e-5, with and without ``reference_quirks``; every parameter
gradient within 1e-4 of its largest |value| against ``jax.grad``. It also
matches the port's ``"plain"`` route (the kernels' plain versions), at 16
and 32 px tiles, within 2e-4: the two decide the ``T > 1e-4`` weight rule
on transmittances rounded differently (a product of ``1 - alpha`` against a
running product), so one term of at most 1e-4 may flip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussian_splatting_lightning_tpu.ops.rasterize_reference import (
    mark_visible as jax_mark_visible,
    rasterize_reference as jax_oracle,
)
from gaussian_splatting_lightning_tpu_torch.ops import rasterize_reference as oracle_mod
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.ops.rasterize import rasterize
from gaussian_splatting_lightning_tpu_torch.ops.rasterize_reference import (
    mark_visible,
    rasterize_reference,
)
from tests.torch_parity import (
    BG,
    activated,
    assert_grads_close,
    cameras,
    jax_scene,
    port_scene,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the dense compositing is a few large ops: threads only contend with
    # the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("w,h,n", [(128, 96, 800), (72, 40, 300)])
def test_oracle_matches_jax(quirks, w, h, n):
    js = jax_scene(n, n + 200, seed=1, dead_every=7)
    ts = port_scene(js)
    jc, tc = cameras(w, h)
    want = jax_oracle(*activated(js, "jax"), jc, w, h, jnp.asarray(BG), js.active_sh_degree,
                      js.max_sh_degree, alive=js.alive, reference_quirks=quirks)
    got = rasterize_reference(*activated(ts, "torch"), tc, w, h, torch.from_numpy(BG),
                              ts.active_sh_degree, ts.max_sh_degree, alive=ts.alive,
                              reference_quirks=quirks)
    assert got.image.shape == (3, h, w) and got.depth.shape == (1, h, w)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.radii.numpy(), np.asarray(want.radii), rtol=0, atol=1e-5)
    assert float(got.image.std()) > 0.01  # the splats are in view


def test_oracle_batches_tiles(monkeypatch):
    """A batch of one tile and a batch of every tile give the same bits."""
    js = jax_scene(300, 300, seed=2)
    ts = port_scene(js)
    _, tc = cameras(48, 32)
    args = (*activated(ts, "torch"), tc, 48, 32, torch.from_numpy(BG), ts.active_sh_degree)
    whole = rasterize_reference(*args)
    monkeypatch.setattr(oracle_mod, "BATCH_EVALS", 1)
    single = rasterize_reference(*args)
    assert torch.equal(whole.image, single.image) and torch.equal(whole.depth, single.depth)


def test_oracle_gradients_match_jax():
    w, h = 64, 48
    js = jax_scene(400, 500, seed=3, dead_every=9)
    ts = port_scene(js)
    jc, tc = cameras(w, h)
    rng = np.random.default_rng(0)
    ct_img = rng.normal(size=(3, h, w)).astype(np.float32)
    ct_dep = rng.normal(size=(1, h, w)).astype(np.float32)

    def jax_loss(*x):
        out = jax_oracle(*x, jc, w, h, jnp.asarray(BG), js.active_sh_degree,
                         js.max_sh_degree, alive=js.alive)
        return jnp.sum(out.image * ct_img) + jnp.sum(out.depth * ct_dep)

    want = jax.jit(jax.grad(jax_loss, argnums=tuple(range(5))))(*activated(js, "jax"))
    xs = [t.requires_grad_() for t in activated(ts, "torch")]
    out = rasterize_reference(*xs, tc, w, h, torch.from_numpy(BG), ts.active_sh_degree,
                              ts.max_sh_degree, alive=ts.alive)
    loss = torch.sum(out.image * torch.from_numpy(ct_img)) + torch.sum(
        out.depth * torch.from_numpy(ct_dep))
    got = torch.autograd.grad(loss, xs)
    assert_grads_close(got, want)


@pytest.mark.parametrize("block", [16, 32])
def test_oracle_matches_plain_route(block):
    w, h = 96, 80
    ts = port_scene(jax_scene(600, 700, seed=4, dead_every=5))
    _, tc = cameras(w, h)
    x = activated(ts, "torch")
    common = (tc, w, h, torch.from_numpy(BG), ts.active_sh_degree)
    want = rasterize_reference(*x, *common, ts.max_sh_degree, alive=ts.alive)
    got, stats = rasterize(*x, *common, config=TilingConfig(max_pairs=1 << 14, block=block),
                           max_sh_degree=ts.max_sh_degree, alive=ts.alive, plain=True)
    assert int(stats["num_dropped_pairs"]) == 0
    assert float(torch.abs(got.image - want.image).max()) <= 2e-4
    assert float(torch.abs(got.depth - want.depth).max()) <= 2e-4
    assert torch.equal(got.radii, want.radii)


def test_mark_visible_matches_jax():
    js = jax_scene(500, 500, seed=5)
    ts = port_scene(js)
    jc, tc = cameras(64, 48)
    want = jax_mark_visible(js.params.xyz, jc.viewmatrix, jc.projmatrix)
    got = mark_visible(ts.params.xyz, tc.viewmatrix, tc.projmatrix)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
