"""The port's render CLI (``--device cpu``) against the JAX package's, on a
tiny COLMAP scene from ``scripts/make_synthetic_scene.py``.

The port's render matches the JAX CLI's XLA-path render at PSNR > 60 dB, and
the two triptychs agree panel by panel to one 8-bit level; so do the two
CLIs' ``--use-oracle`` renders.
"""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gaussian_splatting_lightning_tpu.core.camera import Camera
from gaussian_splatting_lightning_tpu.data import ColmapDataset
from gaussian_splatting_lightning_tpu.models import gaussians as jgm
from gaussian_splatting_lightning_tpu.ops.budget import pair_budget
from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import TilingConfig
from gaussian_splatting_lightning_tpu.training.trainer import render_scene, resolve_rasterizer
from gaussian_splatting_lightning_tpu_torch.data.image_io import read_image
from gaussian_splatting_lightning_tpu_torch.scripts import render as port_cli
from tests.torch_parity import jax_scene, psnr

W, H = 64, 48


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    argv = sys.argv
    sys.argv = ["make_synthetic_scene", "--out", str(root), "--n-views", "2",
                "--width", str(W), "--height", str(H), "--n-splats", "400",
                "--n-points", "200"]
    try:
        from scripts.make_synthetic_scene import main

        main()
    finally:
        sys.argv = argv
    ckpt = root / "ckpt.ply"
    jgm.save_ply(jax_scene(600, 600, seed=9, scale=0.06, aniso=True), ckpt)
    return root, ckpt


def _jax_xla_render(root, ckpt, index):
    """What the JAX CLI computes on the CPU (its ``xla`` path)."""
    scene = jgm.load_ply(str(ckpt))
    ds = ColmapDataset(str(root), str(root / "images"), preload_data=False)
    view = ds[index]
    h, w = view.image.shape[-2:]
    cam = Camera(*(jnp.asarray(getattr(view, f)) for f in
                   ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy")))
    tiling = TilingConfig(max_pairs=pair_budget(scene, cam, w, h, 16), tile_capacity=4096)
    out, _ = jax.jit(lambda s: render_scene(
        s, cam, w, h, jnp.asarray(view.background), tiling,
        rasterize_fn=resolve_rasterizer("xla")))(scene)
    return np.asarray(out.image)


@pytest.mark.parametrize("image_idx", [None, 2])
def test_render_cli_matches_jax_cli(colmap_scene, tmp_path, monkeypatch, image_idx):
    root, ckpt = colmap_scene
    common = [str(ckpt), "--colmap", str(root), "--image-folder", str(root / "images")]
    if image_idx is not None:
        common += ["--image-idx", str(image_idx)]
    port_png = tmp_path / "port.png"
    image, depth = port_cli.main(common + ["--device", "cpu", "--out", str(port_png)])
    assert image.shape == (3, H, W) and depth.shape == (1, H, W)
    assert np.isfinite(image).all() and np.isfinite(depth).all()
    assert image.max() > 0.1  # the splats are in view

    ref = _jax_xla_render(root, ckpt, 0 if image_idx is None else 1)
    assert psnr(np.clip(ref, 0, 1), image) > 60.0

    jax_png = tmp_path / "jax.png"
    monkeypatch.setattr(sys, "argv", ["render"] + common + ["--out", str(jax_png)])
    from scripts.render import main as jax_cli

    jax_cli()
    import imageio.v2 as imageio

    a, b = np.asarray(imageio.imread(jax_png)), read_image(port_png)
    assert a.shape == b.shape == (H, 3 * W, 3)
    np.testing.assert_array_equal(a[:, :W], b[:, :W])  # ground truth panel
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_use_oracle_is_refused(colmap_scene, tmp_path, monkeypatch):
    """``--use-oracle`` renders through the port's oracle: the triptych
    agrees with the JAX CLI's ``--use-oracle`` triptych to one 8-bit level
    and the render with the kernel route's at PSNR > 60 dB."""
    root, ckpt = colmap_scene
    common = [str(ckpt), "--colmap", str(root), "--image-folder", str(root / "images"),
              "--image-idx", "2"]
    port_png = tmp_path / "port.png"
    image, depth = port_cli.main(common + ["--use-oracle", "--device", "cpu", "--out",
                                           str(port_png)])
    assert image.shape == (3, H, W) and depth.shape == (1, H, W) and image.max() > 0.1
    kernel_route, _ = port_cli.main(common + ["--device", "cpu", "--out",
                                              str(tmp_path / "route.png")])
    assert psnr(kernel_route, image) > 60.0

    jax_png = tmp_path / "jax.png"
    monkeypatch.setattr(sys, "argv", ["render"] + common + ["--use-oracle", "--out",
                                                            str(jax_png)])
    from scripts.render import main as jax_cli

    jax_cli()
    import imageio.v2 as imageio

    a, b = np.asarray(imageio.imread(jax_png)), read_image(port_png)
    assert a.shape == b.shape == (H, 3 * W, 3)
    np.testing.assert_array_equal(a[:, :W], b[:, :W])
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
