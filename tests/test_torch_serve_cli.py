"""The port's serving and evaluation entry points against the JAX package's,
on the CPU (``--device cpu``) at tiny sizes.

- ``.splat`` export: ``scene_to_splat_bytes`` byte-identical to JAX's on a
  scene with dead slots, and the export CLIs write identical files.
- Path interpolation: ``slerp`` and ``interpolate_path`` within 1e-12 of
  JAX's (float64 numpy in both).
- The render-path CLI's frames above 60 dB PSNR against the JAX CLI's (the
  port renders through the kernel route's plain versions, the JAX CLI
  through its XLA route), and its GIF decodes (``imageio``) to the frames
  within the palette's quantisation.
- The eval CLI's PSNR within 1e-3 dB and SSIM within 1e-4 of the JAX
  CLI's, with and without ``--use-oracle``; with ``--lpips-weights`` its
  LPIPS rows within 1e-5 relative of the JAX CLI's.
- The generator: the COLMAP files byte-identical to the JAX generator's,
  every pixel within one 8-bit level and at least 99.9% equal for
  ``clusters``; the ``textured`` and ``hard`` GT arrays identical.
- The viewer: the HTML is a byte-identical copy of the JAX file and carries
  the pipeline constants; the view server serves the same bytes as JAX's.
- ``profile_render --device cpu`` prints its table and writes a trace.
"""

import json
import struct
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussian_splatting_lightning_tpu.models import gaussians as jgm
from gaussian_splatting_lightning_tpu.models.splat_export import (
    scene_to_splat_bytes as jax_splat_bytes,
)
from gaussian_splatting_lightning_tpu.viewer import VIEWER_HTML as JAX_HTML
from gaussian_splatting_lightning_tpu_torch.data.image_io import read_image
from gaussian_splatting_lightning_tpu_torch.models.splat_export import scene_to_splat_bytes
from gaussian_splatting_lightning_tpu_torch.scripts import (
    eval as port_eval,
    export_splat as port_export,
    make_synthetic_scene as port_gen,
    profile_render,
    render_path as port_path,
    view as port_view,
)
from gaussian_splatting_lightning_tpu_torch.viewer import VIEWER_HTML
from scripts import make_synthetic_scene as jax_gen
from scripts import render_path as jax_path
from tests.torch_parity import jax_scene, port_scene, psnr

W, H = 64, 48
GEN_ARGS = ["--n-views", "3", "--width", str(W), "--height", str(H), "--n-splats", "400",
            "--n-points", "150", "--seed", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_jax_cli(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["cli"] + [str(a) for a in argv])
    return module.main()


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same tiny scene written by the JAX and the port generator, and a
    checkpoint PLY of another scene to render it with."""
    root = tmp_path_factory.mktemp("gen")
    mp = pytest.MonkeyPatch()
    try:
        run_jax_cli(jax_gen, ["--out", root / "jax"] + GEN_ARGS, mp)
    finally:
        mp.undo()
    port_gen.main(["--out", str(root / "port"), "--device", "cpu"] + GEN_ARGS)
    ckpt = root / "ckpt.ply"
    jgm.save_ply(jax_scene(600, 600, seed=9, scale=0.06, aniso=True), ckpt)
    return root, ckpt


# ---- .splat export --------------------------------------------------------

def test_splat_bytes_match_jax_with_dead_slots(scenes, tmp_path):
    js = jax_scene(300, 400, seed=6, dead_every=4)
    got = scene_to_splat_bytes(port_scene(js))
    assert got == jax_splat_bytes(js)
    assert len(got) == 32 * int(np.asarray(js.alive).sum())
    _, ckpt = scenes
    n = port_export.main([str(ckpt), "--out", str(tmp_path / "port.splat"), "--device", "cpu"])
    from scripts import export_splat as jax_export

    mp = pytest.MonkeyPatch()
    try:
        run_jax_cli(jax_export, [ckpt, "--out", tmp_path / "jax.splat"], mp)
    finally:
        mp.undo()
    data = (tmp_path / "port.splat").read_bytes()
    assert n == 600 and data == (tmp_path / "jax.splat").read_bytes()


# ---- path interpolation ---------------------------------------------------

def test_slerp_and_path_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        q0, q1 = rng.normal(size=(2, 4))
        q0, q1 = q0 / np.linalg.norm(q0), q1 / np.linalg.norm(q1)
        for t in (0.0, 0.3, 0.999):
            np.testing.assert_allclose(port_path.slerp(q0, q1, t), jax_path.slerp(q0, q1, t),
                                       rtol=0, atol=1e-12)
    keys = []
    for _ in range(5):
        q = rng.normal(size=4)
        keys.append((jax_path.quat_to_rotmat(q / np.linalg.norm(q)), rng.normal(size=3)))
    for loop in (False, True):
        got = list(port_path.interpolate_path(keys, 17, loop))
        want = list(jax_path.interpolate_path(keys, 17, loop))
        assert len(got) == len(want) == 17
        for (r1, c1), (r2, c2) in zip(got, want):
            np.testing.assert_allclose(r1, r2, rtol=0, atol=1e-12)
            np.testing.assert_allclose(c1, c2, rtol=0, atol=1e-12)


# ---- the render-path CLI --------------------------------------------------

def test_render_path_cli_matches_jax_cli(scenes, tmp_path, monkeypatch):
    root, ckpt = scenes
    scene = root / "jax"
    common = [str(ckpt), "--colmap", str(scene), "--image-folder", str(scene / "images"),
              "--n-frames", "5", "--loop"]
    res = port_path.main(common + ["--out", str(tmp_path / "port"), "--gif",
                                   str(tmp_path / "port.gif"), "--device", "cpu"])
    assert res["frames"] == 5 and res["dropped_pairs"] == 0
    run_jax_cli(jax_path, common + ["--out", tmp_path / "jax"], monkeypatch)
    import imageio.v2 as imageio

    frames = [read_image(tmp_path / "port" / f"frame_{i:05d}.png") for i in range(5)]
    for i, got in enumerate(frames):
        want = np.asarray(imageio.imread(tmp_path / "jax" / f"frame_{i:05d}.png"))
        assert got.shape == want.shape == (H, W, 3)
        assert got.std() > 1.0  # the splats are in view
        assert psnr(got / 255.0, want / 255.0) > 60.0, i
    gif = imageio.mimread(tmp_path / "port.gif")
    assert len(gif) == 5
    for got, png in zip(gif, frames):
        rgb = np.asarray(got)[..., :3]
        assert rgb.shape == png.shape
        assert len(np.unique(rgb.reshape(-1, 3), axis=0)) <= 256
        # one 256-colour palette per frame: 27.9-28.7 dB on these
        # random-colour frames
        assert psnr(rgb / 255.0, png / 255.0) > 25.0


# ---- the eval CLI ---------------------------------------------------------

@pytest.mark.parametrize("oracle", [False, True])
def test_eval_cli_matches_jax_cli(scenes, tmp_path, monkeypatch, oracle):
    root, ckpt = scenes
    scene = root / "jax"
    common = [str(ckpt), "--colmap", str(scene), "--image-folder", str(scene / "images"),
              "--holdout-every", "2"] + (["--use-oracle"] if oracle else [])
    got = port_eval.main(common + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    from scripts import eval as jax_eval

    run_jax_cli(jax_eval, common + ["--out", tmp_path / "jax.json"], monkeypatch)
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got == json.loads((tmp_path / "port.json").read_text())
    assert [r["view"] for r in got["views"]] == [r["view"] for r in want["views"]]
    assert len(got["views"]) == 2
    for a, b in zip(got["views"] + [got["mean"]], want["views"] + [want["mean"]]):
        assert abs(a["psnr"] - b["psnr"]) <= 1e-3, (a, b)
        assert abs(a["ssim"] - b["ssim"]) <= 1e-4, (a, b)
        assert abs(a["l1"] - b["l1"]) <= 1e-4, (a, b)


def test_eval_cli_refuses_lpips(scenes, tmp_path, monkeypatch, capsys):
    """``--lpips-weights`` (no longer refused): the port CLI's LPIPS rows,
    mean and printed lines against the JAX CLI's on seeded random weights
    in the export layout; LPIPS within 1e-5 relative (``ops/lpips.py``'s
    bound; the renders differ by less than the PSNR bound above)."""
    from tests.test_metrics import _random_weights

    root, ckpt = scenes
    scene = root / "jax"
    weights = tmp_path / "lpips_vgg16.npz"
    np.savez(weights, **_random_weights(np.random.default_rng(3)))
    common = [str(ckpt), "--colmap", str(scene), "--image-folder", str(scene / "images"),
              "--holdout-every", "2", "--lpips-weights", str(weights)]
    got = port_eval.main(common + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    from scripts import eval as jax_eval

    run_jax_cli(jax_eval, common + ["--out", tmp_path / "jax.json"], monkeypatch)
    jax_lines = capsys.readouterr().out.splitlines()
    want = json.loads((tmp_path / "jax.json").read_text())
    assert set(got["mean"]) == set(want["mean"]) == {"psnr", "ssim", "l1", "lpips"}
    assert len(got["views"]) == len(want["views"]) == 2
    for a, b in zip(got["views"] + [got["mean"]], want["views"] + [want["mean"]]):
        assert b["lpips"] > 0
        assert abs(a["lpips"] - b["lpips"]) <= 1e-5 * b["lpips"], (a, b)
    assert all(v["lpips_ms"] > 0 for v in got["views"])
    # a printed lpips= on each view's line and the mean's, as the JAX CLI's
    ours = [x.split(":")[0] for x in port_lines if " lpips=" in x]
    theirs = [x.split(":")[0] for x in jax_lines if " lpips=" in x]
    assert ours == theirs and len(ours) == 3


# ---- the generator --------------------------------------------------------

def test_generator_matches_jax(scenes):
    root, _ = scenes
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        a = (root / "jax" / "sparse" / "0" / name).read_bytes()
        b = (root / "port" / "sparse" / "0" / name).read_bytes()
        assert a == b, name
    import imageio.v2 as imageio

    names = sorted(p.name for p in (root / "jax" / "images").glob("*.png"))
    assert names == sorted(p.name for p in (root / "port" / "images").glob("*.png"))
    assert len(names) == 3
    for name in names:
        want = np.asarray(imageio.imread(root / "jax" / "images" / name)).astype(int)
        got = read_image(root / "port" / "images" / name).astype(int)
        assert got.shape == want.shape == (H, W, 3)
        assert np.abs(got - want).max() <= 1, name
        assert np.mean(got == want) >= 0.999, name
        assert got.std() > 1.0


@pytest.mark.parametrize("style", ["textured", "hard"])
def test_generator_gt_styles_match_jax(style):
    fn = f"make_gt_scene_{style}"
    want = getattr(jax_gen, fn)(seed=3)
    got = getattr(port_gen, fn)(seed=3, device="cpu")
    for name in ("xyz", "features_dc", "features_rest", "opacity", "scales", "quats"):
        np.testing.assert_array_equal(getattr(got.params, name).numpy(),
                                      np.asarray(getattr(want.params, name)), err_msg=name)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    assert got.active_sh_degree == int(want.active_sh_degree)


# ---- the viewer -----------------------------------------------------------

def test_viewer_html_is_the_jax_copy():
    assert VIEWER_HTML.read_bytes() == JAX_HTML.read_bytes()
    src = VIEWER_HTML.read_text()
    # value-spec constants shared with ops/common.py and core/transforms.py
    assert "+ 0.3" in src and "1.3 * tanx" in src and "1.3 * tany" in src
    assert "min(0.99" in src and "1.0 / 255.0" in src and "3.0 * sqrt" in src
    # the 32-byte .splat record and the inverse of the exporter's q * 128 + 128
    assert "i * 8" in src and "b + 24" in src and "b + 28" in src
    assert "- 128) / 128" in src


def fetch(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10).read()


def test_view_server_serves_what_jax_serves(scenes, tmp_path):
    _, ckpt = scenes
    from scripts.view import make_handler as jax_handler

    js = jgm.load_ply(str(ckpt))
    jax_server = ThreadingHTTPServer(
        ("127.0.0.1", 0), jax_handler(JAX_HTML.read_bytes(), jax_splat_bytes(js)))
    servers = [port_view.make_server(str(ckpt), port=0, device="cpu")[0], jax_server]
    splat = tmp_path / "scene.splat"
    splat.write_bytes(jax_splat_bytes(js))
    servers.append(port_view.make_server(str(splat), port=0)[0])
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    try:
        ports = [s.server_address[1] for s in servers]
        pages = [fetch(p, "/") for p in ports]
        blobs = [fetch(p, "/scene.splat") for p in ports]
        assert pages[0] == pages[1] == pages[2] and b"webgl2" in pages[0]
        assert blobs[0] == blobs[1] == blobs[2] and len(blobs[0]) == 32 * 600
        with pytest.raises(urllib.error.HTTPError) as err:
            fetch(ports[0], "/etc/passwd")
        assert err.value.code == 404
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    rec = struct.unpack("<6f", blobs[0][:24])
    assert all(np.isfinite(rec))


# ---- the profiler ---------------------------------------------------------

@pytest.mark.parametrize("impl", ["cuda", "xla"])
def test_profile_render_prints_its_table(tmp_path, capsys, impl):
    rows, trace_dir = profile_render.main(
        ["--width", "48", "--height", "32", "--splats", "300", "--iters", "1", "--top", "6",
         "--impl", impl, "--trace-dir", str(tmp_path), "--device", "cpu"]
        + (["--grad"] if impl == "xla" else []))
    text = capsys.readouterr().out
    assert "ms/iter" in text and "host (CPU) self time" in text
    assert 0 < len(rows) <= 6 and all(r[0][:40] in text for r in rows)
    traces = list(Path(trace_dir).glob("trace-*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
