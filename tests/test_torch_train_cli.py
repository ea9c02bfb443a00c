"""The port's train CLI (``--device cpu``) against the JAX package's, both
in-process, on a 64x48, 4-view COLMAP scene that the port writes.

Both sides run with ``train.rasterizer=pallas_interpret``, 32 px tiles and
f32 pair gradients (the port maps the rasterizer to its kernel route, which
runs the plain versions on CPU tensors), and the port's split noise replays
JAX's ``jax.random.split`` sequence. Bounds: the alive count at every logged
step and in the final PLY exactly; the loss at every logged step, the final
one included, within 1e-5 relative (the coupled-step bound); the held-out
PSNR within 1e-4 dB. Then ``--resume auto`` restores the newest checkpoint
of the newest run.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussian_splatting_lightning_tpu_torch import interop
from gaussian_splatting_lightning_tpu_torch.core.camera import make_camera
from gaussian_splatting_lightning_tpu_torch.core.sh import SH_C0
from gaussian_splatting_lightning_tpu_torch.data import colmap, image_io
from gaussian_splatting_lightning_tpu_torch.models.ply import read_ply_vertices
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.scripts import train as port_cli
from gaussian_splatting_lightning_tpu_torch.training import trainer as ttrainer

W, H, VIEWS = 64, 48, 4
COMMON = ["--set", "train.rasterizer=pallas_interpret", "--set", "train.tiling.block=32",
          "--set", "train.tiling.pair_grad_bf16=false"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """GT splats rendered by the port on a ring of cameras, written as PNGs
    and a COLMAP model whose points are the GT centres plus noise."""
    root = tmp_path_factory.mktemp("scene")
    (root / "images").mkdir()
    gt = interop.synthetic_scene(300, 300, sh_degree=1, seed=4, scale=0.08, aniso=True,
                                 device="cpu")
    images = {}
    for i in range(VIEWS):
        ang = 2 * np.pi * i / VIEWS
        fwd = -np.array([np.cos(ang), 0.3, np.sin(ang)])
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], 0)
        t = -R @ (-4.0 * fwd)
        cam = make_camera(np.concatenate([R, t[:, None]], 1), 50.0, 50.0, W, H, device="cpu")
        out, _ = ttrainer.render_scene(gt, cam, W, H, torch.zeros(3),
                                       TilingConfig(max_pairs=1 << 15))
        img = np.moveaxis(out.image.clamp(0, 1).numpy(), 0, -1) * 255 + 0.5
        name = f"view_{i:03d}.png"
        image_io.write_image(root / "images" / name, img.astype(np.uint8))
        images[i + 1] = (colmap.rotmat_to_qvec(R), t, 1, name)
    rng = np.random.default_rng(2)
    xyz = gt.params.xyz.numpy() + rng.normal(size=(300, 3)).astype(np.float32) * 0.05
    rgb = np.clip(gt.params.features_dc[:, 0].numpy() * SH_C0 + 0.5, 0, 1)
    colmap.write_reconstruction(root / "sparse" / "0", {1: (W, H, 50.0, 50.0, W / 2, H / 2)},
                                images, xyz, rgb)
    return root


def write_config(path, root, out_dir):
    path.write_text(f"""
exp_name: cli
run_name: run
out_dir: {out_dir}
seed: 0
sh_degree: 1
capacity: 1024
data:
  colmap_path: {root}
  image_folder: {root / "images"}
  holdout_every: 4
train:
  num_iters: 30
  log_interval: 5
  overflow_check_interval: 5
  valid_interval: 15
  checkpoint_interval: 10
  seed: 3
  densify:
    densify_since: 5
    densify_interval: 5
    densify_until: 25
    densify_grad_threshold: 0.00005
    opacity_reset_interval: 1000
    sh_degree_step_interval: 10
  tiling:
    max_pairs: 16384
    tile_capacity: 256
    chunk: 64
""")


def jax_noise(self):
    """JAX's maybe_densify draw: key, sub = split(key); normal(sub)."""
    key = getattr(self, "_jax_key", None)
    if key is None:
        key = jax.random.PRNGKey(self.cfg.seed)
    self._jax_key, sub = jax.random.split(key)
    return torch.from_numpy(np.array(
        jax.random.normal(sub, (self.scene.capacity, 3), jnp.float32)))


def logs_of(run_dir, name):
    return [json.loads(line) for line in (run_dir / name).read_text().splitlines()]


def test_rotmat_to_qvec_matches_the_scene_script():
    from scripts.make_synthetic_scene import rotmat_to_qvec

    rng = np.random.default_rng(0)
    for _ in range(5):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R = q * np.sign(np.linalg.det(q))
        np.testing.assert_array_equal(colmap.rotmat_to_qvec(R), rotmat_to_qvec(R))


def test_train_cli_matches_jax_cli(scene_dir, tmp_path, monkeypatch, capsys):
    cfg = tmp_path / "cfg.yaml"
    write_config(cfg, scene_dir, tmp_path / "runs")
    monkeypatch.setattr(ttrainer.Trainer, "densify_noise", jax_noise)
    trainer = port_cli.main(["-c", str(cfg), "--out-dir", str(tmp_path / "port"),
                             "--device", "cpu"] + COMMON)
    monkeypatch.setattr(sys, "argv", ["train", "-c", str(cfg), "--out-dir",
                                      str(tmp_path / "jax")] + COMMON)
    from scripts.train import main as jax_cli

    jax_cli()
    (port_run,) = (tmp_path / "port" / "cli").iterdir()
    (jax_run,) = (tmp_path / "jax" / "cli").iterdir()
    pl, jl = logs_of(port_run, "train_log.jsonl"), logs_of(jax_run, "train_log.jsonl")
    assert [r["step"] for r in pl] == [r["step"] for r in jl] == list(range(0, 30, 5))
    assert [r["n_gaussians"] for r in pl] == [r["n_gaussians"] for r in jl]
    assert pl[-1]["n_gaussians"] > pl[0]["n_gaussians"]  # the densify events grew it
    for a, b in zip(pl, jl):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * b["loss"], a["step"]
    pv, jv = logs_of(port_run, "valid_log.jsonl"), logs_of(jax_run, "valid_log.jsonl")
    assert [r["step"] for r in pv] == [r["step"] for r in jv] == [15, 30]
    for a, b in zip(pv, jv):
        assert abs(a["valid_psnr"] - b["valid_psnr"]) <= 1e-4
    n_final = len(read_ply_vertices(port_run / "point_cloud-final.ply"))
    assert n_final == len(read_ply_vertices(jax_run / "point_cloud-final.ply"))
    assert n_final == trainer.scene.n_alive()
    assert json.loads((port_run / "config.json").read_text())["train"]["rasterizer"] == "cuda"
    assert sorted(p.name for p in port_run.glob("ckpt-*")) == [
        "ckpt-00000010", "ckpt-00000020", "ckpt-00000030"]
    assert trainer.scene.active_sh_degree == 1

    # --resume auto: the newest run by time, its newest checkpoint by step
    old = tmp_path / "port" / "cli" / "old-run" / "ckpt-00000099"
    old.mkdir(parents=True)
    past = time.time() - 1000
    os.utime(old, (past, past))
    capsys.readouterr()
    resumed = port_cli.main(["-c", str(cfg), "--out-dir", str(tmp_path / "port"),
                             "--device", "cpu", "--resume", "auto", "--iters", "0",
                             "--set", "run_name=resumed"] + COMMON)
    out = capsys.readouterr().out
    assert f"--resume auto: run {port_run.name}, step 30" in out
    assert resumed.step == 30
    assert torch.equal(resumed.scene.params.xyz, trainer.scene.params.xyz)


def test_train_cli_batched_matches_jax_cli(scene_dir, tmp_path, monkeypatch):
    """``--set train.batch_views=2`` (with exposure): the logs of both CLIs
    step for step, within the bounds of ``test_train_cli_matches_jax_cli``."""
    cfg = tmp_path / "cfg.yaml"
    write_config(cfg, scene_dir, tmp_path / "runs")
    sets = COMMON + ["--set", "train.batch_views=2", "--set", "train.use_exposure=true"]
    monkeypatch.setattr(ttrainer.Trainer, "densify_noise", jax_noise)
    trainer = port_cli.main(["-c", str(cfg), "--out-dir", str(tmp_path / "port"),
                             "--device", "cpu"] + sets)
    monkeypatch.setattr(sys, "argv", ["train", "-c", str(cfg), "--out-dir",
                                      str(tmp_path / "jax")] + sets)
    from scripts.train import main as jax_cli

    jax_cli()
    (port_run,) = (tmp_path / "port" / "cli").iterdir()
    (jax_run,) = (tmp_path / "jax" / "cli").iterdir()
    pl, jl = logs_of(port_run, "train_log.jsonl"), logs_of(jax_run, "train_log.jsonl")
    assert [r["step"] for r in pl] == [r["step"] for r in jl] == list(range(0, 30, 5))
    assert [r["n_gaussians"] for r in pl] == [r["n_gaussians"] for r in jl]
    assert pl[-1]["n_gaussians"] > pl[0]["n_gaussians"]
    for a, b in zip(pl, jl):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * b["loss"], a["step"]
        assert abs(a["psnr"] - b["psnr"]) <= 1e-4, a["step"]
    pv, jv = logs_of(port_run, "valid_log.jsonl"), logs_of(jax_run, "valid_log.jsonl")
    assert [r["step"] for r in pv] == [r["step"] for r in jv] == [15, 30]
    for a, b in zip(pv, jv):
        assert abs(a["valid_psnr"] - b["valid_psnr"]) <= 1e-4
    assert trainer.cfg.batch_views == 2
    assert json.loads((port_run / "config.json").read_text())["train"]["batch_views"] == 2
    # 30 steps of two draws from three train views: every exposure row moved
    moved = (trainer.exposure.params - torch.eye(3, 4)).abs().amax(dim=(1, 2))
    assert bool((moved > 0).all())
