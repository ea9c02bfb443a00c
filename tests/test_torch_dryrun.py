"""The port's ``scripts/dryrun_multichip.py`` on four gloo ranks on the CPU
against the JAX repo's ``dryrun_multichip(4)`` (``__graft_entry__.py``) on
four of the eight virtual devices.

The ranks run under ``torch.distributed.run`` (``tests/torch_dryrun_worker.py``,
one torch thread each: the script with the densify event's split noise
replaying JAX's draws, the one input the two trainers draw differently).
While they work, this process runs the JAX function's three passes through
its ``Trainer``, with the function's own configs, sizes and seeds (the
function prints its losses to four digits; the passes' histories hold them
whole). Bounds, and why:
- passes 1 and 2 (the (2, 2) mesh; JAX's route ``auto``, the tiled route
  on the CPU, against the port's ``cuda``, whose CPU tensors take the plain
  versions; then JAX's Pallas kernels in interpret mode against "plain"):
  the same logged steps and alive count, every loss within 1e-5 relative
  (the coupled-step bound of ``tests/test_torch_trainer.py``);
- pass 3 (a 1x4 tile mesh against one process, 15 steps): each last loss
  within 1e-4 relative of JAX's (15 Adam steps compound f32 summation
  order), the port's own asserts (|l1 - l2| < 2e-3, cross-PSNR > 45 dB);
- the three OK lines of the JAX function printed once, by rank 0.

With four cards the same script runs on four NCCL ranks, one per card
(marked ``cuda``; it skips here).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
TIMEOUT = 600
SEED = 42  # TrainConfig.seed: the key of JAX's split noise
CAP = 64  # pass 1's capacity

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _child_env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def jax_draws(n=2):
    """The first ``n`` split-noise draws of a JAX ``Trainer`` at ``SEED``:
    its ``maybe_densify`` splits the key and draws (capacity, 3) normals."""
    key, out = jax.random.PRNGKey(SEED), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (CAP, 3), jnp.float32)))
    return np.stack(out)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's dry run on four gloo ranks, started before the JAX side
    runs; yields a function that waits for it and returns (stdout, record)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    np.save(tmp / "noise.npy", jax_draws())
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(RANKS), str(ROOT / "tests" / "torch_dryrun_worker.py"), str(tmp / "noise.npy"),
         "--device", "cpu", "--out", str(tmp / "result.json")],
        cwd=str(ROOT), env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    done = {}

    def result():
        if not done:
            try:
                out, _ = proc.communicate(timeout=TIMEOUT)
            finally:
                if proc.poll() is None:
                    proc.kill()
            assert proc.returncode == 0, out[-4000:]
            done.update(out=out, rec=json.loads((tmp / "result.json").read_text()))
        return done["out"], done["rec"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_passes(port):
    """The JAX function's three passes (its lines 148-301) through its
    ``Trainer``; returns each pass's histories and alive counts."""
    del port  # started first: the ranks work while JAX runs here
    from gaussian_splatting_lightning_tpu.data.dataset import ViewItem
    from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import TilingConfig
    from gaussian_splatting_lightning_tpu.parallel import make_mesh
    from gaussian_splatting_lightning_tpu.training import DensifyConfig, TrainConfig, Trainer
    from gaussian_splatting_lightning_tpu.training.trainer import render_scene

    def items(gt, cams, w, h, tiling):
        out = []
        for cam in cams:
            img, _ = render_scene(gt, cam, w, h, jnp.zeros(3), tiling)
            out.append(ViewItem(image=np.asarray(img.image), viewmatrix=np.asarray(cam.viewmatrix),
                                projmatrix=np.asarray(cam.projmatrix),
                                campos=np.asarray(cam.campos), tanfovx=float(cam.tanfovx),
                                tanfovy=float(cam.tanfovy), background=np.zeros(3, np.float32)))
        return out

    def summary(tr):
        return {"losses": [h["loss"] for h in tr.history],
                "logged_steps": [h["step"] for h in tr.history],
                "n_alive": int(tr.scene.n_alive()), "steps": tr.step}

    quiet = dict(log_fn=lambda *a: None)
    res = {}
    view, tile = 2, RANKS // 2
    mesh = make_mesh(view=view, tile=tile)
    w, h = 64, 16 * tile
    cfg = TrainConfig(num_iters=3, capacity=CAP, log_interval=1, valid_interval=10_000,
                      checkpoint_interval=10_000,
                      tiling=TilingConfig(max_pairs=1 << 13, tile_capacity=64, chunk=32),
                      densify=DensifyConfig(densify_since=1, densify_interval=2,
                                            densify_until=10))
    views = items(graft._synthetic_scene(48, 48, sh_degree=2),
                  [graft._camera(w, h) for _ in range(2 * view)], w, h, cfg.tiling)
    tr = Trainer(cfg, graft._synthetic_scene(48, CAP, sh_degree=2, seed=3), 2.0, views,
                 mesh=mesh, **quiet)
    tr.train()
    res["pass1"] = summary(tr)
    cfg_p = dataclasses.replace(cfg, num_iters=1, rasterizer="pallas_interpret")
    tr = Trainer(cfg_p, graft._synthetic_scene(48, CAP, sh_degree=2, seed=3), 2.0, views,
                 mesh=mesh, **quiet)
    tr.train()
    res["pass2"] = summary(tr)

    steps2, w2, h2, n2 = 15, 192, 16 * RANKS, 5000
    cfg2 = TrainConfig(num_iters=steps2, capacity=n2, log_interval=steps2,
                       valid_interval=10_000, checkpoint_interval=10_000, adaptive_pairs=False,
                       tiling=TilingConfig(max_pairs=1 << 18, tile_capacity=1024, chunk=64),
                       densify=DensifyConfig(densify_since=steps2 + 1, densify_until=0))
    gt2 = graft._synthetic_scene(n2, n2, sh_degree=2, seed=11, scale=0.02)
    views2 = items(gt2, [graft._camera(w2, h2, fx=0.6 + 0.05 * i) for i in range(4)], w2, h2,
                   cfg2.tiling)
    for name, m in (("single", None), ("sharded", make_mesh(view=1, tile=RANKS))):
        tr = Trainer(cfg2, graft._synthetic_scene(n2, n2, sh_degree=2, seed=13, scale=0.03),
                     2.0, views2, mesh=m, **quiet)
        tr.train()
        res[name] = summary(tr)
    return res


def rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("name", ["pass1", "pass2"])
def test_mesh_passes_match_jax(name, port, jax_passes):
    """Passes 1 and 2 on the (2, 2) mesh: steps, alive count and every
    logged loss against the JAX ``Trainer``'s."""
    got, want = port()[1][name], jax_passes[name]
    assert got["steps"] == want["steps"] and got["logged_steps"] == want["logged_steps"]
    assert got["n_alive"] == want["n_alive"]
    for a, b in zip(got["losses"], want["losses"], strict=True):
        assert rel(a, b) <= 1e-5, (name, got["losses"], want["losses"])
    if name == "pass1":
        assert got["mesh"] == [2, 2] and got["n_alive"] > 48  # the densify event


def test_sharded_against_single_matches_jax(port, jax_passes):
    """Pass 3: the port's last losses, one process (l1) and the 1x4 mesh
    (l2), each against JAX's, and the port's own asserts."""
    p3 = port()[1]["pass3"]
    assert rel(p3["l1"], jax_passes["single"]["losses"][-1]) <= 1e-4
    assert rel(p3["l2"], jax_passes["sharded"]["losses"][-1]) <= 1e-4
    assert abs(p3["l1"] - p3["l2"]) < 2e-3 and p3["cross_psnr_db"] > 45.0
    for side in ("single", "sharded"):
        assert p3[side]["steps"] == jax_passes[side]["steps"] == 15
        assert p3[side]["n_alive"] == jax_passes[side]["n_alive"] == 5000


def test_dryrun_prints_the_jax_lines(port):
    """Last in the file: the JAX side of the tests above runs while the
    ranks work."""
    out, rec = port()
    lines = [x for x in out.splitlines() if x.startswith("dryrun_multichip")]
    assert [x.split(":")[0] for x in lines] == [
        "dryrun_multichip OK", "dryrun_multichip OK (plain)",
        "dryrun_multichip sharded-vs-single (15 steps, 192x64, 5000 splats, 1x4 tile mesh)",
        "dryrun_multichip OK (sharded == single-device within tolerance)"], lines
    assert lines[0].startswith("dryrun_multichip OK: mesh=(2x2) ")
    assert "[mesh] backend gloo: 4 ranks on cpu" in out
    assert (rec["backend"], rec["ranks"], rec["routes"]) == ("gloo", 4, ["cuda", "plain"])
