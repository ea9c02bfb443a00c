"""The port's mesh (``parallel/``) on four gloo ranks on the CPU, against the
JAX package's ``parallel/`` on four of the eight virtual devices, and
against the port's own one-process path.

The ranks run ``tests/torch_mesh_worker.py`` (one subprocess each, joined by
a ``FileStore`` under the test's temporary directory; one torch thread
each); one launch runs every task and the tests read its results. The JAX
side runs here, its Pallas kernels in interpret mode with f32 pair
gradients, against the port's route "plain"; the tiled routes ("xla") face
each other. Scenes, cameras and targets come from numpy seeds
(``torch_mesh_worker``'s functions) and go to both sides.

Bounds, and why:
- mesh coordinates, axis groups and the band geometry exactly;
- the band loss: the partials summed over the ring within 1e-5 relative
  and the gradient within 1e-4 of its largest |value| (the loss tests'
  bounds);
- ``sharded_render`` within 1e-5 of JAX's (the tiled route's bound) and
  within 1e-6 of the port's single render (measured: the same bits);
- the sharded step: the bounds of ``tests/test_parallel.py``'s lockstep
  test (loss and logs 1e-5 relative; ``xyz``/``opacity`` 1e-4 relative and
  1e-6; ``grad_accum`` 1e-3 and 1e-7; ``max_radii2d`` 1e-4 and 1e-5; the
  exposure gradient 1e-4 and 1e-7), each Adam first moment (after step 0,
  (1 - beta1) times the gradient) within 1e-4 of its group's largest
  |value|, counts exactly, and every rank's outputs the same bits;
- the mesh ``Trainer`` and CLI against the one-process port at the same
  global batch: the loss at every logged step within 1e-5 relative (the
  coupled-step bound), alive counts exactly, ``xyz`` within 1e-3 and 1e-5
  (``tests/test_parallel.py``'s trainer bound), the ranks' scenes and Adam
  states the same bits.
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
from jax.sharding import PartitionSpec as P

import __graft_entry__ as graft
from gaussian_splatting_lightning_tpu.core.camera import make_camera as jax_make_camera
from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import TilingConfig as JaxTiling
from gaussian_splatting_lightning_tpu.parallel import make_mesh as jax_make_mesh
from gaussian_splatting_lightning_tpu.parallel import make_sharded_train_step as jax_step
from gaussian_splatting_lightning_tpu.parallel import sharded_render as jax_sharded_render
from gaussian_splatting_lightning_tpu.parallel import shard as jshard
from gaussian_splatting_lightning_tpu.training import TrainConfig as JaxTrainConfig
from gaussian_splatting_lightning_tpu.training import init_adam as jax_init_adam
from gaussian_splatting_lightning_tpu.training.densify import DensifyConfig as JaxDensify
from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
from gaussian_splatting_lightning_tpu_torch.models.ply import read_ply_vertices
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig, preprocess
from gaussian_splatting_lightning_tpu_torch.ops.ssim import ssim_map
from gaussian_splatting_lightning_tpu_torch.parallel import batch_cameras, mesh as tmesh
from gaussian_splatting_lightning_tpu_torch.parallel import shard as tshard
from gaussian_splatting_lightning_tpu_torch.scripts import train as port_cli
from gaussian_splatting_lightning_tpu_torch.training.trainer import (
    Trainer,
    render_scene,
    resolve_rasterizer,
)
from tests import torch_mesh_worker as mw
from tests.test_torch_train_cli import scene_dir, write_config  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
TASKS = ("coords", "loss", "render", "steps", "seam", "donate", "trainer")
WORKER_TIMEOUT = 300
JAX_ROUTE = {"plain": "pallas_interpret", "xla": "xla"}

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _child_env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


class Launch:
    """The four ranks, started at once; ``results()`` waits for them and
    returns each rank's arrays."""

    def __init__(self, out: Path, tasks):
        self.out = out
        self.procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"), str(r),
             str(RANKS), str(out / "store"), str(out), *tasks],
            cwd=str(ROOT), env=_child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
        self._results = None

    def results(self):
        if self._results is None:
            try:
                logs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
            self._results = [dict(np.load(self.out / f"rank{r}.npz")) for r in range(RANKS)]
        return self._results


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Started before the module's first test, so that the JAX side of
    each test runs while the ranks work."""
    launch = Launch(tmp_path_factory.mktemp("mesh"), TASKS)
    yield launch
    launch.results()  # reap the ranks whatever the tests did


def same_on_every_rank(res, prefix):
    keys = [k for k in res[0] if k.startswith(prefix)]
    assert keys, prefix
    for r in res[1:]:
        for k in keys:
            assert np.array_equal(res[0][k], r[k]), (k, "differs across ranks")


def jax_devices():
    return jax.devices()[:RANKS]


def jax_cameras(n=mw.BATCH):
    cams = [jax_make_camera(mw.ring_pose(i, 5), mw.FOCAL, mw.FOCAL, mw.W, mw.H)
            for i in range(n)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *cams)


def jax_scene(capacity):
    return graft._synthetic_scene(mw.N_SPLATS, capacity, sh_degree=mw.SH, seed=mw.SEED,
                                  scale=mw.SCALE, aniso=True)


def close_to_max(got, want, tol):
    scale = float(np.abs(want).max())
    assert scale > 0
    return float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("height, n_tile, block", [(112, 4, 32), (112, 2, 32), (112, 4, 16),
                                                   (1080, 4, 32), (1080, 2, 16), (48, 2, 32)])
def test_band_geometry_and_budget_match_jax(height, n_tile, block):
    assert tshard._band_geometry(height, n_tile, block) == jshard._band_geometry(
        height, n_tile, block)
    assert tshard._band_geometry(height, n_tile) == jshard._band_geometry(height, n_tile)
    assert tshard.HALO == jshard.HALO and tshard.SSIM_RADIUS == jshard.SSIM_RADIUS
    for max_pairs in (1 << 14, 2_523_136, 1000):
        got = tshard.band_tiling(TilingConfig(max_pairs=max_pairs), n_tile).max_pairs
        # the JAX step's rule, parallel/shard.py:309-312
        assert got == max(8192, -(-max_pairs // (n_tile * 8192)) * 8192)
    assert tshard.band_tiling(TilingConfig(max_pairs=2_523_136), 4).max_pairs == 630_784
    assert batch_cameras is stack_cameras


# ---- the sharded train step -------------------------------------------------

def jax_step_result(case):
    """JAX's sharded step on one case: (scene, adam, logs, exp_grad)."""
    name, (v, t), route, cap, exposure, depth = case
    cfg = JaxTrainConfig(
        capacity=cap, rasterizer=JAX_ROUTE[route], use_exposure=exposure,
        w_depth=0.5 if depth else 0.0, densify=JaxDensify(),
        tiling=JaxTiling(max_pairs=mw.MAX_PAIRS, pair_grad_bf16=False))
    step = jax_step(cfg, 4.0, mw.W, mw.H, jax_make_mesh(v, t, devices=jax_devices()))
    images, depth_t, exp = mw.targets()
    scene = jax_scene(cap)
    args = [scene, jax_init_adam(scene.params), 0, jax_cameras(), jnp.asarray(images),
            jnp.zeros((mw.BATCH, 3))]
    kw = {}
    if exposure:
        kw["exp_mat"] = jnp.asarray(exp)
    if depth:
        kw["depth_target"] = jnp.asarray(depth_t)
    out = step(*args, **kw)
    return out if exposure else out + (None,)


def assert_step_matches_jax(res, key, want, case):
    scene, adam, logs, exp_grad = want
    name, (v, t), route, cap, exposure, depth = case
    r = res[0]
    for k in ("loss", "recon", "ssim", "psnr") + (("depth_l1",) if depth else ()):
        np.testing.assert_allclose(r[f"{key}/log/{k}"], float(logs[k]), rtol=1e-5, err_msg=k)
    for k in ("n_gaussians", "num_dropped_pairs", "num_pairs"):
        assert int(r[f"{key}/log/{k}"]) == int(logs[k]), k
    assert int(r[f"{key}/log/num_dropped_pairs"]) == 0
    assert not r[f"{key}/band_dropped"].any()
    for k in ("xyz", "opacity"):
        np.testing.assert_allclose(r[f"{key}/param/{k}"], np.asarray(getattr(scene.params, k)),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for k in PARAM_NAMES:
        assert close_to_max(r[f"{key}/mu/{k}"], np.asarray(getattr(adam.mu, k)), 1e-4), k
    np.testing.assert_allclose(r[f"{key}/grad_accum"], np.asarray(scene.grad_accum),
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_array_equal(r[f"{key}/grad_count"], np.asarray(scene.grad_count))
    np.testing.assert_allclose(r[f"{key}/max_radii2d"], np.asarray(scene.max_radii2d),
                               rtol=1e-4, atol=1e-5)
    if exposure:
        np.testing.assert_allclose(r[f"{key}/exp_grad"], np.asarray(exp_grad),
                                   rtol=1e-4, atol=1e-7)
    assert bool(r[f"{key}/sharded_adam"]) == (cap % RANKS == 0)
    assert r[f"{key}/prep_contiguous"].all()


@pytest.mark.parametrize("case", mw.STEP_CASES, ids=lambda c: c[0])
def test_sharded_train_step_matches_jax(case, ranks):
    """Meshes (2, 2) and (1, 4), ZeRO-1 on (capacity 128) and off (126),
    with exposure and with depth, on route "plain" against JAX's
    ``pallas_interpret`` and on route "xla" against JAX's ``xla``."""
    want = jax_step_result(case)
    res = ranks.results()
    same_on_every_rank(res, f"steps/{case[0]}/")
    assert_step_matches_jax(res, f"steps/{case[0]}", want, case)


def test_seam_needs_the_reduce_scatter_backward(ranks):
    """With an all-gather whose backward only slices out the rank's own
    rows, the splats whose footprint crosses a band seam (or lies in another
    band) lose the other bands' gradient terms: the step no longer matches
    JAX. The same case with the reduce-scatter passes
    (``test_sharded_train_step_matches_jax``)."""
    case = mw.SEAM_CASE
    scene, cams = mw.port_scene(case[3]), stack_cameras(mw.port_cameras())
    prep = preprocess(scene.params.xyz, scene.get_opacity(), scene.get_scales(),
                      scene.get_rotation(), scene.get_features(), cams, mw.W, mw.H,
                      scene.active_sh_degree, scene.max_sh_degree, False, scene.alive)
    y, rad = prep.p_pix[..., 1], prep.radius
    band_h = 32  # (1, 4) at 32 px tiles: one tile row per band
    straddle = prep.visible & (torch.floor((y - rad) / band_h) != torch.floor((y + rad) / band_h))
    assert int(straddle.sum()) >= 10
    want = jax_step_result(case)
    res = ranks.results()
    same_on_every_rank(res, "seam/")
    key = f"seam/{case[0]}"
    with pytest.raises(AssertionError):
        assert_step_matches_jax(res, key, want, case)
    for k in PARAM_NAMES:
        assert not close_to_max(res[0][f"{key}/mu/{k}"], np.asarray(getattr(want[1].mu, k)),
                                0.1), k
    assert_step_matches_jax(res, f"steps/{case[0]}", want, case)


@pytest.mark.parametrize("case", mw.DONATE_CASES, ids=lambda c: c[0])
def test_sharded_donating_step_matches_out_of_place(case, ranks):
    """The donating body of the sharded step (``in_place``, run eagerly: the
    graph an NCCL mesh captures) for ``DONATE_STEPS`` steps against the
    out-of-place eager step from the same start, ZeRO-1 on (2, 2) with
    exposure and depth and replicated on (1, 4): every log at every step,
    the exposure gradients, the parameters, Adam's moments and the
    statistics after the last step the same bits on every rank (the same
    operations in the same order, written into the given tensors), and the
    donating step's scene the tensors it was given."""
    name, _, cap, exposure, _ = case
    res = ranks.results()
    same_on_every_rank(res, f"donate/{name}/")
    key = f"donate/{name}"
    assert bool(res[0][f"{key}/sharded_adam"]) == (cap % RANKS == 0)
    for r in res:
        keys = [k for k in r if k.startswith(f"{key}/out/")]
        assert any("/exp_grad/" in k for k in keys) == exposure
        assert len(keys) >= 3 * len(PARAM_NAMES) + 9
        for k in keys:
            if not k.endswith("same_tensors"):
                np.testing.assert_array_equal(r[k.replace("/out/", "/in/")], r[k], err_msg=k)
        assert int(r[f"{key}/in/count"]) == mw.DONATE_STEPS
        assert r[f"{key}/in/same_tensors"].all()
        assert not r[f"{key}/out/same_tensors"].any()


# ---- the band loss ----------------------------------------------------------

def test_band_loss_partials_match_jax(ranks):
    """Partials summed over the (1, 4) ring and the band gradient, against
    JAX's ``_band_loss_partials`` under ``shard_map`` and against the
    port's full-image SSIM and L1."""
    pred, images, band_h = mw.loss_inputs()
    mesh = jax_make_mesh(1, 4, devices=jax_devices())

    def device_fn(band, images):
        def loss_local(band):
            l1, ss, mse = jshard._band_loss_partials(band, images, mw.H, 0.2)
            return jnp.mean(0.8 * l1 - 0.2 * ss), (l1, ss, mse)

        grad, parts = jax.grad(loss_local, has_aux=True)(band)
        return jax.lax.psum(jnp.stack(parts), "tile"), grad

    parts, grad = jax.jit(jax.shard_map(
        device_fn, mesh=mesh, in_specs=(P(None, None, "tile", None), P()),
        out_specs=(P(), P(None, None, "tile", None)), check_vma=False))(
        jnp.asarray(pred), jnp.asarray(images))
    res = ranks.results()
    same_on_every_rank(res, "loss/")
    got = res[0]["loss/partials"]
    np.testing.assert_allclose(got, np.asarray(parts), rtol=1e-5)
    assert close_to_max(res[0]["loss/grad"], np.asarray(grad), 1e-4)
    # the exact full-image means: rows below H are not part of the image
    full, tgt = torch.from_numpy(pred[:, :, :mw.H]), torch.from_numpy(images)
    l1 = torch.mean(torch.abs(full - tgt), dim=(1, 2, 3))
    ss = ssim_map(full, tgt, plain=True).mean(dim=(1, 2, 3))
    mse = torch.mean((full - tgt) ** 2, dim=(1, 2, 3))
    np.testing.assert_allclose(got, torch.stack([l1, ss, mse]).numpy(), rtol=1e-5)
    assert not res[0]["loss/grad"][:, :, mw.H:].any()  # padded rows get nothing


# ---- sharded_render ---------------------------------------------------------

BG = np.array([0.1, 0.2, 0.3], np.float32)


@pytest.fixture(scope="module")
def jax_render():
    """JAX's ``sharded_render`` (its tiled route) on mesh (2, 2), jitted."""
    mesh = jax_make_mesh(2, 2, devices=jax_devices())
    tiling = JaxTiling(max_pairs=mw.MAX_PAIRS)
    jcam = jax_make_camera(mw.ring_pose(0, 5), mw.FOCAL, mw.FOCAL, mw.W, mw.H)
    render = jax.jit(lambda scene, cam, bg: jax_sharded_render(scene, cam, mw.W, mw.H, bg,
                                                               mesh, tiling=tiling))
    return [np.asarray(x) for x in render(jax_scene(128), jcam, jnp.asarray(BG))]


@pytest.mark.parametrize("route", ["plain", "xla"])
def test_sharded_render_matches_jax_and_single_render(route, jax_render, ranks):
    bg = BG
    jimage, jradii, jdepth = jax_render
    scene, cam = mw.port_scene(128), mw.port_cameras(1)[0]
    single, stats = render_scene(scene, cam, mw.W, mw.H, torch.from_numpy(bg),
                                 TilingConfig(max_pairs=mw.MAX_PAIRS),
                                 rasterize_fn=resolve_rasterizer(route))
    assert int(stats["num_dropped_pairs"]) == 0
    res = ranks.results()
    same_on_every_rank(res, f"render/{route}/")
    image, depth = res[0][f"render/{route}/image"], res[0][f"render/{route}/depth"]
    assert image.shape == (3, mw.H, mw.W) and depth.shape == (1, mw.H, mw.W)
    np.testing.assert_allclose(image, jimage, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(depth, jdepth, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(res[0][f"render/{route}/radii"], jradii)
    assert np.abs(image - single.image.numpy()).max() <= 1e-6
    assert np.abs(depth - single.depth.numpy()).max() <= 1e-6


# ---- the mesh ---------------------------------------------------------------

@pytest.mark.parametrize("shape", mw.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_coordinates_match_jax_device_grid(shape, ranks):
    """Rank r sits where JAX's grid holds device r (tile fastest); each
    axis group sums the ranks that share the other coordinate."""
    v, t = shape
    jgrid = np.vectorize(lambda d: d.id)(jax_make_mesh(v, t, devices=jax_devices()).devices)
    np.testing.assert_array_equal(tmesh.mesh_grid(v, t, RANKS), jgrid)
    np.testing.assert_array_equal(tmesh.mesh_grid(v, None, RANKS), jgrid)
    res = ranks.results()
    for r in range(RANKS):
        (vi,), (ti,) = np.nonzero(jgrid == r)
        np.testing.assert_array_equal(res[r][f"coords/{v}x{t}"], [vi, ti, v, t])
        sums = [jgrid[:, ti].sum(), jgrid[vi].sum(), jgrid.sum()]
        np.testing.assert_array_equal(res[r][f"coords/{v}x{t}/sums"], sums)


def test_mesh_errors_match_jax():
    devices = jax_devices()
    for view, tile in ((3, None), (2, 4)):
        with pytest.raises(ValueError) as jerr:
            jax_make_mesh(view, tile, devices=devices)
        with pytest.raises(ValueError) as terr:
            tmesh.mesh_grid(view, tile, RANKS)
        assert str(terr.value) == str(jerr.value)
    # several hosts: the view axis must be a multiple of their count
    with pytest.raises(ValueError, match="multiple of the process count"):
        tmesh.mesh_grid(1, 4, 4, n_hosts=2)
    assert tmesh.mesh_grid(2, 2, 4, n_hosts=2).tolist() == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="idle"):
        tmesh.mesh_grid(1, 2, 4)
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_mesh(1, 1)
    assert tmesh.init_distributed("cpu") is None  # one process: no job
    assert tmesh.choose_backend(torch.device("cpu"), 4) == "gloo"


# ---- the Trainer ------------------------------------------------------------

def one_process_trainer(num_iters=mw.TRAINER_STEPS, **kw):
    cfg = dataclasses.replace(mw.trainer_config(mw.TRAINER_MESH[0]), num_iters=num_iters)
    return Trainer(cfg, mw.trainer_scene(), 4.0, mw.trainer_views(), log_fn=lambda *a: None,
                   **kw)


def test_mesh_trainer_matches_one_process_trainer(ranks):
    """``Trainer(mesh)`` on (2, 2) for 5 steps with a densify event at
    threshold 0 (step 3), ZeRO-1 Adam and exposure, against the one-process
    ``Trainer`` at ``batch_views`` 2; every rank ends with the same bits."""
    one = one_process_trainer()
    one.train()
    res = ranks.results()
    same_on_every_rank(res, "trainer/")
    r = res[0]
    assert bool(r["trainer/zero1"])
    # each rank kept only its quarter of Adam's rows
    assert all(x["local/trainer/mu/xyz"].shape[0] == 128 // RANKS for x in res)
    np.testing.assert_allclose(r["trainer/loss"], [h["loss"] for h in one.history], rtol=1e-5)
    np.testing.assert_array_equal(r["trainer/n_gaussians"],
                                  [h["n_gaussians"] for h in one.history])
    assert r["trainer/n_gaussians"][-1] > r["trainer/n_gaussians"][0]  # the densify event
    np.testing.assert_array_equal(r["trainer/alive"], one.scene.alive.numpy())
    np.testing.assert_allclose(r["trainer/param/xyz"], one.scene.params.xyz.numpy(),
                               rtol=1e-3, atol=1e-5)
    assert close_to_max(r["trainer/mu/xyz"], one.adam.mu.xyz.numpy(), 1e-3)
    np.testing.assert_allclose(r["trainer/exposure"], one.exposure.params.numpy(),
                               rtol=1e-3, atol=1e-5)


def test_mesh_checkpoint_resumes_in_one_process(ranks):
    """The mesh run's step-3 checkpoint (whole Adam, written by rank 0)
    restored by a one-process ``Trainer``, which then takes the mesh run's
    last two steps; the mesh run's own final checkpoint holds its state."""
    res = ranks.results()
    run = ranks.out / "trainer"
    assert sorted(p.name for p in run.glob("ckpt-*")) == ["ckpt-00000003", "ckpt-00000005"]
    final = torch.load(run / "ckpt-00000005" / "state.pt", weights_only=True)
    np.testing.assert_array_equal(final["adam"]["mu"]["xyz"].numpy(), res[0]["trainer/mu/xyz"])
    np.testing.assert_array_equal(final["scene"]["xyz"].numpy(), res[0]["trainer/param/xyz"])
    tr = one_process_trainer(num_iters=2)
    tr.restore_checkpoint(run / "ckpt-00000003")
    assert tr.step == 3 and tr.adam.mu.xyz.shape == (128, 3)
    tr.train()
    np.testing.assert_allclose([h["loss"] for h in tr.history], res[0]["trainer/loss"][3:],
                               rtol=1e-5)
    np.testing.assert_array_equal([h["n_gaussians"] for h in tr.history],
                                  res[0]["trainer/n_gaussians"][3:])
    np.testing.assert_allclose(tr.scene.params.xyz.numpy(), res[0]["trainer/param/xyz"],
                               rtol=1e-3, atol=1e-5)


# ---- the train CLI ----------------------------------------------------------

CLI_SETS = ["--set", "train.densify.densify_grad_threshold=0.0", "--iters", "20"]


def logs_of(run_dir, name):
    return [json.loads(line) for line in (run_dir / name).read_text().splitlines()]


def test_train_cli_refuses_a_mesh_in_one_process(scene_dir, tmp_path):
    cfg = tmp_path / "cfg.yaml"
    write_config(cfg, scene_dir, tmp_path / "runs")
    for sets in (["mesh_view=2"], ["mesh_tile=1"]):
        with pytest.raises(ValueError, match="torch.distributed.run"):
            port_cli.main(["-c", str(cfg), "--device", "cpu", "--set", sets[0]])


def test_train_cli_joins_a_one_rank_torchrun_job(monkeypatch):
    """Under torchrun (its environment: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE`` 1) the CLI's ``mesh_view=1``, ``mesh_tile=1``
    is a 1x1 mesh, the job of ``--nproc-per-node 1``; without torchrun's
    environment the same config refuses (``test_train_cli_refuses_a_mesh_in_one_process``)."""
    import socket
    import types

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    mesh, device = port_cli.build_mesh(types.SimpleNamespace(mesh_view=1, mesh_tile=1), "cpu")
    try:
        assert dist.get_world_size() == 1 and device.type == "cpu"
        assert (mesh.shape, mesh.rank, mesh.backend) == ({"view": 1, "tile": 1}, 0, "gloo")
        assert float(mesh.all_reduce(torch.ones(1), "world")) == 1.0
    finally:
        dist.destroy_process_group()


def test_train_cli_releases_graphs_before_the_process_group_when_train_raises(
        scene_dir, tmp_path, monkeypatch):
    """A rank whose ``Trainer.train`` raises still leaves the job through
    ``parallel.shutdown``: the captured graphs registered on its mesh are
    released before ``destroy_process_group`` runs, although the traceback
    still holds them (a graph of NCCL collectives must not outlive its
    communicators). A gloo mesh captures nothing, so ``train`` registers a
    stand-in graph on the mesh, as ``ShardedTrainStep`` does on NCCL."""
    import socket

    import torch.distributed as dist

    from gaussian_splatting_lightning_tpu_torch.utils import graph

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    cfg = tmp_path / "cfg.yaml"
    write_config(cfg, scene_dir, tmp_path / "runs")
    held, at_destroy = [], []

    def failing_train(self):
        captured = graph.Captured(lambda static: None, name="stand_in")
        captured._entry = graph._Entry(("key",), None, [], None, {})
        self.mesh.graphs.add(captured)
        held.append(captured)
        raise RuntimeError("the step failed")

    destroy = dist.destroy_process_group

    def recorded_destroy(*args, **kwargs):
        at_destroy.append([c.inputs for c in held])
        return destroy(*args, **kwargs)

    monkeypatch.setattr(Trainer, "train", failing_train)
    monkeypatch.setattr(dist, "destroy_process_group", recorded_destroy)
    with pytest.raises(RuntimeError, match="the step failed"):
        port_cli.main(["-c", str(cfg), "--device", "cpu", "--set", "mesh_view=1",
                       "--set", "mesh_tile=1"])
    assert at_destroy == [[None]]  # one destroy, after the graph was released
    assert not dist.is_initialized()


def test_train_cli_under_torchrun_matches_one_process_cli(scene_dir, tmp_path):
    """``torch.distributed.run --nproc-per-node 4`` with mesh (2, 2) against
    the one-process CLI at ``batch_views=2``: 20 steps through two densify
    events (threshold 0), a validation and checkpoints."""
    cfg = tmp_path / "cfg.yaml"
    write_config(cfg, scene_dir, tmp_path / "runs")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(RANKS), "-m", "gaussian_splatting_lightning_tpu_torch."
           "scripts.train", "-c", str(cfg), "--device", "cpu", "--out-dir",
           str(tmp_path / "mesh"), "--set", "mesh_view=2", "--set", "mesh_tile=2"] + CLI_SETS
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=_child_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        one = port_cli.main(["-c", str(cfg), "--device", "cpu", "--out-dir",
                             str(tmp_path / "one"), "--set", "train.batch_views=2"] + CLI_SETS)
        out, _ = proc.communicate(timeout=WORKER_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-4000:]
    assert "mesh: view=2 x tile=2 (4 devices)" in out
    assert "[mesh] backend gloo: 4 ranks on cpu" in out
    assert out.count("done; artifacts in") == 1  # rank 0 alone prints
    (mesh_run,) = (tmp_path / "mesh" / "cli").iterdir()
    (one_run,) = (tmp_path / "one" / "cli").iterdir()
    ml, ol = logs_of(mesh_run, "train_log.jsonl"), logs_of(one_run, "train_log.jsonl")
    assert [r["step"] for r in ml] == [r["step"] for r in ol] == list(range(0, 20, 5))
    assert [r["n_gaussians"] for r in ml] == [r["n_gaussians"] for r in ol]
    assert ml[-1]["n_gaussians"] > ml[0]["n_gaussians"]
    for a, b in zip(ml, ol):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * b["loss"], a["step"]
    mv, ov = logs_of(mesh_run, "valid_log.jsonl"), logs_of(one_run, "valid_log.jsonl")
    assert [r["step"] for r in mv] == [r["step"] for r in ov] == [15, 20]
    for a, b in zip(mv, ov):
        assert abs(a["valid_psnr"] - b["valid_psnr"]) <= 1e-4
    assert sorted(p.name for p in mesh_run.glob("ckpt-*")) == sorted(
        p.name for p in one_run.glob("ckpt-*")) == ["ckpt-00000010", "ckpt-00000020"]
    n_final = len(read_ply_vertices(mesh_run / "point_cloud-final.ply"))
    assert n_final == len(read_ply_vertices(one_run / "point_cloud-final.ply"))
    assert n_final == one.scene.n_alive()
    conf = json.loads((mesh_run / "config.json").read_text())
    assert (conf["mesh_view"], conf["mesh_tile"]) == (2, 2)
