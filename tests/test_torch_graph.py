"""The capture layer (``utils/graph.py``) and the donating step, on the CPU.

A CUDA graph runs only on the card (``tests/test_torch_graph_cuda.py``
replays it against eager there). What the graph runs is checked here:

- The train step (the captured graph's body run eagerly: in-place Adam and
  ``accumulate_stats_``, the plain versions) for 10 steps: it writes into
  the tensors it is given and returns them, counts its Adam steps, and
  matches the JAX jitted step (``rasterizer="pallas_interpret"``, f32 pair
  gradients) within the bounds of ``tests/test_torch_training.py``: loss
  within 1e-5 relative, every parameter group's largest |port - JAX| within
  2e-3 and its 99th percentile within 2e-4 of the group's largest move,
  radii and view counts exact, ``grad_accum`` within 1e-4 of its largest
  value, exposure within 1e-6. Cases: one view, ``sparse_adam`` with
  exposure and a depth target, and two views with exposure.
- The scalars the graph takes as a device input (``adam_scalars``) equal
  the host schedule's floats and bias corrections over a 30k-step sweep,
  and the JAX schedule's within 2 ulp.
- The capture key over a 60-step ``Trainer`` run on the tiled route with a
  tiny pair budget and ``tile_capacity``, SH steps and densify events: it
  changes exactly where the JAX ``Trainer`` compiles its step anew (a pair
  budget or ``tile_capacity`` growth) and where the active SH degree
  changes (a static int here, a traced array in JAX), and nowhere else.
- ``capture`` refuses CPU tensors; the render and eval step built with
  capture on give the eager results on the CPU.
- The sharded step on a ``Mesh`` built by hand (no process group, no
  card): its capture key changes with the SH degree, the views per rank,
  the exposure and depth inputs, the pair budget and the band tiling, and
  with nothing else; it captures on an NCCL mesh on route "cuda" only.
- ``exposure_update_`` (in place, the exposure graph's body), the eager
  ``make_exposure_update`` and the out-of-place ``exposure_update`` against
  JAX's ``exposure_update`` bit for bit, from a state carried across by
  ``interop.exposure_from_numpy``: an int index, and (B,) indices with a
  view repeated in one batch.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussian_splatting_lightning_tpu.models import from_points as jax_from_points
from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import TilingConfig as JaxTiling
from gaussian_splatting_lightning_tpu.training import densify as jdensify
from gaussian_splatting_lightning_tpu.training import exposure as jexposure
from gaussian_splatting_lightning_tpu.training import optimizer as jopt
from gaussian_splatting_lightning_tpu.training import schedule as jsched
from gaussian_splatting_lightning_tpu.training import trainer as jtrainer
from gaussian_splatting_lightning_tpu_torch import interop
from gaussian_splatting_lightning_tpu_torch.core.camera import stack_cameras
from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.parallel import shard as tshard
from gaussian_splatting_lightning_tpu_torch.parallel.mesh import Mesh
from gaussian_splatting_lightning_tpu_torch.training import exposure as texposure
from gaussian_splatting_lightning_tpu_torch.training import optimizer as topt
from gaussian_splatting_lightning_tpu_torch.training import trainer as ttrainer
from gaussian_splatting_lightning_tpu_torch.training.densify import DensifyConfig
from gaussian_splatting_lightning_tpu_torch.utils import graph
from tests.test_torch_batched import adam_to_port, ring_cameras
from tests.test_torch_trainer import QUIET, gt_views
from tests.torch_parity import jax_scene, port_scene

W, H, N, CAP, STEPS = 64, 48, 400, 448, 10
STATS = ("alive", "max_radii2d", "grad_accum", "grad_count")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain kernels are loops of small ops: threads only add overhead,
    # and the test workers already share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clone_scene(scene):
    return dataclasses.replace(
        scene, params=type(scene.params)(**{k: getattr(scene.params, k).clone()
                                            for k in PARAM_NAMES}),
        **{k: getattr(scene, k).clone() for k in STATS})


# ---- the donating step ----------------------------------------------------

CASES = {"one-view": (1, False, False), "sparse-exposure-depth": (1, True, True),
         "two-views-exposure": (2, False, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_donates_and_matches_jax(case):
    b, sparse, exposure = CASES[case]
    w_depth = 0.5 if sparse else 0.0
    js = jax_scene(N, CAP, seed=3, scale=0.08, aniso=True)
    start = port_scene(js)
    jall, tall, _ = ring_cameras(5)
    rng = np.random.default_rng(11)
    imgs = rng.uniform(size=(5, 3, H, W)).astype(np.float32)
    depths = rng.uniform(0.0, 0.3, size=(5, 1, H, W)).astype(np.float32)
    bgs = rng.uniform(size=(5, 3)).astype(np.float32)
    jcfg = jtrainer.TrainConfig(
        w_depth=w_depth, sparse_adam=sparse, batch_views=b, rasterizer="pallas_interpret",
        tiling=JaxTiling(max_pairs=1 << 13, block=32, pair_grad_bf16=False))
    tcfg = ttrainer.TrainConfig(w_depth=w_depth, sparse_adam=sparse, batch_views=b,
                                rasterizer="plain",
                                tiling=TilingConfig(max_pairs=1 << 13, block=32))
    jstep = jtrainer.make_train_step(jcfg, 1.0, W, H)
    tstep = ttrainer.make_train_step(tcfg, 1.0, W, H)
    jadam = jopt.init_adam(js.params)
    st = {"scene": start, "adam": adam_to_port(jadam),
          "exp": texposure.init_exposure(5, device="cpu")}
    jexp = jexposure.init_exposure(5)

    def tensors(scene, adam):
        return ([getattr(scene.params, k) for k in PARAM_NAMES]
                + [getattr(scene, k) for k in STATS]
                + [getattr(m, k) for m in (adam.mu, adam.nu) for k in PARAM_NAMES])

    given = tensors(st["scene"], st["adam"])
    losses = []
    for step in range(STEPS):
        idx = [(step * b + k) % 5 for k in range(b)]
        one = b == 1
        ji, ti = (idx[0], idx[0]) if one else (jnp.asarray(idx), torch.tensor(idx))
        pick = (lambda x: x[idx[0]]) if one else (lambda x: x[idx])
        jcam = jax.tree.map(lambda x: x[ji], jall)
        tcam = type(tall)(*(getattr(tall, f.name)[ti] for f in dataclasses.fields(tall)))
        jargs = [jcam, jnp.asarray(pick(imgs)), jnp.asarray(pick(bgs))]
        targs = [tcam, torch.from_numpy(pick(imgs)), torch.from_numpy(pick(bgs))]
        jkw = {"depth_target": jnp.asarray(pick(depths))} if w_depth else {}
        tkw = {"depth_target": torch.from_numpy(pick(depths))} if w_depth else {}
        if exposure:
            js, jadam, jlogs, jeg = jstep(js, jadam, step, *jargs, jexp.params[ji], **jkw)
            jexp = jexposure.exposure_update(jexp, ji, jeg, 0.001)
        else:
            js, jadam, jlogs = jstep(js, jadam, step, *jargs, **jkw)
        extra = [st["exp"].params[ti]] if exposure else []
        res = tstep(st["scene"], st["adam"], step, *targs, *extra, **tkw)
        # the step wrote into the tensors it was given and returned them
        assert all(x is y for x, y in zip(tensors(*res[:2]), given)), step
        st["scene"], st["adam"], logs = res[:3]
        if exposure:
            st["exp"] = texposure.exposure_update(st["exp"], ti, res[3], 0.001)
        assert set(logs) == set(jlogs) | {"num_on_screen"}
        assert int(logs["num_dropped_pairs"]) == int(jlogs["num_dropped_pairs"]) == 0
        losses.append((float(jlogs["loss"]), float(logs["loss"])))
    assert st["adam"].count == int(jadam.count) == STEPS
    if exposure:
        np.testing.assert_allclose(np.asarray(jexp.params), st["exp"].params.numpy(),
                                   atol=1e-6, rtol=0)

    losses = np.array(losses)
    assert np.max(np.abs(losses[:, 0] - losses[:, 1]) / losses[:, 0]) <= 1e-5
    first = jax_scene(N, CAP, seed=3, scale=0.08, aniso=True).params
    for k in PARAM_NAMES:
        a, t = np.asarray(getattr(js.params, k)), getattr(st["scene"].params, k).numpy()
        moved = np.abs(a - np.asarray(getattr(first, k))).max()
        assert moved > 0, k
        d = np.abs(a - t)
        assert d.max() <= 2e-3 * moved, k
        assert np.quantile(d, 0.99) <= 2e-4 * moved, k
    np.testing.assert_array_equal(np.asarray(js.max_radii2d), st["scene"].max_radii2d.numpy())
    np.testing.assert_array_equal(np.asarray(js.grad_count), st["scene"].grad_count.numpy())
    acc = np.asarray(js.grad_accum)
    assert np.abs(acc - st["scene"].grad_accum.numpy()).max() <= 1e-4 * np.abs(acc).max()


# ---- the graph's scalar input ---------------------------------------------

def test_schedule_scalars_match_host_schedule():
    cfg = topt.OptimizerConfig(xyz_lr_delay_steps=100, xyz_lr_delay_mult=0.01)
    scheds = topt.make_lr_schedules(cfg, 3.7)
    jscheds = jopt.make_lr_schedules(jopt.OptimizerConfig(
        xyz_lr_delay_steps=100, xyz_lr_delay_mult=0.01), 3.7)
    steps = np.arange(30_000)
    got = np.stack([topt.scalars_tensor(topt.adam_scalars(scheds, cfg, int(s), int(s) + 1),
                                        "cpu").numpy() for s in steps])
    assert got.dtype == np.float32 and got.shape == (30_000, len(PARAM_NAMES) + 2)
    for i, name in enumerate(PARAM_NAMES):
        want = np.array([scheds[name](int(s)) for s in steps[::97]], np.float32)
        np.testing.assert_array_equal(got[::97, i], want, err_msg=name)
        jax_lr = np.asarray(jax.vmap(jscheds[name])(jnp.asarray(steps)), np.float32)
        np.testing.assert_allclose(got[:, i], np.broadcast_to(jax_lr, steps.shape),
                                   rtol=2.5e-7, atol=0, err_msg=name)  # 2 ulp of f32
    # the bias corrections as the eager step took them before they became an
    # input: 0-dim float32 tensors, b ** t per step
    for col, beta in ((-2, cfg.beta1), (-1, cfg.beta2)):
        want = [float(1.0 - torch.tensor(beta, dtype=torch.float32)
                      ** torch.tensor(float(s + 1), dtype=torch.float32))
                for s in steps[::97]]
        np.testing.assert_array_equal(got[::97, col], np.array(want, np.float32))
    tj = jnp.arange(1, 30_001, dtype=jnp.float32)
    for col, beta in ((-2, cfg.beta1), (-1, cfg.beta2)):
        np.testing.assert_allclose(got[:, col], np.asarray(1.0 - beta ** tj),
                                   rtol=2.5e-7, atol=0)


# ---- the capture key ------------------------------------------------------

KEY_DENSIFY = dict(densify_since=10, densify_interval=10, densify_until=45,
                   densify_grad_threshold=5e-5, clone_size_threshold=0.1,
                   opacity_reset_interval=35, sh_degree_step_interval=15)


def test_capture_key_changes_at_jax_recompile_points():
    w, h = 48, 32
    xyz, views = gt_views(n_views=4, w=w, h=h, n_gt=40, seed=5)
    js = jax_from_points(xyz, np.full((len(xyz), 3), 0.5, np.float32), 64, 3)
    ts = port_scene(js)
    common = dict(num_iters=60, capacity=64, log_interval=5, overflow_check_interval=5,
                  valid_interval=10_000, checkpoint_interval=10_000, seed=3)
    tiling = dict(max_pairs=128, tile_capacity=4, chunk=4)
    jcfg = jtrainer.TrainConfig(rasterizer="xla", tiling=JaxTiling(**tiling),
                                densify=jdensify.DensifyConfig(**KEY_DENSIFY), **common)
    tcfg = ttrainer.TrainConfig(rasterizer="xla", tiling=TilingConfig(**tiling),
                                densify=DensifyConfig(**KEY_DENSIFY), **common)
    seen = {"jax": [], "port": []}

    def jax_recorder(*a, **k):
        fn = orig["jax"](*a, **k)

        def step(*sa, **sk):
            out = fn(*sa, **sk)
            seen["jax"].append((int(sa[2]), id(fn), fn._cache_size()))
            return out
        return step

    def port_recorder(*a, **k):
        fn = orig["port"](*a, **k)

        def step(*sa, **sk):
            seen["port"].append((sa[2], fn.key(*sa, **sk), sa[0].active_sh_degree))
            return fn(*sa, **sk)
        return step

    orig = {"jax": jtrainer.make_train_step, "port": ttrainer.make_train_step}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrainer, "make_train_step", jax_recorder)
        mp.setattr(ttrainer, "make_train_step", port_recorder)
        jtr = jtrainer.Trainer(jcfg, js, 4.0, views, log_fn=lambda *a: None)
        ttr = ttrainer.Trainer(tcfg, ts, 4.0, views, **QUIET)
        key = [jax.random.PRNGKey(tcfg.seed)]

        def jax_noise():  # the JAX loop's split noise, so both sides split alike
            key[0], sub = jax.random.split(key[0])
            return torch.from_numpy(np.array(jax.random.normal(sub, (64, 3), jnp.float32)))

        ttr.densify_noise = jax_noise
        jtr.train()
        ttr.train()
    finally:
        mp.undo()
    assert [s for s, *_ in seen["port"]] == [s for s, *_ in seen["jax"]] == list(range(60))
    compiled, last = [], (None, 0)
    for step, fn, size in seen["jax"]:  # a new jit, or a new entry in its cache
        if fn != last[0] or size > last[1]:
            compiled.append(step)
        last = (fn, size)
    changed = [s for i, (s, key, _) in enumerate(seen["port"])
               if i == 0 or key != seen["port"][i - 1][1]]
    sh_steps = [s for i, (s, _, sh) in enumerate(seen["port"])
                if i > 0 and sh != seen["port"][i - 1][2]]
    assert sh_steps == [15, 30, 45]  # degrees 1, 2, 3
    assert changed == sorted(set(compiled) | set(sh_steps)), (changed, compiled)
    assert [s for s in compiled if s > 0], compiled  # the budgets grew
    assert ttr.cfg.tiling.max_pairs == jtr.cfg.tiling.max_pairs > 128
    assert ttr.cfg.tiling.tile_capacity == jtr.cfg.tiling.tile_capacity > 4


# ---- the layer itself -----------------------------------------------------

def test_graph_key_and_cpu_refusal():
    a, b = torch.zeros(3, 4), torch.zeros(3, 4, dtype=torch.float64)
    assert graph.graph_key(("s", 1), [a]) == graph.graph_key(("s", 1), [torch.ones(3, 4)])
    assert graph.graph_key(("s", 1), [a]) != graph.graph_key(("s", 2), [a])
    assert graph.graph_key(("s", 1), [a]) != graph.graph_key(("s", 1), [b])
    assert graph.graph_key(("s", 1), [a]) != graph.graph_key(("s", 1), [a.T])
    captured = graph.capture(lambda static, x: x * 2, name="double")
    with pytest.raises(ValueError, match="only CUDA tensors are captured"):
        captured(None, a)
    assert captured.captures == 0 and captured.inputs is None


def test_captured_entry_points_run_eagerly_on_the_cpu():
    js = jax_scene(N, CAP, seed=3, scale=0.08, aniso=True)
    ts = port_scene(js)
    _, _, tcams = ring_cameras(1)
    bg = torch.tensor([0.1, 0.2, 0.3])
    target = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(3, H, W)).astype(np.float32))
    tiling = TilingConfig(max_pairs=1 << 13, block=32)
    render = ttrainer.make_render(W, H, tiling)
    out, stats = render(ts, tcams[0], bg)
    want, want_stats = ttrainer.render_scene(ts, tcams[0], W, H, bg, tiling)
    assert render.captured.captures == 0
    for f in ("image", "radii", "depth"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    assert set(stats) == set(want_stats)
    cfg = ttrainer.TrainConfig(rasterizer="cuda", tiling=tiling)
    img, depth, logs = ttrainer.make_eval_step(cfg, W, H)(ts, tcams[0], target, bg)
    img2, depth2, logs2 = ttrainer.make_eval_step(cfg, W, H, capture=False)(
        ts, tcams[0], target, bg)
    assert torch.equal(img, img2) and torch.equal(depth, depth2)
    assert {k: float(v) for k, v in logs.items()} == {k: float(v) for k, v in logs2.items()}
    step = ttrainer.make_train_step(cfg, 1.0, W, H)
    assert step.captured is not None and step.captured.captures == 0
    assert ttrainer.make_train_step(dataclasses.replace(cfg, rasterizer="plain"), 1.0, W,
                                    H).captured is None


# ---- the sharded step's capture -------------------------------------------

def hand_mesh(backend, view=1, tile=1):
    """A ``Mesh`` as rank 0 sees it, built without a process group: the key
    and the decision to capture are pure Python."""
    return Mesh(grid=np.arange(view * tile).reshape(view, tile), rank=0,
                device=torch.device("cpu"), backend=backend, groups={})


def test_sharded_step_key_and_capture_decision():
    cfg = ttrainer.TrainConfig(capacity=CAP, batch_views=2,
                               tiling=TilingConfig(max_pairs=1 << 13, block=32))

    def make(mesh=None, capture=True, **changes):
        return tshard.make_sharded_train_step(dataclasses.replace(cfg, **changes), 1.0, W, H,
                                              mesh or hand_mesh("nccl"), capture=capture)

    nccl, gloo = hand_mesh("nccl"), hand_mesh("gloo")
    step = make(nccl)
    assert step.captured is not None and step.captured.captures == 0
    assert list(nccl.graphs) == [step.captured]  # for shutdown(mesh)
    assert make(capture=False).captured is None
    assert make(gloo).captured is None and len(gloo.graphs) == 0
    for route in ("plain", "xla"):
        assert make(rasterizer=route).captured is None

    scene = port_scene(jax_scene(N, CAP, seed=3, scale=0.08, aniso=True))
    assert scene.active_sh_degree > 0
    adam = topt.init_adam(scene.params)
    _, cams, tcams = ring_cameras(2)
    imgs, bgs = torch.zeros(2, 3, H, W), torch.zeros(2, 3)

    def key(fn=step, sc=scene, b=2, **kw):
        cam = cams if b == 2 else stack_cameras(tcams[:1])
        return fn.key(sc, adam, 0, cam, imgs[:b], bgs[:b], **kw)

    base = key()
    # the same shapes on other tensors, or another step number: the same key
    assert key(sc=clone_scene(scene)) == base
    assert step.key(scene, topt.init_adam(scene.params), 17, cams, imgs + 1, bgs) == base
    variants = {
        "sh_degree": key(sc=dataclasses.replace(scene, active_sh_degree=0)),
        "b_local": key(b=1),
        "exposure": key(exp_mat=torch.zeros(2, 3, 4)),
        "depth": key(depth_target=torch.zeros(2, 1, H, W)),
        "budget": key(make(tiling=TilingConfig(max_pairs=1 << 14, block=32))),
        "band_tiling": key(make(hand_mesh("nccl", 1, 2))),
    }
    keys = [base] + list(variants.values())
    assert len(set(keys)) == len(keys), variants
    # the tile axis changes the band geometry the key holds
    two = make(hand_mesh("nccl", 1, 2))
    assert (two.gy_local, two.band_tiling) != (step.gy_local, step.band_tiling)


# ---- the exposure update in place -----------------------------------------

EXPOSURE_CASES = {"int": [2, 0, 2, 4], "batch-repeated": [[1, 3, 1], [0, 2, 2], [4, 4, 4]]}


@pytest.mark.parametrize("case", list(EXPOSURE_CASES))
def test_exposure_update_in_place_matches_jax(case):
    rng = np.random.default_rng(4)
    params = (np.eye(3, 4) + 0.05 * rng.normal(size=(5, 3, 4))).astype(np.float32)
    mu = (0.01 * rng.normal(size=(5, 3, 4))).astype(np.float32)
    nu = (1e-4 * rng.uniform(size=(5, 3, 4))).astype(np.float32)
    js = jexposure.ExposureState(jnp.asarray(params), jnp.asarray(mu), jnp.asarray(nu),
                                 jnp.asarray(7, jnp.int32))
    ports = {name: interop.exposure_from_numpy(params, mu, nu, 7, device="cpu")
             for name in ("in_place", "made", "out_of_place")}
    given = ports["in_place"].params
    made = texposure.make_exposure_update(0.01)
    for idx in EXPOSURE_CASES[case]:
        g = (0.1 * rng.normal(size=np.shape(idx) + (3, 4))).astype(np.float32)
        js = jexposure.exposure_update(js, idx if np.ndim(idx) == 0 else jnp.asarray(idx),
                                       jnp.asarray(g), 0.01)
        ti, tg = torch.tensor(idx), torch.from_numpy(g)
        st = ports["in_place"]
        scalars = topt.scalars_tensor(topt.bias_corrections(0.9, 0.999, st.count + 1), "cpu")
        ports["in_place"] = texposure.exposure_update_(st, ti, tg, scalars, 0.01)
        ports["made"] = made(ports["made"], ti, tg)
        ports["out_of_place"] = texposure.exposure_update(ports["out_of_place"], idx, tg, 0.01)
    assert ports["in_place"].params is given  # written into the state's own tensors
    assert made.captured.captures == 0  # the CPU runs it eagerly
    for name, st in ports.items():
        assert st.count == int(js.count) == 7 + len(EXPOSURE_CASES[case]), name
        for f in ("params", "mu", "nu"):
            np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                          err_msg=f"{name}.{f}")
