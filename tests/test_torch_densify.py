"""The port's densification events against the JAX package.

``densify_and_prune`` runs on both sides from the same scene, Adam state and
statistics, with JAX's ``jax.random.normal`` draw passed to the port as its
``noise``. Bounds, and why:
- ``alive``, every parameter group, both Adam moments, the accumulators and
  all eight stats bit-identical, except ``xyz`` of split splats;
- ``xyz`` of split parents and their children within 4 ulp of the largest
  |xyz| (measured <= 1 ulp): the displacement goes through a 3x3 rotation
  product, which the two libraries sum in their own order.
Also ``reset_opacity``, ``step_sh_degree``, the trainer's three event
functions and ``from_colmap_points_ply``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussian_splatting_lightning_tpu.models import gaussians as jgm
from gaussian_splatting_lightning_tpu.training import densify as jdensify
from gaussian_splatting_lightning_tpu.training import optimizer as jopt
from gaussian_splatting_lightning_tpu.training import trainer as jtrainer
from gaussian_splatting_lightning_tpu_torch import interop
from gaussian_splatting_lightning_tpu_torch.models import gaussians as tgm
from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
from gaussian_splatting_lightning_tpu_torch.training import densify as tdensify
from gaussian_splatting_lightning_tpu_torch.training import trainer as ttrainer
from tests.torch_parity import jax_scene

STAT_KEYS = ("n_cloned", "n_split", "n_pruned", "n_pruned_opacity", "n_pruned_screen",
             "n_pruned_size", "n_dropped_children", "n_alive")
# thresholds that give every branch work on the fixture (scales 0.015-0.15,
# opacity logits -2..3): clone below 0.05, split above, world prune at 0.125
CFG = dict(densify_grad_threshold=2e-4, clone_size_threshold=0.01,
           prune_size_threshold=0.025, prune_opacity_threshold=0.2,
           prune_screensize_threshold=40.0)
SPATIAL = 5.0


def stat_scene(n, capacity, seed):
    """The JAX fixture with random densification statistics and random Adam
    moments (so the surgery's zeroing shows)."""
    rng = np.random.default_rng(seed)
    js = jax_scene(n, capacity, seed=seed, aniso=True)
    count = rng.integers(0, 5, size=capacity).astype(np.float32)
    accum = (rng.uniform(0, 5e-4, size=capacity) * count).astype(np.float32)
    radii = rng.uniform(0, 60, size=capacity).astype(np.float32)
    js = dataclasses.replace(js, grad_accum=jnp.asarray(accum),
                             grad_count=jnp.asarray(count), max_radii2d=jnp.asarray(radii))
    moments = [{k: rng.normal(size=np.asarray(getattr(js.params, k)).shape).astype(np.float32)
                for k in PARAM_NAMES} for _ in range(2)]
    moments[1] = {k: np.abs(v) for k, v in moments[1].items()}
    jadam = jopt.AdamState(count=jnp.asarray(7, jnp.int32),
                           mu=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in moments[0].items()}),
                           nu=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in moments[1].items()}))
    return js, jadam


def to_port(js, jadam):
    ts = interop.scene_from_numpy({k: np.asarray(getattr(js.params, k)) for k in PARAM_NAMES},
                                  np.asarray(js.alive), int(js.active_sh_degree), device="cpu")
    for k in ("max_radii2d", "grad_accum", "grad_count"):
        setattr(ts, k, torch.from_numpy(np.array(getattr(js, k))))
    tadam = interop.adam_from_numpy(
        int(jadam.count), {k: np.asarray(getattr(jadam.mu, k)) for k in PARAM_NAMES},
        {k: np.asarray(getattr(jadam.nu, k)) for k in PARAM_NAMES}, device="cpu")
    return ts, tadam


def snapshot(ts, tadam):
    out = {f"p.{k}": getattr(ts.params, k).clone() for k in PARAM_NAMES}
    out.update({f"mu.{k}": getattr(tadam.mu, k).clone() for k in PARAM_NAMES})
    out.update({f"nu.{k}": getattr(tadam.nu, k).clone() for k in PARAM_NAMES})
    out.update({k: getattr(ts, k).clone() for k in ("alive", "max_radii2d", "grad_accum",
                                                    "grad_count")})
    return out


def assert_same(js, jadam, jstats, ts, tadam, tstats, split_rows):
    for k in STAT_KEYS:
        assert int(tstats[k]) == int(jstats[k]), k
    np.testing.assert_array_equal(np.asarray(js.alive), ts.alive.numpy())
    for k in PARAM_NAMES:
        a, b = np.asarray(getattr(js.params, k)), getattr(ts.params, k).numpy()
        if k == "xyz":
            bound = 4 * np.spacing(np.float32(np.abs(a).max()))
            np.testing.assert_allclose(a[split_rows], b[split_rows], rtol=0, atol=bound)
            a, b = a[~split_rows], b[~split_rows]
        np.testing.assert_array_equal(a, b, err_msg=k)
        for name, jm, tm in (("mu", jadam.mu, tadam.mu), ("nu", jadam.nu, tadam.nu)):
            np.testing.assert_array_equal(np.asarray(getattr(jm, k)), getattr(tm, k).numpy(),
                                          err_msg=f"{name}.{k}")
    for k in ("max_radii2d", "grad_accum", "grad_count"):
        np.testing.assert_array_equal(np.asarray(getattr(js, k)), getattr(ts, k).numpy())
    assert ts.active_sh_degree == int(js.active_sh_degree)
    assert tadam.count == int(jadam.count)


CASES = {
    # name: (n alive, capacity, config overrides, apply_screensize)
    "clone-split-prune": (600, 1000, {}, False),
    "screensize-on": (600, 1000, {}, True),
    "screensize-threshold-off": (600, 1000, {"use_screensize_threshold": False}, True),
    "full-capacity": (1000, 1000, {"prune_opacity_threshold": 0.13}, False),
    "no-children": (600, 1000, {"densify_grad_threshold": 1.0}, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_densify_and_prune_matches_jax(case):
    n, cap, over, apply_screensize = CASES[case]
    js, jadam = stat_scene(n, cap, seed=len(case))
    ts, tadam = to_port(js, jadam)
    before = snapshot(ts, tadam)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, (cap, 3), jnp.float32))
    jcfg = jdensify.DensifyConfig(**dict(CFG, **over))
    tcfg = tdensify.DensifyConfig(**dict(CFG, **over))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    js2, jadam2, jstats = jdensify.densify_and_prune(js, jadam, key, jcfg, SPATIAL,
                                                     apply_screensize)
    ts2, tadam2, tstats = tdensify.densify_and_prune(ts, tadam, torch.from_numpy(noise), tcfg,
                                                     SPATIAL, apply_screensize)
    split = np.asarray(js2.params.xyz) != np.asarray(js.params.xyz)
    assert_same(js2, jadam2, jstats, ts2, tadam2, tstats, split.any(axis=1))
    # the inputs are left as they were
    after = snapshot(ts, tadam)
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    s = {k: int(v) for k, v in jstats.items()}
    if case == "no-children":
        assert s["n_cloned"] == s["n_split"] == 0 and s["n_pruned"] > 0
    else:
        assert s["n_cloned"] > 0 and s["n_split"] > 0 and s["n_pruned_opacity"] > 0
    if case == "full-capacity":
        assert s["n_dropped_children"] > 0 and s["n_alive"] == cap
    else:
        assert s["n_dropped_children"] == 0
    if case == "screensize-on":
        assert s["n_pruned_screen"] > 0 and s["n_pruned_size"] > 0
    if case == "screensize-threshold-off":
        assert s["n_pruned_screen"] == 0 and s["n_pruned_size"] > 0
    if case == "clone-split-prune":
        assert s["n_pruned_screen"] == s["n_pruned_size"] == 0


def test_trainer_events_match_jax():
    """``densify_step``, ``opacity_reset_step`` (``reset_opacity``) and
    ``sh_degree_step`` (``step_sh_degree``, capped at the scene's degree)."""
    js, jadam = stat_scene(600, 1000, seed=2)
    ts, tadam = to_port(js, jadam)
    key = jax.random.PRNGKey(9)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (1000, 3), jnp.float32)))
    cfg_j = jdensify.DensifyConfig(**CFG)
    cfg_t = tdensify.DensifyConfig(**CFG)
    xyz0 = np.asarray(js.params.xyz)
    js, jadam, jstats = jtrainer.densify_step(js, jadam, key, cfg_j, SPATIAL, True)
    ts, tadam, tstats = ttrainer.densify_step(ts, tadam, noise, cfg_t, SPATIAL, True)
    assert_same(js, jadam, jstats, ts, tadam, tstats,
                (np.asarray(js.params.xyz) != xyz0).any(axis=1))

    js, ts = jtrainer.opacity_reset_step(js), ttrainer.opacity_reset_step(ts)
    np.testing.assert_array_equal(np.asarray(js.params.opacity), ts.params.opacity.numpy())
    assert float(ts.get_opacity().max()) <= 0.0100001
    for _ in range(5):
        js, ts = jtrainer.sh_degree_step(js), ttrainer.sh_degree_step(ts)
        assert ts.active_sh_degree == int(js.active_sh_degree)
    assert ts.active_sh_degree == ts.max_sh_degree == 3


def test_from_colmap_points_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    n = 300
    verts = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, size=(n, 3))
    for i, c in enumerate("xyz"):
        verts[c] = xyz[:, i]
    for i, c in enumerate(("red", "green", "blue")):
        verts[c] = rgb[:, i]
    header = (["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
              + [f"property float {c}" for c in "xyz"]
              + [f"property uchar {c}" for c in ("red", "green", "blue")] + ["end_header", ""])
    path = tmp_path / "points3D.ply"
    path.write_bytes("\n".join(header).encode("ascii") + verts.tobytes())
    js = jgm.from_colmap_points_ply(str(path), 512, sh_degree=2)
    ts = tgm.from_colmap_points_ply(str(path), 512, sh_degree=2, device="cpu")
    for k in PARAM_NAMES:
        np.testing.assert_allclose(np.asarray(getattr(js.params, k)),
                                   getattr(ts.params, k).numpy(), rtol=1e-6, atol=0, err_msg=k)
    np.testing.assert_array_equal(np.asarray(js.alive), ts.alive.numpy())
    assert ts.active_sh_degree == int(js.active_sh_degree) == 0 and ts.max_sh_degree == 2
