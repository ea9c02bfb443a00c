"""Shared fixtures of the PyTorch port's parity tests (``test_torch_*.py``).

Scenes and cameras come from the JAX package's bench fixtures
(``__graft_entry__._synthetic_scene`` / ``_camera``); the port receives the
same numbers through ``interop``. Everything runs on the CPU.
"""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from gaussian_splatting_lightning_tpu.models.gaussians import PARAM_NAMES
from gaussian_splatting_lightning_tpu.ops.common import preprocess as jax_preprocess
from gaussian_splatting_lightning_tpu_torch import interop
from gaussian_splatting_lightning_tpu_torch.ops.common import Preprocessed
from gaussian_splatting_lightning_tpu_torch.scripts import bench

BG = np.array([0.1, 0.2, 0.3], np.float32)


def jax_scene(n=800, capacity=1000, seed=0, scale=0.05, aniso=True, dead_every=0):
    """The JAX bench fixture; every ``dead_every``-th live splat is killed."""
    scene = graft._synthetic_scene(n, capacity, seed=seed, scale=scale, aniso=aniso)
    if dead_every:
        alive = np.asarray(scene.alive).copy()
        alive[:n:dead_every] = False
        scene = dataclasses.replace(scene, alive=jnp.asarray(alive))
    return scene


def port_scene(jscene):
    params = {k: np.asarray(getattr(jscene.params, k)) for k in PARAM_NAMES}
    return interop.scene_from_numpy(params, np.asarray(jscene.alive),
                                    int(jscene.active_sh_degree), device="cpu")


def cameras(w, h, fx=0.7):
    jc = graft._camera(w, h, fx)
    tc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, f)) for f in
          ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy")),
        device="cpu",
    )
    return jc, tc


def jax_prep(jscene, jcam, w, h, antialias=False):
    return jax_preprocess(
        jscene.params.xyz, jscene.get_opacity(), jscene.get_scales(),
        jscene.get_rotation(), jscene.get_features(), jcam, w, h,
        jscene.active_sh_degree, jscene.max_sh_degree, antialias=antialias,
        alive=jscene.alive,
    )


def torch_prep_from_jax(jprep) -> Preprocessed:
    """The same Preprocessed numbers as port tensors (CPU)."""
    return Preprocessed(**{
        f.name: torch.from_numpy(np.array(getattr(jprep, f.name)))
        for f in dataclasses.fields(Preprocessed)
    })


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def activated(scene, lib):
    """The activated parameters (means, opacity, scales, rotation, SH), as
    the render wrappers pass them: fresh torch leaves or jnp arrays."""
    x = bench.activated(scene)
    if lib == "torch":
        return [t.detach().clone() for t in x]
    return [jnp.asarray(t) for t in x]


def assert_grads_close(got, want, tol=1e-4):
    """Each gradient of ``activated``'s five inputs within ``tol`` of the
    largest |value| of its JAX counterpart."""
    for name, g, w in zip(("xyz", "opacity", "scales", "quats", "sh"), got, want):
        w = np.asarray(w).reshape(g.shape)
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol * scale, (name, err, scale)

