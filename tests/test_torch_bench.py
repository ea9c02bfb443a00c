"""The port's measurement entry points (``scripts/bench.py``,
``bench_batched.py``, ``benchmark_scaling.py``, ``banded_check.py``) on the
CPU, where every kernel wrapper takes its plain version, against the JAX
repo's bench and step at small sizes.

Bounds, and why:
- the bench's loss within 1e-5 relative and each gradient within 1e-4 of
  its column's largest |JAX| value: ``test_photometric_loss_value_and_
  gradient_match_jax``'s bounds, the loss and gradient of the same render;
- the parity gate within the bench's own ``PARITY_TOL`` (1e-4);
- the batched first-step loss within 1e-5 relative (the coupled batched
  steps' bound);
- bands bit for bit against the full frame: each band runs the full
  frame's per-tile work in the same order;
- the 1x2 mesh's first loss within 1e-5 of the 1x1 mesh's (the band loss
  sums the same terms in another order).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
import bench as jax_bench
from gaussian_splatting_lightning_tpu.core.camera import make_camera as jax_make_camera
from gaussian_splatting_lightning_tpu.ops.rasterize_pallas import rasterize_pallas
from gaussian_splatting_lightning_tpu.ops.rasterize_tiled import TilingConfig as JaxTiling
from gaussian_splatting_lightning_tpu.training import loss as jloss
from gaussian_splatting_lightning_tpu.training import optimizer as jopt
from gaussian_splatting_lightning_tpu.training import trainer as jtrainer
from gaussian_splatting_lightning_tpu_torch.scripts import (
    banded_check,
    bench,
    bench_batched,
    benchmark_scaling,
)

W, H, N = 64, 48, 2000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain kernels are loops of small ops: threads only add overhead,
    # and the test workers already share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_result(**kw):
    res = {"step_s": 0.0262, "device_ms": 17.5, "compile_s": 2.1, "pairs": 2_094_637,
           "budget": 2_138_112, "dropped": 0,
           "launches": {"expand_pairs": 1.0, "composite_fwd": 1.0, "composite_bwd": 1.0,
                        "segment_sum": 1.0, "blur": 2.0}}
    res.update(kw)
    return res


# ---- (a) the result line and the roofline --------------------------------

def test_result_line_schema():
    line = bench._result_line("headline-1080p", 1920, 1080, 1_000_000, run_result(),
                              "gpu", gpu="NVIDIA H100 80GB HBM3, 700.00 W")
    parsed = json.loads(json.dumps(line))  # JSON-serializable as it is
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in parsed
    assert parsed["value"] == pytest.approx(1920 * 1080 / 0.0262)
    assert parsed["vs_baseline"] is None
    ex = parsed["extra"]
    assert ex["dropped_pairs"] == 0 and ex["impl"] == "cuda" and ex["platform"] == "gpu"
    assert ex["pairs"] == 2_094_637 and ex["pair_budget"] == 2_138_112
    assert ex["step_ms"] == pytest.approx(26.2) and ex["device_ms"] == 17.5
    assert ex["gpu"].startswith("NVIDIA") and ex["launches"]["blur"] == 2.0
    assert "roofline_attainable_ms" not in ex
    assert ex["roofline_hard_ms"] == pytest.approx(
        bench.roofline_ms(2_094_637, 32, 1_000_000, 1920, 1080))
    assert ex["pct_of_roofline"] == pytest.approx(100 * ex["roofline_hard_ms"] / 26.2)
    # the JAX bench's keys, less the attainable bound, are all there
    jline = jax_bench._result_line("headline-1080p", 1920, 1080, 1_000_000, 0.0262, 2.1,
                                   2_094_637, 2_138_112, 0, "tpu")
    assert set(jline) == set(line)
    assert set(jline["extra"]) - {"roofline_attainable_ms"} <= set(ex)
    # enrichment (the final print) keeps it serializable
    line["extra"]["parity_512x384_100k"] = {"routing_f32": {"image_max_abs": 1e-7}}
    json.loads(json.dumps(line))


def test_roofline_monotone_and_on_card_peaks():
    base = bench.roofline_ms(2_000_000, 32, 1_000_000, 1920, 1080)
    assert 0 < base
    assert bench.roofline_ms(4_000_000, 32, 1_000_000, 1920, 1080) > base
    assert bench.roofline_ms(2_000_000, 32, 2_000_000, 1920, 1080) > base
    ops, nbytes = bench.roofline_work(2_000_000, 32, 1_000_000, 1920, 1080)
    assert base == pytest.approx(1e3 * (nbytes / 3.35e12 + ops / 67e12))
    # the bench step runs no Adam; a train step's Adam adds bytes, a ZeRO-1
    # shard's fewer, and the operations stay
    ops2, nbytes2 = bench.roofline_work(2_000_000, 32, 1_000_000, 1920, 1080,
                                        adam_splats=250_000)
    ops3, nbytes3 = bench.roofline_work(2_000_000, 32, 1_000_000, 1920, 1080,
                                        adam_splats=1_000_000)
    assert ops2 == ops3 == ops and nbytes < nbytes2 < nbytes3
    # with every splat's Adam the bytes are the JAX bench model's terms
    jax_bytes = (7 * 236 * 1_000_000 + (236 + 2 * 52) * 1_000_000
                 + (3 * 16 * 4 + 16 * 2) * 2_000_000 + 10 * 3 * 4 * 1920 * 1080
                 + 8 * 6 * 2_000_000)
    assert nbytes3 == jax_bytes and nbytes == jax_bytes - 6 * 236 * 1_000_000


# ---- (b) the bench's gradient against the JAX bench's --------------------

def test_bench_gradient_matches_jax_pallas_interpret():
    grad_fn, args, pairs, budget = bench.bench_problem(W, H, N, device="cpu")
    loss, grads, dropped = grad_fn(*args)

    scene = graft._synthetic_scene(N, N, scale=0.008)
    cam = graft._camera(W, H)
    jpairs = jax_bench._estimate_pairs_numpy(scene, cam, W, H)
    assert pairs == jpairs
    assert budget == max(16384, -(-int(jpairs * 1.02) // 8192) * 8192)
    cfg = JaxTiling(max_pairs=budget, block=32, pair_grad_bf16=False)
    target = jnp.asarray(np.random.default_rng(0).uniform(size=(3, H, W)).astype(np.float32))

    def loss_fn(*p):
        out, stats = rasterize_pallas(*p, cam, W, H, jnp.zeros(3), 3, config=cfg,
                                      interpret=True)
        value, _ = jloss.photometric_loss(out.image, target, 0.2)
        return value, (value, stats["num_dropped_pairs"])

    jargs = (scene.params.xyz, scene.get_opacity(), scene.get_scales(),
             scene.get_rotation(), scene.get_features())
    jgrads, (jvalue, jdropped) = jax.grad(loss_fn, argnums=(0, 1, 2, 3, 4),
                                          has_aux=True)(*jargs)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(dropped) == int(jdropped) == 0
    assert abs(float(loss) - float(jvalue)) <= 1e-5 * abs(float(jvalue))
    for name, g, jg in zip(("xyz", "opacity", "scales", "rotation", "sh"), grads, jgrads):
        jg = np.asarray(jg).reshape(N, -1)
        col = np.abs(jg).max(axis=0)
        # isotropic splats: the rotation moves nothing, on both sides
        assert (col.max() == 0) == (name == "rotation"), name
        assert np.all(np.abs(g.numpy().reshape(N, -1) - jg) <= 1e-4 * col), name


def test_run_and_parity_gate_on_the_cpu():
    res = bench.run(W, H, N, iters=1, warmup=0, device="cpu")
    assert res["dropped"] == 0 and res["step_s"] > 0 and res["device_ms"] is None
    assert res["pairs"] == jax_bench._estimate_pairs_numpy(
        graft._synthetic_scene(N, N, scale=0.008), graft._camera(W, H), W, H)
    # CPU tensors run the plain versions, which count no launch
    assert set(res["launches"]) == {"expand_pairs", "composite_fwd", "composite_bwd",
                                    "segment_sum", "blur", "preprocess_fwd",
                                    "preprocess_bwd", "adam", "photometric"}
    assert not any(res["launches"].values())
    row = bench.parity_gate(W, H, N, device="cpu", iters=1)["routing_f32"]
    assert row["dropped_pairs"] == 0 and row["tile_overflow"] == 0
    assert row["image_max_abs"] <= bench.PARITY_TOL
    assert row["grad_max_rel"] <= bench.PARITY_TOL
    assert set(row["grad_rel_per_param"]) == {"xyz", "opacity", "scales", "quats", "sh"}


@pytest.mark.parametrize("module", [bench, bench_batched, benchmark_scaling, banded_check],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_entry_points_default_to_the_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main([])


# ---- (c) the view-batched bench -------------------------------------------

def test_bench_batched_rows_and_first_loss_match_jax(capsys):
    w, h, n = 64, 48, 600
    res = bench_batched.main(["--width", str(w), "--height", str(h), "--n", str(n),
                              "--iters", "1", "--batches", "1", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    rows = res["rows"]
    assert [r["batch_views"] for r in rows] == [1, 2]
    for r in rows:
        assert {"batch_views", "step_ms", "ms_per_view", "views_per_s",
                "speedup_per_view"} <= set(r)
        assert r["dropped_pairs"] == 0 and np.isfinite(r["first_step_loss"])
        assert r["device_ms"] is None and r["peak_mem_bytes"] is None
    assert rows[0]["speedup_per_view"] == 1.0

    # the JAX repo's bench_batched problem at B = 2, on its interpret route
    def ring_cam(i, total):
        return jax_make_camera(bench_batched.ring_pose(i, total), w * 0.7, w * 0.7, w, h)

    cams = [ring_cam(i, 8) for i in range(8)]
    scene = graft._synthetic_scene(n, n, scale=0.01)
    budget = max(jax_bench._estimate_pairs_numpy(scene, c, w, h) for c in cams[:4])
    budget = max(16384, -(-int(budget * 1.3) // 8192) * 8192)
    assert res["config"] == f"{w}x{h}, {n} splats, budget {budget}"
    rng = np.random.default_rng(0)
    rng.uniform(size=(1, 3, h, w))  # B = 1's images come first
    img = jnp.asarray(rng.uniform(size=(2, 3, h, w)).astype(np.float32))
    cfg = jtrainer.TrainConfig(capacity=n, batch_views=2, rasterizer="pallas_interpret",
                               tiling=JaxTiling(max_pairs=budget, tile_capacity=4096,
                                                pair_grad_bf16=False))
    step = jtrainer.make_train_step(cfg, 4.0, w, h)
    cam_b = jax.tree.map(lambda *xs: jnp.stack(xs), *cams[:2])
    _, _, logs = step(scene, jopt.init_adam(scene.params), 0, cam_b, img,
                      jnp.zeros((2, 3), jnp.float32))
    want = float(logs["loss"])
    assert abs(rows[1]["first_step_loss"] - want) <= 1e-5 * abs(want)


# ---- (d) the banded check -------------------------------------------------

def test_banded_check_is_bit_for_bit_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "banded.json"
    rec = banded_check.main(["--width", "128", "--height", "64", "--splats", "2000",
                             "--bands", "2", "--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == rec
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["ok"] and rec["per_tile_pair_lists_identical"]
    assert rec["banded_vs_full_max_delta"] == 0.0 and rec["banded_dropped_pairs"] == 0
    assert rec["sharded_1x1_backend"] == "gloo"
    assert rec["sharded_1x1_loss_rel_err"] <= banded_check.SHARDED_LOSS_TOL
    # the JAX record's keys are all there
    for key in ("banded_vs_full_max_delta", "banded_vs_full_mean_delta",
                "banded_vs_full_psnr_db", "per_tile_pair_lists_identical",
                "banded_dropped_pairs", "sharded_1x1_loss", "ok"):
        assert key in rec


def test_banded_check_refuses_uneven_bands():
    with pytest.raises(ValueError, match="do not divide"):
        banded_check.run_check(128, 96, 100, bands=2, device="cpu")


# ---- (e) the scaling harness on gloo ranks --------------------------------

def test_benchmark_scaling_on_gloo_ranks(tmp_path, capsys):
    out = tmp_path / "scaling.md"
    res = benchmark_scaling.main(["--width", "64", "--height", "64", "--splats", "500",
                                  "--iters", "1", "--meshes", "1x1,1x2,2x2",
                                  "--devices", "2", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "skip 2x2: only 2 devices" in text and res["skipped"] == ["2x2"]
    rows = {r["mesh"]: r for r in res["rows"]}
    assert set(rows) == {"1x1", "1x2"}
    for r in rows.values():
        assert r["backend"] == "gloo" and not r["shared_card"]
        assert r["dropped"] == 0 and r["tile_overflow"] == 0
        for k in ("step_ms", "rays_per_s", "wall_eff", "gflop_per_dev", "gb_per_dev",
                  "flops_eff", "bytes_eff", "loss", "last_loss"):
            assert np.isfinite(r[k]) and r[k] > 0, k
    one, two = rows["1x1"], rows["1x2"]
    assert abs(two["loss"] - one["loss"]) <= 1e-5 * one["loss"]
    assert len(two["band_pairs"]) == 2 and sum(two["band_pairs"]) >= one["band_pairs"][0]
    assert two["gflop_per_dev"] < one["gflop_per_dev"]  # each band holds half the pairs
    table = out.read_text()
    assert "not a compiler's estimate" in table and "| 1x2 | gloo |" in table


def test_benchmark_scaling_eff_is_null_across_drops(capsys):
    # ~500 splats a 16 px tile against the harness's tile capacity of 256:
    # the only mesh, the baseline, overflows its tiles, so no efficiency is
    # reported for it
    res = benchmark_scaling.main(["--width", "64", "--height", "64", "--splats", "5000",
                                  "--iters", "1", "--meshes", "1x1",
                                  "--devices", "1", "--device", "cpu"])
    (row,) = res["rows"]
    assert row["dropped"] + row["tile_overflow"] > 0 and np.isfinite(row["loss"])
    assert row["wall_eff"] is None and row["flops_eff"] is None and row["bytes_eff"] is None
    assert "wall eff n/c" in capsys.readouterr().out
