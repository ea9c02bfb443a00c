"""The result line's schema, the trace reduction and the import guard."""

import json

import pytest

from gsbench import run, trace
from gsbench.tests.tiny import tiny_spec


class _Event:
    def __init__(self, name, start, dur, dev):
        self._n, self._s, self._d, self._dev = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"


def _trace(steps=2):
    events = [
        _Event("void composite_fwd_kernel<32>(float4 const*)", 0, 1000, True),
        _Event("void composite_bwd_kernel<32>(float4 const*)", 1000, 3000, True),
        _Event("void expand_pairs_kernel(int const*)", 4000, 500, True),
        _Event("void cub::DeviceRadixSortOnesweepKernel<...>", 4500, 500, True),
        _Event("ncclDevKernel_AllReduce_Sum_f32", 4000, 2000, True),  # overlaps
        # the preprocess pair's, Adam's and the loss's kernels, inside it
        _Event("preprocess_fwd_kernel(float const*)", 4000, 200, True),
        _Event("adam_update_kernel(float*)", 4200, 300, True),
        _Event("photometric_fwd_kernel(float const*)", 5000, 400, True),
        _Event("void at::native::vectorized_elementwise_kernel<4, add>", 20000, 1000, True),
        _Event("cudaStreamSynchronize", 5500, 14000, False),
    ]
    return trace.reduce_events(events, steps, wall_s=30e-6)


def test_trace_reduction_by_hand():
    tr = _trace()
    assert tr.busy_s == pytest.approx(7000e-9)  # [0, 6000) and [20000, 21000)
    assert tr.per_step_ms(lambda k: trace.kernel_class(k) == "torch") == pytest.approx(0.95e-3)
    assert tr.per_step_ms(lambda k: trace.kernel_class(k) == "sort") == pytest.approx(0.25e-3)
    assert tr.per_step_ms(lambda k: trace.kernel_class(k) == "nccl") == pytest.approx(1e-3)
    assert tr.launches_per_step() == 4.5
    assert tr.top_ops(2)[0][0] == "K3 composite_bwd"
    assert tr.idle_gaps == [["cudaStreamSynchronize", pytest.approx(14000e-9)]]


def _res(checks, trace_=None):
    return {"steps": 100, "wall_s": 2.0, "setup_s": 9.5, "pixels_per_step": 1000,
            "memory_peak_bytes": 123, "attempted": 100, "failed": 0, "checks": checks,
            "trace": trace_, "work": {"kept": 1e9, "visible": 1e6, "views": 2,
                                      "rank0": {"kept": 1e9, "visible": 1e6, "pixels": 2000}}}


def test_line_untraced_schema_and_rate():
    spec = tiny_spec()
    limits = spec["limits"]
    line = run.result_line(spec, _res({k: 0.0 for k in limits}), False, "card", 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"]["train_mrays_per_s"] == {"value": 0.05, "unit": "Mrays/s"}
    assert line["metrics"]["setup_s"]["value"] == 9.5
    assert line["device"] == {"platform": "gpu", "kind": "card", "count": 1,
                              "memory_peak_bytes": 123}
    assert set(line["checks"]) == set(limits)
    json.dumps(line)


def test_a_mesh_lines_busy_time_is_the_ranks_mean_in_both_places():
    spec = tiny_spec("train-1080p-1m-mesh2x2")
    res = dict(_res({k: 0.0 for k in spec["limits"]}, _trace()), busy_s=6000e-9)
    line = run.result_line(spec, res, True, "card", 4)
    assert line["device"]["busy_s"] == 6000e-9
    assert line["device"]["window_s"] == pytest.approx(30e-6)
    assert line["metrics"]["device_idle_pct.train"]["value"] == pytest.approx(80.0)


def test_line_traced_schema_and_a_failed_check():
    spec = tiny_spec()
    checks = {k: 0.0 for k in spec["limits"]}
    checks["grad_gap"] = 2 * spec["limits"]["grad_gap"]
    line = run.result_line(spec, _res(checks, _trace()), True, "card", 1)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert line["correct"] is False
    assert set(line["metrics"]) == {m["name"] for m in spec["per_layer"]}
    assert line["device"]["busy_s"] == pytest.approx(7000e-9)
    assert len(line["breakdown"]["device_ops"]) <= 10
    for name, m in line["metrics"].items():
        if name.endswith("roofline_pct") or "mfu" in name or name.endswith("roofline_pct.train"):
            assert 0 < m["value"]


def test_import_guard_compares_whole_top_level_names():
    assert run.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client"]) == [
        "jax", "jax.numpy", "jaxlib.xla_client"]
    assert run.forbidden_modules(["gaussian_splatting_lightning_tpu.ops"]) == [
        "gaussian_splatting_lightning_tpu.ops"]
    assert run.forbidden_modules(["gaussian_splatting_lightning_tpu_torch",
                                  "gaussian_splatting_lightning_tpu_torch.ops", "jaxtyping",
                                  "flaxen"]) == []


def test_a_reader_that_loads_jax_stops_the_line(tmp_path, monkeypatch, capsys):
    """The guard runs after the per-layer readers load: a reader importing a
    module named ``jax`` (a stand-in here) leaves no result line."""
    import shutil
    import sys

    assert run.forbidden_modules() == []
    here = tmp_path / "gsbench"
    shutil.copytree(run.ROOT / "gsbench" / "metrics", here / "metrics")
    (here / "metrics" / "loads_jax.py").write_text(
        "def read(ctx):\n    import jax  # noqa: F401\n    return 1.0\n")
    (tmp_path / "standin" / "jax").mkdir(parents=True)
    (tmp_path / "standin" / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "standin"))
    spec = tiny_spec()
    res = _res({k: 0.0 for k in spec["limits"]}, _trace())
    assert run.emit(spec, res, True, "card", 1, here) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"] is True
    spec["per_layer"].append({"name": "loads_jax", "unit": "%"})
    try:
        assert run.emit(spec, res, True, "card", 1, here) != 0
        captured = capsys.readouterr()
        assert captured.out == "" and "jax" in captured.err
    finally:
        sys.modules.pop("jax", None)
