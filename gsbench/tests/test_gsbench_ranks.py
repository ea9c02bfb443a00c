"""A mesh cell on four gloo ranks on the CPU: one result line, from rank 0
alone; each fault the mesh can have caught; a rank that fails or stalls
ends the run, non-zero, within its limit. Each launch runs in a process of
its own, as the benchmark's command does, and is judged by what that
process prints and its exit code."""

import json
import subprocess
import sys
import time
import types

import pytest

from gsbench import run
from gsbench.tests.tiny import ROOT, tiny_spec

CELL = "train-1080p-1m-mesh2x2"
WHATS = ["none", "unchanged", "half_batch", "altered_image", "no_exchange"]


def raising_rank(r, *args):
    if r.rank == 1:
        raise RuntimeError("a planted failure")
    run.rank_run(r, *args)


def stalling_rank(r, *args):
    if r.rank == 1:
        time.sleep(3600)
    run.rank_run(r, *args)


def jax_loading_rank(r, *args):
    """Rank 1 finds a module named ``jax`` (a stand-in) loaded once it has
    left the mesh, after the window."""
    if r.rank == 1:
        leave = r.leave

        def leave_and_load():
            sys.modules["jax"] = types.ModuleType("jax")
            return leave()

        r.leave = leave_and_load
    run.rank_run(r, *args)


def launch_faults():
    """Each of ``WHATS`` on the tiny mesh cell: the rows on standard output."""
    from gsbench import faults, ranks

    spec = tiny_spec(CELL)
    for row in ranks.launch(4, spec["config"]["mesh"], faults.mesh_job,
                            (spec, [5], 0.05, WHATS), "cpu"):
        print(json.dumps(row))


def _in_a_process(call: str, timeout: float) -> tuple:
    """``call`` (an expression on ``run``, ``t``, this module, and
    ``tiny_spec``) in a process of its own: (exit code, standard output,
    standard error, seconds)."""
    code = ("import sys, time\n"
            "from gsbench import run\n"
            "from gsbench.tests import test_gsbench_ranks as t\n"
            "from gsbench.tests.tiny import tiny_spec\n"
            "if __name__ == '__main__':\n"
            f"    sys.exit({call})\n")
    t0 = time.time()
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    return done.returncode, done.stdout, done.stderr, time.time() - t0


def _run_ranks(target: str = "run.rank_run", limit_s: float = 300, trace: bool = False) -> tuple:
    return _in_a_process(f"run.run_ranks(tiny_spec(t.CELL), 5, 0.05, {trace}, time.time(), "
                         f"device='cpu', target={target}, limit_s={limit_s})", limit_s + 300)


@pytest.mark.parametrize("trace", [False, True])
def test_four_ranks_give_one_line_from_rank_0(trace):
    spec = tiny_spec(CELL)
    assert spec["chips"] == 4
    rc, out, err, _ = _run_ranks(trace=trace)
    assert rc == 0, err[-2000:]
    out = out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["count"] == 4
    if not trace:
        assert set(line["metrics"]) == {"train_mrays_per_s", "setup_s"}
        return
    # the CPU's trace has no device events: the readers of kernels find nothing
    assert set(line["metrics"]) <= {m["name"] for m in spec["per_layer"]}
    assert "breakdown" in line and line["device"]["window_s"] > 0
    diag = next(ln for ln in err.splitlines() if ln.startswith("gsbench: {"))
    rank0 = json.loads(diag[len("gsbench: "):])["work"]["rank0"]
    assert 0 < rank0["kept"] and rank0["pixels"] == 2 * 2 * 32 * 64  # 2 steps of 2 views


def test_each_mesh_fault_is_caught():
    rc, out, err, _ = _in_a_process("t.launch_faults()", 900)
    assert rc == 0, err[-2000:]
    limits = tiny_spec(CELL)["limits"]
    rows = [json.loads(ln) for ln in out.strip().splitlines()]
    correct = {r["what"]: all(r["checks"][k] <= v for k, v in limits.items()) for r in rows}
    assert correct == {"none": True, "unchanged": False, "half_batch": False,
                       "altered_image": False, "no_exchange": False}


def test_a_rank_that_raises_ends_the_run():
    rc, out, err, seconds = _run_ranks("t.raising_rank")
    assert rc != 0 and seconds < 120
    assert out == "" and "rank 1 exited 1" in err


def test_jax_loaded_on_a_rank_but_0_leaves_no_line():
    rc, out, err, _ = _run_ranks("t.jax_loading_rank")
    assert rc != 0 and out == ""
    assert "JAX modules loaded: jax" in err and "rank 1 exited 3" in err


def test_a_rank_that_stalls_ends_the_run():
    rc, out, err, seconds = _run_ranks("t.stalling_rank", limit_s=20)
    assert rc != 0 and seconds < 20 + 120
    assert out == "" and "reached nothing for 20 s" in err
