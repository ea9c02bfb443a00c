"""``spans.reduce`` on hand-made events: segment sums, the busy share inside
the segments, the device idle under a host span, the marks' own time, the
kernels inside the segments, and None for a sequence with a mark missing,
repeated or out of order."""

import pytest

from gsbench import spans
from gsbench.tests.test_gsbench_line import _Event

WORK = "void at::native::vectorized_elementwise_kernel<4, add>"


def step(t0, order=spans.SPANS, work_ns=40, name=WORK):
    """Marks 100 ns apart from ``t0`` (2 ns each), each followed by
    ``work_ns`` of ``name``."""
    events = []
    for i, mark in enumerate(order):
        events.append(_Event(f"gs_span_{mark}()", t0 + 100 * i, 2, True))
        if i < len(order) - 1:
            events.append(_Event(name, t0 + 100 * i + 10, work_ns, True))
    return events


def test_segments_coverage_marks_and_kernels():
    events = step(0) + step(2000, work_ns=60)
    events.append(_Event("Memcpy DtoH (Device -> Pageable)", 1500, 100, True))  # outside
    events.append(_Event("void composite_bwd_kernel<32>(float4 const*)", 510, 30, True))
    sp = spans.reduce(events)
    assert sp.steps == 2
    assert list(sp.segment_ms) == list(spans.SPANS[:-1])
    for name, ms in sp.segment_ms.items():  # K3 lies inside the work: counted once
        assert ms == pytest.approx(50e-6), name
    assert sp.ms("binning", "composite", "composite_bwd") == pytest.approx(150e-6)
    assert sp.covered == pytest.approx(900 / 1000)
    assert sp.mark_us == pytest.approx(10 * 2e-3)
    assert sp.inside_ms[WORK] == pytest.approx(9 * 50e-6)
    assert sp.inside_ms["void composite_bwd_kernel<32>(float4 const*)"] == pytest.approx(15e-6)
    assert "Memcpy DtoH (Device -> Pageable)" not in sp.inside_ms


def test_idle_under_a_host_span():
    events = step(0) + step(2000)
    events += [_Event("trainer.log_read", 950, 250, False),  # device busy 1000-1060
               _Event(WORK, 1000, 60, True),
               _Event("trainer.log_read", 1000, 60, True),  # the profiler's copy: no work
               _Event("trainer.step", 1900, 100, False),  # idle throughout
               _Event("aten::copy_", 1900, 100, False)]  # not a span of the loop
    sp = spans.reduce(events)
    assert sp.host_idle_ms["trainer.log_read"] == pytest.approx((250 - 60) * 1e-6 / 2)
    assert sp.host_idle_ms["trainer.step"] == pytest.approx(100e-6 / 2)
    assert "aten::copy_" not in sp.host_idle_ms
    # a host span over the first nine marks and their work: the gaps are idle
    sp = spans.reduce(step(0) + [_Event("trainer.step", 0, 900, False)])
    assert sp.host_idle_ms["trainer.step"] == pytest.approx((900 - 9 * 40 - 9 * 2) * 1e-6)


def test_eval_and_render_sequences_are_left_out():
    base = spans.reduce(step(0) + step(2000))
    mixed = spans.reduce(step(0) + step(1000, spans.EVAL_SPANS) + step(1500, spans.RENDER_SPANS)
                         + step(2000))
    assert mixed.steps == 2 and mixed.segment_ms == base.segment_ms


@pytest.mark.parametrize("broken", ["missing", "swapped", "repeated", "no-start", "no-step"])
def test_a_broken_sequence_gives_none(broken):
    order = list(spans.SPANS)
    if broken == "missing":
        order.remove("adam")
    elif broken == "swapped":
        order[3], order[4] = order[4], order[3]
    elif broken == "repeated":
        order.insert(5, "loss_bwd")
    elif broken == "no-start":
        order = order[1:]
    else:  # an eval step alone: no step to count
        assert spans.reduce(step(0, spans.EVAL_SPANS)) is None
        return
    assert spans.reduce(step(0) + step(2000, order)) is None


def test_the_names_are_the_programs():
    """The harness reads the program's names without importing it."""
    import ast
    from pathlib import Path

    src = (Path(__file__).resolve().parents[2] / "gaussian_splatting_lightning_tpu_torch"
           / "utils" / "runtime.py").read_text()
    names = {t.id: ast.literal_eval(node.value) for node in ast.parse(src).body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name)
             and t.id in ("SPANS", "EVAL_SPANS", "RENDER_SPANS", "HOST_SPANS")}
    assert names == {"SPANS": spans.SPANS, "EVAL_SPANS": spans.EVAL_SPANS,
                     "RENDER_SPANS": spans.RENDER_SPANS, "HOST_SPANS": spans.HOST_SPANS}
