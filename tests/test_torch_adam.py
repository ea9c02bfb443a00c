"""The Adam kernel's wrapper (``ops/adam.py``) and routing, on the CPU.

- CPU tensors take ``_adam_plain`` (no launch, the kernel's wrapper never
  called): ``adam_update`` and ``adam_update_`` give its bits, dense and
  sparse.
- The descriptor table of the six groups: rows, widths, gradient row
  strides, rate indices and the path of each group, for one tensor a group,
  for the mesh's column slices of a (rows, 59) table, for a row slice that
  starts off a 16-byte boundary, and at SH degree 0.
- The wrapper's checks refuse what the kernel does not take: another dtype,
  a p, m, v or output that is not contiguous, a gradient whose rows are not
  contiguous, a shape that differs, a mask of the wrong length.

The kernel against the plain version bit for bit runs on the card:
``tests/test_torch_cuda_kernels.py`` (``-k adam``).
"""

import pytest
import torch

from gaussian_splatting_lightning_tpu_torch.models.gaussians import PARAM_NAMES
from gaussian_splatting_lightning_tpu_torch.ops import _build
from gaussian_splatting_lightning_tpu_torch.ops import adam as adam_kernel
from gaussian_splatting_lightning_tpu_torch.training import optimizer as topt
from torch_adam_cases import adam_case, bits_differ, clone_state, group_shapes

CFG = topt.OptimizerConfig()


def groups_of(params, grads, state, out=None):
    out = (params, state) if out is None else out
    return [tuple(getattr(x, k) for x in (params, grads, state.mu, state.nu, out[0],
                                          out[1].mu, out[1].nu)) for k in PARAM_NAMES]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("in_place", [False, True], ids=["out_of_place", "in_place"])
def test_cpu_tensors_take_the_plain_path(monkeypatch, sparse, in_place):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(adam_kernel, "adam_update_kernel", refuse)
    params, grads, state, visible = adam_case(101, 3, "contiguous", "cpu", seed=3)
    visible = visible if sparse else None
    sched = topt.make_lr_schedules(CFG, 1.7)
    scalars = topt.scalars_tensor(topt.adam_scalars(sched, CFG, 15001, state.count + 1), "cpu")
    want_p, want_state = clone_state(params, state)
    topt._adam_plain(want_p, grads, want_state, scalars, CFG, visible)
    want = (want_p, want_state.mu, want_state.nu)
    launched = _build.launches["adam"]
    if in_place:
        p, st = clone_state(params, state)
        new = topt.adam_update_(p, grads, st, scalars, CFG, visible)
        got = (p, new.mu, new.nu)
        assert new.count == state.count + 1
    else:
        got_p, new = topt.adam_update(params, grads, state, sched, CFG, 15001, visible)
        got = (got_p, new.mu, new.nu)
    assert _build.launches["adam"] == launched
    for a, b in zip(got, want):
        for k in PARAM_NAMES:
            assert bits_differ(getattr(a, k), getattr(b, k)) == 0, k


def _layout(case):
    """(params, grads, state) of a layout the mesh or the store may pass."""
    if case == "degree0":
        return adam_case(1001, 0, "contiguous", "cpu")[:3]
    params, grads, state, _ = adam_case(1001, 3, "strided" if case == "strided" else
                                        "contiguous", "cpu")
    if case == "row_slice":  # a ZeRO-1 shard of rows starting at row 1
        cut = (lambda x: type(x)(**{k: getattr(x, k)[1:] for k in PARAM_NAMES}))
        params, grads = cut(params), cut(grads)
        state = topt.AdamState(count=state.count, mu=cut(state.mu), nu=cut(state.nu))
    return params, grads, state


@pytest.mark.parametrize("case", ["contiguous", "strided", "row_slice", "degree0"])
def test_descriptor_table_of_the_six_groups(case):
    params, grads, state = _layout(case)
    rows = params.xyz.shape[0]
    shapes = group_shapes(rows, 0 if case == "degree0" else 3)
    table = adam_kernel.adam_groups(groups_of(params, grads, state))
    assert [d.lr for d in table] == list(range(6))
    assert [d.rows for d in table] == [rows] * 6
    widths = [int(torch.Size(shapes[k][1:]).numel()) for k in PARAM_NAMES]
    assert [d.width for d in table] == widths
    if case == "strided":
        assert [d.g_stride for d in table] == [59] * 6
        assert [d.path for d in table] == ["scalar"] * 6
    else:
        assert [d.g_stride for d in table] == widths
        # a row slice starts 4 * width bytes in: 16-byte aligned only for quats
        want = (["scalar"] * 5 + ["vec4"]) if case == "row_slice" else ["vec4"] * 6
        assert [d.path for d in table] == want
    for d, k in zip(table, PARAM_NAMES):
        assert d.ptrs == tuple(getattr(x, k).data_ptr() for x in (
            params, grads, state.mu, state.nu, params, state.mu, state.nu))
        assert d.row()[7:] == [d.rows, d.width, d.g_stride, d.lr, int(d.path == "vec4")]


def _break(case, params, grads, state):
    """Make one tensor of the xyz group something the kernel refuses."""
    if case == "float64_p":
        params.xyz = params.xyz.double()
    elif case == "float64_g":
        grads.xyz = grads.xyz.double()
    elif case in ("strided_p", "strided_m", "strided_v"):
        x = {"strided_p": params, "strided_m": state.mu, "strided_v": state.nu}[case]
        x.xyz = torch.empty(3, x.xyz.shape[0]).t()  # same shape, columns first
    elif case == "gradient_columns":
        grads.xyz = torch.empty(3, grads.xyz.shape[0]).t()
    elif case == "shape":
        state.mu.xyz = state.mu.xyz[:-1]


@pytest.mark.parametrize("case", ["float64_p", "float64_g", "strided_p", "strided_m",
                                  "strided_v", "gradient_columns", "shape", "mask"])
def test_checks_refuse_what_the_kernel_does_not_take(case):
    params, grads, state, visible = adam_case(33, 3, "contiguous", "cpu")
    _break(case, params, grads, state)
    if case == "mask":
        visible = visible[:-1]
    with pytest.raises(ValueError, match="adam:"):
        adam_kernel.adam_groups(groups_of(params, grads, state),
                                visible if case == "mask" else None)


def test_row_stride():
    t = torch.empty(10, 59)
    assert adam_kernel.row_stride(t) == 59
    assert adam_kernel.row_stride(t[:, 14:59].reshape(10, 15, 3)) == 59
    assert adam_kernel.row_stride(t[:, 3:4]) == 59
    assert adam_kernel.row_stride(t.t()) is None
    assert adam_kernel.row_stride(torch.empty(1, 3)[:, :2]) == 2
    assert adam_kernel.row_stride(torch.empty(10, 0, 3)) == 0
