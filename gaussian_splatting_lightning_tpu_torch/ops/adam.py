"""Adam's update of every parameter group as one kernel (``csrc/adam.cu``).

``adam_groups`` checks the groups' tensors and builds the kernel's
descriptor table from their dtypes, shapes, strides and addresses alone, so
the CPU tests reach it; ``adam_update_kernel`` launches the kernel on CUDA
tensors. The arithmetic and its plain version are
``training/optimizer.py``'s (``_adam_plain``), which CPU tensors take.

A group is (p, g, m, v, p_out, m_out, v_out): the parameter, its gradient,
the two moments, and where the new three go (the same tensors for the update
in place). p, m, v and the outputs must be contiguous float32 of one shape;
the gradient may have rows further apart than their width (the mesh's
ZeRO-1 update passes column slices of one (rows, 59) table), as long as each
row is contiguous. Each group's path follows from what the wrapper sees: a
contiguous gradient and seven 16-byte aligned arrays move 16 bytes a thread
(``"vec4"``), anything else a float a thread (``"scalar"``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from gaussian_splatting_lightning_tpu_torch.ops import _build

# fields of a descriptor row, in csrc/adam.cu's order
DESC_FIELDS = ("p", "g", "m", "v", "p_out", "m_out", "v_out", "rows", "width",
               "g_stride", "lr", "vec")
MAX_GROUPS = 8  # csrc/adam.cu kMaxGroups


@dataclasses.dataclass(frozen=True)
class GroupDesc:
    """One row of the kernel's descriptor table."""

    ptrs: tuple  # addresses of p, g, m, v, p_out, m_out, v_out
    rows: int
    width: int  # floats a row
    g_stride: int  # floats from one gradient row to the next
    lr: int  # index of the group's rate in ``scalars``
    path: str  # "vec4" or "scalar"

    def row(self) -> list:
        return [*self.ptrs, self.rows, self.width, self.g_stride, self.lr,
                int(self.path == "vec4")]


def row_stride(t: torch.Tensor):
    """Elements from one row of ``t`` to the next when every row (all
    dimensions but the first) is contiguous, else None."""
    if t.dim() == 0:
        return None
    width = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != width:
            return None
        width *= size
    if t.shape[0] <= 1 or width == 0:
        return width
    return t.stride(0) if t.stride(0) >= width else None


def adam_groups(groups, visible=None) -> list:
    """The descriptor table of ``groups`` (a list of (p, g, m, v, p_out,
    m_out, v_out), group i at rate ``scalars[i]``); raises ValueError on
    what the kernel does not take."""
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"adam: at most {MAX_GROUPS} groups, got {len(groups)}")
    table = []
    for i, group in enumerate(groups):
        p, g = group[0], group[1]
        for name, t in zip(DESC_FIELDS, group):
            if t.dtype != torch.float32:
                raise ValueError(f"adam: group {i}'s {name} is {t.dtype}, not float32")
            if t.shape != p.shape:
                raise ValueError(f"adam: group {i}'s {name} has shape {tuple(t.shape)}, "
                                 f"p {tuple(p.shape)}")
            if name != "g" and not t.is_contiguous():
                raise ValueError(f"adam: group {i}'s {name} is not contiguous")
        g_stride = row_stride(g)
        if g_stride is None:
            raise ValueError(f"adam: group {i}'s gradient rows are not contiguous "
                             f"(strides {g.stride()})")
        rows = p.shape[0] if p.dim() else 1
        width = p.numel() // rows if rows else 0
        if visible is not None and visible.shape != (rows,):
            raise ValueError(f"adam: the mask has shape {tuple(visible.shape)}, "
                             f"the groups {rows} rows")
        ptrs = tuple(t.data_ptr() for t in group)
        vec4 = g_stride == width and all(a % 16 == 0 for a in ptrs)
        table.append(GroupDesc(ptrs, rows, width, g_stride, i, "vec4" if vec4 else "scalar"))
    return table


def adam_update_kernel(groups, scalars: torch.Tensor, visible, b1: float, b2: float,
                       eps: float) -> None:
    """One launch of ``adam_update_kernel`` over ``groups`` (see
    ``adam_groups``) on their CUDA device: ``scalars`` holds the groups'
    rates, then bc1 and bc2; ``visible`` (rows,) bool or None."""
    dev = groups[0][0].device
    for i, group in enumerate(groups):
        for name, t in zip(DESC_FIELDS, group):
            if t.device != dev:
                raise ValueError(f"adam: group {i}'s {name} is on {t.device}, not {dev}")
    _build.check_tensor(scalars, "scalars", torch.float32, dev)
    if scalars.numel() != len(groups) + 2:
        raise ValueError(f"adam: need {len(groups) + 2} scalars, got {scalars.numel()}")
    if visible is not None:
        _build.check_tensor(visible, "visible", torch.bool, dev)
    table = adam_groups(groups, visible)
    if not any(d.rows * d.width for d in table):
        return
    desc = (ctypes.c_int64 * (len(table) * len(DESC_FIELDS)))(
        *[x for d in table for x in d.row()])
    lib = _build.load("adam")
    # ctypes rounds each double to float as PyTorch rounds a Python scalar
    rc = lib.gs_adam_update(
        ctypes.c_void_p(ctypes.addressof(desc)), len(table), _build.ptr(scalars), len(groups),
        None if visible is None else _build.ptr(visible), b1, 1.0 - b1, b2, 1.0 - b2, eps,
        _build.stream_of(scalars))
    _build.check(lib, "adam", rc)
