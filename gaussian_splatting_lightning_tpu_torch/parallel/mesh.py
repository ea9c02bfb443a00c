"""Process mesh over ``torch.distributed`` and the collectives of the mesh.

Counterpart of ``gaussian_splatting_lightning_tpu/parallel/mesh.py``. The
layout is the JAX package's: a 2D logical mesh

    ("view", "tile")

- ``view``: data parallel over training views (each view group renders its
  own cameras); only the gradient reduction crosses view groups.
- ``tile``: spatial parallel over image tile rows within one view (each rank
  composites a horizontal band).

The tile axis varies fastest over the ranks (rank = view * tile_size + tile),
so each view group's tile ring is made of adjacent ranks, one host's.
Splats are replicated on every rank.

One process runs per rank, started by ``python -m torch.distributed.run``
(or given its rank, world size and rendezvous explicitly). Each rank runs on
``cuda:{LOCAL_RANK % device_count}`` unless the caller asks for the CPU. The
backend is decided once, up front: NCCL when every rank of a host has a card
of its own, gloo when ranks share a card or run on the CPU; it is never
changed after a failed call. The collectives take the same path on both.
"""

from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gaussian_splatting_lightning_tpu_torch.device import resolve_device

@dataclasses.dataclass(frozen=True)
class DistInfo:
    """This process's place in the job, as ``init_distributed`` set it up."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int  # ranks on this host
    device: torch.device
    backend: str


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    value = os.environ.get(name)
    return default if value is None else int(value)


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when each rank of a host has a card of its own, else gloo (ranks
    on the CPU, or several ranks sharing a card: NCCL refuses two ranks on
    one GPU)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def init_distributed(
    device="cuda",
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
) -> Optional[DistInfo]:
    """Join the job: ``torch.distributed.init_process_group`` with this
    rank's device and backend. Rank and world size come from the arguments
    or from torchrun's environment (``RANK``, ``WORLD_SIZE``); the local
    rank and the ranks per host from ``LOCAL_RANK`` (default: the rank) and
    ``LOCAL_WORLD_SIZE`` (default: the world); the rendezvous from
    ``init_method`` (``tcp://host:port`` or ``file://path``) or torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``.

    A single process with no ``init_method`` is not a job: returns None and
    initialises nothing (the JAX package's no-op). An explicit
    ``init_method`` joins even at world size 1 (a 1x1 mesh)."""
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE", 1)
    rank = rank if rank is not None else _env_int("RANK", 0)
    if world_size <= 1 and init_method is None:
        return None
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_world)
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    if rank == 0:
        share = "" if dev.type != "cuda" else (
            f", {local_world} ranks per host on {torch.cuda.device_count()} card(s)")
        print(f"[mesh] backend {backend}: {world_size} ranks on {dev.type}{share}")
    return DistInfo(rank, world_size, local_rank, local_world, dev, backend)


def mesh_grid(view: int, tile: Optional[int], world_size: int, n_hosts: int = 1) -> np.ndarray:
    """The (view, tile) grid of ranks, tile fastest, with the JAX
    ``make_mesh``'s errors: a world not divisible by ``view``, a mesh larger
    than the world, and (several hosts) a view axis that is not a multiple of
    the host count."""
    if tile is None:
        if world_size % view:
            raise ValueError(f"{world_size} devices not divisible by view={view}")
        tile = world_size // view
    if n_hosts > 1 and view % n_hosts:
        raise ValueError(
            f"multi-host mesh requires the view axis ({view}) to be a multiple of "
            f"the process count ({n_hosts}) so tile rings never cross DCN")
    n = view * tile
    if n > world_size:
        raise ValueError(f"mesh {view}x{tile} needs {n} devices, have {world_size}")
    if n < world_size:
        raise ValueError(f"mesh {view}x{tile} leaves {world_size - n} of {world_size} "
                         "ranks idle: every rank of the job must be on the mesh")
    return np.arange(n).reshape(view, tile)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ("view", "tile") mesh as this rank sees it: its coordinates, the
    axis sizes, one process group per axis (the ranks that share this rank's
    other coordinate) and the world group, and the collectives over them.

    A collective names its axis: "tile", "view" or "world" (both axes).
    Every collective is out of place and returns a new tensor. ``graphs``
    holds, weakly, the captured graphs whose collectives run on these
    groups, for ``shutdown``."""

    grid: np.ndarray  # (view, tile) ranks
    rank: int
    device: torch.device
    backend: str
    groups: dict  # axis name -> ProcessGroup
    graphs: weakref.WeakSet = dataclasses.field(default_factory=weakref.WeakSet, repr=False)

    @property
    def shape(self) -> dict:
        return {"view": self.grid.shape[0], "tile": self.grid.shape[1]}

    @property
    def size(self) -> int:
        return int(self.grid.size)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``; on "world" its flat index
        (view * tile_size + tile)."""
        v, t = divmod(self.rank, self.grid.shape[1])
        return {"view": v, "tile": t, "world": self.rank}[axis]

    def axis_size(self, axis: str) -> int:
        return self.size if axis == "world" else self.shape[axis]

    # -- collectives -------------------------------------------------------
    # one path on both backends: gloo takes CUDA tensors in these three
    # collectives as NCCL does
    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """``psum``/``pmax`` over ``axis``."""
        buf = t.contiguous().clone()
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                        group=self.groups[axis])
        return buf

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """``all_gather(..., tiled=True)``: the ranks' tensors concatenated
        along ``dim`` in axis order."""
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((self.axis_size(axis) * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=self.groups[axis])
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """``psum_scatter(..., tiled=True)``: the sum over ``axis`` of the
        ranks' tensors, cut into equal parts along ``dim``; this rank keeps
        the part at its axis index."""
        n = self.axis_size(axis)
        src = t.movedim(dim, 0).contiguous()
        if src.shape[0] % n:
            raise ValueError(f"reduce_scatter: {src.shape[0]} rows do not divide by {n}")
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=self.groups[axis])
        return out.movedim(0, dim).contiguous()

    def barrier(self) -> None:
        dist.barrier(group=self.groups["world"])


def shutdown(*meshes: Optional[Mesh]) -> None:
    """Leave the job: release every captured graph built on ``meshes`` (a
    graph that holds NCCL collectives must go before its communicators do),
    wait for the card, then destroy the process group. It releases the
    graphs themselves, so it keeps that order on an error path too, where a
    traceback still holds the steps. Every rank calls it; a None mesh (one
    not built yet) is skipped, and without a process group it destroys
    nothing."""
    for mesh in filter(None, meshes):
        for captured in list(mesh.graphs):
            captured.release()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(view: int = 1, tile: Optional[int] = None,
              info: Optional[DistInfo] = None) -> Mesh:
    """Build the ("view", "tile") mesh over the job's ranks (every rank
    calls it, with the same arguments). ``tile`` defaults to filling the
    world. ``info`` is what ``init_distributed`` returned."""
    if info is None or not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: pass what init_distributed "
                           "returned (launch with python -m torch.distributed.run)")
    world = info.world_size
    grid = mesh_grid(view, tile, world, max(1, world // info.local_world_size))
    # one group per row (a view group's tile ring) and per column; every
    # rank creates every group, in the same order
    tile_group, _ = dist.new_subgroups_by_enumeration([list(map(int, r)) for r in grid])
    view_group, _ = dist.new_subgroups_by_enumeration([list(map(int, c)) for c in grid.T])
    groups = {"tile": tile_group, "view": view_group, "world": dist.group.WORLD}
    return Mesh(grid=grid, rank=info.rank, device=info.device, backend=info.backend,
                groups=groups)
