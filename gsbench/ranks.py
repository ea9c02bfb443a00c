"""A cell on several ranks: one process a card, the port's mesh over them.

``launch`` starts one process per rank (``torch.multiprocessing``, spawn)
with a free local port for the rendezvous, and watches them: every rank
reports each stage it reaches (``Ranks.beat``) to the launching process,
which ends every rank (SIGKILL) as soon as one exits non-zero, or when one
has reported nothing for ``limit_s`` seconds (a rendezvous or a collective
that does not finish). Each rank leaves through the port's
``parallel.shutdown``; a rank whose launcher is gone exits by itself. Only
when every rank has exited 0 does ``launch`` return what rank 0 handed back
(``Ranks.hand_back``).

In a rank, ``Ranks`` is what ``cell.run`` asks of its ranks: the window's
agreement (rank 0's clock decides, over a gloo group on the host, so no
agreement waits for the card), the fence (a mesh barrier, then
``torch.cuda.synchronize``), gathering small host values, and leaving the
mesh. ``Solo`` is the same for one process, with no mesh.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time

LIMIT_S = 300.0  # a rank silent this long (no stage reached) ends the run
POLL_S = 0.2


class Solo:
    """One process, no mesh: ``cell.run``'s ranks where a cell has one chip."""

    rank = 0
    mesh = None

    def beat(self, stage: str) -> None:
        pass

    def go(self, flag: bool) -> bool:
        return flag

    def fence(self, dev) -> None:
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)

    def gather(self, value) -> list:
        return [value]

    def leave(self) -> bool:
        return True


class Ranks(Solo):
    """This rank's mesh, its host group and its line to the launcher."""

    def __init__(self, mesh, host, queue):
        self.mesh, self.host, self.queue = mesh, host, queue
        self.rank = mesh.rank

    def beat(self, stage: str) -> None:
        self.queue.put(("beat", self.rank, stage))

    def go(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(flag)])
        dist.broadcast(t, 0, group=self.host)
        return bool(t.item())

    def fence(self, dev) -> None:
        self.mesh.barrier()
        super().fence(dev)

    def gather(self, value) -> list:
        """Every rank's ``value`` (picklable), in rank order."""
        import torch.distributed as dist

        out = [None] * self.mesh.size
        dist.all_gather_object(out, value, group=self.host)
        return out

    def leave(self) -> bool:
        """Leave the mesh (its graphs, then the process group); True on rank 0."""
        from gaussian_splatting_lightning_tpu_torch.parallel import shutdown

        self.beat("leave")
        shutdown(self.mesh)
        return self.rank == 0

    def hand_back(self, value) -> None:
        self.queue.put(("result", self.rank, value))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _watch_launcher(parent: int) -> None:
    """Exit when the launching process is gone."""
    while True:
        if os.getppid() != parent:
            os._exit(1)
        time.sleep(1.0)


def _rank_main(rank: int, world: int, port: int, mesh_shape: dict, device: str, queue,
               target, args: tuple, parent: int) -> None:
    """One rank: join the job, build the mesh as the train CLI does, run
    ``target(ranks, *args)`` and leave through ``parallel.shutdown``."""
    threading.Thread(target=_watch_launcher, args=(parent,), daemon=True).start()
    os.dup2(2, 1)  # the launcher alone writes standard output
    sys.stdout = sys.stderr
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    queue.put(("beat", rank, "start"))
    import torch
    import torch.distributed as dist

    from gaussian_splatting_lightning_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        shutdown,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = init_distributed(device, rank=rank, world_size=world,
                            init_method=f"tcp://localhost:{port}")
    mesh = None
    try:
        mesh = make_mesh(view=mesh_shape["view"], tile=mesh_shape["tile"], info=info)
        ranks = Ranks(mesh, dist.new_group(backend="gloo"), queue)
        ranks.beat("mesh")
        target(ranks, *args)
    finally:
        shutdown(mesh)
    queue.put(("beat", rank, "done"))


def launch(world: int, mesh_shape: dict, target, args: tuple, device: str = "cuda",
           limit_s: float = LIMIT_S):
    """Run ``target(ranks, *args)`` on ``world`` ranks; return what rank 0
    handed back, or raise ``RuntimeError`` (every rank ended) when a rank
    fails or stalls."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, mesh_shape, device, queue,
                                                  target, args, os.getpid()))
             for r in range(world)]
    for p in procs:
        p.start()
    last = [time.monotonic()] * world
    stage = ["launched"] * world
    result, failure = None, None
    try:
        while failure is None:
            while not queue.empty():
                kind, rank, value = queue.get()
                last[rank] = time.monotonic()
                if kind == "result":
                    result = value
                else:
                    stage[rank] = value
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failure = ", ".join(f"rank {r} exited {c} at stage {stage[r]!r}"
                                    for r, c in bad)
            elif all(c == 0 for c in codes):
                break
            else:
                now = time.monotonic()
                stalled = [r for r in range(world)
                           if codes[r] is None and now - last[r] > limit_s]
                if stalled:
                    r = stalled[0]
                    failure = (f"rank {r} reached nothing for {limit_s:.0f} s after stage "
                               f"{stage[r]!r}")
                time.sleep(POLL_S)
        while result is None and not queue.empty():
            kind, _, value = queue.get()
            if kind == "result":
                result = value
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join()
        queue.close()
        queue.join_thread()
    if failure is not None:
        raise RuntimeError(f"gsbench: {failure}; every rank ended")
    return result
