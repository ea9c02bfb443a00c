"""Synthetic inputs of K1, the pair expansion, at the edges of its runs.

Shared by the CPU tests (``test_torch_binning.py``, against the JAX
expansion kernel) and the card tests (``test_torch_cuda_kernels.py``,
against the plain version). numpy only: the machine with the card has no JAX.
"""

import numpy as np

GX, GY = 60, 34  # the tile grid of 1920x1080 at 32 px tiles


def expand_layout(nx, ny, seed=0, block=32):
    """Synthetic K1 inputs in numpy, in ``binning.ExpandInputs`` order
    (offsets, order, rows, p_pix, total), for splats in depth
    order whose tile rects are nx by ny tiles (ny = 0: a splat with no tile)
    at random places of the GX x GY grid; means near their rects and cull
    radii up to two tiles, so that some pairs are culled; the fields in a
    random original order. The columns of ``rows`` are x0, nx, y0 and the
    bits of cull_r2 (``binning.X0`` ... ``CULL_R2``)."""
    rng = np.random.default_rng(seed)
    nx, ny = np.asarray(nx, np.int64), np.asarray(ny, np.int64)
    n = nx.shape[0]
    ntiles = nx * ny
    x0 = rng.integers(0, GX - nx + 1)
    y0 = rng.integers(0, GY - ny + 1)
    px = ((x0 + rng.uniform(-1, nx + 1)) * block).astype(np.float32)
    py = ((y0 + rng.uniform(-1, ny + 1)) * block).astype(np.float32)
    cull_r2 = rng.uniform(0, (2 * block) ** 2, n).astype(np.float32)
    order = rng.permutation(n)

    def original(a):  # depth rank g's value goes to splat order[g]
        out = np.empty_like(a)
        out[order] = a
        return out

    offsets = np.cumsum(ntiles) - ntiles
    rows = np.stack([x0, nx, y0, cull_r2.view(np.int32)], 1).astype(np.int32)
    return (offsets.astype(np.int32), order.astype(np.int32), original(rows),
            original(np.stack([px, py], 1)), np.array(ntiles.sum(), np.int32))


def expand_case(name):
    """(offsets, order, rows, p_pix, total, max_pairs) of a named synthetic
    K1 layout. The kernel's blocks cover runs of 1024 slots;
    the layouts put a splat's slots across runs, the end of the pairs inside
    a run and on its edge, budgets that are not a multiple of the run, below
    the pair total and at the bench's 2,523,136, and zero-tile splats inside
    the live prefix (a window wider than a block can stage)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    ones = lambda n: (np.ones(n, np.int64), np.ones(n, np.int64))
    mixed = rng.integers(1, 5, 20000), rng.integers(1, 5, 20000)
    mixed[1][-2000:] = 0  # the dead tail: splats with no tile sort last
    budget = None
    if name == "big_rect":  # three 2040-tile rects, wider than a run, one last
        nx, ny = rng.integers(1, 4, 3000), rng.integers(1, 4, 3000)
        ny[rng.choice(2999, 40, replace=False)] = 0  # a few zero-tile splats in windows
        nx[[100, 1500, 2999]], ny[[100, 1500, 2999]] = GX, GY
    elif name == "one_slot_each":  # every run's window is 1024 splats wide
        (nx, ny), budget = ones(5000), 8192
    elif name == "total_in_a_run":
        (nx, ny), budget = ones(1500), 4096
    elif name == "total_on_a_run_edge":
        (nx, ny), budget = ones(2048), 4096
    elif name == "budget_bench":
        (nx, ny), budget = mixed, 2_523_136
    elif name == "budget_below_total":
        (nx, ny), budget = mixed, 1000
    elif name == "budget_odd":  # 3 mod 4: the last slots are stored one by one
        nx, ny = mixed
        budget = (int((nx * ny).sum()) + 1000) | 3
    elif name == "total_zero":
        (nx, _), ny, budget = ones(100), np.zeros(100, np.int64), 1000
    elif name == "one_splat":
        nx, ny, budget = np.array([3]), np.array([2]), 1000
    elif name == "zero_tiles_inside":
        nx, ny = ones(60000)
        ny[:4000:2] = 0  # every other splat of the first 4000
        ny[4000:54000] = 0  # and a stretch of 50000
    else:
        raise KeyError(name)
    *inputs, total = expand_layout(nx, ny, seed=1)
    if budget is None:
        budget = -(-int(total) // 128) * 128
    return (*inputs, total, budget)


EXPAND_LAYOUTS = ("big_rect", "one_slot_each", "total_in_a_run", "total_on_a_run_edge",
                  "budget_bench", "budget_below_total", "budget_odd", "total_zero",
                  "one_splat", "zero_tiles_inside")
