"""A plain reference for the harness's tests: ``reference/gs.py`` with a
count of the calls the harness makes to it. Not named by BENCHMARK.json."""

from gsbench.reference import gs

LEAVES = gs.LEAVES
W_SSIM = gs.W_SSIM
block_rect = gs.block_rect
CALLS = {"project": 0, "render": 0, "train": 0}


def project(*a, **k):
    CALLS["project"] += 1
    return gs.project(*a, **k)


def render(*a, **k):
    CALLS["render"] += 1
    return gs.render(*a, **k)


def train(*a, **k):
    CALLS["train"] += 1
    return gs.train(*a, **k)
