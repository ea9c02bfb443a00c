"""A cell cut to a size the CPU runs in seconds, for the harness's tests."""

from __future__ import annotations

from pathlib import Path

from gsbench import manifest

ROOT = Path(__file__).resolve().parents[2]


def tiny_spec(cell: str = "train-1080p-1m", **config) -> dict:
    spec = manifest.cell(manifest.load(ROOT), cell)
    spec["config"].update(dict(dict(splats=2000, capacity=2000, width=64, height=48, views=6),
                               **config))
    spec["traffic"].update(chunk_steps=2, trace_steps=2)
    return spec
