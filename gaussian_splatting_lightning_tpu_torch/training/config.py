"""Run configuration: dataclasses loaded from a YAML file.

Counterpart of ``gaussian_splatting_lightning_tpu/training/config.py``: one
file drives data, model, trainer, optimizer and tiling, with ``${a.b}``
interpolation and dotted ``--set`` overrides. The four ``configs/*.yaml``
files load to the JAX loader's values, field for field, except the fields
the port maps:

- ``train.rasterizer``: ``auto``, ``pallas`` and ``pallas_interpret`` become
  ``"cuda"`` (the kernels; CPU tensors take their plain versions);
  ``"cuda"`` and ``"plain"`` stay as they are; ``xla`` runs the tiled route
  (``ops/rasterize_tiled.py``), which reads ``train.tiling.tile_capacity``
  and ``chunk``.
- ``train.tiling.pair_grad_bf16`` and the top-level ``use_pallas`` are
  accepted and have no effect: they route the TPU's Pallas kernels, and the
  port keeps its pair gradients in f32.
- ``mesh_view``/``mesh_tile`` shape the ("view", "tile") mesh as in the JAX
  configuration; the train CLI builds it over the ranks that
  ``python -m torch.distributed.run`` starts (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
from gaussian_splatting_lightning_tpu_torch.training.densify import DensifyConfig
from gaussian_splatting_lightning_tpu_torch.training.optimizer import OptimizerConfig
from gaussian_splatting_lightning_tpu_torch.training.trainer import TrainConfig

RASTERIZERS = {"auto": "cuda", "pallas": "cuda", "pallas_interpret": "cuda",
               "cuda": "cuda", "plain": "plain", "xla": "xla"}
# keys of the JAX configuration that the port reads and ignores
IGNORED = {"RunConfig": {"use_pallas"}, "TilingConfig": {"pair_grad_bf16"}}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    colmap_path: str = ""
    image_folder: str = ""
    train_idx_file: Optional[str] = None
    valid_idx_file: Optional[str] = None
    mask_folder: Optional[str] = None
    depth_folder: Optional[str] = None  # per-view <stem>.npy inverse-depth
    # maps for the optional depth-regularization loss (train.w_depth)
    resize_to: Optional[int] = None
    downscale: Optional[float] = None
    white_background: bool = False
    z_near: float = 0.01
    z_far: float = 100.0
    holdout_every: Optional[int] = None  # alternative to idx files


@dataclasses.dataclass(frozen=True)
class RunConfig:
    exp_name: str = "gs_tpu"
    run_name: str = "run"
    out_dir: str = "runs"
    seed: int = 42
    sh_degree: int = 3
    capacity: int = 1 << 20
    mesh_view: int = 1
    mesh_tile: Optional[int] = None
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()


SUBCONFIGS = {"data": DataConfig, "train": TrainConfig, "densify": DensifyConfig,
              "optimizer": OptimizerConfig, "tiling": TilingConfig}


def _interpolate(obj: Any, root: Dict[str, Any]) -> Any:
    """Minimal ${a.b} interpolation over a loaded dict."""
    if isinstance(obj, dict):
        return {k: _interpolate(v, root) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_interpolate(v, root) for v in obj]
    if isinstance(obj, str):
        def repl(m):
            cur: Any = root
            for part in m.group(1).split("."):
                cur = cur[part]
            return str(cur)

        return re.sub(r"\$\{([^}]+)\}", repl, obj)
    return obj


def _build(cls, data: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    ignored = IGNORED.get(cls.__name__, set())
    kwargs = {}
    for k, v in (data or {}).items():
        if k in ignored:
            continue
        if k not in names:
            raise KeyError(f"unknown config key '{k}' for {cls.__name__}")
        if k in SUBCONFIGS:
            v = _build(SUBCONFIGS[k], v)
        elif cls is TrainConfig and k == "rasterizer":
            if v not in RASTERIZERS:
                raise ValueError(f"train.rasterizer={v!r}: the port runs "
                                 f"{sorted(RASTERIZERS)}")
            v = RASTERIZERS[v]
        kwargs[k] = v
    return cls(**kwargs)


def apply_overrides(raw: Dict[str, Any], overrides) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` overrides onto the raw dict (values parsed as
    YAML, so ``--set train.num_iters=100`` and ``--set data.mask_folder=null``
    both work). Unknown keys are still rejected by _build."""
    for ov in overrides or ():
        key, sep, val = ov.partition("=")
        if not sep:
            raise ValueError(f"override '{ov}' is not of the form key=value")
        parts = key.strip().split(".")
        cur = raw
        for p in parts[:-1]:
            nxt = cur.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                cur[p] = nxt
            cur = nxt
        v = yaml.safe_load(val)
        if isinstance(v, str):
            # YAML 1.1 misses dotless scientific floats like "5e-5"
            try:
                v = float(v)
            except ValueError:
                pass
        cur[parts[-1]] = v
    return raw


def load_config(path: str, overrides=()) -> RunConfig:
    raw = yaml.safe_load(Path(path).read_text()) or {}
    raw = apply_overrides(raw, overrides)
    raw = _interpolate(raw, raw)
    return _build(RunConfig, raw)
