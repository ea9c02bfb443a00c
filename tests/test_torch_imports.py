"""Import hygiene of the PyTorch port: a static scan of every module.

Neither the port, nor ``chip_smoke.py``, nor the kernel tests that run on the
card may import JAX or any module of the
JAX package (``gaussian_splatting_lightning_tpu``). The port's own name has
the JAX package's name as a prefix, so the whole dotted head is compared.
A runtime ``sys.modules`` check cannot work here: the container imports jax
into every interpreter at start-up.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = "gaussian_splatting_lightning_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "gaussian_splatting_lightning_tpu", "__graft_entry__"}
# the kernel tests run on the machine with the card, which has no JAX
FILES = sorted((ROOT / PORT).rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda_kernels.py",
    ROOT / "tests" / "test_torch_graph_cuda.py",
    ROOT / "tests" / "torch_expand_layouts.py", ROOT / "tests" / "torch_mesh_worker.py",
    ROOT / "tests" / "torch_preprocess_cases.py", ROOT / "tests" / "test_torch_partial_views.py",
    ROOT / "tests" / "torch_nccl_worker.py", ROOT / "tests" / "torch_dryrun_worker.py"]


def imported_modules(path: Path):
    """Absolute module names a file imports (relative imports resolve into
    the port itself, so they cannot reach the JAX package)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert f"{PORT}/ops/binning.py" in names and "chip_smoke.py" in names
    for module in ("training/config.py", "training/densify.py", "training/trainer.py",
                   "scripts/train.py", "utils/runtime.py", "models/splat_export.py",
                   "ops/rasterize_reference.py", "ops/rasterize_tiled.py",
                   "scripts/make_synthetic_scene.py", "scripts/eval.py",
                   "scripts/render_path.py", "scripts/export_splat.py", "scripts/view.py",
                   "scripts/profile_render.py", "viewer/__init__.py", "ops/lpips.py",
                   "parallel/__init__.py", "parallel/mesh.py", "parallel/shard.py",
                   "scripts/bench.py", "scripts/bench_batched.py",
                   "scripts/benchmark_scaling.py", "scripts/scaling_worker.py",
                   "scripts/banded_check.py", "utils/graph.py",
                   "scripts/dryrun_multichip.py"):
        assert f"{PORT}/{module}" in names, module
    assert len(names) >= 30
    # the viewer page is the port's own file, not a path into the JAX package
    assert (ROOT / PORT / "viewer" / "viewer.html").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = sorted(m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_catches_a_jax_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os\nfrom jax import numpy\n"
        "import gaussian_splatting_lightning_tpu.ops.binning as b\n"
        f"from {PORT}.ops import binning\n"
    )
    heads = [m.split(".")[0] for m in imported_modules(src)]
    assert [h for h in heads if h in FORBIDDEN] == ["jax", "gaussian_splatting_lightning_tpu"]
