"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds); the kernels of one source (the preprocess pair) share
its library. Builds happen at first use, from the checkout's sources
only, into ``_build/`` beside ``csrc/`` (listed in ``.gitignore``), keyed by a
hash of the source and the flags. A missing ``nvcc`` is an error: there is
no fallback for a CUDA tensor.

``launches`` counts kernel launches by kernel name; each wrapper adds one a
launch where it launches its kernels (a C entry may launch several: the
photometric loss's forward launches three) and nowhere else. The span marks
(``csrc/span_mark.cu``, launched by ``utils/runtime.mark`` only while spans
are on) are built and loaded here too, but are no kernel of the port's and
are not counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

SOURCES = {
    "expand_pairs": "expand_pairs.cu",
    "composite_fwd": "composite_fwd.cu",
    "composite_bwd": "composite_bwd.cu",
    "segment_sum": "segment_sum.cu",
    "blur": "blur.cu",
    "preprocess_fwd": "preprocess.cu",
    "preprocess_bwd": "preprocess.cu",
    "adam": "adam.cu",
    "photometric": "photometric.cu",
}
# libraries built and loaded like the kernels, but not counted in ``launches``
LIBRARIES = dict(SOURCES, span_mark="span_mark.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# K1's, the preprocess pair's and Adam's whole arithmetic must round like the
# plain versions' separate PyTorch ops; K2, K3 and K5 round what must match
# explicitly (__fmul_rn & co.) and let the rest contract to FMA; K4 only adds;
# the photometric loss decides no threshold and contracts freely
EXTRA_FLAGS = {"expand_pairs": ("--fmad=false",), "composite_fwd": (),
               "composite_bwd": (), "segment_sum": (), "blur": (), "span_mark": (),
               "preprocess_fwd": ("--fmad=false",), "preprocess_bwd": ("--fmad=false",),
               "adam": ("--fmad=false",), "photometric": ()}


def nvcc_flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS[name]

# C entries of each kernel's library: (symbol, argtypes) pairs; pointers and
# the stream are c_void_p, or ctypes would pass them as 32-bit ints
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRIES = {
    "expand_pairs": [("gs_expand_pairs", [_VP] * 5 + [_I] * 7 + [_VP] * 3)],
    "composite_fwd": [("gs_composite_fwd", [_VP] * 6 + [_I] * 9 + [_VP])],
    "composite_bwd": [("gs_composite_bwd", [_VP] * 8 + [_I] * 10 + [_VP])],
    "segment_sum": [("gs_segment_sum", [_VP] * 5 + [_I] * 3 + [_VP])],
    "blur": [("gs_blur_valid", [_VP] * 2 + [_I] * 5 + [_VP] * 2)],
    "span_mark": [("gs_span_mark", [_I, _VP])],
    "preprocess_fwd": [("gs_preprocess_fwd", [_VP] * 20 + [_I] * 10 + [_F] * 2 + [_VP])],
    "preprocess_bwd": [("gs_preprocess_bwd", [_VP] * 20 + [_I] * 7 + [_F] + [_VP])],
    "adam": [("gs_adam_update", [_VP, _I, _VP, _I, _VP] + [_F] * 5 + [_VP])],
    "photometric": [("gs_photometric_fwd", [_VP] * 10 + [_I] * 8 + [_F] * 2 + [_VP] * 2),
                    ("gs_photometric_bwd", [_VP] * 8 + [_I] * 4 + [_VP] + [_I] * 7 + [_F] * 2
                     + [_VP] * 2)],
}

launches = {name: 0 for name in SOURCES}
_libs: dict = {}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library(name: str) -> Path:
    """The library of kernel ``name``: named by its source, keyed by a hash
    of the source and the flags."""
    src = (SRC_DIR / LIBRARIES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(nvcc_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(LIBRARIES[name]).stem}-{digest}.so"


def build(names=None) -> dict:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns {name: seconds} for the sources it
    compiled; the ptxas report of each lands next to its library as ``.log``.
    """
    names = list(SOURCES) if names is None else list(names)
    # one nvcc per library: the kernels of one source share it
    todo = list({_library(n): n for n in names if not _library(n).exists()}.values())
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        lib = _library(name)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp), str(SRC_DIR / LIBRARIES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    seconds, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)  # atomic: concurrent builds never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The ptxas report (registers, shared memory, spills) of a built kernel."""
    path = _library(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library(name)))
        lib.gs_error_string.restype = ctypes.c_char_p
        lib.gs_error_string.argtypes = [ctypes.c_int]
        for symbol, argtypes in ENTRIES[name]:
            getattr(lib, symbol).restype = ctypes.c_int
            getattr(lib, symbol).argtypes = argtypes
        _libs[name] = lib
    return lib


def raise_for(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        msg = lib.gs_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


def check(lib: ctypes.CDLL, name: str, rc: int, kernels: int = 1) -> None:
    """Raise if a C entry returned a CUDA error, else count its ``kernels``
    launches."""
    raise_for(lib, name, rc)
    launches[name] += kernels


def check_tensor(t: torch.Tensor, name: str, dtype, device) -> None:
    """A kernel takes only contiguous tensors of its dtype on its device."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
