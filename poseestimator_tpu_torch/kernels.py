"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Builds
happen at first use (never at import), all sources in parallel, into
``build/kernels/`` beside the package; a library's file name carries a hash
of its source and flags, so an edited source is rebuilt and an unchanged one
is reused. Every C entry returns ``cudaGetLastError()`` after its launch and
``check`` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# -fmad=false: no multiply-add contraction anywhere in these kernels — the
# distance and edge-function arithmetic must round exactly as the plain
# PyTorch versions do (the sources also spell each product and sum with
# __fmul_rn / __fadd_rn)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

# C signature of each library's launch entry: (name, argtypes)
_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "fused_nn": ("fused_nn_launch", [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P]),
    "raster": ("raster_launch", [_P, _P, _I, _I, _I, _P, _P]),
}

_libs: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Launch count of one kernel wrapper: a plain integer that the wrapper
    raises by one per launch and a caller may reset to 0."""

    def __init__(self):
        self.launches = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{h}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns {name: seconds} for the ones built now."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    took, errors = {}, []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
        took[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call the launch entry of ``name`` and raise on a CUDA error code."""
    lib = library(name)
    fn_name, _ = SIGNATURES[name]
    code = getattr(lib, fn_name)(*args)
    if code != 0:
        raise RuntimeError(f"{fn_name} failed with cudaError {code}")


def current_stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
