"""Binding of the certified exact maximum-clique solver ``native/maxclique.cpp``
(counterpart of ``poseestimator_tpu/registration/native.py``), with the
same ``available()`` / ``max_clique_exact()`` semantics.

The library is built at first use, never at import: ``g++`` compiles the
repository's source into ``build/native/`` (the source directory is never
written). The build runs under an exclusive file lock and writes to a
temporary name that is renamed into place, so processes that load the
library at once from a clean build directory all see a whole file: one
builds, the others wait on the lock and load its result.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "maxclique.cpp"
BUILD_DIR = _ROOT / "build" / "native"
# no -march=native: a build directory copied to another machine must load there
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _target() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libpe_native-{h}.so"


def build() -> Path:
    """The built library's path, compiling it first when it is missing.
    Raises ``RuntimeError`` when ``g++`` fails or is absent."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            p = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                               capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the exact max-clique solver needs it") from e
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{p.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError):
        return None
    lib.pe_max_clique.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int)]
    lib.pe_max_clique.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the library is built (or builds now) and loads."""
    return _load() is not None


def max_clique_exact(adj: np.ndarray, valid: Optional[np.ndarray] = None):
    """Certified maximum clique of a boolean (n, n) adjacency matrix among
    the ``valid`` vertices: ``(mask (n,) bool, size int)``. Raises
    ``RuntimeError`` when the library cannot be built or loaded."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native max-clique library unavailable (g++ missing or failed)")
    adj = np.asarray(adj, bool)
    n = adj.shape[0]
    if adj.shape != (n, n):
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    if valid is not None:
        v = np.asarray(valid, bool)
        adj = adj & v[:, None] & v[None, :]
    buf = np.ascontiguousarray(adj.astype(np.uint8))
    out = np.zeros(n, np.int32)
    size = lib.pe_max_clique(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_int(n),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if size < 0:
        raise RuntimeError(f"pe_max_clique failed (n={n})")
    mask = np.zeros(n, bool)
    mask[out[:size]] = True
    return mask, int(size)
