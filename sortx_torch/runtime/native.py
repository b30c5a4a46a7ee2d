"""ctypes bindings to the host sort, scan and k-way merge.

Port of ``sortx/runtime/native.py`` on the port's own copy of the C++
source, ``sortx_torch/csrc/host_sort.cpp``. The library is compiled by
the host C++ compiler (``$CXX``, else ``c++`` or ``g++`` on PATH) at
first use, into a shared library whose name carries a hash of the
source, the flags and the compiler, under :data:`BUILD_DIR` (the
checkout's ``build/sortx_torch/``, beside the CUDA library but built
apart from it, so no ``nvcc`` is needed). The build runs under
``ops/_build.py:build_lock``, so processes that start together build
once and the rest load what the first built. A missing compiler or a
failed build raises; nothing falls back.

``host_merge`` is the host half of the out-of-core sort
(``ops/out_of_core.py``); ``host_sort`` / ``host_sort_kv`` /
``host_scan`` back the numpy oracle in ``reference.py`` once built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..ops._build import build_lock

__all__ = ["available", "build_native", "host_sort", "host_sort_kv",
           "host_scan", "host_merge", "BUILD_DIR", "SOURCE", "CXX_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host_sort.cpp"
# Where the library is built; runtime.cache.enable_cache moves it.
BUILD_DIR = _PKG.parent / "build" / "sortx_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None
_P32 = ctypes.POINTER(ctypes.c_uint32)
_P64 = ctypes.POINTER(ctypes.c_int64)


def _compiler() -> str:
    for c in (os.environ.get("CXX"), "c++", "g++"):
        path = c and shutil.which(c)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found (set CXX or put c++ on "
                       "PATH); the sortx_torch host library is built from "
                       "source")


@functools.cache
def _version(cxx: str) -> str:
    return subprocess.run([cxx, "--version"], capture_output=True,
                          text=True).stdout


def _library_path(cxx: str) -> Path:
    """The library's path: its name hashes the source, the flags and the
    compiler (path and version), so no other toolchain's build loads."""
    h = hashlib.sha256(" ".join((cxx, _version(cxx)) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsortx_torch_host_{h.hexdigest()[:16]}.so"


def _bind(path: Path) -> ctypes.CDLL:
    global _lib
    lib = ctypes.CDLL(str(path))
    lib.sortx_host_sort_u32.argtypes = [_P32, ctypes.c_int64, ctypes.c_int]
    lib.sortx_host_sort_u32.restype = None
    lib.sortx_host_sort_kv_u32.argtypes = [_P32, _P32, ctypes.c_int64,
                                           ctypes.c_int]
    lib.sortx_host_sort_kv_u32.restype = None
    lib.sortx_host_exclusive_scan_u32.argtypes = [_P32, _P32,
                                                  ctypes.c_int64]
    lib.sortx_host_exclusive_scan_u32.restype = ctypes.c_uint32
    lib.sortx_host_merge_u32.argtypes = [_P32, _P32, _P64, ctypes.c_int,
                                         _P32, _P32]
    lib.sortx_host_merge_u32.restype = None
    _lib = lib
    return lib


def build_native() -> bool:
    """Build the library if this source has none yet, and load it
    (KernelBuilder compile-step analog). Raises if the build fails."""
    if _lib is not None:
        return True
    cxx = _compiler()
    out = _library_path(cxx)
    with build_lock(BUILD_DIR):
        if not out.exists():
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                so = os.path.join(tmp, out.name)
                cmd = [cxx, *CXX_FLAGS, "-o", so, str(SOURCE)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"host library build failed ({res.returncode}):\n"
                        f"{' '.join(cmd)}\n{res.stderr[-4000:]}")
                os.replace(so, out)
    _bind(out)
    return True


def available() -> bool:
    """True once the library of this source is built (nothing is built
    here)."""
    if _lib is not None:
        return True
    try:
        out = _library_path(_compiler())
    except RuntimeError:
        return False
    if not out.exists():
        return False
    _bind(out)
    return True


def _require() -> ctypes.CDLL:
    build_native()
    return _lib


def _u32(a: np.ndarray):
    return a.ctypes.data_as(_P32)


def host_sort(keys: np.ndarray, sort_bits: int = 32) -> np.ndarray:
    """Stable native LSD sort; returns a new sorted array."""
    lib = _require()
    out = np.ascontiguousarray(keys, dtype=np.uint32).copy()
    lib.sortx_host_sort_u32(_u32(out), out.shape[0], sort_bits)
    return out


def host_sort_kv(keys: np.ndarray, values: np.ndarray, sort_bits: int = 32):
    lib = _require()
    k = np.ascontiguousarray(keys, dtype=np.uint32).copy()
    v = np.ascontiguousarray(values, dtype=np.uint32).copy()
    if k.shape != v.shape:
        raise ValueError("values must match keys shape")
    lib.sortx_host_sort_kv_u32(_u32(k), _u32(v), k.shape[0], sort_bits)
    return k, v


def host_merge(keys: np.ndarray, offsets, values: np.ndarray | None = None):
    """Stable parallel k-way merge of sorted u32 runs.

    ``keys``: sorted runs laid out back-to-back; run r is
    ``keys[offsets[r]:offsets[r+1]]``. Returns the merged array (and the
    values array carried through the same permutation when given); equal
    keys keep run order.
    """
    lib = _require()
    k = np.ascontiguousarray(keys, dtype=np.uint32)
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    if off.ndim != 1 or off.shape[0] < 1 or off[0] != 0:
        raise ValueError("offsets must be 1D and start at 0")
    if off[-1] != k.shape[0]:
        raise ValueError("offsets[-1] must equal len(keys)")
    if np.any(np.diff(off) < 0):
        raise ValueError("offsets must be nondecreasing")
    ko = np.empty_like(k)
    offp = off.ctypes.data_as(_P64)
    if values is None:
        lib.sortx_host_merge_u32(_u32(k), None, offp, off.shape[0] - 1,
                                 _u32(ko), None)
        return ko
    v = np.ascontiguousarray(values, dtype=np.uint32)
    if v.shape != k.shape:
        raise ValueError("values must match keys shape")
    vo = np.empty_like(v)
    lib.sortx_host_merge_u32(_u32(k), _u32(v), offp, off.shape[0] - 1,
                             _u32(ko), _u32(vo))
    return ko, vo


def host_scan(x: np.ndarray):
    """Exclusive u32 scan; returns (out, total)."""
    lib = _require()
    xin = np.ascontiguousarray(x, dtype=np.uint32)
    out = np.empty_like(xin)
    total = lib.sortx_host_exclusive_scan_u32(_u32(xin), _u32(out),
                                              xin.shape[0])
    return out, np.uint32(total)
