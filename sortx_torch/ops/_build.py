"""Builds the hand-written CUDA kernels at first use and binds them.

The kernels are compiled from ``sortx_torch/csrc/*.cu`` and nothing
else, by ``nvcc`` for ``sm_90a``, into one shared library with a plain C
interface under ``build/sortx_torch/`` at the root of the checkout. The
library's name carries a hash of the sources and flags, so an unchanged
tree loads the library it built before. It is loaded with ``ctypes``:
every pointer and the stream pass as ``c_void_p``.

A missing ``nvcc`` or a failed build raises; nothing falls back. Each C
entry launches on the stream it is given (PyTorch's current stream),
does not synchronise, allocates nothing, and returns
``cudaGetLastError()`` after its launches; :func:`launch` raises if that
is not 0 and otherwise counts one launch of the kernel in
:data:`launches`.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["library", "launch", "launches", "on_card", "BUILD_DIR",
           "SOURCES"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parent / "build" / "sortx_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# Launches of each kernel through its wrapper, by kernel name. A run
# clears it before the work it wants to witness and reads it after.
launches: collections.Counter = collections.Counter()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry -> argument types; every entry returns a cudaError_t as int.
_ENTRIES = {
    # (x, ext, stride, ns, nk, log_block, stream)
    "sortx_bitonic_block": (_P, _L, _L, _I, _I, _I, _P),
    # (x, ext, stride, ns, nk, log_block, s, stream)
    "sortx_bitonic_tail": (_P, _L, _L, _I, _I, _I, _I, _P),
    # (x, ext, stride, ns, nk, s, j_hi, j_lo, stream)
    "sortx_bitonic_global": (_P, _L, _L, _I, _I, _I, _I, _I, _P),
    # (x, out, tile_sums, total, n, tile, inclusive, stream)
    "sortx_scan": (_P, _P, _P, _P, _L, _L, _I, _P),
}


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             ] if os.environ.get("CUDA_HOME") else []
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the sortx_torch kernels are built from source")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    out = BUILD_DIR / f"libsortx_torch_{_digest()}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sortx_error_string.argtypes = (ctypes.c_int,)
    lib.sortx_error_string.restype = ctypes.c_char_p
    return lib


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor
    (the plain version runs); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"sortx_torch runs on CUDA or CPU tensors, got "
                     f"{t.device}")


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Run C ``entry`` on ``device``'s current stream; count ``kernel``."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err:
        raise RuntimeError(f"{kernel}: CUDA error {err} "
                           f"({lib.sortx_error_string(err).decode()})")
    launches[kernel] += 1
