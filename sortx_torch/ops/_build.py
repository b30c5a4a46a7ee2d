"""Builds the hand-written CUDA kernels at first use and binds them.

The kernels are compiled from ``sortx_torch/csrc/*.cu`` and nothing
else, by ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started
together (``-split-compile 0``: each also compiles its kernels on all
cores, which halves the wait for ``bitonic.cu``), then linked into one
shared library with a plain C interface under :data:`BUILD_DIR` (the
checkout's ``build/sortx_torch/``; ``runtime.cache.enable_cache`` moves
it). The library's name carries a hash of the sources and flags, so an
unchanged tree loads the library it built before. It is loaded with
``ctypes``: every pointer and the stream pass as ``c_void_p``.

A missing ``nvcc`` or a failed build raises; nothing falls back. Each C
entry launches on the stream it is given (PyTorch's current stream),
does not synchronise, allocates nothing, and returns
``cudaGetLastError()`` after its launches; :func:`launch` raises if that
is not 0 and otherwise counts one launch of the kernel in
:data:`launches`. Processes that start together on a fresh tree (the
ranks of a distributed run) build once: the first takes
:func:`build_lock` and builds, the rest wait on it and load.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..runtime.launcher import span

__all__ = ["library", "launch", "launches", "on_card", "check_device",
           "nvcc_path", "build_lock", "BUILD_DIR", "SOURCES", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parent / "build" / "sortx_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-split-compile", "0", "-Xcompiler", "-fPIC")

# Launches of each kernel through its wrapper, by kernel name. A run
# clears it before the work it wants to witness and reads it after.
launches: collections.Counter = collections.Counter()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry -> argument types; every entry returns a cudaError_t as int.
_ENTRIES = {
    # (x, skip, ext, stride, ns, nk, log_block, row_log, stream)
    "sortx_bitonic_block": (_P, _P, _L, _L, _I, _I, _I, _I, _P),
    # (x, skip, ext, stride, ns, nk, log_block, s, force_asc, stream)
    "sortx_bitonic_tail": (_P, _P, _L, _L, _I, _I, _I, _I, _I, _P),
    # (x, skip, ext, stride, ns, nk, s, j_hi, j_lo, force_asc, stream)
    "sortx_bitonic_global": (_P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _P),
    # (flags, src, out, n, stream)
    "sortx_reverse_ordered": (_P, _P, _P, _L, _P),
    # (x, out, scratch, total, n, tile, inclusive, stream)
    "sortx_scan": (_P, _P, _P, _P, _L, _L, _I, _P),
    # (x, out, prefix, n, tile, shift, radix, per_tile, stream)
    "sortx_histogram": (_P, _P, _P, _L, _L, _I, _I, _I, _P),
    # (srcs[], outs[], fills[], ns, src_len, run_src, run_dst, run_len,
    #  chunk_first, chunk_count, out_len, chunk, stream)
    "sortx_move_runs": (_P, _P, _P, _I, _L, _P, _P, _P, _P, _P, _L, _L, _P),
    # (src, out, src_len, piece_src, piece_dst_off, piece_len,
    #  chunk_first, chunk_count, out_len, chunk, stream)
    "sortx_apply_pieces": (_P, _P, _L, _P, _P, _P, _P, _P, _L, _L, _P),
    # (keys, n, bits, scratch, scratch_words, stream)
    "sortx_radix_histogram": (_P, _L, _I, _P, _L, _P),
    # (keys_in, keys_out, values_in, values_out, n, shift, digit_bits,
    #  offsets, region, region_words, stream)
    "sortx_radix_onesweep": (_P, _P, _P, _P, _L, _I, _I, _P, _P, _L, _P),
}


def nvcc_path() -> str:
    """The nvcc that builds the kernels: $CUDA_HOME's, /usr/local/cuda's
    or the one on PATH."""
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


@contextlib.contextmanager
def build_lock(build_dir: Path):
    """Hold an exclusive ``flock`` on ``build_dir/.build.lock`` (made with
    the directory if need be): whoever checks for a library and builds it
    inside, builds it alone. The lock dies with its process."""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    out = BUILD_DIR / f"libsortx_torch_{_digest()}.so"
    with build_lock(BUILD_DIR):
        if not out.exists():
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                nvcc = nvcc_path()
                objs = [os.path.join(tmp, src.stem + ".o")
                        for src in SOURCES]
                _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                          for src, obj in zip(SOURCES, objs)])
                so = os.path.join(tmp, out.name)
                _run_all([[nvcc, "-shared", "-o", so, *objs]])
                os.replace(so, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sortx_error_string.argtypes = (ctypes.c_int,)
    lib.sortx_error_string.restype = ctypes.c_char_p
    return lib


def _run_all(cmds) -> None:
    """Run the commands side by side; once all have ended, raise with the
    output of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errs = [p.communicate()[1] for p in procs]
    for cmd, proc, err in zip(cmds, procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{err[-4000:]}")


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor
    (the plain version runs); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"sortx_torch runs on CUDA or CPU tensors, got "
                     f"{t.device}")


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device`` for an entry point that places
    its own tensors; a CUDA device without a card raises (nothing falls
    back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but there is no "
                           "CUDA card (torch.cuda.is_available() is "
                           "False); pass device='cpu' for the host")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"sortx_torch runs on CUDA or CPU, got {device}")
    return device


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Run C ``entry`` on ``device``'s current stream; count ``kernel``.
    The span ``launch.<kernel>`` covers the stream's look-up and the
    call."""
    lib = library()
    with span("launch", kernel), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err:
        raise RuntimeError(f"{kernel}: CUDA error {err} "
                           f"({lib.sortx_error_string(err).decode()})")
    launches[kernel] += 1
