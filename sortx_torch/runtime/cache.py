"""Build cache management + warmup.

Port of ``sortx/runtime/cache.py`` (the reference's on-disk kernel
binary cache, keyed by source hash + device + driver,
``Adl/CL/AdlKernelUtilsCL.inl:176-337``). The port's two libraries (the
CUDA kernels, ``ops/_build.py``, and the host library,
``runtime/native.py``) are already kept under a hash of their sources
and flags; ``enable_cache`` points both at one directory
(``adl::s_cacheDirectory`` analog, ``Adl/Adl.h:19-20``), and ``warmup``
builds them and runs ``sort``, ``sort_kv`` and ``scan`` once per size.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from ..utils.log import Channel, log

__all__ = ["enable_cache", "warmup"]

_DEFAULT_DIR = os.environ.get("SORTX_CACHE_DIR", os.path.join(
    os.path.expanduser("~"), ".cache", "sortx_torch"))


def enable_cache(directory: str | None = None) -> str:
    """Build (and look for) both libraries under ``directory``. Takes
    effect for a library not yet loaded in this process."""
    from ..ops import _build
    from . import native

    directory = directory or _DEFAULT_DIR
    os.makedirs(directory, exist_ok=True)
    _build.BUILD_DIR = native.BUILD_DIR = Path(directory)
    log(f"build cache at {directory}", Channel.DEVICE)
    return directory


def warmup(sizes=(1 << 20,), kv: bool = True, scan_too: bool = True,
           config=None, *, device="cuda") -> None:
    """Build the kernels and run each op once per size on ``device``
    (KernelManager cold-start analog: the reference compiles on first
    Launcher construction, ``Adl/AdlKernel.inl:18-108``). The keys are
    a fixed scramble, not sorted, so the engines do run."""
    from .. import ops
    from ..ops._build import check_device

    device = check_device(device)
    for n in sizes:
        idx = torch.arange(n, dtype=torch.int64, device=device)
        k = ((idx * 0x9E3779B1) & 0x7FFFFFFF).to(torch.int32)
        ops.sort(k, config=config)
        if kv:
            ops.sort_kv(k, idx.to(torch.int32), config=config)
        if scan_too:
            ops.scan(k, config=config)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log(f"warmup n={n} done", Channel.DEVICE)
