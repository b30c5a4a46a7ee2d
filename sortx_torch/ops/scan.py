"""Prefix sum of 32-bit words, mod 2^32.

Port of ``sortx/ops/scan.py:scan`` (:173-228). The kernel (K4,
``csrc/scan.cu``) replaces ``_scan_tile_kernel``; its plain version is
``torch.cumsum`` in int64, wrapped to 32 bits. The TPU in-kernel
helpers ``cumsum_lanes`` / ``cumsum_sublanes`` are not carried: the
kernel scans with warp shuffles instead.
"""

from __future__ import annotations

import torch

from ..config import Config, resolve_engine
from ..utils.math import cdiv
from ..utils.words import wrap_i32
from ._build import launch, on_card

__all__ = ["scan", "tile_scan", "scan_plain"]


def scan_plain(x: torch.Tensor, inclusive: bool = False):
    """Plain version of K4: (scan, total) of 1-D int32 words."""
    x64 = x.to(torch.int64)
    incl = torch.cumsum(x64, 0)
    out = incl if inclusive else incl - x64
    return wrap_i32(out), wrap_i32(incl[-1])


def tile_scan(x: torch.Tensor, *, inclusive: bool = False,
              tile_elems: int = Config.scan_tile_elems):
    """K4: (scan, total) of a non-empty 1-D int32 tensor, mod 2^32.

    Returns a new int32 tensor of x's length and a 0-dim int32 total.
    """
    if x.dim() != 1 or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("tile_scan takes a contiguous 1-D int32 tensor")
    n = x.shape[0]
    if n == 0:
        raise ValueError("tile_scan needs at least one element")
    if not on_card(x):
        return scan_plain(x, inclusive)
    if tile_elems <= 0 or tile_elems % 1024:
        raise ValueError("tile_elems must be a positive multiple of 1024")
    out = torch.empty_like(x)
    tile_sums = torch.empty(cdiv(n, tile_elems), dtype=torch.int32,
                            device=x.device)
    total = torch.empty(1, dtype=torch.int32, device=x.device)
    launch("scan", "sortx_scan", x.device, x.data_ptr(), out.data_ptr(),
           tile_sums.data_ptr(), total.data_ptr(), n, tile_elems,
           int(inclusive))
    return out, total[0]


def scan(x: torch.Tensor, *, with_total: bool = False,
         inclusive: bool = False, config: Config | None = None):
    """Prefix sum of a 1-D int32/uint32 tensor (exclusive by default).

    Any length; arithmetic wraps mod 2^32. Returns the scan in x's dtype,
    and with ``with_total`` also the grand total as a 0-dim tensor.
    """
    cfg = config or Config()
    if x.dim() != 1:
        raise ValueError("scan expects a 1D array")
    if x.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"scan supports 32-bit integer arrays, got {x.dtype}")
    if x.shape[0] == 0:
        total = torch.zeros((), dtype=torch.int32, device=x.device)
        return (x, total.view(x.dtype)) if with_total else x
    xi = x.contiguous().view(torch.int32)
    if resolve_engine(cfg, x) == "host":
        out, total = scan_plain(xi, inclusive)
    else:
        out, total = tile_scan(xi, inclusive=inclusive,
                               tile_elems=cfg.scan_tile_elems)
    out = out.view(x.dtype)
    return (out, total.view(x.dtype)) if with_total else out
