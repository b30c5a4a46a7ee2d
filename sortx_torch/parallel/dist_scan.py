"""Distributed prefix sum over the ranks of a ``torch.distributed`` group.

Port of ``sortx/parallel/dist_scan.py``: each rank scans its shard with
the single-card scan (K4 on the card), the shards' totals are
all-gathered (D words), and each rank adds the lower ranks' total, mod
2^32. The result is bit for bit the single-card ``scan`` of the global
array, split as the input was.
"""

from __future__ import annotations

import torch

from ..config import Config, default_config
from ..ops.scan import scan
from ..runtime.launcher import profiled
from ..utils.words import as_u64, wrap_i32
from .dist_sort import _gather_rows, _global_split
from .mesh import make_sort_mesh, mesh_ranks

__all__ = ["dist_scan"]


@profiled("dist_scan")
def dist_scan(x: torch.Tensor, *, with_total: bool = False,
              inclusive: bool = False, mesh=None,
              config: Config | None = None):
    """Prefix sum (exclusive by default) of a 1-D int32 / uint32 array.

    ``x`` is this rank's shard in ``shard_1d``'s split over ``mesh``
    (default: ``make_sort_mesh()``); returns this rank's shard of the
    scan, and with ``with_total`` also the grand total (0-dim, x's dtype,
    the same on every rank). Arithmetic wraps mod 2^32.
    """
    cfg = config or default_config()
    if x.dim() != 1:
        raise ValueError("dist_scan expects a 1D array")
    if x.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"dist_scan supports 32-bit integer arrays, got "
                        f"{x.dtype}")
    mesh = mesh or make_sort_mesh()
    d, me, group = mesh_ranks(mesh)
    if d > 1:
        _global_split(x.shape[0], x.shape[0], d, group)
    local, total = scan(x, with_total=True, inclusive=inclusive, config=cfg)
    totals = as_u64(_gather_rows(total.view(torch.int32).reshape(1),
                                 group).reshape(-1))
    carry = int(wrap_i32(totals[:me].sum()))
    grand = wrap_i32(totals.sum()).to(x.device).view(x.dtype)
    if carry:
        # int32 addition wraps: the carry is added mod 2^32
        local = (local.view(torch.int32) + carry).view(x.dtype)
    return (local, grand) if with_total else local
