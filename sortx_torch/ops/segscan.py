"""Ragged segmented prefix scan: ``scan_segments`` and ``scan_by_key``.

Port of ``sortx/ops/segscan.py``. ``sortx`` runs the segmented-sum
operator through ``jax.lax.associative_scan``. Here both ops read K4's
flat exclusive scan g of the whole array (``scan``): the exclusive
result at i is g[i] - g[start(i)] mod 2^32, and the inclusive one adds
x[i], where start(i) is the first index of i's segment. That is
bit-identical to the associative scan. ``scan_segments`` reads start(i)
from the offsets; ``scan_by_key`` numbers the runs with a second K4
scan (of the run-start flags) and scatters g at each run start to its
run's slot (``keyed.scatter_kept``). torch's ``cummax``, the obvious
running start, scans a 1-D tensor in one CUDA block: 407 ms at 2^27 on
an H100 (against 15 ms for this).
The per-segment totals read the same g at the offsets.
"""

from __future__ import annotations

import torch

from ..config import Config, default_config
from ..runtime.launcher import profiled
from ..utils.words import as_u64, int_view, wrap_i32
from .keyed import scatter_kept
from .scan import scan
from .segmented import _segment_ids

__all__ = ["scan_segments", "scan_by_key"]


def _segmented(x: torch.Tensor, g: torch.Tensor, g_start: torch.Tensor,
               inclusive: bool) -> torch.Tensor:
    """The segmented scan of int32 words x from their flat exclusive scan
    g and g at each element's segment start."""
    out = g.to(torch.int64) - g_start.to(torch.int64)
    if inclusive:
        out += x
    return wrap_i32(out)


def _check_words(x: torch.Tensor, what: str, noun: str) -> None:
    if x.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"{what} supports 32-bit integer {noun}, got "
                        f"{x.dtype}")


def _run_keys(keys: torch.Tensor) -> torch.Tensor:
    """The keys as ``sortx/ops/segscan.py:116`` compares them: by value
    (float NaNs never equal, -0.0 == +0.0), with f32, f64 and bf16
    subnormals as zero, since XLA flushes them there (on the CPU and the
    TPU); f16 keys keep theirs (XLA compares them as f32, where they are
    normal)."""
    if not keys.is_floating_point():
        return int_view(keys)
    if keys.dtype == torch.float16:
        return keys
    sub = keys.abs() < torch.finfo(keys.dtype).tiny
    return torch.where(sub, torch.zeros_like(keys), keys)


@profiled("scan_segments")
def scan_segments(x: torch.Tensor, offsets, *, with_totals: bool = False,
                  inclusive: bool = False, config: Config | None = None):
    """Prefix-scan each ``x[offsets[i]:offsets[i+1]]`` on its own
    (exclusive by default) for int32/uint32 x, mod 2^32; ``offsets`` as
    in ``sort_segments``. With ``with_totals`` also the [S] segment
    sums."""
    cfg = config or default_config()
    if x.dim() != 1:
        raise ValueError("scan_segments expects a 1D array")
    _check_words(x, "scan_segments", "arrays")
    n = x.shape[0]
    offsets = torch.as_tensor(offsets, device=x.device)
    n_seg = offsets.shape[0] - 1
    if offsets.dim() != 1 or n_seg < 1:
        raise ValueError("offsets must be 1D with at least 2 entries "
                         "(S+1 boundaries for S segments)")
    if n == 0:
        totals = torch.zeros(n_seg, dtype=x.dtype, device=x.device)
        return (x, totals) if with_totals else x
    xi = x.contiguous().view(torch.int32)
    offsets = offsets.long()
    start = offsets[as_u64(_segment_ids(offsets, n, x.device))]
    g, total = scan(xi, with_total=True, config=cfg)
    out = _segmented(xi, g, g[start], inclusive).view(x.dtype)
    if not with_totals:
        return out
    g = torch.cat([g, total.view(1)]).to(torch.int64)
    return out, wrap_i32(g[offsets[1:]] - g[offsets[:-1]]).view(x.dtype)


@profiled("scan_by_key")
def scan_by_key(keys: torch.Tensor, values: torch.Tensor, *,
                inclusive: bool = False, config: Config | None = None):
    """Prefix-scan ``values`` (int32/uint32, mod 2^32) within runs of
    equal consecutive keys (CUB ``DeviceScan::*SumByKey``): a key that
    comes back later starts a new run. Keys compare as ``sortx``'s
    ``!=`` does under XLA (:func:`_run_keys`)."""
    cfg = config or default_config()
    if keys.dim() != 1 or values.dim() != 1:
        raise ValueError("scan_by_key expects 1D arrays")
    if keys.shape != values.shape:
        raise ValueError("keys and values must have the same shape")
    _check_words(values, "scan_by_key", "values")
    n = values.shape[0]
    if n == 0:
        return values
    xi = values.contiguous().view(torch.int32)
    k = _run_keys(keys)
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    first[1:] = k[1:] != k[:-1]
    run = scan(first.to(torch.int32), inclusive=True, config=cfg).long() - 1
    g = scan(xi, config=cfg)
    g_start = scatter_kept(g, run, first, n)[run]
    return _segmented(xi, g, g_start, inclusive).view(values.dtype)
