"""Stream compaction and key-grouped reductions.

Port of ``sortx/ops/keyed.py``: ``partition``, ``reduce_by_key``,
``sum_by_key``, ``run_length_encode``, ``searchsorted`` and
``is_sorted``, the CUB-style companions of a sort library.

``sortx`` compacts with a stable 1-bit ``sort_kv``, because the TPU
cannot scatter. That is a workaround, not the contract: here the
compaction is the usual GPU shape, flags, then the exclusive scan of
K4 (``scan``), then a scatter. The run compaction scatters each run's
first and last position into a ``size + 1`` buffer whose last slot
absorbs every other element (:func:`scatter_kept`), so nothing reads
the run count on the host. The outputs are ``sortx``'s bit for bit: the fixed ``size``
slots, ``num_*`` as a 0-d device tensor, the fill rules (the last valid
key or ``fill_value`` for keys, 0 for counts and sums), and run sums
mod 2^32, taken from K4's scan at the run bounds.

Equality of keys is bitwise on the radix image: -0.0 and +0.0 differ,
and two NaNs of the same bits are one key.
"""

from __future__ import annotations

import torch

from ..config import Config, default_config
from ..runtime.launcher import profiled
from ..utils.words import int_view, ordered, wrap_i32
from .scan import scan
from .sort import _check_keys, _to_radix_u32, sort_kv

__all__ = ["partition", "reduce_by_key", "sum_by_key", "run_length_encode",
           "searchsorted", "is_sorted"]


@profiled("partition")
def partition(x: torch.Tensor, mask: torch.Tensor, *,
              config: Config | None = None):
    """Stable partition: returns ``(out, num_true)``, where
    ``out[:num_true]`` are the elements under True in their order and
    ``out[num_true:]`` the rest in theirs (CUB
    ``DevicePartition::Flagged``)."""
    cfg = config or default_config()
    if x.dim() != 1:
        raise ValueError("partition expects a 1D array")
    if mask.shape != x.shape:
        raise ValueError("mask must have the same shape as x")
    if mask.dtype != torch.bool:
        raise TypeError("mask must be boolean")
    n = x.shape[0]
    if n == 0:
        return x, torch.zeros((), dtype=torch.int32, device=x.device)
    rank, num_true = scan(mask.to(torch.int32), with_total=True, config=cfg)
    i = torch.arange(n, dtype=torch.int32, device=x.device)
    pos = torch.where(mask, rank, num_true + i - rank)
    xi = int_view(x.contiguous())
    out = torch.empty_like(xi)
    out[pos.long()] = xi
    return out.view(x.dtype), num_true


def scatter_kept(src: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                 size: int) -> torch.Tensor:
    """A (size,) tensor with out[slot[i]] = src[i] for every kept i (their
    slots distinct and < size) and 0 elsewhere. The other elements land in
    one sink slot past ``size``, so nothing reads a count on the host."""
    buf = torch.zeros(size + 1, dtype=src.dtype, device=src.device)
    buf[torch.where(keep, slot, size)] = src
    return buf[:size]


def _runs(k: torch.Tensor, size: int, cfg: Config):
    """The runs of equal consecutive u32 words k (int32): (starts[size],
    ends[size], num_runs), where run r < min(num_runs, size) covers
    [starts[r], ends[r]) and the later slots hold 0."""
    n = k.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=k.device)
    first[1:] = k[1:] != k[:-1]
    last = torch.ones_like(first)
    last[:-1] = first[1:]
    rank, num_runs = scan(first.to(torch.int32), with_total=True, config=cfg)
    # run r's first element has exclusive rank r, its last inclusive r + 1
    pos = torch.arange(n, device=k.device)
    starts, ends = (scatter_kept(pos, r.long(), flag & (r < size), size)
                    for flag, r in ((first, rank),
                                    (last, rank + first.to(torch.int32) - 1)))
    return starts, ends + 1, num_runs


def _fill(dtype: torch.dtype, fill_value, device) -> torch.Tensor:
    """``fill_value`` (or 0) as a 0-d tensor of ``dtype``, in its int view."""
    return int_view(torch.tensor(0 if fill_value is None else fill_value,
                                 dtype=dtype, device=device))


def _consecutive_reduce(keys: torch.Tensor, values, size: int, fill_value,
                        cfg: Config):
    """Shared body of reduce_by_key / run_length_encode / unique.

    ``values=None`` counts run lengths; otherwise it sums the int32 or
    uint32 values of each run mod 2^32. Returns (keys_out, agg, num_runs).
    """
    n = keys.shape[0]
    if size < 1:
        raise ValueError("size must be >= 1")
    dev = keys.device
    agg_dt = torch.int32 if values is None else values.dtype
    if n == 0:
        fv = _fill(keys.dtype, fill_value, dev)
        return (fv.expand(size).clone().view(keys.dtype),
                torch.zeros(size, dtype=agg_dt, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    k, _ = _to_radix_u32(keys.contiguous())
    starts, ends, num_runs = _runs(k, size, cfg)
    valid = torch.arange(size, device=dev) < num_runs
    keys_out = int_view(keys.contiguous())[starts]
    if values is None:
        agg = torch.where(valid, ends - starts, 0).to(torch.int32)
    else:
        g, total = scan(values.contiguous().view(torch.int32),
                        with_total=True, config=cfg)
        g = torch.cat([g, total.view(1)]).to(torch.int64)
        agg = wrap_i32(torch.where(valid, g[ends] - g[starts], 0)).view(
            values.dtype)
    if fill_value is None:
        # a 1-element index: a 0-d one would read it on the host
        fv = keys_out[(num_runs.clamp(max=size) - 1).clamp(min=0).view(1)]
    else:
        fv = _fill(keys.dtype, fill_value, dev)
    keys_out = torch.where(valid, keys_out, fv).view(keys.dtype)
    return keys_out, agg, num_runs


def _check_sum_args(keys, values, what: str) -> None:
    _check_keys(keys)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    if values.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"{what} sums 32-bit integer values, got "
                        f"{values.dtype}")


@profiled("reduce_by_key")
def reduce_by_key(keys: torch.Tensor, values: torch.Tensor, size: int, *,
                  fill_value=None, config: Config | None = None):
    """Sum ``values`` over runs of CONSECUTIVE equal keys (CUB
    ``DeviceReduce::ReduceByKey``); the keys are not sorted first.
    Returns ``(run_keys[size], run_sums[size], num_runs)``: the first
    ``min(num_runs, size)`` slots are valid, key slots past them hold
    ``fill_value`` (default: the last valid key) and sum slots 0. Sums
    wrap mod 2^32."""
    _check_sum_args(keys, values, "reduce_by_key")
    return _consecutive_reduce(keys, values, size, fill_value,
                               config or default_config())


@profiled("sum_by_key")
def sum_by_key(keys: torch.Tensor, values: torch.Tensor, size: int, *,
               fill_value=None, config: Config | None = None):
    """Sum ``values`` grouped by key over the whole array: the distinct
    keys ascending with their totals, ``(keys[size], sums[size],
    num_distinct)``. The grouping sort runs ``stable=False``: the sums
    do not depend on the order of values within a key."""
    cfg = config or default_config()
    _check_sum_args(keys, values, "sum_by_key")
    if keys.shape[0] == 0:
        return _consecutive_reduce(keys, values, size, fill_value, cfg)
    ks, vs = sort_kv(keys, values, stable=False, config=cfg)
    return _consecutive_reduce(ks, vs, size, fill_value, cfg)


@profiled("run_length_encode")
def run_length_encode(x: torch.Tensor, size: int, *, fill_value=None,
                      config: Config | None = None):
    """Lengths of consecutive equal-value runs (CUB RunLengthEncode):
    ``(run_values[size], run_lengths[size], num_runs)``, with the fill
    rules of :func:`reduce_by_key`."""
    _check_keys(x)
    return _consecutive_reduce(x, None, size, fill_value,
                               config or default_config())


def searchsorted(sorted_keys: torch.Tensor, queries: torch.Tensor, *,
                 side: str = "left", config: Config | None = None
                 ) -> torch.Tensor:
    """int32 insertion points of ``queries`` into ``sorted_keys`` in the
    total order of ``sort`` (float NaNs at the extremes by sign). Both
    must share a dtype."""
    if side not in ("left", "right"):
        raise ValueError("side must be 'left' or 'right'")
    _check_keys(sorted_keys)
    if queries.dim() != 1:
        raise ValueError("searchsorted expects 1D queries")
    if queries.dtype != sorted_keys.dtype:
        raise TypeError("sorted_keys and queries must share a dtype")
    a = ordered(_to_radix_u32(sorted_keys.contiguous())[0])
    q = ordered(_to_radix_u32(queries.contiguous())[0])
    return torch.searchsorted(a, q, side=side).to(torch.int32)


def is_sorted(x: torch.Tensor, *, descending: bool = False) -> torch.Tensor:
    """0-d bool tensor: is ``x`` sorted in the total order of ``sort``?"""
    _check_keys(x)
    if x.shape[0] <= 1:
        return torch.ones((), dtype=torch.bool, device=x.device)
    k = ordered(_to_radix_u32(x.contiguous())[0])
    if descending:
        return torch.all(k[1:] <= k[:-1])
    return torch.all(k[1:] >= k[:-1])
