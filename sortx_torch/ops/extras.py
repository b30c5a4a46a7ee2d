"""64-bit keys as (hi, lo) u32 halves, argsort and lexsort.

Port of ``sortx/ops/extras.py``: ``sort_u64``, ``sort_kv_u64``,
``argsort`` and ``lexsort``. The network runs them in one pass with
every key word in the comparator, and the index stream where the order
must be stable:

  sort_u64                      (hi, lo)                   2 keys
  sort_kv_u64, stable           (hi, lo, idx, value)       3 keys
  sort_kv_u64, unstable, 2^k    (hi, lo, value)            2 keys
  sort_kv_u64, unstable, else   (hi, lo, value)            3 keys
  argsort, 32-bit keys          (masked key, idx)          2 keys
  argsort, 64-bit keys          (hi, lo, idx)              3 keys
  lexsort                       (words..., idx)            all keys

The index stream is the result of argsort and lexsort.

Engines, as in ``sortx``: the network runs where ``sortx``'s
``_use_engine`` picks its engine, i.e. under "network", or "auto" on a
CUDA tensor. Otherwise ``sort_u64`` and the 32-bit ``argsort`` run
``sortx``'s word passes through ``sort_kv`` (so "hybrid" runs the
hybrid engine there), and the rest the stable multi-word host sort
(``sort_host.sort_multi_host``). ``lexsort`` past 8 streams takes the
host path too. The TPU's small-n floor is not carried (ROADMAP Queue 1
item 5e). ``_u64_words`` variants take and return int32 words, for the
other ops of the port.
"""

from __future__ import annotations

import torch

from ..config import Config, default_config, resolve_engine
from ..runtime.launcher import profiled
from ..utils.words import int_view, order_flags
from .capacity import check_device_bytes, network_bytes
from .sort import (_DTYPES64, _check_key_dtype, _check_keys, _order_mask,
                   _resolve_sort_bits, _sort_key, _to_radix_u32,
                   _to_radix_u64, sort_kv)
from .sort_host import sort_multi_host
from .sort_network import _bitonic, _iota, presorted

__all__ = ["argsort", "lexsort", "sort_u64", "sort_kv_u64",
           "sort_u64_words", "sort_kv_u64_words"]


def _use_network(cfg: Config, t: torch.Tensor) -> bool:
    return resolve_engine(cfg, t) == "network"


def _network(streams, num_keys: int, what: str, skip=None):
    """Run the network over the streams (int32 words), with the capacity
    check; returns all of them, sorted (as they are, where ``skip``)."""
    n = streams[0].shape[0]
    check_device_bytes(network_bytes(n, len(streams)), streams[0].device,
                       f"{what} of n={n}")
    return _bitonic(tuple(streams), num_keys, n, skip)


def sort_u64_words(h: torch.Tensor, l: torch.Tensor, descending: bool,
                   cfg: Config):
    """``sort_u64`` on int32 (hi, lo) words of n >= 2 elements."""
    if descending:
        # complementing both words reverses the 64-bit order
        h, l = ~h, ~l
    if _use_network(cfg, h):
        h2, l2 = _network((h, l), 2, "sort_u64")
    else:
        # the reference's word passes: stable by lo, then stable by hi
        lo1, hi1 = sort_kv(l.view(torch.uint32), h.view(torch.uint32),
                           config=cfg)
        hi2, lo2 = sort_kv(hi1, lo1, config=cfg)
        h2, l2 = hi2.view(torch.int32), lo2.view(torch.int32)
    return (~h2, ~l2) if descending else (h2, l2)


def sort_kv_u64_words(h: torch.Tensor, l: torch.Tensor,
                      values: torch.Tensor, stable: bool, descending: bool,
                      cfg: Config):
    """``sort_kv_u64`` on int32 (hi, lo) words; values of any dtype (the
    network carries 32-bit ones, the host path the rest)."""
    n = h.shape[0]
    if descending:
        h, l = ~h, ~l
    if n <= 1:
        h2, l2, v2 = h, l, values
    elif _use_network(cfg, h) and values.element_size() == 4:
        v = values.view(torch.int32)
        if stable:
            h2, l2, _, v2 = _network((h, l, _iota(n, h.device), v), 3,
                                     "sort_kv_u64")
        else:
            # As for sort_kv(stable=False): at n = 2^k >= 1024 there are
            # no pads and the key words alone compare; at ragged n the
            # value joins them, so a pad never displaces a real
            # (0xFFFFFFFF, 0xFFFFFFFF, v) triple.
            pow2 = n >= 1024 and n & (n - 1) == 0
            h2, l2, v2 = _network((h, l, v), 2 if pow2 else 3,
                                  "sort_kv_u64")
        v2 = v2.view(values.dtype)
    else:
        perm = sort_multi_host((h, l))
        h2, l2 = h[perm], l[perm]
        v2 = int_view(values)[perm].view(values.dtype)
    return ((~h2, ~l2) if descending else (h2, l2)) + (v2,)


def _check_halves(hi, lo, what: str) -> None:
    if hi.dtype != torch.uint32 or lo.dtype != torch.uint32:
        raise TypeError(f"{what} expects uint32 hi/lo halves")


@profiled("sort_u64")
def sort_u64(hi: torch.Tensor, lo: torch.Tensor, *, descending: bool = False,
             config: Config | None = None):
    """Stable sort of 64-bit keys given as uint32 (hi, lo) halves.
    Returns the sorted (hi, lo)."""
    if hi.shape != lo.shape:
        raise ValueError("hi and lo must have the same shape")
    _check_halves(hi, lo, "sort_u64")
    if hi.shape[0] <= 1:
        return hi, lo
    h2, l2 = sort_u64_words(hi.view(torch.int32), lo.view(torch.int32),
                            descending, config or default_config())
    return h2.view(torch.uint32), l2.view(torch.uint32)


@profiled("sort_kv_u64")
def sort_kv_u64(hi: torch.Tensor, lo: torch.Tensor, values: torch.Tensor, *,
                stable: bool = True, descending: bool = False,
                config: Config | None = None):
    """Stable sort of 64-bit keys given as uint32 (hi, lo) halves,
    carrying ``values``. Returns the sorted (hi, lo, values);
    ``stable=False`` leaves the order of values under equal keys
    unspecified."""
    if not hi.shape == lo.shape == values.shape:
        raise ValueError("hi, lo, values must have the same shape")
    _check_halves(hi, lo, "sort_kv_u64")
    h2, l2, v2 = sort_kv_u64_words(hi.view(torch.int32),
                                   lo.view(torch.int32),
                                   values.contiguous(), stable, descending,
                                   config or default_config())
    return h2.view(torch.uint32), l2.view(torch.uint32), v2


@profiled("argsort")
def argsort(keys: torch.Tensor, sort_bits: int | None = None, *,
            descending: bool = False, config: Config | None = None
            ) -> torch.Tensor:
    """Stable argsort: the int32 permutation that sorts ``keys`` (any key
    dtype of ``sort``, 64-bit included). ``descending`` reverses the key
    order; equal keys still keep ascending positions."""
    cfg = config or default_config()
    _check_keys(keys, allow64=True)
    sort_bits = _resolve_sort_bits(keys, sort_bits, what="argsort")
    n = keys.shape[0]
    idx = _iota(n, keys.device)
    if sort_bits == 64:
        hi, lo, _ = _to_radix_u64(keys.contiguous())
        if descending:
            hi, lo = ~hi, ~lo
        if n <= 1:
            return idx
        if _use_network(cfg, keys):
            return _network((hi, lo, idx), 3, "argsort")[2]
        return sort_multi_host((hi, lo)).to(torch.int32)
    if _use_network(cfg, keys):
        k, _ = _to_radix_u32(keys.contiguous())
        masked = _sort_key(k, sort_bits)
        if descending:
            masked = masked ^ _order_mask(sort_bits)
        if n <= 1:
            return idx
        # an ordered key skips the network on the device: idx comes back
        return _network((masked, idx), 2, "argsort",
                        presorted(order_flags(masked)))[1]
    _, perm = sort_kv(keys, idx.view(torch.uint32), sort_bits,
                      descending=descending, config=cfg)
    return perm.view(torch.int32)


@profiled("lexsort")
def lexsort(keys, *, descending: bool = False,
            config: Config | None = None) -> torch.Tensor:
    """Stable multi-column argsort, ``np.lexsort``'s convention: the LAST
    column is the primary key. Columns may mix key dtypes (a 64-bit one
    contributes two words). Returns the int32 permutation; equal rows
    keep ascending positions, also under ``descending``."""
    keys = tuple(keys)
    if not keys:
        raise ValueError("lexsort needs at least one key column")
    n = keys[0].shape[0]
    for k in keys:
        if k.dim() != 1:
            raise ValueError("lexsort expects 1D key columns")
        if k.shape[0] != n:
            raise ValueError("lexsort key columns must have equal length")
        _check_key_dtype(k.dtype, what="lexsort", allow64=True)
    streams = []
    for k in reversed(keys):               # primary key first
        if k.dtype in _DTYPES64:
            streams += _to_radix_u64(k.contiguous())[:2]
        else:
            streams.append(_to_radix_u32(k.contiguous())[0])
    if descending:
        streams = [~s for s in streams]    # complement = reverse lex order
    cfg = config or default_config()
    idx = _iota(n, keys[0].device)
    if n <= 1:
        return idx
    nk = len(streams) + 1
    if _use_network(cfg, keys[0]) and nk <= 8:
        return _network((*streams, idx), nk, "lexsort")[-1]
    return sort_multi_host(streams).to(torch.int32)
