"""Network sort engine: the bitonic network over the sort's stream sets.

Port of the bitonic branch of ``sortx/ops/sort_pallas.py`` (``_bitonic``,
``packed_partial``, ``sort_pallas``, ``sort_kv_pallas``). Keys arrive as
u32 words (int32) already transformed by ``ops/sort.py``. The stream
sets, by case (comparator keys first):

  keys-only, full bits         (key)                       1 key
  partial bits, packed         ((masked << (32-b)) | idx, key)  1 key
  partial bits                 (masked, idx, key)          2 keys
  stable KV                    (key, idx, value)           2 keys
  unstable KV, 2^k >= 1024     (key, value)                1 key
  unstable KV, otherwise       (key, value)                2 keys
  partial-bit KV, packed       (composite, key, value)     1 key
  partial-bit KV               (masked, idx, key, value)   2 keys

The network runs at every n >= 2. The short cuts for ordered inputs
are taken before any engine, in ``ops/sort.py``.

Under ``stable=False`` at n = 2^k the comparator ties on equal keys, so
the order of their values is the network's own: it is a permutation of
the input's pairs, not the reference engine's order.
"""

from __future__ import annotations

import torch

from ..utils.words import FF, wrap_i32
from .bitonic import bitonic_sort_streams

__all__ = ["sort_network", "sort_kv_network", "packed_partial",
           "network_streams"]


def packed_partial(n: int, sort_bits: int) -> bool:
    """Can a partial-bits sort pack its index tie-break into the spare low
    bits of one composite key? Needs the padded length 2^log_n <=
    2^(32 - sort_bits); then a real composite equals the 0xFFFFFFFF pad
    only where there are no pads (see sortx.ops.sort_pallas)."""
    log_n = max((n - 1).bit_length(), 10)
    return 0 < sort_bits < 32 and sort_bits + log_n <= 32


def network_streams(n: int, sort_bits: int, kv: bool, stable: bool) -> int:
    """Streams the network carries for a sort (the capacity check's count)."""
    if not kv:
        if sort_bits >= 32:
            return 1
        return 2 if packed_partial(n, sort_bits) else 3
    if sort_bits >= 32:
        return 3 if stable else 2
    return 3 if packed_partial(n, sort_bits) else 4


def _bitonic(streams, num_keys: int, n_out: int):
    """Pad the streams with 0xFFFFFFFF to max(next power of two, 1024) and
    run the network; returns the first n_out columns of each stream."""
    n = streams[0].shape[0]
    np2 = 1 << max((n - 1).bit_length(), 10)
    x = torch.full((len(streams), np2), FF, dtype=torch.int32,
                   device=streams[0].device)
    for t, s in enumerate(streams):
        x[t, :n] = s
    bitonic_sort_streams(x, num_keys, n_valid=n)
    return tuple(x[t, :n_out] for t in range(len(streams)))


def _composite(masked: torch.Tensor, sort_bits: int) -> torch.Tensor:
    """(masked << (32 - sort_bits)) | index, as int32 words."""
    idx = torch.arange(masked.shape[0], device=masked.device)
    return wrap_i32((masked.to(torch.int64) << (32 - sort_bits)) | idx)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def sort_network(keys: torch.Tensor, sort_bits: int) -> torch.Tensor:
    """Stable sort of u32 keys (int32 words) by their low sort_bits bits."""
    n = keys.shape[0]
    if sort_bits >= 32:
        return _bitonic((keys,), 1, n)[0]
    masked = keys & ((1 << sort_bits) - 1)
    if packed_partial(n, sort_bits):
        return _bitonic((_composite(masked, sort_bits), keys), 1, n)[1]
    return _bitonic((masked, _iota(n, keys.device), keys), 2, n)[2]


def sort_kv_network(keys: torch.Tensor, values: torch.Tensor,
                    sort_bits: int, stable: bool = True):
    """Key-value sort of u32 keys and 32-bit value words (both int32)."""
    n = keys.shape[0]
    masked = keys if sort_bits >= 32 else keys & ((1 << sort_bits) - 1)
    if sort_bits >= 32 and not stable:
        # At n = 2^k >= 1024 there are no pads, so the key alone may be
        # the comparator; otherwise (key, value) pairs keep a pad from
        # displacing a real (0xFFFFFFFF, v) pair off the kept prefix.
        pow2 = n >= 1024 and n & (n - 1) == 0
        return _bitonic((keys, values), 1 if pow2 else 2, n)
    if sort_bits >= 32:
        out = _bitonic((keys, _iota(n, keys.device), values), 2, n)
        return out[0], out[2]
    if packed_partial(n, sort_bits):
        out = _bitonic((_composite(masked, sort_bits), keys, values), 1, n)
        return out[1], out[2]
    out = _bitonic((masked, _iota(n, keys.device), keys, values), 2, n)
    return out[2], out[3]
