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

A 64-bit value rides as two words, (hi, lo), where a KV set has one
value word: one more stream, and under unstable KV at ragged n one more
key, (key, hi, lo).

The row sorts on the network engine (``sort_rows`` of rows up to 2^11
under "auto" on a card, or any under "network"; the hybrid engine's
phases) run the network in rows mode over (key), (key, pos) or (key,
pos, payloads...) rows: :func:`network_rows`, the span ``engine.rows``.

The network runs at every n >= 2. Ordered inputs take the reference's
short cuts on the device (``sortx/ops/sort_pallas.py:343-350, 442-445``):
given the order flags of ``utils.words.order_flags``, every pass of the
network is skipped where the sort key is nondecreasing, and the streams
come back as they went in, which is the reference's "return the keys
(and values)" in every stream set below (the payload streams read back
are the input's). A keys-only full-width sort also skips where the keys
are nonincreasing, and K8 (``bitonic.reverse_ordered``) writes them
reversed: equal keys cannot be told apart, so that is the stable
result. Nothing is read on the host, so these sorts can be captured in a
CUDA graph.

Under ``stable=False`` at n = 2^k the comparator ties on equal keys, so
the order of their values is the network's own: it is a permutation of
the input's pairs, not the reference engine's order.
"""

from __future__ import annotations

import torch

from ..runtime.launcher import span
from ..utils.math import cdiv
from ..utils.words import FF, NONDECREASING, wrap_i32
from .bitonic import bitonic_sort_streams, block_log, reverse_ordered

__all__ = ["sort_network", "sort_kv_network", "packed_partial",
           "network_streams", "network_rows", "presorted"]


def packed_partial(n: int, sort_bits: int) -> bool:
    """Can a partial-bits sort pack its index tie-break into the spare low
    bits of one composite key? Needs the padded length 2^log_n <=
    2^(32 - sort_bits); then a real composite equals the 0xFFFFFFFF pad
    only where there are no pads (see sortx.ops.sort_pallas)."""
    log_n = max((n - 1).bit_length(), 10)
    return 0 < sort_bits < 32 and sort_bits + log_n <= 32


def network_streams(n: int, sort_bits: int, kv: bool, stable: bool,
                    value_words: int = 1) -> int:
    """Streams the network carries for a sort (the capacity check's
    count); a KV sort's values take ``value_words`` streams."""
    if not kv:
        if sort_bits >= 32:
            return 1
        return 2 if packed_partial(n, sort_bits) else 3
    if sort_bits >= 32:
        keys = 2 if stable else 1
    else:
        keys = 2 if packed_partial(n, sort_bits) else 3
    return keys + value_words


def _bitonic(streams, num_keys: int, n_out: int, skip=None):
    """Pad the streams with 0xFFFFFFFF to max(next power of two, 1024) and
    run the network; returns the first n_out columns of each stream.
    Where the 1-element int32 tensor ``skip`` is set, no pass moves a
    word, so the columns come back as the streams went in."""
    n = streams[0].shape[0]
    np2 = 1 << max((n - 1).bit_length(), 10)
    x = torch.full((len(streams), np2), FF, dtype=torch.int32,
                   device=streams[0].device)
    for t, s in enumerate(streams):
        x[t, :n] = s
    bitonic_sort_streams(x, num_keys, n_valid=n, skip=skip)
    return tuple(x[t, :n_out] for t in range(len(streams)))


def presorted(flags):
    """The skip flag of a sort whose input is already in order: the
    NONDECREASING bit of ``flags`` (None passes through)."""
    return None if flags is None else flags & NONDECREASING


def _composite(masked: torch.Tensor, sort_bits: int) -> torch.Tensor:
    """(masked << (32 - sort_bits)) | index, as int32 words."""
    idx = torch.arange(masked.shape[0], device=masked.device)
    return wrap_i32((masked.to(torch.int64) << (32 - sort_bits)) | idx)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def sort_network(keys: torch.Tensor, sort_bits: int,
                 flags: torch.Tensor | None = None) -> torch.Tensor:
    """Stable sort of u32 keys (int32 words) by their low sort_bits bits.
    ``flags``: the order flags of the sort key (``order_flags``), for the
    device-side short cuts; None runs the network whatever the input."""
    with span("engine", "network"):
        n = keys.shape[0]
        skip = presorted(flags)
        if sort_bits >= 32:
            if flags is None:
                return _bitonic((keys,), 1, n)[0]
            out = _bitonic((keys,), 1, n, (flags != 0).to(torch.int32))[0]
            return reverse_ordered(keys, out, flags)
        masked = keys & ((1 << sort_bits) - 1)
        if packed_partial(n, sort_bits):
            return _bitonic((_composite(masked, sort_bits), keys), 1, n,
                            skip)[1]
        return _bitonic((masked, _iota(n, keys.device), keys), 2, n, skip)[2]


def sort_kv_network(keys: torch.Tensor, values, sort_bits: int,
                    stable: bool = True, flags: torch.Tensor | None = None):
    """Key-value sort of u32 keys and the value word streams ``values``
    (a tuple of int32: one word, or the (hi, lo) of 64-bit values).
    Returns (keys, tuple of value words). ``flags`` as for
    :func:`sort_network`: a nondecreasing sort key skips the network."""
    with span("engine", "network"):
        n = keys.shape[0]
        skip = presorted(flags)
        values = tuple(values)
        masked = keys if sort_bits >= 32 else keys & ((1 << sort_bits) - 1)
        if sort_bits >= 32 and not stable:
            # At n = 2^k >= 1024 there are no pads, so the key alone may
            # be the comparator; otherwise (key, value words) keep a pad
            # from displacing a real (0xFFFFFFFF, v) pair off the kept
            # prefix.
            pow2 = n >= 1024 and n & (n - 1) == 0
            out = _bitonic((keys,) + values,
                           1 if pow2 else 1 + len(values), n, skip)
            return out[0], out[1:]
        if sort_bits >= 32:
            out = _bitonic((keys, _iota(n, keys.device)) + values, 2, n,
                           skip)
            return out[0], out[2:]
        if packed_partial(n, sort_bits):
            out = _bitonic((_composite(masked, sort_bits), keys) + values,
                           1, n, skip)
            return out[1], out[2:]
        out = _bitonic((masked, _iota(n, keys.device), keys) + values, 2, n,
                       skip)
        return out[2], out[3:]


def network_rows(rows, positions: bool = False):
    """Sort every row of the (R, L) int32 word tensors ``rows`` by the
    unsigned order of ``rows[0]`` on the row network; the other tensors
    follow, and with any of them equal keys keep their order (the
    in-row position joins the comparator). Returns the sorted tensors.

    With ``positions`` the position stream joins the comparator even
    where ``rows`` is the key alone, and comes back last: the int32
    in-row position of each output slot's key (``sort_rows(...,
    return_indices=True)``; no payload stream carries it)."""
    with span("engine", "rows"):
        R, L = rows[0].shape
        Lp = 1 << max((L - 1).bit_length(), 1)
        stable = len(rows) > 1 or positions
        ns = len(rows) + stable
        n = R * Lp
        total = cdiv(n, 1 << block_log(ns)) << block_log(ns)
        x = torch.full((ns, total), FF, dtype=torch.int32,
                       device=rows[0].device)
        x[0, :n].view(R, Lp)[:, :L] = rows[0]
        if stable:
            # pads past L in a row hold key 0xFFFFFFFF and a position
            # >= L, so they stay behind the row's real 0xFFFFFFFF keys
            x[1, :n].view(R, Lp)[:] = torch.arange(Lp, dtype=torch.int32,
                                                    device=x.device)
            for t, r in enumerate(rows[1:], 2):
                x[t, :n].view(R, Lp)[:, :L] = r
        bitonic_sort_streams(x, 2 if stable else 1, n_valid=n,
                             row_log=Lp.bit_length() - 1)
        out = [x[t, :n].view(R, Lp)[:, :L] for t in range(ns)]
        return [out[0]] + out[2:] + ([out[1].contiguous()] if positions
                                     else [])
