"""Host sort engine: stable ``torch.sort`` by the masked key bits.

Port of ``sortx/ops/sort_xla.py``: the engine for CPU tensors, and for
any tensor when ``Config(engine="host")`` asks for it. Keys are u32
words carried as int32; they sort through their int64 images, so the
order is unsigned. With partial ``sort_bits`` the order is by the low
bits only, stable, and the full key is carried. The short cuts for
ordered inputs are taken before any engine, in ``ops/sort.py``.
:func:`host_rows` is the same sort along the rows of 2-D streams, and
:func:`sort_multi_host` a stable sort by several words (``sortx``'s
``sort_multi_xla`` passes, and the host path of the 64-bit ops).
"""

from __future__ import annotations

import torch

from ..runtime.launcher import span
from ..utils.words import as_u64, join64, ordered

__all__ = ["sort_host", "sort_kv_host", "host_rows", "sort_multi_host"]


def _order(keys: torch.Tensor, sort_bits: int) -> torch.Tensor:
    """Stable sorting permutation of keys by their low sort_bits bits."""
    k = as_u64(keys)
    if sort_bits < 32:
        k = k & ((1 << sort_bits) - 1)
    return torch.sort(k, stable=True).indices


def sort_host(keys: torch.Tensor, sort_bits: int = 32) -> torch.Tensor:
    """Stable sort of u32 keys (int32 words) by their low sort_bits bits."""
    return keys[_order(keys, sort_bits)]


def sort_kv_host(keys: torch.Tensor, values, sort_bits: int = 32):
    """Stable key-value sort by the low sort_bits bits of u32 keys; the
    value streams (a tuple of int32 words) follow."""
    idx = _order(keys, sort_bits)
    return keys[idx], tuple(v[idx] for v in values)


def host_rows(rows, positions: bool = False):
    """Stable ``torch.sort`` of each row of the (R, L) int32 word tensors
    ``rows`` by the unsigned order of ``rows[0]``, the others gathered
    along (the host counterpart of ``sort_network.network_rows``); with
    ``positions`` the sort's in-row indices, as int32, come back last."""
    with span("engine", "rows"):
        idx = torch.sort(as_u64(rows[0]), dim=1, stable=True).indices
        out = [r.gather(1, idx) for r in rows]
        return out + [idx.to(torch.int32)] if positions else out


def sort_multi_host(words) -> torch.Tensor:
    """Stable sorting permutation (int64) of the columns of the u32 word
    streams ``words`` (int32), lexicographic, ``words[0]`` the most
    significant. Each pair of words is one int64 image, ordered(hi) *
    2^32 + lo, whose signed order is the pair's unsigned order; the
    images sort stable from the least significant one up."""
    images = [join64(ordered(words[i]), words[i + 1]) if i + 1 < len(words)
              else as_u64(words[i]) for i in range(0, len(words), 2)]
    perm = torch.sort(images[-1], stable=True).indices
    for img in reversed(images[:-1]):
        perm = perm[torch.sort(img[perm], stable=True).indices]
    return perm
