"""Host sort engine: stable ``torch.sort`` by the masked key bits.

Port of ``sortx/ops/sort_xla.py``: the engine for CPU tensors, and for
any tensor when ``Config(engine="host")`` asks for it. Keys are u32
words carried as int32; they sort through their int64 images, so the
order is unsigned. With partial ``sort_bits`` the order is by the low
bits only, stable, and the full key is carried. The short cuts for
ordered inputs are taken before any engine, in ``ops/sort.py``.
"""

from __future__ import annotations

import torch

from ..utils.words import as_u64

__all__ = ["sort_host", "sort_kv_host"]


def _order(keys: torch.Tensor, sort_bits: int) -> torch.Tensor:
    """Stable sorting permutation of keys by their low sort_bits bits."""
    k = as_u64(keys)
    if sort_bits < 32:
        k = k & ((1 << sort_bits) - 1)
    return torch.sort(k, stable=True).indices


def sort_host(keys: torch.Tensor, sort_bits: int = 32) -> torch.Tensor:
    """Stable sort of u32 keys (int32 words) by their low sort_bits bits."""
    return keys[_order(keys, sort_bits)]


def sort_kv_host(keys: torch.Tensor, values: torch.Tensor,
                 sort_bits: int = 32):
    """Stable key-value sort by the low sort_bits bits of u32 keys."""
    idx = _order(keys, sort_bits)
    return keys[idx], values[idx]
