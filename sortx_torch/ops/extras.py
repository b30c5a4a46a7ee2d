"""64-bit keys as (hi, lo) u32 halves: ``sort_u64``.

Port of ``sortx/ops/extras.py:sort_u64`` (:149-175). The network engine
sorts the two halves as one (hi, lo) stream set with two keys: one pass
of the network instead of two word passes. The other engines run the
reference's fallback, two stable ``sort_kv`` word passes (lo, then hi).
``argsort``, ``lexsort`` and ``sort_kv_u64`` of the same module are not
ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import torch

from ..config import Config, resolve_engine
from .sort import sort_kv
from .sort_network import _bitonic

__all__ = ["sort_u64"]


def sort_u64(hi: torch.Tensor, lo: torch.Tensor, *, descending: bool = False,
             config: Config | None = None):
    """Stable sort of 64-bit keys given as uint32 (hi, lo) halves.
    Returns the sorted (hi, lo)."""
    if hi.shape != lo.shape:
        raise ValueError("hi and lo must have the same shape")
    if hi.dtype != torch.uint32 or lo.dtype != torch.uint32:
        raise TypeError("sort_u64 expects uint32 hi/lo halves")
    cfg = config or Config()
    n = hi.shape[0]
    if n <= 1:
        return hi, lo
    if resolve_engine(cfg, hi) != "network":
        # the reference's word passes: stable by lo, then stable by hi
        if descending:
            hi, lo = _flip(hi), _flip(lo)
        lo1, hi1 = sort_kv(lo, hi, config=cfg)
        hi2, lo2 = sort_kv(hi1, lo1, config=cfg)
        return (_flip(hi2), _flip(lo2)) if descending else (hi2, lo2)
    h, l = hi.view(torch.int32), lo.view(torch.int32)
    if descending:
        # complementing both words reverses the 64-bit order
        h, l = ~h, ~l
    h2, l2 = _bitonic((h, l), 2, n)
    if descending:
        h2, l2 = ~h2, ~l2
    return h2.view(torch.uint32), l2.view(torch.uint32)


def _flip(u: torch.Tensor) -> torch.Tensor:
    """The complement of uint32 words."""
    return (~u.view(torch.int32)).view(torch.uint32)
