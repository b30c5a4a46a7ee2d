"""Ragged segmented sort: each segment of ``offsets`` sorted on its own.

Port of ``sortx/ops/segmented.py``. Each element's segment id (a
``searchsorted`` against the offsets) is the high word of a 64-bit key
and its radix key the low word, so one (hi, lo) sort sorts every
segment in place: ``sort_u64`` on the network at (2, 2), and for
``sort_kv_segments`` the stable ``sort_kv_u64`` at (4, 3). The cost does
not depend on the number or the lengths of the segments.
"""

from __future__ import annotations

import torch

from ..config import Config, default_config
from ..runtime.launcher import profiled
from ..utils.words import wrap_i32
from .extras import sort_kv_u64_words, sort_u64_words
from .sort import _check_keys, _to_radix_u32

__all__ = ["sort_segments", "sort_kv_segments"]


def _segment_ids(offsets, n: int, device) -> torch.Tensor:
    """Segment index of each of n elements, as u32 words (int32), from
    CUB-style offsets: S + 1 nondecreasing ints, offsets[0] == 0 and
    offsets[-1] == n; segment i is [offsets[i], offsets[i+1]), empty
    segments allowed (not validated)."""
    offsets = torch.as_tensor(offsets, device=device)
    if offsets.dim() != 1 or offsets.shape[0] < 2:
        raise ValueError("offsets must be 1D with at least 2 entries "
                         "(S+1 boundaries for S segments)")
    if offsets.shape[0] - 1 > 0xFFFFFFFF:
        raise ValueError("too many segments")
    pos = torch.arange(n, dtype=offsets.dtype, device=device)
    # side='right' - 1: an element at a boundary belongs to the segment
    # that starts there (an empty segment holds no element)
    return wrap_i32(torch.searchsorted(offsets.contiguous(), pos,
                                       side="right") - 1)


@profiled("sort_segments")
def sort_segments(keys: torch.Tensor, offsets, *, descending: bool = False,
                  config: Config | None = None) -> torch.Tensor:
    """Sort each ``keys[offsets[i]:offsets[i+1]]`` on its own (keys as
    ``sort`` takes them, 32-bit or narrower); segment bounds stay."""
    cfg = config or default_config()
    _check_keys(keys)
    n = keys.shape[0]
    if n <= 1:
        return keys
    seg = _segment_ids(offsets, n, keys.device)
    k, undo = _to_radix_u32(keys.contiguous())
    if descending:
        k = ~k
    _, lo = sort_u64_words(seg, k, False, cfg)
    return undo(~lo if descending else lo)


@profiled("sort_kv_segments")
def sort_kv_segments(keys: torch.Tensor, values: torch.Tensor, offsets, *,
                     descending: bool = False, config: Config | None = None):
    """Stable segmented key-value sort: within each segment, values
    follow their keys and equal keys keep their order."""
    cfg = config or default_config()
    _check_keys(keys)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    n = keys.shape[0]
    if n <= 1:
        return keys, values
    seg = _segment_ids(offsets, n, keys.device)
    k, undo = _to_radix_u32(keys.contiguous())
    if descending:
        k = ~k
    _, lo, v = sort_kv_u64_words(seg, k, values.contiguous(), True, False,
                                 cfg)
    return undo(~lo if descending else lo), v
