"""The per-tile digit histogram kernel (K5).

Port of ``sortx/ops/radix_kernels.py:tile_histogram``. The kernel
(``csrc/histogram.cu``) replaces ``_histogram_kernel``: one CTA counts
one tile with 16-byte loads and shared-memory atomics on per-warp
counters, and leaves that plain path only where a warp's lanes crowd on
one digit. Two things the TPU kernel does not have: the rows can be
summed inside the kernel (``per_tile=False``: one (radix,) table), and
a ``prefix`` filters the words inside the kernel, counting only those
whose bits above the digit equal it, which is what a round of
``kth_value`` needs. The TPU's 128-lane output rows and 8-row output
blocks do not come along: the output is (num_tiles, radix) int32. The
TPU pads the last tile with 0xFFFFFFFF and its caller subtracts the pad
count; the kernel bounds-checks the last tile instead, so no pad is
counted.
``bitonic_rowsort_comp`` and ``row_sort`` of the same module are
in-kernel helpers that nothing calls, and are not carried.
"""

from __future__ import annotations

import torch

from ..runtime.launcher import profiled
from ..utils.math import cdiv
from ..utils.words import as_u64
from ._build import launch, on_card

__all__ = ["tile_histogram", "histogram_plain"]


def histogram_plain(x: torch.Tensor, shift: int, radix: int,
                    tile_elems: int, prefix: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Plain version of K5: (num_tiles, radix) int32 counts of
    ``(x >> shift) & (radix - 1)`` over tiles of ``tile_elems``. With
    ``prefix`` (one int32 element holding a u32) a word counts only if
    ``x >> (shift + log2 radix)`` equals it; where no bits lie above the
    digit (``shift + log2 radix >= 32``) the prefix is ignored."""
    n = x.shape[0]
    tiles = cdiv(n, tile_elems)
    u = as_u64(x)
    t = torch.arange(n, device=x.device) // tile_elems
    slot = t * radix + ((u >> shift) & (radix - 1))
    hi_shift = shift + radix.bit_length() - 1
    if prefix is not None and hi_shift < 32:
        # the words that do not count go to a slot past the last row
        slot = torch.where((u >> hi_shift) == as_u64(prefix.view(1)), slot,
                           tiles * radix)
    # a fixed-size table (no bincount, whose length follows the data)
    counts = torch.zeros(tiles * radix + 1, dtype=torch.int64,
                         device=x.device)
    counts.scatter_add_(0, slot, torch.ones_like(slot))
    return counts[:tiles * radix].view(tiles, radix).to(torch.int32)


@profiled("histogram", level="kernel")
def tile_histogram(x: torch.Tensor, shift: int, *, radix: int,
                   tile_elems: int, per_tile: bool = True,
                   prefix: torch.Tensor | None = None) -> torch.Tensor:
    """K5: counts of the digit ``(x >> shift) & (radix - 1)`` of a
    non-empty contiguous 1-D int32 tensor (u32 words): per tile, as a
    (ceil(n / tile_elems), radix) int32 tensor, or with
    ``per_tile=False`` their sum over the tiles, (radix,). radix is a
    power of two up to 256. ``prefix``, one int32 element on x's device,
    filters the words as in :func:`histogram_plain`."""
    if x.dim() != 1 or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("tile_histogram takes a contiguous 1-D int32 tensor")
    if x.shape[0] == 0:
        raise ValueError("tile_histogram needs at least one element")
    if not 0 <= shift <= 31:
        raise ValueError("shift must be in 0..31")
    if not 1 <= radix <= 256 or radix & (radix - 1):
        raise ValueError("radix must be a power of two up to 256")
    if tile_elems <= 0:
        raise ValueError("tile_elems must be positive")
    if prefix is not None and (prefix.dtype != torch.int32
                               or prefix.numel() != 1
                               or prefix.device != x.device):
        raise ValueError("prefix must be one int32 element on x's device")
    if not on_card(x):
        counts = histogram_plain(x, shift, radix, tile_elems, prefix)
        return counts if per_tile else counts.sum(0, dtype=torch.int32)
    shape = (cdiv(x.shape[0], tile_elems), radix) if per_tile else (radix,)
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    launch("histogram", "sortx_histogram", x.device, x.data_ptr(),
           out.data_ptr(), None if prefix is None else prefix.data_ptr(),
           x.shape[0], tile_elems, shift, radix, int(per_tile))
    return out
