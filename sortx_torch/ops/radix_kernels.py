"""The per-tile digit histogram kernel (K5).

Port of ``sortx/ops/radix_kernels.py:tile_histogram``. The kernel
(``csrc/histogram.cu``) replaces ``_histogram_kernel``: one CTA counts
one tile. The TPU's 128-lane output rows and 8-row output blocks do not
come along: the output is (num_tiles, radix) int32. The TPU pads the
last tile with 0xFFFFFFFF and its caller subtracts the pad count; the
kernel bounds-checks the last tile instead, so no pad is counted.
``bitonic_rowsort_comp`` and ``row_sort`` of the same module are
in-kernel helpers that nothing calls, and are not carried.
"""

from __future__ import annotations

import torch

from ..utils.math import cdiv
from ..utils.words import as_u64
from ._build import launch, on_card

__all__ = ["tile_histogram", "histogram_plain"]


def histogram_plain(x: torch.Tensor, shift: int, radix: int,
                    tile_elems: int) -> torch.Tensor:
    """Plain version of K5: (num_tiles, radix) int32 counts of
    ``(x >> shift) & (radix - 1)`` over tiles of ``tile_elems``."""
    n = x.shape[0]
    tiles = cdiv(n, tile_elems)
    d = (as_u64(x) >> shift) & (radix - 1)
    t = torch.arange(n, device=x.device) // tile_elems
    return torch.bincount(t * radix + d, minlength=tiles * radix).view(
        tiles, radix).to(torch.int32)


def tile_histogram(x: torch.Tensor, shift: int, *, radix: int,
                   tile_elems: int) -> torch.Tensor:
    """K5: per-tile counts of the digit ``(x >> shift) & (radix - 1)`` of
    a non-empty contiguous 1-D int32 tensor (u32 words), as a
    (ceil(n / tile_elems), radix) int32 tensor. radix is a power of two
    up to 256."""
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
    if not on_card(x):
        return histogram_plain(x, shift, radix, tile_elems)
    out = torch.empty((cdiv(x.shape[0], tile_elems), radix),
                      dtype=torch.int32, device=x.device)
    launch("histogram", "sortx_histogram", x.device, x.data_ptr(),
           out.data_ptr(), x.shape[0], tile_elems, shift, radix)
    return out
