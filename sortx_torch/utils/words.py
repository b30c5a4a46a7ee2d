"""32-bit words carried as int32.

PyTorch's uint32 takes no shifts, comparisons or sums, so the port
carries every u32 word as the int32 of the same bits and views it as
uint32 only at the public boundary. Unsigned order is signed order on
``x ^ SIGN``; unsigned values are ``x.long() & 0xFFFFFFFF``.

64-bit words (u64, i64, f64) are carried as int64 and split into a
(hi, lo) pair of such 32-bit words by shifts and masks, never through a
uint64 tensor (which takes no shifts or comparisons either).
"""

from __future__ import annotations

import torch

__all__ = ["SIGN", "FF", "INTS", "as_u64", "wrap_i32", "ordered",
           "order_flags", "NONDECREASING", "NONINCREASING", "split64",
           "join64", "int_view"]

SIGN = -(1 << 31)   # the sign bit as an int32
FF = -1             # the word 0xFFFFFFFF as an int32


def as_u64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned values of int32 words, as int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values mod 2^32, as the int32 words of the same low bits."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


INTS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def int_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as the signed integer dtype of its width: the form in
    which any dtype (uint32 and uint64 included) gathers, scatters and
    takes ``torch.where``."""
    return t.view(INTS[t.element_size()])


def split64(x: torch.Tensor):
    """The (hi, lo) 32-bit words (int32) of int64 ``x``."""
    return (x >> 32).to(torch.int32), wrap_i32(x)


def join64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The int64 whose (hi, lo) words are the int32 words ``hi``, ``lo``."""
    return (hi.to(torch.int64) << 32) | as_u64(lo)


def ordered(x: torch.Tensor) -> torch.Tensor:
    """int32 words whose signed order is the unsigned order of ``x``."""
    return x ^ SIGN


NONDECREASING = 1   # bit of order_flags: the words never decrease
NONINCREASING = 2   # bit of order_flags: the words never increase


def order_flags(x: torch.Tensor) -> torch.Tensor:
    """0-d int32 tensor on x's device: NONDECREASING | NONINCREASING of
    the u32 sequence ``x`` (int32 words). Nothing reads it on the host,
    so the branches it selects run on the device, as the reference's
    ``lax.cond`` does, and the call can be captured in a CUDA graph."""
    o = ordered(x)
    up = torch.all(o[1:] >= o[:-1]).to(torch.int32)
    down = torch.all(o[1:] <= o[:-1]).to(torch.int32)
    return up | (down << 1)
