"""32-bit words carried as int32.

PyTorch's uint32 takes no shifts, comparisons or sums, so the port
carries every u32 word as the int32 of the same bits and views it as
uint32 only at the public boundary. Unsigned order is signed order on
``x ^ SIGN``; unsigned values are ``x.long() & 0xFFFFFFFF``.
"""

from __future__ import annotations

import torch

__all__ = ["SIGN", "FF", "as_u64", "wrap_i32", "ordered", "monotone"]

SIGN = -(1 << 31)   # the sign bit as an int32
FF = -1             # the word 0xFFFFFFFF as an int32


def as_u64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned values of int32 words, as int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values mod 2^32, as the int32 words of the same low bits."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def ordered(x: torch.Tensor) -> torch.Tensor:
    """int32 words whose signed order is the unsigned order of ``x``."""
    return x ^ SIGN


def monotone(x: torch.Tensor) -> tuple[bool, bool]:
    """(nondecreasing, nonincreasing) of the u32 sequence ``x`` (int32
    words), read with one host sync."""
    o = ordered(x)
    up, down = torch.stack((torch.all(o[1:] >= o[:-1]),
                            torch.all(o[1:] <= o[:-1]))).tolist()
    return up, down
