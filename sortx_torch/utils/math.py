"""Scalar math helpers (counterpart of ``sortx/utils/math.py``)."""

from __future__ import annotations

__all__ = ["cdiv", "next_pow2", "next_multiple_of", "clamp", "is_pow2"]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def next_pow2(x: int) -> int:
    """The smallest power of two >= x (1 for x <= 1)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def next_multiple_of(x: int, m: int) -> int:
    """x rounded up to a multiple of m."""
    return cdiv(x, m) * m


def clamp(x, lo, hi):
    return max(lo, min(hi, x))


def is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0
