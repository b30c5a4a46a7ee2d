"""Scalar math helpers (counterpart of ``sortx/utils/math.py``)."""

from __future__ import annotations

__all__ = ["cdiv"]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
