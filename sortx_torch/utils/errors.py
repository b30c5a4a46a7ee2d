"""Typed errors (counterpart of ``sortx/utils/errors.py``)."""

from __future__ import annotations

__all__ = ["CapacityError"]


class CapacityError(MemoryError):
    """A requested single-device operation cannot fit device memory."""
