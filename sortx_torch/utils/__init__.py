"""Scalar helpers and typed errors."""

from .errors import CapacityError
from .math import cdiv

__all__ = ["CapacityError", "cdiv"]
