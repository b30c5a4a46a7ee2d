"""Sort and scan operators and the kernels under them."""

from .scan import scan
from .sort import sort, sort_kv

__all__ = ["scan", "sort", "sort_kv"]
