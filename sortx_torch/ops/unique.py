"""unique: sorted distinct values with counts, at a fixed output size.

Port of ``sortx/ops/unique.py``: a sort, then the run compaction of
``ops/keyed.py`` (flags, K4's scan, a scatter) in place of ``sortx``'s
1-bit ``sort_kv``, which the TPU needs only because it cannot scatter.
Values are distinct by their bits on the radix image: -0.0 and +0.0
are two values, and NaNs of the same bits are one (``sortx``'s code
merges them, whatever its docstring says).
"""

from __future__ import annotations

import torch

from ..config import Config, default_config
from ..runtime.launcher import profiled
from .keyed import _consecutive_reduce
from .sort import _check_keys, sort

__all__ = ["unique"]


@profiled("unique")
def unique(x: torch.Tensor, size: int, *, assume_sorted: bool = False,
           fill_value=None, config: Config | None = None):
    """Sorted distinct values of ``x`` with their multiplicities:
    ``(values[size], counts[size], num_unique)``. The first
    ``min(num_unique, size)`` slots are valid; later value slots hold
    ``fill_value`` (default: the last distinct value) and counts 0.
    ``assume_sorted`` skips the sort of an ascending ``x``."""
    cfg = config or default_config()
    _check_keys(x)
    if size < 1:
        raise ValueError("size must be >= 1")
    xs = x if assume_sorted or x.shape[0] == 0 else sort(x, config=cfg)
    return _consecutive_reduce(xs, None, size, fill_value, cfg)
