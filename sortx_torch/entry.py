"""The flagship step: stable key-value sort, then a scan of the sorted keys.

Port of the ``fn`` of ``__graft_entry__.py:entry`` (the reference's
headline workload) on torch tensors.
"""

from __future__ import annotations

import torch

from .config import Config
from .ops.scan import scan
from .ops.sort import sort_kv

__all__ = ["entry"]


def entry(keys: torch.Tensor, values: torch.Tensor,
          config: Config | None = None):
    """(sorted keys, values, exclusive scan of the keys as int32, total)."""
    ks, vs = sort_kv(keys, values, config=config)
    s, total = scan(ks.view(torch.int32), with_total=True, config=config)
    return ks, vs, s, total
