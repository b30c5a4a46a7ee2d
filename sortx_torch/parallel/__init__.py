"""Distributed layer: the rank mesh, process groups, the multi-rank sort
and scan (port of ``sortx/parallel``, on ``torch.distributed``)."""

from .dist_scan import dist_scan
from .dist_sort import (dist_sort, dist_sort_kv, dist_sort_kv_padded,
                        dist_sort_padded)
from .mesh import AXIS, make_sort_mesh, shard_1d
from .multihost import host_count, init_multihost, is_multihost

__all__ = ["dist_scan", "dist_sort", "dist_sort_kv", "dist_sort_padded",
           "dist_sort_kv_padded", "make_sort_mesh", "shard_1d", "AXIS",
           "init_multihost", "is_multihost", "host_count"]
