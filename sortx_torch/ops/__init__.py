"""Sort, scan, selection, merge and grouping operators, the out-of-core
sorts, and the kernels under them."""

from .extras import argsort, lexsort, sort_kv_u64, sort_u64
from .histogram import histogram
from .keyed import (is_sorted, partition, reduce_by_key, run_length_encode,
                    searchsorted, sum_by_key)
from .merge import merge, merge_kv
from .out_of_core import (check_device_capacity, device_capacity_keys,
                          sort_kv_large, sort_large)
from .rows import sort_kv_rows, sort_rows
from .scan import scan
from .segmented import sort_kv_segments, sort_segments
from .segscan import scan_by_key, scan_segments
from .select import kth_value, median, top_k
from .shuffle import apply_runs, build_piece_plan, move_runs
from .sort import sort, sort_kv
from .sort_host import sort_host as sort_xla, sort_kv_host as sort_kv_xla
from .topk_rows import top_k_rows
from .unique import unique

__all__ = ["apply_runs", "argsort", "build_piece_plan",
           "check_device_capacity", "device_capacity_keys", "histogram",
           "is_sorted", "kth_value", "lexsort", "median", "merge",
           "merge_kv", "move_runs", "partition", "reduce_by_key",
           "run_length_encode", "scan", "scan_by_key", "scan_segments",
           "searchsorted", "sort", "sort_kv", "sort_kv_large",
           "sort_kv_rows", "sort_kv_segments", "sort_kv_u64", "sort_kv_xla",
           "sort_large", "sort_rows", "sort_segments", "sort_u64",
           "sort_xla", "sum_by_key", "top_k", "top_k_rows", "unique"]
