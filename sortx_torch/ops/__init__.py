"""Sort, scan and selection operators and the kernels under them."""

from .extras import sort_u64
from .histogram import histogram
from .rows import sort_kv_rows, sort_rows
from .scan import scan
from .select import kth_value, median, top_k
from .shuffle import apply_runs, build_piece_plan, move_runs
from .sort import sort, sort_kv

__all__ = ["apply_runs", "build_piece_plan", "histogram", "kth_value",
           "median", "move_runs", "scan", "sort", "sort_kv",
           "sort_kv_rows", "sort_rows", "sort_u64", "top_k"]
