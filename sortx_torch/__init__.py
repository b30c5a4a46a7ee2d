"""sortx_torch — the PyTorch / CUDA port of sortx for NVIDIA Hopper.

A package beside ``sortx`` (JAX, the reference): the same contracts on
torch tensors. On CUDA tensors every kernel runs as hand-written CUDA
(``csrc/``), built with ``nvcc`` at first use; on CPU tensors the same
schedules run as plain PyTorch. This package never imports jax or sortx.

Layer map:
  ParallelPrimitives               api.py (the Pprims facade)
  runtime                          runtime/: device.py, buffer.py,
                                   mirror.py, launcher.py (profiling,
                                   capture), stopwatch.py, profiler.py,
                                   cache.py, native.py (host library)
  sort / sort_kv / scan / entry    ops/sort.py, ops/scan.py, entry.py
  sort_large / sort_kv_large       ops/out_of_core.py (chunks on the card,
                                   runs merged by runtime/native.py)
  sort_rows / sort_kv_rows         ops/rows.py
  histogram / kth_value / median / top_k
                                   ops/histogram.py, ops/select.py
  top_k_rows                       ops/topk_rows.py (per-row top-k over
                                   rows of their own lengths: a radix
                                   select, K13 and K14, then the row
                                   network)
  sort_u64 / sort_kv_u64 / argsort / lexsort
                                   ops/extras.py
  merge / merge_kv                 ops/merge.py
  partition / reduce_by_key / sum_by_key / run_length_encode /
  searchsorted / is_sorted / unique
                                   ops/keyed.py, ops/unique.py
  sort_segments / sort_kv_segments / scan_segments / scan_by_key
                                   ops/segmented.py, ops/segscan.py
  engines                          ops/radix.py (the main path: "auto"
                                   on a card for stable sorts of <= 32-bit
                                   keys), ops/radix_rows.py (rows longer
                                   than 2^11), ops/sort_network.py,
                                   ops/sort_hybrid.py, ops/sort_host.py
  bitonic network pass plans       ops/bitonic.py
  kernel wrappers                  ops/radix.py, ops/radix_rows.py,
                                   ops/topk_rows.py, ops/bitonic.py, ops/scan.py,
                                   ops/radix_kernels.py, ops/shuffle.py
  kernels                          csrc/radix.cu (K9, K10: the main
                                   path), csrc/radix_rows.cu (K11, K12:
                                   the long rows; both include
                                   csrc/onesweep.cuh), csrc/topk_rows.cu
                                   (K13-K15: top_k_rows), csrc/bitonic.cu
                                   (K1-K3), csrc/scan.cu (K4),
                                   csrc/histogram.cu (K5), csrc/shuffle.cu
                                   (K6, K7)
  dist_sort / dist_sort_kv / *_padded / dist_scan / make_sort_mesh
                                   parallel/ (one process per rank on
                                   torch.distributed; one schedule: the
                                   local sort, a ragged all-to-all, the
                                   merge its engine implies, a ragged
                                   rebalance; the sorts, merges and scans
                                   on the ops above: the radix engine
                                   under "auto" on a card)
  host library (merge, oracle)     csrc/host_sort.cpp
  golden oracle (numpy)            reference.py
  config, default_config           config.py
"""

from .api import ParallelPrimitives
from .config import Config, default_config, set_default_config
from .entry import entry
from .ops import (argsort, histogram, is_sorted, kth_value, lexsort, median,
                  merge, merge_kv, partition, reduce_by_key,
                  run_length_encode, scan, scan_by_key, scan_segments,
                  searchsorted, sort, sort_kv, sort_kv_large, sort_kv_rows,
                  sort_kv_segments, sort_kv_u64, sort_large, sort_rows,
                  sort_segments, sort_u64, sum_by_key, top_k, top_k_rows,
                  unique)
from .parallel import (dist_scan, dist_sort, dist_sort_kv,
                       dist_sort_kv_padded, dist_sort_padded,
                       make_sort_mesh)
from . import parallel
from . import reference
from . import runtime
from . import utils

__version__ = "0.1.0"

__all__ = ["ParallelPrimitives", "Config", "default_config",
           "set_default_config", "argsort", "entry", "histogram",
           "is_sorted", "kth_value", "lexsort", "median", "merge",
           "merge_kv", "partition", "reduce_by_key", "run_length_encode",
           "scan", "scan_by_key", "scan_segments", "searchsorted", "sort",
           "sort_kv", "sort_kv_large", "sort_kv_rows", "sort_kv_segments",
           "sort_kv_u64", "sort_large", "sort_rows", "sort_segments",
           "sort_u64", "sum_by_key", "top_k", "top_k_rows", "unique",
           "dist_scan",
           "dist_sort", "dist_sort_kv", "dist_sort_padded",
           "dist_sort_kv_padded", "make_sort_mesh", "parallel",
           "reference", "runtime", "utils", "__version__"]
