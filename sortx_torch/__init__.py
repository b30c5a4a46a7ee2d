"""sortx_torch — the PyTorch / CUDA port of sortx for NVIDIA Hopper.

A package beside ``sortx`` (JAX, the reference): the same contracts on
torch tensors. On CUDA tensors every kernel runs as hand-written CUDA
(``csrc/``), built with ``nvcc`` at first use; on CPU tensors the same
schedules run as plain PyTorch. This package never imports jax or sortx.

Layer map:
  sort / sort_kv / scan / entry    ops/sort.py, ops/scan.py, entry.py
  sort_rows / sort_kv_rows         ops/rows.py
  histogram / kth_value / median / top_k / sort_u64
                                   ops/histogram.py, ops/select.py,
                                   ops/extras.py
  engines                          ops/sort_network.py, ops/sort_hybrid.py,
                                   ops/sort_host.py
  bitonic network pass plan        ops/bitonic.py
  kernel wrappers                  ops/bitonic.py, ops/scan.py,
                                   ops/radix_kernels.py, ops/shuffle.py
  kernels                          csrc/bitonic.cu (K1-K3), csrc/scan.cu
                                   (K4), csrc/histogram.cu (K5),
                                   csrc/shuffle.cu (K6, K7)
"""

from .config import Config
from .entry import entry
from .ops import (histogram, kth_value, median, scan, sort, sort_kv,
                  sort_kv_rows, sort_rows, sort_u64, top_k)

__all__ = ["Config", "entry", "histogram", "kth_value", "median", "scan",
           "sort", "sort_kv", "sort_kv_rows", "sort_rows", "sort_u64",
           "top_k"]
