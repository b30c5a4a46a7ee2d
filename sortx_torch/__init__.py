"""sortx_torch — the PyTorch / CUDA port of sortx for NVIDIA Hopper.

A package beside ``sortx`` (JAX, the reference): the same sort and scan
contracts on torch tensors. On CUDA tensors the bitonic network and the
scan run on hand-written CUDA kernels (``csrc/``), built with ``nvcc``
at first use; on CPU tensors the same schedules run as plain PyTorch.
This package never imports jax or sortx.

Layer map:
  sort / sort_kv / scan           ops/sort.py, ops/scan.py  (public API)
  engines                         ops/sort_network.py, ops/sort_host.py
  bitonic network pass plan       ops/bitonic.py
  kernels                         csrc/bitonic.cu, csrc/scan.cu
"""

from .config import Config
from .entry import entry
from .ops import scan, sort, sort_kv

__all__ = ["Config", "entry", "scan", "sort", "sort_kv"]
