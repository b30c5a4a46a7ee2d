"""The card's peaks, and the least time a piece of work can take.

A frozen copy of ``chip_smoke.py``'s ``bound`` arithmetic (NVIDIA's H100
SXM data sheet): device memory at 3.35 TB/s; integer compare, min, max,
add and select on 64 INT32 lanes per SM, one operation a clock, a
quarter of the 67 TFLOP/s of float32. The figures assume the card's
700 W limit; each run prints the limit it ran under.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4


def least_seconds(n_bytes: float, n_ops: float = 0.0) -> tuple:
    """(seconds, "bytes" or "operations"): the least time the card could
    take to move ``n_bytes`` through device memory and do ``n_ops``
    integer operations, and which of the two sets it."""
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = n_ops / INT32_OPS_PER_S
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")
