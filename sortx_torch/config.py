"""Engine configuration of the PyTorch port.

Counterpart of ``sortx/config.py``, carrying only the fields the port
reads. The TPU tuning fields (radix width, hybrid engine, distributed
exchange, interpret and profiling switches) have no reader here.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Config", "LOG_BLOCK_MAX", "resolve_engine"]

# Largest shared-memory block (log2 elements) of the bitonic block
# kernels: 2^13 u32 per stream keeps two streams within 64 KB of the
# 227 KB a CTA may hold, so three CTAs fit on one SM.
LOG_BLOCK_MAX = 13


@dataclasses.dataclass(frozen=True)
class Config:
    """Tuning knobs for the sort/scan engines.

    engine: "network" runs the bitonic network on the hand-written CUDA
      kernels (their plain PyTorch versions for CPU tensors); "host" runs
      the stable ``torch.sort`` engine; "auto" picks the network for CUDA
      tensors and the host engine for CPU tensors.
    scan_tile_elems: elements one CTA of the scan kernels covers (a
      multiple of the 1024-thread CTA).

    The bitonic network's block size is not a field: its output does not
    depend on it, and ``LOG_BLOCK_MAX`` caps it.
    """

    engine: str = "auto"
    scan_tile_elems: int = 1 << 13

    def __post_init__(self):
        if self.engine not in ("auto", "network", "host"):
            raise ValueError("engine must be auto|network|host")
        if self.scan_tile_elems <= 0 or self.scan_tile_elems % 1024:
            raise ValueError("scan_tile_elems must be a positive multiple "
                             "of 1024")


def resolve_engine(cfg: Config, t) -> str:
    """"network" or "host" for tensor ``t`` under ``cfg``."""
    if cfg.engine != "auto":
        return cfg.engine
    return "network" if t.device.type == "cuda" else "host"
