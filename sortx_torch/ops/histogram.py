"""Public digit-histogram op.

Port of ``sortx/ops/histogram.py``: counts of ``(x >> shift) &
(2^bits - 1)`` over a 1-D u32/i32 tensor, global or per tile, with the
same errors and empty-input shapes. The tile is ``sort_tile_elems``
clamped to 8..2048 rows of 128 (16384 elements at the default), as the
reference sizes it, so ``per_tile`` tables agree row for row. The
"host" engine (and "auto" on CPU tensors) counts with the kernel's
plain version; the others run K5 (``ops/radix_kernels.py``), which sums
the tiles' rows itself when the caller wants the whole count.
"""

from __future__ import annotations

import torch

from ..config import Config, default_config, resolve_engine
from ..runtime.launcher import profiled
from .radix_kernels import histogram_plain, tile_histogram

__all__ = ["histogram", "histogram_tile", "digit_counts"]

_LANES = 128     # the reference's tile is counted in 128-lane rows


def histogram_tile(cfg: Config) -> int:
    """Elements per tile of ``histogram(per_tile=True)`` under cfg."""
    return max(8, min(2048, cfg.sort_tile_elems // _LANES)) * _LANES


def digit_counts(xi: torch.Tensor, bits: int, shift: int, cfg: Config, *,
                 per_tile: bool = False,
                 prefix: torch.Tensor | None = None) -> torch.Tensor:
    """``histogram`` of non-empty contiguous int32 words under cfg's
    engine, unchecked; ``prefix`` filters the words as in
    ``radix_kernels.histogram_plain``."""
    tile = histogram_tile(cfg)
    if resolve_engine(cfg, xi) == "host":
        counts = histogram_plain(xi, shift, 1 << bits, tile, prefix)
        return counts if per_tile else counts.sum(0, dtype=torch.int32)
    return tile_histogram(xi, shift, radix=1 << bits, tile_elems=tile,
                          per_tile=per_tile, prefix=prefix)


@profiled("histogram")
def histogram(x: torch.Tensor, bits: int = 8, shift: int = 0, *,
              per_tile: bool = False,
              config: Config | None = None) -> torch.Tensor:
    """int32 counts of the ``bits``-wide digit at ``shift`` (1..8 bits,
    0..31): shape (2^bits,), or (num_tiles, 2^bits) with ``per_tile``."""
    cfg = config or default_config()
    if x.dim() != 1:
        raise ValueError("histogram expects a 1D array")
    if x.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"histogram expects 32-bit integers, got {x.dtype}")
    if not 1 <= bits <= 8:
        raise ValueError("bits must be in 1..8")
    if not 0 <= shift <= 31:
        raise ValueError("shift must be in 0..31")
    radix = 1 << bits
    if x.shape[0] == 0:
        shape = (1, radix) if per_tile else (radix,)
        return torch.zeros(shape, dtype=torch.int32, device=x.device)
    return digit_counts(x.contiguous().view(torch.int32), bits, shift, cfg,
                        per_tile=per_tile)
