"""Device-memory admission for single-device sorts.

The byte check under ``sortx/ops/out_of_core.py:check_device_capacity``
(:187-210), for the port's engines: a sort must fit within 90% of the
card's memory, its total as ``torch.cuda.get_device_properties`` gives
it, read once a device (no memory query per sort, so a sort can be
captured in a CUDA graph). The network pads to a
power of two (at least 1024) and holds padded * 4 B * streams * 2
(:func:`network_bytes`); the radix engine two buffers a stream and its
scratch (:func:`radix_bytes`); the hybrid counts its own buffers
(``ops/sort_hybrid.py:hybrid_bytes``). The reference's public
``check_device_capacity(n, n_streams)`` is ``ops/out_of_core.py``'s.
"""

from __future__ import annotations

import functools

import torch

from ..utils.errors import CapacityError
from .radix import scratch_words

__all__ = ["check_device_bytes", "network_bytes", "radix_bytes"]


def network_bytes(n: int, n_streams: int) -> int:
    """Device bytes the network holds for a sort of n with n_streams."""
    padded = 1 << max((n - 1).bit_length(), 10)
    return padded * 4 * n_streams * 2


def radix_bytes(n: int, n_streams: int) -> int:
    """Device bytes the radix engine holds for a sort of n with n_streams
    (keys, or keys and one value word): two buffers a stream, and the
    scratch of four passes."""
    return n * 4 * n_streams * 2 + 4 * scratch_words(n, 4)


@functools.cache
def _total_memory(index: int) -> int:
    return torch.cuda.get_device_properties(index).total_memory


def check_device_bytes(need: int, device: torch.device, what: str) -> None:
    """Raise ``CapacityError`` if ``need`` bytes for ``what`` cannot fit
    on ``device``. Only CUDA devices are checked."""
    if device.type != "cuda":
        return
    limit = _total_memory(device.index if device.index is not None
                          else torch.cuda.current_device())
    if need > int(limit * 0.90):
        raise CapacityError(
            f"{what} needs ~{need / 1e9:.1f} GB of device memory but the "
            f"device holds {limit / 1e9:.1f} GB; use sortx_torch.sort_large "
            f"(host-staged chunked sort) for inputs beyond the card")
