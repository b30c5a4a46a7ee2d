"""Device-memory admission for single-device sorts.

Port of ``sortx/ops/out_of_core.py:check_device_capacity`` (:187-210),
on ``torch.cuda.mem_get_info``. Same rule: the network pads to a power
of two (at least 1024) and the sort must fit padded * 4 B * streams * 2
within 90% of the card's memory.
"""

from __future__ import annotations

import torch

from ..utils.errors import CapacityError

__all__ = ["check_device_capacity"]


def check_device_capacity(n: int, n_streams: int,
                          device: torch.device) -> None:
    """Raise ``CapacityError`` if a sort of n on ``device`` cannot fit.

    Only CUDA devices are checked."""
    if device.type != "cuda":
        return
    _free, limit = torch.cuda.mem_get_info(device)
    padded = 1 << max((n - 1).bit_length(), 10)
    need = padded * 4 * n_streams * 2
    if need > int(limit * 0.90):
        raise CapacityError(
            f"sort of n={n} needs ~{need / 1e9:.1f} GB of device memory "
            f"({n_streams} stream(s), padded to {padded}) but the device "
            f"holds {limit / 1e9:.1f} GB; the out-of-core sort is not "
            f"ported yet (ROADMAP Queue 1 item 12)")
