"""Host/device mirrored array with dirty-state coherence.

Port of ``sortx/runtime/mirror.py`` (the reference's ``uArray<T>``,
``Tahoe/ParallelPrimitives/uArray.h:13-228``): a numpy host array
mirrored by a lazily created tensor on a device, with the coherence
state machine (UNINITIALIZED / CLEAN / CPU_DIRTY / GPU_DIRTY) that
copies on access — ``prepareAccessCpu`` / ``prepareAccessGpu`` as in
the reference. Copies are bit for bit (``convert.py``).
"""

from __future__ import annotations

from enum import Enum
from typing import Optional

import numpy as np
import torch

from ..convert import to_numpy, to_torch
from .buffer import torch_dtype
from .device import SortxDevice

__all__ = ["MirrorState", "MirroredArray"]


class MirrorState(Enum):
    """uArray.h:20-26 state machine."""

    UNINITIALIZED = 0
    CLEAN = 1        # host and device agree
    CPU_DIRTY = 2    # host modified; device stale
    GPU_DIRTY = 3    # device modified; host stale


class MirroredArray:
    """A host array with a coherent, lazily created device mirror.

    ``device``: a ``SortxDevice``, a ``torch.device`` or its name;
    default ``cuda:0``, which is first touched by a device access.
    """

    def __init__(self, dtype, n: int = 0, device=None):
        self.dtype = np.dtype(dtype)
        self._host = np.zeros(n, dtype=self.dtype)
        self._dev: Optional[torch.Tensor] = None
        if isinstance(device, SortxDevice):
            device = device.torch_device
        self._device = torch.device(device if device is not None
                                    else "cuda")
        self.state = (MirrorState.UNINITIALIZED if n == 0
                      else MirrorState.CPU_DIRTY)

    @property
    def size(self) -> int:
        return self._host.shape[0]

    def set_size(self, n: int) -> None:
        """Grow/shrink; preserves host contents up to min(n, old), unlike
        Buffer.set_size but like Tahoe::Array::setSize (Array.h:147)."""
        if n == self.size:
            return
        self.prepare_access_cpu()
        old = self._host
        self._host = np.zeros(n, dtype=self.dtype)
        keep = min(n, old.shape[0])
        self._host[:keep] = old[:keep]
        self._dev = None
        self.state = MirrorState.CPU_DIRTY

    def _pull(self) -> None:
        self._host = to_numpy(self._dev)

    def _push(self) -> None:
        self._dev = to_torch(self._host, self._device)

    # -- coherence protocol (uArray.h:157-212) ------------------------
    def prepare_access_cpu(self) -> np.ndarray:
        """Make the host copy current and mark it writable (CPU_DIRTY)."""
        if self.state == MirrorState.GPU_DIRTY:
            self._pull()
        self.state = MirrorState.CPU_DIRTY
        return self._host

    def prepare_access_gpu(self) -> torch.Tensor:
        """Make the device copy current and mark it writable
        (GPU_DIRTY)."""
        if self._dev is None or self.state == MirrorState.CPU_DIRTY:
            self._push()
        self.state = MirrorState.GPU_DIRTY
        return self._dev

    # -- reads without claiming write access --------------------------
    def host_view(self) -> np.ndarray:
        if self.state == MirrorState.GPU_DIRTY:
            self._pull()
            self.state = MirrorState.CLEAN
        return self._host

    def device_view(self) -> torch.Tensor:
        """getGpuBuffer analog (uArray.h:196-212)."""
        if self._dev is None or self.state == MirrorState.CPU_DIRTY:
            self._push()
            if self.state == MirrorState.CPU_DIRTY:
                self.state = MirrorState.CLEAN
        return self._dev

    def set_device_result(self, t: torch.Tensor) -> None:
        """Adopt an op's output as the new device contents (GPU_DIRTY)."""
        on = (t.device.type == self._device.type
              and self._device.index in (None, t.device.index))
        if (tuple(t.shape) != (self.size,)
                or t.dtype != torch_dtype(self.dtype) or not on):
            raise ValueError("shape/dtype/device mismatch adopting device "
                             "result")
        self._dev = t
        self.state = MirrorState.GPU_DIRTY

    def __getitem__(self, idx):
        return self.host_view()[idx]

    def __setitem__(self, idx, value):
        self.prepare_access_cpu()[idx] = value
