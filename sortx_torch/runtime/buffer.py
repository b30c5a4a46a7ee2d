"""Typed device buffers with accounting.

Port of ``sortx/runtime/buffer.py`` (the reference's ``adl::Buffer<T>``
/ ``BufferUtils``, ``Adl/Adl.h:161-274``, ``Adl/Adl.inl:201-557``) over
a 1-D torch tensor on the buffer's device: allocate, host <-> device and
device <-> device copies, fill / clear, resize, and map semantics.

Writes go into the tensor in place. ``write(..., blocking=False)`` on a
card stages the host data in pinned memory, queues the copy on the
current stream and returns a ``SyncObject`` holding a
``torch.cuda.Event`` recorded after it (the reference's ``SyncObject``,
``Adl/AdlKernel.h:45-54``). Every copy moves the same-width integer
view of the data, so each bit pattern arrives as it left.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..convert import to_numpy, to_torch
from ..utils.words import INTS, int_view
from .device import SortxDevice

__all__ = ["Buffer", "SyncObject"]

_INT_NP = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch, numpy or ml_dtypes dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    name = str(dtype).removeprefix("torch.")
    if name == "bfloat16":
        import ml_dtypes  # only needed to name the numpy dtype

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


class SyncObject:
    """Completion handle (Adl/AdlKernel.h:45-54 analog) of a queued copy.

    Holds the ``torch.cuda.Event`` recorded after the copy (None: done
    already) and the staging memory the copy reads from, until it ends.
    """

    def __init__(self, event: Optional[torch.cuda.Event] = None,
                 keep=None):
        self._event = event
        self._keep = keep

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()
        self._keep = None

    @property
    def is_complete(self) -> bool:
        """Polls without blocking (cl_event::isComplete analog,
        Adl/CL/AdlCL.inl:616-634)."""
        return self._event is None or self._event.query()


class Buffer:
    """A typed, device-resident 1-D buffer.

    Mirrors the reference Buffer<T> capability set (Adl/Adl.h:161-222):
      - allocate(n) / set_size(n) (set_size zeroes and does NOT preserve
        contents, matching Adl/Adl.inl:331-356)
      - write(host_array) / read() -> numpy (blocking or async)
      - write_buffer(other) (device-to-device copy, AdlCL.inl:442-483)
      - fill(value) / clear()
      - get_host_ptr() / return_host_ptr() map semantics, as copies
    """

    def __init__(self, device: SortxDevice, dtype, n: int = 0):
        self.device = device
        self.dtype = torch_dtype(dtype)
        self._np_dtype = numpy_dtype(self.dtype)
        self._t: Optional[torch.Tensor] = None
        self._nbytes = 0
        if n:
            self.set_size(n)

    # -- lifecycle ----------------------------------------------------
    @property
    def size(self) -> int:
        return 0 if self._t is None else self._t.shape[0]

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def set_size(self, n: int) -> None:
        """(Re)allocate to n zeroed elements; contents are NOT
        preserved."""
        if n == self.size:
            return
        self._release()
        if n > 0:
            self._t = torch.zeros((n,), dtype=INTS[self.dtype.itemsize],
                                  device=self.device.torch_device
                                  ).view(self.dtype)
            self._nbytes = n * self._t.element_size()
            self.device._on_alloc(self._nbytes)

    def _release(self) -> None:
        if self._t is not None:
            self.device._on_free(self._nbytes)
            self._t = None
            self._nbytes = 0

    def destroy(self) -> None:
        self._release()

    # -- data movement ------------------------------------------------
    @property
    def array(self) -> torch.Tensor:
        if self._t is None:
            raise RuntimeError("buffer not allocated")
        return self._t

    @array.setter
    def array(self, value: torch.Tensor) -> None:
        """Adopt a tensor produced by an op (no copy)."""
        if (value.shape != (self.size,) or value.dtype != self.dtype
                or value.device != self.array.device):
            raise ValueError(
                f"shape/dtype/device mismatch: {tuple(value.shape)}/"
                f"{value.dtype}/{value.device} vs ({self.size},)/"
                f"{self.dtype}/{self.array.device}")
        self._t = value

    def write(self, host, n: Optional[int] = None, *, blocking: bool = True
              ) -> Optional[SyncObject]:
        """Copy the first n (default all) elements of ``host`` into the
        buffer's first n. Non-blocking on a card: returns a
        ``SyncObject``."""
        host = np.asarray(host, dtype=self._np_dtype)
        n = len(host) if n is None else n
        if n > self.size:
            raise ValueError(f"write of {n} exceeds buffer size {self.size}")
        src = int_view(to_torch(host[:n]))
        dst = int_view(self.array[:n])
        if blocking or not self.device.is_cuda:
            dst.copy_(src)
            return None if blocking else SyncObject()
        src = src.pin_memory()
        dst.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device.torch_device))
        return SyncObject(event, keep=src)

    def write_buffer(self, src: "Buffer", n: Optional[int] = None) -> None:
        """Device-to-device copy of src's first n elements
        (Buffer::write(Buffer&), Adl/Adl.inl); values convert to this
        buffer's dtype."""
        n = src.size if n is None else n
        if n > self.size:
            raise ValueError(f"copy of {n} exceeds buffer size {self.size}")
        if src.dtype == self.dtype:
            int_view(self.array[:n]).copy_(int_view(src.array[:n]))
        else:
            self.array[:n].copy_(src.array[:n])

    def read(self, n: Optional[int] = None, *, blocking: bool = True):
        """The first n elements: a numpy copy, or (non-blocking) the
        tensor slice itself."""
        n = self.size if n is None else n
        out = self.array[:n]
        return to_numpy(out) if blocking else out

    def fill(self, value) -> None:
        bits = np.asarray(value, dtype=self._np_dtype).reshape(1).view(
            _INT_NP[self._np_dtype.itemsize])[0]
        int_view(self.array).fill_(int(bits))

    def clear(self) -> None:
        self.fill(0)

    # -- map semantics (BufferUtils, Adl/Adl.inl:370-535) -------------
    def get_host_ptr(self) -> np.ndarray:
        """Map for CPU access: a mutable host copy. Not zero-copy, as in
        ``sortx`` (``sortx/runtime/buffer.py:150-164``): the reference
        maps the allocation in place, here it is a device -> host copy
        and ``return_host_ptr`` the copy back."""
        return self.read()

    def return_host_ptr(self, host: np.ndarray) -> None:
        """Unmap: push the (possibly modified) host copy back."""
        self.write(host)

    def __len__(self):
        return self.size

    def __repr__(self):
        return f"Buffer({self.dtype}, n={self.size}, dev={self.device.name})"
