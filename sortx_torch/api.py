"""Device-bound facade with the shape of the reference's ``Pprims`` class.

Port of ``sortx/api.py``. The reference exposes its primitives through
an object bound to a device that owns its work buffers
(``Pprims::Pprims(const Device*)``, ``Tahoe/ParallelPrimitives/
Pprims.h:15-41``); the port keeps the call shape, on
``sortx_torch.runtime`` buffers:

    pp = sortx_torch.ParallelPrimitives(device)   # Pprims p(device)
    pp.radix_sort(buf)                             # p.radixSort(d, buf, n)
    pp.radix_sort_kv(kbuf, vbuf)                   # p.radixSort(d, kv, n)
    pp.scan(dst, src, with_total=True)             # p.scan(d, dst, src, n, &s)

Results are written back into the buffers (the reference's in-out
Buffer semantics). With ``n`` shorter than a buffer, only its first n
elements are read and written; the rest stay as they were.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import Config, default_config
from .ops import scan as _scan, sort as _sort, sort_kv as _sort_kv
from .runtime.buffer import Buffer
from .runtime.device import SortxDevice, allocate_device
from .utils.words import int_view

__all__ = ["ParallelPrimitives"]


def _store(buf: Buffer, n: int, out: torch.Tensor) -> None:
    """Write an op's n outputs back into the buffer: adopt the tensor
    when it covers the buffer, else copy into the first n."""
    if n == buf.size:
        buf.array = out
    else:
        int_view(buf.array[:n]).copy_(int_view(out))


class ParallelPrimitives:
    """Primitive API facade bound to a device (Pprims analog)."""

    def __init__(self, device: Optional[SortxDevice] = None,
                 config: Optional[Config] = None):
        self.device = device or allocate_device()
        self.config = config or default_config()

    # -- Pprims::radixSort(Buffer<u32>&, n, sortBits) ------------------
    def radix_sort(self, keys: Buffer, n: Optional[int] = None,
                   sort_bits: int = 32) -> None:
        """Sort the buffer's first n keys in place (keys-only overload)."""
        n = keys.size if n is None else n
        _store(keys, n, _sort(keys.array[:n], sort_bits,
                              config=self.config))

    # -- Pprims::radixSort(Buffer<uint2>&, n) --------------------------
    def radix_sort_kv(self, keys: Buffer, values: Buffer,
                      n: Optional[int] = None, sort_bits: int = 32) -> None:
        """Stable key-value sort in place."""
        n = keys.size if n is None else n
        ks, vs = _sort_kv(keys.array[:n], values.array[:n], sort_bits,
                          config=self.config)
        _store(keys, n, ks)
        _store(values, n, vs)

    # -- Pprims::scan(Buffer& dst, Buffer& src, n, sum*) ---------------
    def scan(self, dst: Buffer, src: Buffer, n: Optional[int] = None,
             with_total: bool = False):
        """Exclusive prefix sum src -> dst; optionally return the total.

        Unlike the reference (hard failure above 2^20 elements,
        ``Pprims.cpp:134-138``), any size is supported. The source is read
        as int32 words; the total comes back as a 0-d tensor in dst's
        dtype (the reference's u32 out-parameter, ``Pprims.h:35``).
        """
        n = src.size if n is None else n
        res = _scan(src.array[:n].view(torch.int32), with_total=with_total,
                    config=self.config)
        out, total = res if with_total else (res, None)
        _store(dst, n, out.view(dst.dtype))
        return total.view(dst.dtype) if with_total else None
