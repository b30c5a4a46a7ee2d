"""Out-of-core sort: chunks sorted on the card, merged on the host.

Port of ``sortx/ops/out_of_core.py`` (the reference's host-backed
buffers beyond the device's allocation limit, ``Adl/CL/AdlCL.inl:
373-378``). Host numpy in, host numpy out: each ``chunk_elems`` slice
is copied to ``device``, sorted there by ``sortx_torch.sort`` /
``sort_kv`` (the network engine, K1-K3, on a card), copied back into
one array of sorted runs, and the runs are merged by the host
library's stable parallel k-way merge (``runtime/native.py:host_merge``,
``csrc/host_sort.cpp:sortx_host_merge_u32``). So ``n`` is bounded by
host memory, not the card's.

Keys of u32 / i32 / f32 travel as u32 radix images, so the merge
compares unsigned words; the order is ``sortx_torch.sort``'s. Also the
home of the reference's public capacity contract,
``check_device_capacity`` / ``device_capacity_keys``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..runtime.launcher import profiled
from ..utils.errors import CapacityError
from ._build import check_device
from .capacity import network_bytes
from .sort import sort, sort_kv

__all__ = ["sort_large", "sort_kv_large", "check_device_capacity",
           "device_capacity_keys"]

_SIGN = np.int32(-(1 << 31))


def _flip_f32(bits: np.ndarray, undo: bool) -> np.ndarray:
    """int32 words ``bits`` with all bits flipped where the top bit is set
    (clear, to ``undo``), the sign bit elsewhere: one allocation, passes
    in place."""
    if undo:
        m = ~bits
        m >>= 31
    else:
        m = bits >> 31
    m |= _SIGN
    m ^= bits
    return m


def _np_to_radix_u32(keys: np.ndarray):
    """u32 / i32 / f32 keys -> (u32 words whose unsigned order is the
    keys' order, undo): ``sortx``'s transform (f32: negatives all bits
    flipped, the rest the sign bit)."""
    dt = keys.dtype
    if dt == np.uint32:
        return keys, lambda k: k
    if dt == np.int32:
        sign = np.uint32(0x80000000)
        return keys.view(np.uint32) ^ sign, (
            lambda k: (k ^ sign).view(np.int32))
    if dt == np.float32:
        bits = keys.view(np.int32)

        def undo(k):
            return _flip_f32(k.view(np.int32), True).view(np.float32)

        return _flip_f32(bits, False).view(np.uint32), undo
    raise TypeError(f"sort_large supports uint32/int32/float32 keys, "
                    f"got {dt}")


def to_card(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host u32 words as a uint32 tensor on ``device`` (one copy)."""
    return torch.from_numpy(words.view(np.int32)).to(device).view(
        torch.uint32)


def from_card(t: torch.Tensor, out: np.ndarray) -> None:
    """Copy 32-bit tensor ``t`` into the host u32 words ``out``."""
    torch.from_numpy(out.view(np.int32)).copy_(t.view(torch.int32))


def chunk_offsets(n: int, chunk_elems: int) -> np.ndarray:
    """Run boundaries: 0, chunk_elems, 2 chunk_elems, ..., n."""
    bounds = list(range(0, n, chunk_elems)) + [n]
    return np.asarray(bounds, dtype=np.int64)


def sort_chunks(ku: np.ndarray, off: np.ndarray, sort_bits: int,
                config: Config | None, device: torch.device) -> np.ndarray:
    """Each run ``ku[off[i]:off[i+1]]`` sorted on ``device``, as one host
    array of sorted runs."""
    runs = np.empty_like(ku)
    for lo, hi in zip(off[:-1].tolist(), off[1:].tolist()):
        from_card(sort(to_card(ku[lo:hi], device), sort_bits,
                       config=config), runs[lo:hi])
    return runs


def sort_kv_chunks(ku: np.ndarray, vu: np.ndarray, off: np.ndarray,
                   config: Config | None, device: torch.device):
    """Each run of (keys, values) sorted stably on ``device``."""
    kr, vr = np.empty_like(ku), np.empty_like(vu)
    for lo, hi in zip(off[:-1].tolist(), off[1:].tolist()):
        ks, vs = sort_kv(to_card(ku[lo:hi], device),
                         to_card(vu[lo:hi], device), config=config)
        from_card(ks, kr[lo:hi])
        from_card(vs, vr[lo:hi])
    return kr, vr


@profiled("sort_large")
def sort_large(keys, sort_bits: int = 32, *, descending: bool = False,
               chunk_elems: int = 1 << 27,
               config: Config | None = None, device="cuda") -> np.ndarray:
    """Stable sort of a host-resident array of any size that fits RAM.

    ``keys``: 1D numpy (or array-like) of u32/i32/f32. Each
    ``chunk_elems`` slice is sorted on ``device`` (default the card; the
    same engine as ``sortx_torch.sort``), then the sorted runs are merged
    by the host library's parallel k-way merge. Ordering contract is
    ``sortx_torch.sort``'s (stable, descending = stable reverse, partial
    ``sort_bits`` low-bit order for u32 keys). Returns numpy.
    """
    keys_np = np.ascontiguousarray(np.asarray(keys))
    if keys_np.ndim != 1:
        raise ValueError("sort_large expects a 1D array")
    if not (1 <= sort_bits <= 32):
        raise ValueError("sort_bits must be in 1..32")
    if sort_bits != 32 and keys_np.dtype != np.uint32:
        raise ValueError("partial sort_bits requires uint32 keys "
                         "(the reference's contract, Pprims.cpp:253)")
    n = keys_np.shape[0]
    ku, undo = _np_to_radix_u32(keys_np)
    device = check_device(device)
    omask = np.uint32(0xFFFFFFFF if sort_bits >= 32
                      else (1 << sort_bits) - 1)
    if descending:
        ku = ku ^ omask
    off = chunk_offsets(n, chunk_elems)
    runs = sort_chunks(ku, off, sort_bits, config, device)
    if len(off) <= 2:
        out = runs
    else:
        from ..runtime import native

        if sort_bits >= 32:
            out = native.host_merge(runs, off)
        else:
            # Merge by the masked key, carrying the full key as the
            # payload: run order == input order keeps the merge stable
            # for equal masked keys (the partial-bits contract).
            _, out = native.host_merge(runs & omask, off, values=runs)
    if descending:
        out = out ^ omask
    return undo(out)


@profiled("sort_kv_large")
def sort_kv_large(keys, values, *, descending: bool = False,
                  chunk_elems: int = 1 << 27,
                  config: Config | None = None, device="cuda"):
    """Stable key-value out-of-core sort (full 32 sort bits).

    Values may be any 4-byte dtype (they ride the merge as u32 views).
    Returns (keys, values) as numpy.
    """
    keys_np = np.ascontiguousarray(np.asarray(keys))
    vals_np = np.ascontiguousarray(np.asarray(values))
    if keys_np.shape != vals_np.shape or keys_np.ndim != 1:
        raise ValueError("keys and values must be equal-shape 1D arrays")
    if vals_np.dtype.itemsize != 4:
        raise TypeError("sort_kv_large requires 4-byte value dtypes")
    n = keys_np.shape[0]
    ku, undo = _np_to_radix_u32(keys_np)
    device = check_device(device)
    if descending:
        ku = ku ^ np.uint32(0xFFFFFFFF)
    vu = vals_np.view(np.uint32)
    off = chunk_offsets(n, chunk_elems)
    kr, vr = sort_kv_chunks(ku, vu, off, config, device)
    if len(off) <= 2:
        ko, vo = kr, vr
    else:
        from ..runtime import native

        ko, vo = native.host_merge(kr, off, values=vr)
    if descending:
        ko = ko ^ np.uint32(0xFFFFFFFF)
    return undo(ko), vo.view(vals_np.dtype)


def _card_bytes() -> int | None:
    """The card's memory (``torch.cuda.mem_get_info``), None without
    one."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.mem_get_info()[1]


def device_capacity_keys(n_streams: int = 1) -> int | None:
    """Max sortable n on the current card, or None without one.

    The network pads to the next power of two and holds one input and
    one output buffer per stream: the largest power of two p with
    p * 4 B * n_streams * 2 <= 90% of the card's memory.
    """
    limit = _card_bytes()
    if not limit:
        return None
    budget = int(limit * 0.90)
    p = 1
    while p * 8 * n_streams <= budget:  # p*4B*streams*2 buffers
        p *= 2
    return p // 2  # largest power of two that fits


def check_device_capacity(n: int, n_streams: int = 1) -> None:
    """Raise ``CapacityError`` if a single-device sort of n cannot fit
    the current card (nothing to check without one), naming
    ``sortx_torch.sort_large`` as the way out."""
    limit = _card_bytes()
    if not limit:
        return
    need = network_bytes(n, n_streams)
    if need > int(limit * 0.90):
        padded = need // (8 * n_streams)
        raise CapacityError(
            f"sort of n={n} needs ~{need / 1e9:.1f} GB of device memory "
            f"({n_streams} stream(s), padded to {padded}) but the device "
            f"limit is {limit / 1e9:.1f} GB; use sortx_torch.sort_large "
            f"(host-staged chunked sort) for beyond-HBM inputs")
