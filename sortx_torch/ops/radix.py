"""The radix engine: a one-sweep LSD radix sort of 32-bit words (K9, K10).

Replaces no TPU kernel: ``sortx`` sorts on the bitonic network. This is
the algorithm of the system ``sortx`` was modelled on (OCLRadixSort, an
LSD radix sort of digit histogram, scan and stable scatter) in the
one-sweep form of Onesweep (arXiv:2206.01784), with 8-bit digits:

- K9 (``radix_histogram``, ``csrc/radix.cu``) reads the keys once and
  counts every digit of every pass, then turns the counts into each
  pass's exclusive digit offsets;
- K10 (``radix_onesweep``) runs one stable counting pass a digit. Its
  CTAs take tiles (4096 words keys-only, 6144 with values) in ticket
  (input) order, rank each word stably inside the tile, and find where
  the tile's run of each digit starts by decoupled look-back over the
  tiles before it.

Both are bound by bytes: 36 bytes a key keys-only at 32 bits, 68 with a
32-bit value, against the network's 296 and about 1250. The plain
versions (:func:`offsets_plain`, :func:`onesweep_plain`) follow the
kernels' schedule: the warps' slots, ranks and offsets, the tiles in
ticket order. The wrappers take them only for CPU tensors.

The engine sorts u32 words (int32) by their low ``sort_bits`` bits in
ceil(sort_bits / 8) passes, the last digit narrower where sort_bits is
no multiple of 8. Every pass is stable, so the output is the unique
stable order: a sorted input comes back as it went in, with no order
flags. One scratch tensor holds the offsets, the tickets and the status
words; K9's entry zeroes it on the stream, so nothing is read on the
host and a call can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch

from ..runtime.launcher import profiled, span
from ..utils.math import cdiv
from ..utils.words import as_u64
from ._build import launch, on_card

__all__ = ["RADIX_TILE", "RADIX_MAX_N", "radix_passes", "scratch_words",
           "offsets_plain", "onesweep_plain", "radix_histogram",
           "radix_onesweep", "radix_sort_streams", "sort_radix",
           "sort_kv_radix"]

RADIX = 256            # 8-bit digits
RADIX_MAX_N = 1 << 30  # the status words count in 30 bits: n < 2^30
_WARPS = 8             # K10's warps a tile, each ranking slots of 32 lanes
_SLOTS = {False: 16, True: 24}   # slots a warp: keys-only, with values
RADIX_TILE = _WARPS * 32 * _SLOTS[False]   # the smaller K10 tile, 4096
_HEADER = 4 * RADIX + 32   # words before the first pass's region
_REGION_HEADER = 32        # a region's ticket, then its status words


def radix_passes(sort_bits: int) -> int:
    return cdiv(sort_bits, 8)


def _digit_bits(sort_bits: int, p: int) -> int:
    """Width of pass p's digit: 8, the last one what is left."""
    return min(8, sort_bits - 8 * p)


def _region(n: int) -> int:
    """A pass's ticket and status words, for the smaller tile (K10's
    entry refuses a region too small for the tile it launches)."""
    return _REGION_HEADER + cdiv(n, RADIX_TILE) * RADIX


def scratch_words(n: int, passes: int) -> int:
    """int32 words of a sort's scratch: the offsets and K9's ticket, then
    a ticket and 256 status words a tile for each pass."""
    return _HEADER + passes * _region(n)


def offsets_plain(keys: torch.Tensor, sort_bits: int) -> torch.Tensor:
    """Plain version of K9: (passes, 256) int32, the place in each pass's
    output where each digit's run starts."""
    u = as_u64(keys)
    rows = []
    for p in range(radix_passes(sort_bits)):
        d = (u >> 8 * p) & ((1 << _digit_bits(sort_bits, p)) - 1)
        c = torch.zeros(RADIX, dtype=torch.int64, device=keys.device)
        c.scatter_add_(0, d, torch.ones_like(d))
        rows.append(c.cumsum(0) - c)
    return torch.stack(rows).to(torch.int32)


def onesweep_plain(keys: torch.Tensor, shift: int, digit_bits: int,
                   offsets: torch.Tensor, values: torch.Tensor | None = None):
    """Plain version of K10: (keys, values) stably by the digit ``(k >>
    shift) & (2^digit_bits - 1)``; ``offsets`` the pass's 256 digit
    offsets. In the kernel's schedule: the tiles' digit counts are summed
    in ticket order (the look-back), the warps' counts inside a tile give
    each warp its first rank of each digit, and each warp ranks its slots
    of 32 words in turn (the lanes below with the same digit, plus the
    warp's count of it so far); 16 slots a warp keys-only, 24 with
    values, as the kernel's two tiles."""
    n = keys.shape[0]
    slots_per_warp = _SLOTS[values is not None]
    tile = _WARPS * 32 * slots_per_warp
    tiles = cdiv(n, tile)
    dev = keys.device
    d = torch.full((tiles * tile,), RADIX, dtype=torch.int64,
                   device=dev)   # past the end: a digit no word has
    d[:n] = (as_u64(keys) >> shift) & ((1 << digit_bits) - 1)
    slots = d.view(tiles * _WARPS, slots_per_warp, 32)
    counts = torch.zeros(tiles * _WARPS, RADIX + 1, dtype=torch.int64,
                         device=dev)
    rank = torch.empty_like(slots)
    lower = torch.ones(32, 32, dtype=torch.bool, device=dev).tril(-1)
    for i in range(slots_per_warp):
        s = slots[:, i]
        peers = s[:, :, None] == s[:, None, :]
        rank[:, i] = counts.gather(1, s) + (peers & lower).sum(2)
        counts.scatter_add_(1, s, torch.ones_like(s))
    counts = counts[:, :RADIX].view(tiles, _WARPS, RADIX)
    warp_off = counts.cumsum(1) - counts
    tile_count = counts.sum(1)
    tile_excl = tile_count.cumsum(0) - tile_count
    # each word's place: its digit's offset, the tiles and warps before it,
    # its rank in the warp
    before = (offsets.to(torch.int64)[None, None, :] + tile_excl[:, None, :]
              + warp_off).view(tiles * _WARPS, RADIX)
    pos = before.gather(1, slots.reshape(tiles * _WARPS, -1).clamp(
        max=RADIX - 1)).view(-1)[:n] + rank.view(-1)[:n]
    out = torch.empty_like(keys)
    out[pos] = keys
    if values is None:
        return out, None
    vout = torch.empty_like(values)
    vout[pos] = values
    return out, vout


def _check_words(t: torch.Tensor, what: str) -> None:
    if t.dim() != 1 or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D int32 tensor")


@profiled("radix_histogram", level="kernel")
def radix_histogram(keys: torch.Tensor, sort_bits: int,
                    scratch: torch.Tensor | None = None) -> torch.Tensor:
    """K9: (passes, 256) int32 digit offsets of the u32 words ``keys``
    (a contiguous 1-D int32 tensor, 0 < n < 2^30) by their low
    ``sort_bits`` bits. On the card ``scratch`` (``scratch_words(n,
    passes)`` int32 words) is zeroed and the offsets are its first rows;
    without one the call makes its own."""
    _check_words(keys, "keys")
    n = keys.shape[0]
    if not 0 < n < RADIX_MAX_N:
        raise ValueError(f"radix_histogram takes 0 < n < 2^30, got {n}")
    if not 1 <= sort_bits <= 32:
        raise ValueError("sort_bits must be in 1..32")
    passes = radix_passes(sort_bits)
    if not on_card(keys):
        return offsets_plain(keys, sort_bits)
    if scratch is None:
        scratch = torch.empty(scratch_words(n, passes), dtype=torch.int32,
                              device=keys.device)
    if (scratch.dtype != torch.int32 or not scratch.is_contiguous()
            or scratch.device != keys.device
            or scratch.numel() < scratch_words(n, passes)):
        raise ValueError("scratch must hold scratch_words(n, passes) "
                         "contiguous int32 words on the keys' device")
    launch("radix_histogram", "sortx_radix_histogram", keys.device,
           keys.data_ptr(), n, sort_bits, scratch.data_ptr(),
           scratch.numel())
    return scratch[:passes * RADIX].view(passes, RADIX)


@profiled("radix_onesweep", level="kernel")
def radix_onesweep(keys: torch.Tensor, keys_out: torch.Tensor,
                   offsets: torch.Tensor, shift: int, digit_bits: int, *,
                   region: torch.Tensor | None = None,
                   values: torch.Tensor | None = None,
                   values_out: torch.Tensor | None = None) -> None:
    """K10: one stable pass of the digit ``(k >> shift) & (2^digit_bits -
    1)``: keys (and values) into keys_out (values_out), which overlap
    nothing. ``offsets``: the pass's row of :func:`radix_histogram`. On
    the card ``region``, the pass's zeroed ticket and status words (its
    slice of K9's scratch), is needed."""
    for t, what in ((keys, "keys"), (keys_out, "keys_out")):
        _check_words(t, what)
    n = keys.shape[0]
    if keys_out.shape[0] != n or not 0 < n < RADIX_MAX_N:
        raise ValueError("keys and keys_out must share a length in 1..2^30-1")
    if not (0 <= shift <= 31 and 1 <= digit_bits <= 8):
        raise ValueError("shift must be in 0..31, digit_bits in 1..8")
    if (values is None) != (values_out is None):
        raise ValueError("values and values_out go together")
    if values is not None:
        for t, what in ((values, "values"), (values_out, "values_out")):
            _check_words(t, what)
            if t.shape[0] != n:
                raise ValueError(f"{what} must have the keys' length")
    if (offsets.dtype != torch.int32 or offsets.shape != (RADIX,)
            or not offsets.is_contiguous() or offsets.device != keys.device):
        raise ValueError("offsets must be 256 int32 words on the keys' "
                         "device")
    if not on_card(keys):
        k, v = onesweep_plain(keys, shift, digit_bits, offsets, values)
        keys_out.copy_(k)
        if values is not None:
            values_out.copy_(v)
        return
    if (region is None or region.dtype != torch.int32
            or not region.is_contiguous() or region.device != keys.device
            or region.numel() < _region(n)):
        raise ValueError("region must hold the pass's ticket and status "
                         "words: a zeroed slice of K9's scratch")
    launch("radix_onesweep", "sortx_radix_onesweep", keys.device,
           keys.data_ptr(), keys_out.data_ptr(),
           None if values is None else values.data_ptr(),
           None if values_out is None else values_out.data_ptr(), n, shift,
           digit_bits, offsets.data_ptr(), region.data_ptr(),
           region.numel())


def radix_sort_streams(keys: torch.Tensor, sort_bits: int,
                       values: torch.Tensor | None = None):
    """Stable sort of the u32 words ``keys`` (contiguous int32, n <
    2^30) by their low ``sort_bits`` bits, with one word of ``values``
    following: K9, then ceil(sort_bits / 8) passes of K10 between two
    buffers a stream. Returns (keys, values or None); the inputs are only
    read."""
    with span("driver", "radix"):
        n = keys.shape[0]
        if n == 0:
            return keys, values
        passes = radix_passes(sort_bits)
        dev = keys.device
        scratch = (torch.empty(scratch_words(n, passes), dtype=torch.int32,
                               device=dev) if on_card(keys) else None)
        offsets = radix_histogram(keys, sort_bits, scratch)
        bufs = [torch.empty_like(keys) for _ in range(min(passes, 2))]
        vbufs = ([torch.empty_like(values) for _ in bufs]
                 if values is not None else [None] * len(bufs))
        src, vsrc = keys, values
        for p in range(passes):
            region = None
            if scratch is not None:
                lo = _HEADER + p * _region(n)
                region = scratch[lo:lo + _region(n)]
            radix_onesweep(src, bufs[p % 2], offsets[p], 8 * p,
                           _digit_bits(sort_bits, p), region=region,
                           values=vsrc, values_out=vbufs[p % 2])
            src, vsrc = bufs[p % 2], vbufs[p % 2]
        return src, vsrc


def sort_radix(keys: torch.Tensor, sort_bits: int) -> torch.Tensor:
    """Stable sort of u32 keys (int32 words) by their low sort_bits
    bits."""
    with span("engine", "radix"):
        return radix_sort_streams(keys, sort_bits)[0]


def sort_kv_radix(keys: torch.Tensor, value: torch.Tensor, sort_bits: int):
    """Stable key-value sort of u32 keys and one int32 value word."""
    with span("engine", "radix"):
        return radix_sort_streams(keys, sort_bits, value)
