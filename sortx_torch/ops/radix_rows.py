"""The rows' radix engine: a segmented one-sweep LSD radix sort (K11, K12).

Replaces no TPU kernel: ``sortx`` sorts rows on the bitonic network in
rows mode. This is the flat radix engine (``ops/radix.py``, K9 / K10)
with a row-aware tile map, so every row of an [R, L] array sorts at once
in four stable 8-bit passes:

- K11 (``radix_rows_histogram``, ``csrc/radix_rows.cu``) reads the keys
  once and counts each row's digits of every pass, then turns each row's
  counts into exclusive in-row offsets (the row's last CTA, by a per-row
  ticket);
- K12 (``radix_rows_onesweep``) runs one stable pass of every row: row r
  owns ceil(L / tile) consecutive tickets, its words spread evenly over
  them, so a tile never spans two rows, and its look-back stops at the
  row's first tile.

The keys are the caller's own 32-bit words: K11 and the first K12 apply
the order map of ``ops/sort.py:_to_radix_u32`` (and, descending, its
complement) in registers, the last K12 stores the words mapped back, and
a sort with indices makes each word's in-row position in the first pass.
So a call is one memset, K11 and four K12, with no pad, fill or staging
(16-bit keys keep their widening and narrowing on the torch side). The
output is the unique stable order: the row network's and a stable
``torch.sort``'s, bit for bit.

The plain versions (:func:`offsets_rows_plain`, :func:`onesweep_rows_plain`:
each row's digit counts, and a stable sort of each row's digits placed
at K11's offsets) give the kernels' outputs bit for bit; the wrappers
take them only for CPU tensors.
Which calls this engine serves is ``ops/rows.py:rows_engine``'s rule.
"""

from __future__ import annotations

import torch

from ..runtime.launcher import profiled, span
from ..utils.math import cdiv, next_multiple_of
from ..utils.words import SIGN, as_u64
from ._build import launch, on_card
from .radix import RADIX, RADIX_MAX_N
from .sort import _narrow_float32, _widen_float16

__all__ = ["PASSES", "KINDS", "tile_shape", "scratch_words", "key_words",
           "encode_plain", "decode_plain", "offsets_rows_plain",
           "onesweep_rows_plain", "radix_rows_histogram",
           "radix_rows_onesweep", "radix_rows"]

PASSES = 4             # rows sort on all 32 bits
# K12's tile (Sweep in csrc/onesweep.cuh): keys alone, with values
_TILE = {False: 4096, True: 6144}
_REGION_HEADER = 32    # a pass's ticket, then its status words
# kind -> (neg_mask, pos_xor) of the order map: w ^ ((w >> 31 & neg_mask)
# | pos_xor), the map of ops/sort.py:_to_radix_u32 for u32, i32 and f32
KINDS = {"u32": (0, 0), "i32": (0, SIGN), "f32": (-1, SIGN)}
_KIND_CODE = {"u32": 0, "i32": 1, "f32": 2}


def tile_shape(length: int, pairs: bool):
    """(tiles a row, words a tile but the last) of K12 for rows of
    ``length``: the fewest tiles of at most K12's tile, the row's words
    spread evenly over them."""
    tiles = cdiv(length, _TILE[pairs])
    return tiles, cdiv(length, tiles)


def _header(rows: int) -> int:
    """Words of the offsets (a row's 4 x 256) and K11's row tickets."""
    return rows * PASSES * RADIX + next_multiple_of(rows, 32)


def _region(rows: int, length: int, pairs: bool) -> int:
    return _REGION_HEADER + rows * tile_shape(length, pairs)[0] * RADIX


def scratch_words(rows: int, length: int, pairs: bool) -> int:
    """int32 words of a sort's scratch: the offsets and K11's tickets,
    then each pass's ticket and 256 status words a tile."""
    return _header(rows) + PASSES * _region(rows, length, pairs)


def key_words(keys: torch.Tensor):
    """(words, kind, narrow): the keys as int32 words of their own 32
    bits (16-bit keys widened as ``_to_radix_u32`` widens them), the
    kind of their order map, and ``narrow(words)`` back to the keys'
    dtype."""
    dt = keys.dtype
    if dt == torch.uint32:
        return keys.view(torch.int32), "u32", lambda w: w.view(dt)
    if dt == torch.int32:
        return keys, "i32", lambda w: w
    if dt == torch.float32:
        return keys.view(torch.int32), "f32", lambda w: w.view(dt)
    if dt == torch.uint16:
        return (keys.view(torch.int16).to(torch.int32) & 0xFFFF, "u32",
                lambda w: (((w & 0xFFFF) ^ 0x8000) - 0x8000).to(
                    torch.int16).view(dt))
    if dt == torch.int16:
        return keys.to(torch.int32), "i32", lambda w: w.to(dt)
    return (_widen_float16(keys).view(torch.int32), "f32",
            lambda w: _narrow_float32(w.view(torch.float32), dt))


def encode_plain(words: torch.Tensor, kind: str, descending: bool):
    """The order map of ``kind`` on int32 words, complemented under
    ``descending``: unsigned order of the result is the sort's order."""
    neg, pos = KINDS[kind]
    u = words ^ (((words >> 31) & neg) | pos)
    return ~u if descending else u


def decode_plain(u: torch.Tensor, kind: str, descending: bool):
    """The inverse of :func:`encode_plain`."""
    v = ~u if descending else u
    neg, pos = KINDS[kind]
    return v ^ (((~v >> 31) & neg) | pos)


def offsets_rows_plain(keys: torch.Tensor, kind: str,
                       descending: bool) -> torch.Tensor:
    """Plain version of K11: (R, 4, 256) int32, the place in each row of
    each pass's output where each digit's run starts."""
    u = as_u64(encode_plain(keys, kind, descending))
    out = []
    for p in range(PASSES):
        d = (u >> 8 * p) & (RADIX - 1)
        c = torch.zeros(keys.shape[0], RADIX, dtype=torch.int64,
                        device=keys.device)
        c.scatter_add_(1, d, torch.ones_like(d))
        out.append(c.cumsum(1) - c)
    return torch.stack(out, 1).to(torch.int32)


def onesweep_rows_plain(keys: torch.Tensor, p: int, offsets: torch.Tensor,
                        kind: str, descending: bool,
                        values: torch.Tensor | None = None,
                        positions: bool = False):
    """Plain version of K12: pass ``p`` of every row of the [R, L] words
    ``keys`` (and ``values``; with ``positions``, the in-row positions,
    made here) stably by digit p; ``offsets`` the pass's (R, 256) in-row
    digit offsets. The first pass maps the words by ``kind`` and
    ``descending``, the last maps them back. A stable pass by one digit
    has one output whatever the tiles: each word goes to its digit's
    offset plus its rank among the row's words of that digit, which a
    stable sort of the digits gives."""
    R, L = keys.shape
    k = encode_plain(keys, kind, descending) if p == 0 else keys
    digits = (as_u64(k) >> 8 * p) & (RADIX - 1)
    d, order = torch.sort(digits, dim=1, stable=True)
    rank = torch.arange(L, device=keys.device) - torch.searchsorted(d, d)
    pos = offsets.to(torch.int64).gather(1, d) + rank
    if p == PASSES - 1:
        k = decode_plain(k, kind, descending)
    out = torch.empty_like(k).scatter_(1, pos, k.gather(1, order))
    if values is None and not positions:
        return out, None
    if positions:
        values = torch.arange(L, dtype=torch.int32,
                              device=keys.device).expand(R, L)
    return out, torch.empty_like(k).scatter_(1, pos, values.gather(1, order))


def _check_rows(t: torch.Tensor, what: str) -> None:
    if t.dim() != 2 or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 2-D int32 tensor")


def _check_shape(keys: torch.Tensor, kind: str) -> None:
    _check_rows(keys, "keys")
    R, L = keys.shape
    if not (R > 0 and L > 0 and R * L < RADIX_MAX_N):
        raise ValueError(f"radix rows take 0 < R * L < 2^30, got {R} x {L}")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}")


@profiled("radix_rows_histogram", level="kernel")
def radix_rows_histogram(keys: torch.Tensor, kind: str, descending: bool,
                         scratch: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """K11: (R, 4, 256) int32 in-row digit offsets of the [R, L] words
    ``keys`` under the order map ``kind`` (and ``descending``). On the
    card ``scratch`` (:func:`scratch_words` int32 words) is zeroed and
    the offsets are its first rows; without one the call makes its
    own."""
    _check_shape(keys, kind)
    R, L = keys.shape
    if not on_card(keys):
        return offsets_rows_plain(keys, kind, descending)
    if scratch is None:
        scratch = torch.empty(scratch_words(R, L, False), dtype=torch.int32,
                              device=keys.device)
    if (scratch.dtype != torch.int32 or not scratch.is_contiguous()
            or scratch.device != keys.device
            or scratch.numel() < _header(R)):
        raise ValueError("scratch must hold scratch_words(R, L, pairs) "
                         "contiguous int32 words on the keys' device")
    launch("radix_rows_histogram", "sortx_radix_rows_histogram",
           keys.device, keys.data_ptr(), R, L, _KIND_CODE[kind],
           int(descending), scratch.data_ptr(), scratch.numel())
    return scratch[:R * PASSES * RADIX].view(R, PASSES, RADIX)


@profiled("radix_rows_onesweep", level="kernel")
def radix_rows_onesweep(keys: torch.Tensor, keys_out: torch.Tensor,
                        offsets: torch.Tensor, p: int, kind: str,
                        descending: bool, *,
                        region: torch.Tensor | None = None,
                        values: torch.Tensor | None = None,
                        values_out: torch.Tensor | None = None) -> None:
    """K12: pass ``p`` (0..3) of every row, keys (and values) into
    keys_out (values_out), which overlap nothing. ``values_out`` without
    ``values`` (pass 0 only): the values are the in-row positions.
    ``offsets``: :func:`radix_rows_histogram`'s (R, 4, 256). On the card
    ``region``, the pass's zeroed ticket and status words (its slice of
    K11's scratch), is needed."""
    _check_shape(keys, kind)
    _check_rows(keys_out, "keys_out")
    R, L = keys.shape
    if keys_out.shape != keys.shape:
        raise ValueError("keys and keys_out must have one shape")
    if not 0 <= p < PASSES:
        raise ValueError("p must be in 0..3")
    if values is not None and values_out is None:
        raise ValueError("values need values_out")
    if values_out is not None and values is None and p != 0:
        raise ValueError("positions are made by the first pass only")
    for t, what in ((values, "values"), (values_out, "values_out")):
        if t is not None:
            _check_rows(t, what)
            if t.shape != keys.shape:
                raise ValueError(f"{what} must have the keys' shape")
    if (offsets.dtype != torch.int32 or offsets.shape != (R, PASSES, RADIX)
            or not offsets.is_contiguous() or offsets.device != keys.device):
        raise ValueError("offsets must be K11's (R, 4, 256) int32 words on "
                         "the keys' device")
    if not on_card(keys):
        k, v = onesweep_rows_plain(keys, p, offsets[:, p], kind, descending,
                                   values, positions=values_out is not None
                                   and values is None)
        keys_out.copy_(k)
        if values_out is not None:
            values_out.copy_(v)
        return
    pairs = values_out is not None
    if (region is None or region.dtype != torch.int32
            or not region.is_contiguous() or region.device != keys.device
            or region.numel() < _region(R, L, pairs)):
        raise ValueError("region must hold the pass's ticket and status "
                         "words: a zeroed slice of K11's scratch")
    launch("radix_rows_onesweep", "sortx_radix_rows_onesweep", keys.device,
           keys.data_ptr(), keys_out.data_ptr(),
           None if values is None else values.data_ptr(),
           None if values_out is None else values_out.data_ptr(), R, L, p,
           _KIND_CODE[kind], int(descending), offsets.data_ptr(),
           region.data_ptr(), region.numel())


def radix_rows(keys: torch.Tensor, kind: str, descending: bool, *,
               values: torch.Tensor | None = None, positions: bool = False):
    """Stable sort of every row of the [R, L] int32 words ``keys`` (the
    caller's own bits) in the order of ``kind``, ascending or
    descending, with one int32 value word following, or with
    ``positions`` the in-row positions: K11, then four K12 passes between
    two buffers a stream. Returns (keys, values or positions or None):
    the keys as the caller's words again, in sorted order; the inputs are
    only read. The engine's span holds its buffers (the scratch, two a
    stream), the driver's the launches."""
    with span("engine", "rows"):
        R, L = keys.shape
        pairs = values is not None or positions
        scratch = (torch.empty(scratch_words(R, L, pairs), dtype=torch.int32,
                               device=keys.device) if on_card(keys) else None)
        bufs = [torch.empty_like(keys) for _ in range(2)]
        vbufs = ([torch.empty_like(keys) for _ in range(2)] if pairs
                 else [None, None])
        return _passes(keys, values, kind, descending, scratch, bufs, vbufs)


def _passes(keys, values, kind, descending, scratch, bufs, vbufs):
    """K11, then the four K12 passes from ``keys`` (and ``values``) in
    turn through ``bufs`` (and ``vbufs``); each pass's region is its
    slice of ``scratch`` (None off the card)."""
    with span("driver", "radix_rows"):
        R, L = keys.shape
        offsets = radix_rows_histogram(keys, kind, descending, scratch)
        src, vsrc = keys, values
        region = _region(R, L, vbufs[0] is not None)
        for p in range(PASSES):
            lo = _header(R) + p * region
            radix_rows_onesweep(
                src, bufs[p % 2], offsets, p, kind, descending,
                region=None if scratch is None else scratch[lo:lo + region],
                values=vsrc, values_out=vbufs[p % 2])
            src, vsrc = bufs[p % 2], vbufs[p % 2]
        return src, vsrc
