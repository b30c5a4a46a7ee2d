"""Per-row top-k over rows of their own lengths: ``top_k_rows``.

No port of a ``sortx`` op: ``sortx.top_k`` is 1-D. This is the select of
DeepSeek-V3.2's sparse-attention indexer, which keeps the ``index_topk``
best-scoring earlier positions of every query token's causal row of
scores (``Indexer.forward``: ``index_score.topk(min(index_topk,
end_pos), dim=-1)`` over the scores masked with -inf past each row's
end). Row r of the result is the same as
``sortx.top_k(keys[r, :lengths[r]], min(k, lengths[r]),
return_indices=True)``, padded to k.

On a CUDA tensor, whatever the engine, a radix select that never sorts
a row and reads each valid key twice (``csrc/topk_rows.cu``; AIR top-k's
filtering):

- K13 (``topk_rows_histogram``) counts each row's 11-bit first digit and
  picks the bucket that holds the row's k-th key: a row's need (the
  words still to take in it), its bucket and the bucket's size;
- K14 (``topk_rows_gather``) reads every valid key once more: the keys
  above the bucket go to the row network's three streams (mapped word,
  in-row index, the caller's word), the bucket's keys with their indices
  to the row's candidate buffer (:func:`buffer_cap` keys);
- K15 (``topk_rows_buffer_select``), one CTA a row, counts the next two
  digits (bits 10..20, then 0..9) over the buffer alone, which gives the
  row's k-th key's word T and its ties to keep (the lowest indices), and
  writes the bucket's winners and kept ties after K14's, then fills the
  row's later slots so that they sort last.

A row whose bucket is larger than its buffer (a low-entropy row) leaves
its buffer empty and K15 reads its whole row instead: the card decides
from the row's own count, with nothing read on the host. The network
then sorts each row of k by (word, index) with the caller's words
following: descending keys, ties to the lowest index. Words are the
caller's keys mapped by ``ops/sort.py:_to_radix_u32`` and complemented
(``radix_rows.encode_plain(..., descending=True)``), so the largest key
is the smallest word. A call is a memset, K13, K14, K15 and the row
network's passes (one at k = 2048).

:func:`buffer_counts` reads a running count, kept by K15 on each card
and by its plain version on the CPU, of the rows whose later rounds and
gather read their buffer alone, against all rows (calls captured into a
CUDA graph are not counted).

CPU tensors run the plain versions (:func:`histogram_plain`,
:func:`gather_plain`, :func:`buffer_select_plain`) in the same
schedule; they give the kernels' row state and the same kept words
(the kernels' slots come in the order their warps take them, which the
row sort makes one).
"""

from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import is_fake

from ..config import Config
from ..runtime.launcher import profiled, span
from ..utils.math import cdiv, next_multiple_of
from ..utils.words import FF, SIGN, as_u64, wrap_i32
from ._build import launch, on_card
from .bitonic import bitonic_sort_streams, block_log
from .radix_rows import encode_plain, key_words
from .sort import _check_key_dtype

__all__ = ["top_k_rows", "CHUNK", "TOP_BITS", "buffer_cap",
           "scratch_words", "row_state", "row_taken", "row_buffer",
           "buffer_counts", "histogram_plain", "gather_plain",
           "buffer_select_plain", "topk_rows_histogram", "topk_rows_gather",
           "topk_rows_buffer_select", "topk_rows_select"]

CHUNK = 16384         # words of a row a CTA, K13 and K14 (csrc: kChunk)
TOP_BITS = 11         # K13's digit: bits 21..31; then K15's 10..20, 0..9
_MID, _LOW = 11, 10
_BINS = 1 << TOP_BITS
_MIN_BUFFER = 1024    # a row's buffer holds at least (csrc: kMinBuffer)
_KIND_CODE = {"u32": 0, "i32": 1, "f32": 2}
_MAX = (1 << 31) - 1  # k, L and int32 in-row indices
# the word of the lowest key, which the slots past min(k, lengths[r]) hold:
# -inf (float32 bits, which narrow to -inf in 16 bits) or the integer's least
_LOWEST = {torch.float32: -8388608, torch.float16: -8388608,
           torch.bfloat16: -8388608, torch.int32: SIGN, torch.int16: -32768,
           torch.uint32: 0, torch.uint16: 0}
# device -> int64 [2]: rows K15 selected on their buffer alone, and rows
_COUNTS: dict = {}


def buffer_cap(length: int) -> int:
    """Keys a row's candidate buffer holds: a sixteenth of the row, at
    least 1024 and at most the row (csrc: ``buffer_cap``)."""
    return min(length, max(_MIN_BUFFER, cdiv(length, 16)))


@functools.lru_cache(maxsize=256)
def _layout(rows: int, length: int) -> tuple:
    """(each part's first word, the scratch's words): the parts as
    csrc/topk_rows.cu ``layout`` lays them out, each padded to 32 words:
    the counts (rows x 2048), tickets, the rows' 64-bit counters, need,
    prefix, bucket, and the buffers' words and indices (rows x cap)."""
    cap = buffer_cap(length)
    at, first = 0, {}
    for name, words in (("counts", rows * _BINS), ("tickets", rows),
                        ("taken", 2 * rows), ("state", rows),
                        ("prefix", rows), ("bucket", rows),
                        ("buf_words", rows * cap), ("buf_index", rows * cap)):
        first[name] = at
        at += next_multiple_of(words, 32)
    return first, at


def scratch_words(rows: int, length: int) -> int:
    """int32 words of a select's scratch: K13's counts and tickets, the
    rows' counters and state, their candidate buffers."""
    return _layout(rows, length)[1]


def row_state(scratch: torch.Tensor, rows: int, length: int) -> torch.Tensor:
    """The rows' state in ``scratch``: [3, rows] int32, each row's keys
    still to take at its prefix (need), its prefix and its bucket's size.
    After K13 the prefix is the bucket (the top 11 bits of the row's k-th
    largest key's word); after K15 it is that word and need the number of
    its ties kept."""
    at = _layout(rows, length)[0]["state"]
    p = next_multiple_of(rows, 32)
    return scratch[at:at + 3 * p].view(3, p)[:, :rows]


def row_taken(scratch: torch.Tensor, rows: int, length: int) -> torch.Tensor:
    """[rows, 2] int32: each row's 64-bit counter as K14 leaves it, its
    winners above the bucket and the bucket keys it buffered."""
    at = _layout(rows, length)[0]["taken"]
    return scratch[at:at + 2 * rows].view(rows, 2)


def row_buffer(scratch: torch.Tensor, rows: int, length: int):
    """(words, indices), each [rows, buffer_cap(length)] int32: the rows'
    candidate buffers (a row's first bucket-size entries are its bucket's
    mapped words and in-row indices, where they fit)."""
    first, _ = _layout(rows, length)
    cap = buffer_cap(length)
    return tuple(scratch[first[p]:first[p] + rows * cap].view(rows, cap)
                 for p in ("buf_words", "buf_index"))


def _key(device) -> str:
    """``device``'s name with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _counter(device: torch.device) -> torch.Tensor:
    key = _key(device)
    if key not in _COUNTS:
        _COUNTS[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _COUNTS[key]


def buffer_counts(device=None) -> tuple:
    """(rows whose later rounds and gather read only their buffer, rows)
    that K15 and its plain version have selected since the process
    started, on ``device`` (None: every device). One copy a device, made
    here, outside any call; calls captured into a CUDA graph are not
    counted."""
    want = None if device is None else _key(device)
    got = [t.cpu() for d, t in list(_COUNTS.items())
           if want is None or d == want]
    total = sum(got, torch.zeros(2, dtype=torch.int64))
    return int(total[0]), int(total[1])


def _valid(words: torch.Tensor, lengths: torch.Tensor | None):
    """(each row's length clamped to [0, L] as int64, the [R, L] mask of
    its valid keys)."""
    R, L = words.shape
    n = (torch.full((R,), L, dtype=torch.int64, device=words.device)
         if lengths is None else lengths.to(torch.int64).clamp(0, L))
    return n, torch.arange(L, device=words.device) < n[:, None]


def _pick(counts: torch.Tensor, need: torch.Tensor):
    """(digit, words before it, its count) a row: the first bin of the
    [R, bins] counts whose running count reaches need (0 for need 0)."""
    incl = counts.cumsum(1)
    b = (incl < need[:, None]).sum(1, keepdim=True).clamp(
        max=counts.shape[1] - 1)
    count = counts.gather(1, b)[:, 0]
    return b[:, 0], incl.gather(1, b)[:, 0] - count, count


def _count(digits: torch.Tensor, live: torch.Tensor, bins: int):
    """[R, bins] int64: each row's live entries by digit."""
    counts = torch.zeros(digits.shape[0], bins, dtype=torch.int64,
                         device=digits.device)
    return counts.scatter_add_(1, digits.clamp(0, bins - 1),
                               live.to(torch.int64))


def _scatter(out: torch.Tensor, slot: torch.Tensor, src: torch.Tensor):
    """``out``'s rows with ``src`` written at ``slot`` (a slot of
    ``out.shape[1]`` writes nothing) and every other slot kept."""
    wide = torch.cat([out, out[:, :1]], 1).scatter_(1, slot, src)
    out.copy_(wide[:, :out.shape[1]])


def histogram_plain(words, lengths, kind: str, k: int,
                    scratch: torch.Tensor) -> torch.Tensor:
    """Plain version of K13: counts the top 11 bits of each row's valid
    mapped words, picks the bucket that holds the row's min(k,
    length)-th word and keeps the words still to take in it and its size
    (all 0 for an empty row). Zeroes the rows' counters as K13's entry
    does. Writes and returns :func:`row_state`."""
    R, L = words.shape
    state = row_state(scratch, R, L)
    row_taken(scratch, R, L).zero_()
    n, valid = _valid(words, lengths)
    u = as_u64(encode_plain(words, kind, True))
    need = n.clamp(max=k)
    b, before, count = _pick(_count(u >> (32 - TOP_BITS), valid, _BINS),
                             need)
    some = need > 0
    state[0] = need - before
    state[1] = b
    state[2] = torch.where(some, count, 0)
    return state


def gather_plain(words, lengths, kind: str, k: int, scratch: torch.Tensor,
                 keys_out: torch.Tensor, index_out: torch.Tensor,
                 words_out: torch.Tensor) -> None:
    """Plain version of K14: each row's keys above its bucket (its
    winners, in row order) into the first slots of the [R, >= k] rows
    ``keys_out`` (mapped words), ``index_out`` (in-row indices) and
    ``words_out`` (the caller's words), and, where the bucket fits the
    row's buffer, the bucket's keys (mapped word and index, in row order)
    into it; the rows' counters end at (winners, buffered). Other slots
    are left as they are."""
    R, L = words.shape
    state = row_state(scratch, R, L)
    b, size = state[1].to(torch.int64), state[2].to(torch.int64)
    cap = buffer_cap(L)
    _, valid = _valid(words, lengths)
    enc = encode_plain(words, kind, True)
    d = as_u64(enc) >> (32 - TOP_BITS)
    win = valid & (d < b[:, None])
    cand = valid & (d == b[:, None]) & (size <= cap)[:, None]
    index = torch.arange(L, dtype=torch.int32,
                         device=words.device).expand(R, L)
    slot = torch.where(win, win.cumsum(1) - 1, keys_out.shape[1])
    for out, src in ((keys_out, enc), (index_out, index),
                     (words_out, words)):
        _scatter(out, slot, src)
    slot = torch.where(cand, cand.cumsum(1) - 1, cap)
    for out, src in zip(row_buffer(scratch, R, L), (enc, index)):
        _scatter(out, slot, src)
    taken = row_taken(scratch, R, L)
    taken[:, 0] = win.sum(1)
    taken[:, 1] = cand.sum(1)


def buffer_select_plain(words, lengths, kind: str, k: int, lowest: int,
                        scratch: torch.Tensor, keys_out: torch.Tensor,
                        index_out: torch.Tensor,
                        words_out: torch.Tensor) -> None:
    """Plain version of K15: on each row's buffer (or, where its bucket
    did not fit, its whole row's bucket keys) the digits at bits 10..20
    and 0..9, which give the row's k-th word T and the number of its ties
    to keep; then the bucket's winners (words below T) after K14's and
    the first ties by index after all winners, each with its mapped word,
    index and own word, and the slots past min(k, length) 0xFFFFFFFF,
    0xFFFFFFFF and ``lowest``. The row state ends at (ties kept, T); the
    CPU's count of buffered rows grows."""
    R, L = words.shape
    state = row_state(scratch, R, L)
    need, top, size = (state[i].to(torch.int64) for i in range(3))
    cap = buffer_cap(L)
    n, valid = _valid(words, lengths)
    kept = n.clamp(max=k)
    buffered = size <= cap
    enc = encode_plain(words, kind, True)
    # each row's source as [R, L]: its buffer's first `size` entries (in
    # row order, as the plain K14 fills it) or its row's bucket keys
    pad = torch.zeros(R, L - cap, dtype=torch.int32, device=words.device)
    bw, bi = (torch.cat([t, pad], 1) for t in row_buffer(scratch, R, L))
    j = torch.arange(L, device=words.device)
    on = buffered[:, None]
    u = torch.where(on, as_u64(bw), as_u64(enc))
    at = torch.where(on, bi.to(torch.int64), j)
    live = torch.where(on, j < size[:, None],
                       valid & ((u >> (32 - TOP_BITS)) == top[:, None]))
    mid, before, _ = _pick(_count((u >> _LOW) & (_BINS - 1), live, _BINS),
                           need)
    need = need - before
    high = (top << _MID) | mid
    live_low = live & ((u >> _LOW) == high[:, None])
    low, before, _ = _pick(_count(u & ((1 << _LOW) - 1), live_low, _BINS),
                           need)
    ties = need - before
    t = (high << _LOW) | low
    win = live & (u < t[:, None])
    tie = live & (u == t[:, None])
    keep = tie & (tie.cumsum(1) <= ties[:, None])   # the lowest indices
    width = keys_out.shape[1]
    first_win = row_taken(scratch, R, L)[:, 0].to(torch.int64)[:, None]
    first_tie = (kept - ties)[:, None]
    slot = torch.where(win, first_win + win.cumsum(1) - 1,
                       torch.where(keep, first_tie + keep.cumsum(1) - 1,
                                   width))
    own = words.gather(1, at.clamp(0, L - 1))
    for out, src in ((keys_out, wrap_i32(u)), (index_out, wrap_i32(at)),
                     (words_out, own)):
        _scatter(out, slot, src)
    past = torch.arange(width, device=words.device) >= kept[:, None]
    for out, fill in ((keys_out, FF), (index_out, FF),
                      (words_out, lowest)):
        out.masked_fill_(past, fill)
    some = kept > 0
    state[0] = torch.where(some, ties, state[0].to(torch.int64))
    state[1] = torch.where(some, wrap_i32(t), state[1])
    if not is_fake(buffered):   # a call traced without data counts nothing
        _counter(words.device).add_(torch.stack(
            [buffered.sum(), torch.ones_like(buffered).sum()]))


def _check_words(words, lengths, scratch) -> None:
    if (words.dim() != 2 or words.dtype != torch.int32
            or not words.is_contiguous()):
        raise ValueError("words must be a contiguous 2-D int32 tensor")
    R, L = words.shape
    if not (R > 0 and 0 < L <= _MAX and R <= _MAX):
        raise ValueError(f"top-k rows take 0 < R, L < 2^31, got "
                         f"{R} x {L}")
    if lengths is not None and (lengths.dtype != torch.int32
                                or lengths.shape != (R,)
                                or not lengths.is_contiguous()
                                or lengths.device != words.device):
        raise ValueError("lengths must be R contiguous int32 on the words' "
                         "device")
    if (scratch.dtype != torch.int32 or not scratch.is_contiguous()
            or scratch.device != words.device
            or scratch.numel() < scratch_words(R, L)):
        raise ValueError("scratch must hold scratch_words(R, L) contiguous "
                         "int32 words on the words' device")


def _check_select(words, lengths, kind, k, scratch, outs=()) -> None:
    _check_words(words, lengths, scratch)
    if kind not in _KIND_CODE or not 0 < k <= _MAX:
        raise ValueError("kind must be u32, i32 or f32 and 0 < k < 2^31")
    for t in outs:
        if (t.dtype != torch.int32 or t.dim() != 2
                or t.shape[0] != words.shape[0] or t.shape[1] < k
                or t.shape != outs[0].shape or not t.is_contiguous()
                or t.device != words.device):
            raise ValueError("the outputs must be contiguous [R, >= k] int32 "
                             "of one shape on the words' device")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


@profiled("topk_rows_histogram", level="kernel")
def topk_rows_histogram(words: torch.Tensor, lengths: torch.Tensor | None,
                        kind: str, k: int,
                        scratch: torch.Tensor) -> torch.Tensor:
    """K13: zeroes the scratch's counters on the card, then picks each
    row's bucket for its ``k`` largest keys among its first
    ``lengths[r]`` int32 words (the caller's bits, ordered by ``kind``).
    Returns :func:`row_state`."""
    _check_select(words, lengths, kind, k, scratch)
    R, L = words.shape
    if not on_card(words):
        return histogram_plain(words, lengths, kind, k, scratch)
    launch("topk_rows_histogram", "sortx_topk_rows_histogram", words.device,
           words.data_ptr(), R, L, _ptr(lengths), _KIND_CODE[kind], k,
           scratch.data_ptr(), scratch.numel())
    return row_state(scratch, R, L)


@profiled("topk_rows_gather", level="kernel")
def topk_rows_gather(words: torch.Tensor, lengths: torch.Tensor | None,
                     kind: str, k: int, scratch: torch.Tensor,
                     keys_out: torch.Tensor, index_out: torch.Tensor,
                     words_out: torch.Tensor) -> None:
    """K14: after K13, each row's keys above its bucket into the first
    slots of the rows of ``keys_out`` (mapped words), ``index_out``
    (int32 in-row indices) and ``words_out`` (the caller's words),
    contiguous [R, >= k] int32, and the bucket's keys into the row's
    buffer where they fit (on the card both in the order the warps take
    them)."""
    _check_select(words, lengths, kind, k, scratch,
                  (keys_out, index_out, words_out))
    if not on_card(words):
        gather_plain(words, lengths, kind, k, scratch, keys_out, index_out,
                     words_out)
        return
    R, L = words.shape
    launch("topk_rows_gather", "sortx_topk_rows_gather", words.device,
           words.data_ptr(), R, L, _ptr(lengths), _KIND_CODE[kind], k,
           scratch.data_ptr(), scratch.numel(), keys_out.data_ptr(),
           index_out.data_ptr(), words_out.data_ptr(), keys_out.shape[1])


@profiled("topk_rows_buffer_select", level="kernel")
def topk_rows_buffer_select(words: torch.Tensor,
                            lengths: torch.Tensor | None, kind: str, k: int,
                            lowest: int, scratch: torch.Tensor,
                            keys_out: torch.Tensor, index_out: torch.Tensor,
                            words_out: torch.Tensor) -> None:
    """K15: after K14, the rest of each row's min(k, lengths[r]) kept keys
    (its bucket's winners, then its first ties by index) into the outputs
    K14 wrote, from the row's buffer alone where its bucket fit; each
    row's later slots 0xFFFFFFFF, 0xFFFFFFFF and ``lowest``, so that they
    sort last. Counts the rows in :func:`buffer_counts`, but in a call
    captured into a CUDA graph."""
    _check_select(words, lengths, kind, k, scratch,
                  (keys_out, index_out, words_out))
    if not on_card(words):
        buffer_select_plain(words, lengths, kind, k, lowest, scratch,
                            keys_out, index_out, words_out)
        return
    R, L = words.shape
    counted = (None if torch.cuda.is_current_stream_capturing()
               else _counter(words.device).data_ptr())
    launch("topk_rows_buffer_select", "sortx_topk_rows_buffer_select",
           words.device, words.data_ptr(), R, L, _ptr(lengths),
           _KIND_CODE[kind], k, scratch.data_ptr(), scratch.numel(),
           keys_out.data_ptr(), index_out.data_ptr(), words_out.data_ptr(),
           keys_out.shape[1], lowest, counted)


def topk_rows_select(words: torch.Tensor, lengths: torch.Tensor | None,
                     kind: str, k: int, lowest: int):
    """(words, indices), each [R, k] int32: every row's k largest keys
    among its valid words, as the caller's words in descending key order,
    ties by index; slots past min(k, lengths[r]) hold ``lowest`` and index
    -1. K13, K14 and K15 on a CUDA tensor, their plain versions on a CPU
    tensor. The engine's span holds the scratch, the driver's K13, the
    row network's buffer, K14, K15 and the row sort (by mapped word, then
    index; the caller's words follow)."""
    with span("engine", "topk_rows"):
        R, L = words.shape
        width = 1 << max((k - 1).bit_length(), 1)   # the row network's row
        n = R * width
        blk = 1 << block_log(3)
        scratch = torch.empty(scratch_words(R, L), dtype=torch.int32,
                              device=words.device)
        with span("driver", "topk_rows"):
            # K13 first: the card starts on it at once, and the host's
            # work below hides behind it
            topk_rows_histogram(words, lengths, kind, k, scratch)
            x = torch.empty((3, cdiv(n, blk) * blk), dtype=torch.int32,
                            device=words.device)
            if x.shape[1] > n:          # the network's pad past the rows
                x[:, n:].fill_(FF)
            rows = x[:, :n].view(3, R, width)
            topk_rows_gather(words, lengths, kind, k, scratch, *rows)
            topk_rows_buffer_select(words, lengths, kind, k, lowest,
                                    scratch, *rows)
            bitonic_sort_streams(x, 2, n_valid=n,
                                 row_log=width.bit_length() - 1)
        return rows[2, :, :k], rows[1, :, :k]


def _check(keys: torch.Tensor, k, lengths) -> None:
    if keys.dim() != 2:
        raise ValueError("top_k_rows expects a 2D [rows, length] array")
    _check_key_dtype(keys.dtype, "top_k_rows")
    if isinstance(k, bool) or not isinstance(k, int) or not 0 <= k <= _MAX:
        raise ValueError(f"k must be an int in [0, 2^31), got {k!r}")
    if keys.shape[1] > _MAX:
        raise ValueError("rows longer than 2^31 - 1 keys")
    if lengths is not None and (lengths.dtype != torch.int32
                                or lengths.shape != keys.shape[:1]
                                or lengths.device != keys.device):
        raise ValueError("lengths must be int32 [rows] on the keys' device")


@profiled("top_k_rows")
def top_k_rows(keys: torch.Tensor, k: int, *,
               lengths: torch.Tensor | None = None,
               config: Config | None = None):
    """The ``k`` largest keys of each row of a [R, L] tensor and their
    int32 in-row indices, as (values, indices) of [R, k].

    Row r's keys are its first ``lengths[r]`` (int32 [R] on the keys'
    device, 0 <= lengths[r] <= L; None: all L); the op reads nothing past
    them. Row r holds its min(k, lengths[r]) largest keys in descending
    order, ties to the lowest index (``sortx.top_k``'s and
    ``lax.top_k``'s order), then slots of the dtype's lowest value (-inf,
    or the integer's least) and index -1. Keys follow ``sort``'s dtype
    contract (u32/i32/f32 and 16-bit keys; floats by the order of their
    bits, as ``sort`` orders them). Nothing is read on the host.
    ``config`` is taken as every op takes it; every engine runs the one
    select (K13, K14 and K15 on a CUDA tensor, their plain versions on
    CPU)."""
    _check(keys, k, lengths)
    R, L = keys.shape
    lowest = _LOWEST[keys.dtype]
    w, kind, narrow = key_words(keys.contiguous())
    if R == 0 or L == 0 or k == 0:
        return (narrow(torch.full((R, k), lowest, dtype=torch.int32,
                                  device=keys.device)),
                torch.full((R, k), -1, dtype=torch.int32, device=keys.device))
    if lengths is not None:
        lengths = lengths.contiguous()
    vals, idx = topk_rows_select(w, lengths, kind, k, lowest)
    return narrow(vals.contiguous()), idx.contiguous()
