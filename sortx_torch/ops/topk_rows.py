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
a row (``csrc/topk_rows.cu``):

- K13 (``topk_rows_histogram``), four rounds: each counts one 8-bit
  digit of every row's valid keys under the prefix the rounds before it
  chose, and the row's last CTA picks the digit that holds the row's
  k-th key; after round 3 a row holds its k-th key's word T and the
  number of its ties to keep;
- K14 (``topk_rows_gather``) writes each row's winners (words below T,
  then the first ties in row order) with their in-row indices and the
  caller's words into the row network's three streams, and fills the
  row's later slots so that they sort last; the network sorts each row
  of k by (word, index) with the caller's words following: descending
  keys, ties to the lowest index.

Words are the caller's keys mapped by ``ops/sort.py:_to_radix_u32`` and
complemented (``radix_rows.encode_plain(..., descending=True)``), so the
largest key is the smallest word. A call is a memset, four K13, K14 and
the row network's passes (one at k = 2048), with nothing read on the
host and nothing to decode. Each key is read five times (four rounds
and the gather); no row is sorted.

CPU tensors run the plain versions of K13 and K14
(:func:`histogram_round_plain`, :func:`gather_plain`) in the same
schedule; they give the kernels' row state and the same kept words
(K14's winners land in the order its CTAs take them, which the row sort
makes one).
"""

from __future__ import annotations

import functools

import torch

from ..config import Config
from ..runtime.launcher import profiled, span
from ..utils.math import cdiv, next_multiple_of
from ..utils.words import FF, SIGN, as_u64, wrap_i32
from ._build import launch, on_card
from .bitonic import bitonic_sort_streams, block_log
from .radix import RADIX
from .radix_rows import encode_plain, key_words
from .sort import _check_key_dtype

__all__ = ["top_k_rows", "ROUNDS", "CHUNK", "scratch_words", "row_state",
           "histogram_round_plain", "gather_plain", "topk_rows_histogram",
           "topk_rows_gather", "topk_rows_select"]

ROUNDS = 4            # 8-bit digits, most significant first
CHUNK = 16384         # words of a row a CTA, K13 and K14 (csrc: kChunk)
_KIND_CODE = {"u32": 0, "i32": 1, "f32": 2}
_MAX = (1 << 31) - 1  # k, L and int32 in-row indices
# the word of the lowest key, which the slots past min(k, lengths[r]) hold:
# -inf (float32 bits, which narrow to -inf in 16 bits) or the integer's least
_LOWEST = {torch.float32: -8388608, torch.float16: -8388608,
           torch.bfloat16: -8388608, torch.int32: SIGN, torch.int16: -32768,
           torch.uint32: 0, torch.uint16: 0}


@functools.lru_cache(maxsize=256)
def _layout(rows: int, length: int) -> tuple:
    """(the first word of the rows' need, the scratch's words): its parts
    as csrc/topk_rows.cu ``layout`` lays them out, each padded to 32
    words: the counts (rows x 256), tickets, winner counters, need,
    prefix, the chunks' tie bases and the last round's chunk counts."""
    chunks = cdiv(length, CHUNK)
    at = sum(next_multiple_of(w, 32) for w in (rows * RADIX, rows, rows))
    rest = (rows, rows, rows * chunks, rows * chunks * RADIX)
    return at, at + sum(next_multiple_of(w, 32) for w in rest)


def scratch_words(rows: int, length: int) -> int:
    """int32 words of a select's scratch: K13's counts, tickets and the
    rows' state, K14's winner counters, the last round's chunk counts."""
    return _layout(rows, length)[1]


def row_state(scratch: torch.Tensor, rows: int, length: int) -> torch.Tensor:
    """The rows' state in ``scratch``: [2, rows] int32, each row's keys
    still to take at its prefix (need) and its prefix; after round 3 the
    prefix is the word of the row's k-th largest key and need the number
    of its ties to keep."""
    at = _layout(rows, length)[0]
    p = next_multiple_of(rows, 32)
    return scratch[at:at + 2 * p].view(2, p)[:, :rows]


def _valid(words: torch.Tensor, lengths: torch.Tensor | None):
    """(each row's length clamped to [0, L] as int64, the [R, L] mask of
    its valid keys)."""
    R, L = words.shape
    n = (torch.full((R,), L, dtype=torch.int64, device=words.device)
         if lengths is None else lengths.to(torch.int64).clamp(0, L))
    return n, torch.arange(L, device=words.device) < n[:, None]


def histogram_round_plain(words, lengths, kind: str, k: int, p: int,
                          scratch: torch.Tensor) -> torch.Tensor:
    """Plain version of K13's round ``p``: counts digit p (bits 24 - 8p)
    of each row's valid mapped words under its prefix (all of them in
    round 0, where need starts at min(k, length)), then appends the digit
    that holds the row's need-th word to its prefix and takes the words
    below it off need. Writes and returns :func:`row_state`."""
    R, L = words.shape
    state = row_state(scratch, R, L)
    n, valid = _valid(words, lengths)
    u = as_u64(encode_plain(words, kind, True))
    shift = 24 - 8 * p
    if p == 0:
        need, prefix, match = n.clamp(max=k), torch.zeros_like(n), valid
    else:
        need, prefix = state[0].to(torch.int64), as_u64(state[1])
        match = valid & ((u >> (shift + 8)) == prefix[:, None])
    counts = torch.zeros(R, RADIX, dtype=torch.int64, device=words.device)
    counts.scatter_add_(1, (u >> shift) & (RADIX - 1), match.to(torch.int64))
    incl = counts.cumsum(1)
    # the first digit whose running count reaches need (0 for an empty row)
    b = (incl < need[:, None]).sum(1, keepdim=True).clamp(max=RADIX - 1)
    before = (incl.gather(1, b) - counts.gather(1, b))[:, 0]
    state[0] = need - before
    state[1] = wrap_i32((prefix << 8) | b[:, 0])
    return state


def gather_plain(words, lengths, kind: str, k: int, lowest: int,
                 scratch: torch.Tensor, keys_out: torch.Tensor,
                 index_out: torch.Tensor, words_out: torch.Tensor) -> None:
    """Plain version of K14: each row's min(k, length) kept keys (those
    whose mapped word is below the row's k-th largest key's word T, in row
    order, then the first need whose word is T) into the first slots of
    the [R, >= k] rows ``keys_out`` (mapped words), ``index_out`` (in-row
    indices) and ``words_out`` (the caller's words); each row's later
    slots 0xFFFFFFFF, 0xFFFFFFFF and ``lowest``."""
    R, L = words.shape
    state = row_state(scratch, R, L)
    need, t = state[0].to(torch.int64), as_u64(state[1])[:, None]
    n, valid = _valid(words, lengths)
    enc = encode_plain(words, kind, True)
    u = as_u64(enc)
    win, tie = valid & (u < t), valid & (u == t)
    tie_rank = tie.cumsum(1) - 1
    first_tie = (n.clamp(max=k) - need)[:, None]
    keep = win | (tie & (tie_rank < need[:, None]))
    width = keys_out.shape[1]
    # slots past the rows' width take what is not kept; they are cut off
    slot = torch.where(keep, torch.where(win, win.cumsum(1) - 1,
                                         first_tie + tie_rank), width)
    index = torch.arange(L, dtype=torch.int32, device=words.device)
    for out, src, fill in ((keys_out, enc, FF),
                           (index_out, index.expand(R, L), FF),
                           (words_out, words, lowest)):
        wide = torch.full((R, width + 1), fill, dtype=torch.int32,
                          device=words.device).scatter_(1, slot, src)
        out.copy_(wide[:, :width])


def _check_words(words, lengths, scratch) -> None:
    if (words.dim() != 2 or words.dtype != torch.int32
            or not words.is_contiguous()):
        raise ValueError("words must be a contiguous 2-D int32 tensor")
    R, L = words.shape
    if not (R > 0 and 0 < L <= _MAX):
        raise ValueError(f"top-k rows take R > 0 and 0 < L < 2^31, got "
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


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


@profiled("topk_rows_histogram", level="kernel")
def topk_rows_histogram(words: torch.Tensor, lengths: torch.Tensor | None,
                        kind: str, k: int, p: int,
                        scratch: torch.Tensor) -> torch.Tensor:
    """K13: round ``p`` (0..3) of the select of each row's ``k`` largest
    keys among its first ``lengths[r]`` int32 words (the caller's bits,
    ordered by ``kind``); round 0 also zeroes the scratch's counters on
    the card. Returns :func:`row_state`."""
    _check_words(words, lengths, scratch)
    if kind not in _KIND_CODE or not 0 < k <= _MAX or not 0 <= p < ROUNDS:
        raise ValueError("kind must be u32, i32 or f32, 0 < k < 2^31 and "
                         "p in 0..3")
    R, L = words.shape
    if not on_card(words):
        return histogram_round_plain(words, lengths, kind, k, p, scratch)
    launch("topk_rows_histogram", "sortx_topk_rows_histogram", words.device,
           words.data_ptr(), R, L, _ptr(lengths), _KIND_CODE[kind], k, p,
           scratch.data_ptr(), scratch.numel())
    return row_state(scratch, R, L)


@profiled("topk_rows_gather", level="kernel")
def topk_rows_gather(words: torch.Tensor, lengths: torch.Tensor | None,
                     kind: str, k: int, lowest: int, scratch: torch.Tensor,
                     keys_out: torch.Tensor, index_out: torch.Tensor,
                     words_out: torch.Tensor) -> None:
    """K14: after the four rounds, each row's min(k, lengths[r]) kept keys
    into the first slots of the rows of ``keys_out`` (mapped words),
    ``index_out`` (int32 in-row indices) and ``words_out`` (the caller's
    words), contiguous [R, >= k] int32 (on the card the winners come in
    the order the CTAs take them); each row's later slots 0xFFFFFFFF,
    0xFFFFFFFF and ``lowest``, so that they sort last."""
    _check_words(words, lengths, scratch)
    R, L = words.shape
    for t in (keys_out, index_out, words_out):
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != R
                or t.shape[1] < k or t.shape != keys_out.shape
                or not t.is_contiguous() or t.device != words.device):
            raise ValueError("the outputs must be contiguous [R, >= k] int32 "
                             "of one shape on the words' device")
    if kind not in _KIND_CODE or not 0 < k <= _MAX:
        raise ValueError("kind must be u32, i32 or f32 and 0 < k < 2^31")
    if not on_card(words):
        gather_plain(words, lengths, kind, k, lowest, scratch, keys_out,
                     index_out, words_out)
        return
    launch("topk_rows_gather", "sortx_topk_rows_gather", words.device,
           words.data_ptr(), R, L, _ptr(lengths), _KIND_CODE[kind], k,
           scratch.data_ptr(), scratch.numel(), keys_out.data_ptr(),
           index_out.data_ptr(), words_out.data_ptr(), keys_out.shape[1],
           lowest)


def topk_rows_select(words: torch.Tensor, lengths: torch.Tensor | None,
                     kind: str, k: int, lowest: int):
    """(words, indices), each [R, k] int32: every row's k largest keys
    among its valid words, as the caller's words in descending key order,
    ties by index; slots past min(k, lengths[r]) hold ``lowest`` and index
    -1. K13 and K14 on a CUDA tensor, their plain versions on a CPU
    tensor. The engine's span holds the scratch, the driver's the rounds,
    the row network's buffer, the gather and the row sort (by mapped
    word, then index; the caller's words follow)."""
    with span("engine", "topk_rows"):
        R, L = words.shape
        width = 1 << max((k - 1).bit_length(), 1)   # the row network's row
        n = R * width
        blk = 1 << block_log(3)
        scratch = torch.empty(scratch_words(R, L), dtype=torch.int32,
                              device=words.device)
        with span("driver", "topk_rows"):
            # the rounds first: the card starts on them at once, and the
            # host's work below hides behind them
            for p in range(ROUNDS):
                topk_rows_histogram(words, lengths, kind, k, p, scratch)
            x = torch.empty((3, cdiv(n, blk) * blk), dtype=torch.int32,
                            device=words.device)
            if x.shape[1] > n:          # the network's pad past the rows
                x[:, n:].fill_(FF)
            rows = x[:, :n].view(3, R, width)
            topk_rows_gather(words, lengths, kind, k, lowest, scratch, *rows)
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
    select (K13 and K14 on a CUDA tensor, their plain versions on CPU)."""
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
