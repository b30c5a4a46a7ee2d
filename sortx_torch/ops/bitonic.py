"""Bitonic sorting network over parallel 32-bit streams.

Port of ``sortx/ops/bitonic.py:bitonic_sort_streams``. The streams are
the rows of one ``(ns, n)`` int32 buffer (u32 words, see
``utils/words.py``), sorted together by the first ``num_keys`` rows,
unsigned and lexicographic. The network over flat index i: stage
s = 1..log2 n, layers j = s-1..0, partner i ^ 2^j, direction bit
(i >> s) & 1; a pair swaps only when strictly out of order, so tied
pairs never move and the output does not depend on how the layers are
split into passes.

Passes, with L the shared-memory block (:func:`block_log`):

  bitonic_block   (K1, csrc/bitonic.cu)  stages 1..L, one pass;
  bitonic_global  (K3)                   stage s > L, layers s-1..L in
                                         passes of up to f_max(ns) layers;
  bitonic_tail    (K2)                   stage s > L, layers L-1..0.

Each wrapper runs its CUDA kernel on a CUDA tensor and its plain PyTorch
version (the same layers as pair reshapes and ``torch.where``) on a CPU
tensor. All of them work in place on the prefix ``x[:, :ext]``.

``n_valid`` prunes pad-only work as the reference does: every index
>= n_valid holds 0xFFFFFFFF in every stream, a stage-s group without a
real element sorts to itself, so stage s only runs over the prefix
``ceil(n_valid / 2^s) * 2^s``. The pads beyond that prefix are never
touched, so they stay 0xFFFFFFFF with no re-padding between stages.

``row_log`` R is rows mode (``sort_rows``, the hybrid engine's phases):
the buffer is rows of 2^R elements, each sorted ascending on its own.
Exchanges at distance < 2^R never cross a row, so the network stops at
stage R and runs stage R ascending everywhere (K1's ``row_log``, K2's
and K3's ``force_asc``). The length then need only be a multiple of
the row and of 1024, not a power of two.

:func:`bitonic_merge_streams` (``merge``, ``merge_kv``) runs only the
last stage s = log2 n over a bitonic sequence, ascending: K3 passes for
layers s-1..L and one K2 pass, which may then take s == L
(:func:`merge_plan`).

Stream sets (:data:`STREAM_SETS`): the narrow sets, 1-4 streams with
1-2 keys, run every mode; the wide sets of the 64-bit, argsort and
lexsort paths run the full network only. Above 4 streams a K3 pass
fuses at most 3 layers (:func:`f_max`), so that its registers hold.
"""

from __future__ import annotations

import torch

from ..config import LOG_BLOCK_MAX
from ..utils.math import cdiv
from ..utils.words import ordered
from ._build import launch, on_card

__all__ = ["bitonic_sort_streams", "bitonic_merge_streams", "pass_plan",
           "merge_plan", "bitonic_block", "bitonic_tail", "bitonic_global",
           "block_plain", "tail_plain", "global_plain", "block_log", "f_max",
           "KERNELS", "STREAM_SETS", "NARROW_SETS"]

# (streams, keys) pairs the kernels take. The narrow sets serve every
# mode; the wide ones the full network (64-bit keys and values, argsort,
# sort_kv_u64, lexsort) and are never in rows mode or a forced K2. Both
# must match csrc/bitonic.cu: STREAM_SETS its SORTX_DISPATCH_STREAMS
# cases, NARROW_SETS its narrow(), and f_max below its f_max().
NARROW_SETS = frozenset((ns, nk) for ns in range(1, 5)
                        for nk in range(1, min(ns, 2) + 1))
STREAM_SETS = NARROW_SETS | {(3, 3), (4, 3), (5, 2), (4, 4), (5, 5),
                             (6, 6), (7, 7), (8, 8)}


def f_max(ns: int) -> int:
    """Cross-block layers F one K3 pass fuses for ns streams: 2^F words
    per stream and thread stay in registers, so F shrinks where the
    streams are many."""
    return 4 if ns <= 4 else 3


def block_log(ns: int, log_block: int = LOG_BLOCK_MAX) -> int:
    """Shared-memory block (log2) for ns streams: the largest L with
    ns * 4 B * 2^L <= 64 KB, capped at ``log_block``."""
    return min(log_block, 14 - (ns - 1).bit_length())


# --- plain versions ------------------------------------------------------

def _lt(a: torch.Tensor, b: torch.Tensor, num_keys: int) -> torch.Tensor:
    """a < b on the first num_keys streams (dim 0), unsigned, lexicographic."""
    lt = ordered(a[0]) < ordered(b[0])
    eq = a[0] == b[0]
    for t in range(1, num_keys):
        lt = lt | (eq & (ordered(a[t]) < ordered(b[t])))
        eq = eq & (a[t] == b[t])
    return lt


def _layer(x: torch.Tensor, ext: int, num_keys: int, s: int, j: int,
           asc: bool = False) -> None:
    """Layer j of stage s over x[:, :ext], in place; ``asc`` runs it
    ascending everywhere (the last stage of rows mode)."""
    d = 1 << j
    groups = ext // (2 * d)
    v = x[:, :ext].view(x.shape[0], groups, 2, d)
    a, b = v[:, :, 0], v[:, :, 1]
    if asc:
        swap = _lt(b, a, num_keys)
    else:
        # group g starts at flat index g * 2^(j+1); its direction is bit s
        desc = ((torch.arange(groups, device=x.device) >> (s - j - 1)) & 1
                ).bool().unsqueeze(1)
        swap = torch.where(desc, _lt(a, b, num_keys), _lt(b, a, num_keys))
    na, nb = torch.where(swap, b, a), torch.where(swap, a, b)
    a.copy_(na)
    b.copy_(nb)


def block_plain(x, ext: int, num_keys: int, log_block: int,
                row_log: int = 0) -> None:
    """Plain version of K1: stages 1..log_block over x[:, :ext], or with
    ``row_log`` stages 1..row_log, the last one ascending."""
    for s in range(1, (row_log or log_block) + 1):
        for j in range(s - 1, -1, -1):
            _layer(x, ext, num_keys, s, j, s == row_log)


def tail_plain(x, ext: int, num_keys: int, log_block: int, s: int,
               force_asc: bool = False) -> None:
    """Plain version of K2: layers log_block-1..0 of stage s."""
    for j in range(log_block - 1, -1, -1):
        _layer(x, ext, num_keys, s, j, force_asc)


def global_plain(x, ext: int, num_keys: int, s: int, j_hi: int,
                 j_lo: int, force_asc: bool = False) -> None:
    """Plain version of K3: layers j_hi..j_lo of stage s."""
    for j in range(j_hi, j_lo - 1, -1):
        _layer(x, ext, num_keys, s, j, force_asc)


# --- kernel wrappers -----------------------------------------------------

def _check(x: torch.Tensor, ext: int, num_keys: int, granule: int,
           narrow: bool = False) -> None:
    """Validate the buffer and the stream set; ``narrow`` for the modes
    only the narrow sets run (rows mode, forced K2)."""
    if (x.dim() != 2 or x.dtype != torch.int32 or x.stride(1) != 1
            or (x.shape[0] > 1 and x.stride(0) < x.shape[1])):
        raise ValueError("bitonic streams must be an (ns, n) int32 buffer "
                         "with unit stride along n and disjoint rows")
    sets = NARROW_SETS if narrow else STREAM_SETS
    if (x.shape[0], num_keys) not in sets:
        raise ValueError(f"unsupported stream set: {x.shape[0]} streams, "
                         f"{num_keys} keys (not in {sorted(sets)})")
    if not 0 < ext <= x.shape[1] or ext % granule:
        raise ValueError(f"extent {ext} is not a positive multiple of "
                         f"{granule} within {x.shape[1]}")


def bitonic_block(x: torch.Tensor, ext: int, num_keys: int,
                  log_block: int, row_log: int = 0) -> torch.Tensor:
    """K1: stages 1..log_block on every 2^log_block block of x[:, :ext];
    with ``row_log`` <= log_block, stages 1..row_log, the last ascending."""
    _check(x, ext, num_keys, 1 << log_block, narrow=row_log > 0)
    if not 0 <= row_log <= log_block:
        raise ValueError(f"row_log {row_log} is not within the block "
                         f"2^{log_block}")
    if on_card(x):
        launch("bitonic_block", "sortx_bitonic_block", x.device,
               x.data_ptr(), ext, x.stride(0), x.shape[0], num_keys,
               log_block, row_log)
    else:
        block_plain(x, ext, num_keys, log_block, row_log)
    return x


def bitonic_tail(x: torch.Tensor, ext: int, num_keys: int, log_block: int,
                 s: int, force_asc: bool = False) -> torch.Tensor:
    """K2: layers log_block-1..0 of stage s > log_block over x[:, :ext];
    under ``force_asc`` (rows mode, the merge stage) also s == log_block."""
    _check(x, ext, num_keys, 1 << log_block, narrow=force_asc)
    if s < log_block or (s == log_block and not force_asc):
        raise ValueError(f"stage {s} is inside the block 2^{log_block}")
    if on_card(x):
        launch("bitonic_tail", "sortx_bitonic_tail", x.device,
               x.data_ptr(), ext, x.stride(0), x.shape[0], num_keys,
               log_block, s, int(force_asc))
    else:
        tail_plain(x, ext, num_keys, log_block, s, force_asc)
    return x


def bitonic_global(x: torch.Tensor, ext: int, num_keys: int, s: int,
                   j_hi: int, j_lo: int,
                   force_asc: bool = False) -> torch.Tensor:
    """K3: layers j_hi..j_lo (at most f_max(ns)) of stage s over
    x[:, :ext]."""
    _check(x, ext, num_keys, 1 << (j_hi + 1))
    fm = f_max(x.shape[0])
    if not 0 <= j_lo <= j_hi < s or j_hi - j_lo >= fm:
        raise ValueError(f"layers {j_hi}..{j_lo} of stage {s}: need "
                         f"j_lo <= j_hi < s and at most {fm} layers")
    if on_card(x):
        launch("bitonic_global", "sortx_bitonic_global", x.device,
               x.data_ptr(), ext, x.stride(0), x.shape[0], num_keys, s,
               j_hi, j_lo, int(force_asc))
    else:
        global_plain(x, ext, num_keys, s, j_hi, j_lo, force_asc)
    return x


# --- the whole network ---------------------------------------------------

KERNELS = {   # kernel name -> (wrapper, plain version)
    "bitonic_block": (bitonic_block, block_plain),
    "bitonic_tail": (bitonic_tail, tail_plain),
    "bitonic_global": (bitonic_global, global_plain),
}


def pass_plan(ns: int, n: int, num_keys: int, n_valid: int | None = None,
              log_block: int = LOG_BLOCK_MAX, row_log: int | None = None):
    """The passes that sort an (ns, n) buffer, in order, as
    (kernel name, arguments after ``x``) pairs; see the module notes.

    In rows mode only the passes that differ from the full network's
    carry the rows-mode argument: K1 when it holds the last row stage,
    and the passes of stage row_log."""
    nv = n if n_valid is None else min(n_valid, n)
    if row_log is None:
        log_n = n.bit_length() - 1
        if (1 << log_n) != n:
            raise ValueError("bitonic_sort_streams needs power-of-two "
                             "length")
        if n < 2 or nv <= 0:
            return []
        lb = min(block_log(ns, log_block), log_n)
        top = log_n
    else:
        # rows pack into blocks freely (K1 stops at row_log); the block
        # only has to divide the length
        if n <= 0 or n % 1024 or row_log < 1 or n % (1 << row_log):
            raise ValueError(f"rows-mode length {n} must be a positive "
                             f"multiple of 1024 and of the row 2^{row_log}")
        if nv <= 0:
            return []
        lb = min(block_log(ns, log_block), (n & -n).bit_length() - 1)
        top = row_log
    rows_k1 = (row_log,) if row_log is not None and row_log <= lb else ()
    plan = [("bitonic_block",
             (min(n, cdiv(nv, 1 << lb) << lb), num_keys, lb) + rows_k1)]
    for s in range(lb + 1, top + 1):
        ext = min(n, cdiv(nv, 1 << s) << s)
        plan += _stage(ns, ext, num_keys, lb, s, s == row_log)
    return plan


def _stage(ns: int, ext: int, num_keys: int, lb: int, s: int,
           asc: bool):
    """The passes of stage s > lb (s >= lb under ``asc``): K3 over layers
    s-1..lb, f_max(ns) at a time, then K2; ``asc`` runs it ascending."""
    flag = (True,) if asc else ()
    plan = []
    j = s - 1
    while j >= lb:
        j_lo = max(lb, j - f_max(ns) + 1)
        plan.append(("bitonic_global", (ext, num_keys, s, j, j_lo) + flag))
        j = j_lo - 1
    plan.append(("bitonic_tail", (ext, num_keys, lb, s) + flag))
    return plan


def merge_plan(ns: int, n: int, num_keys: int,
               log_block: int = LOG_BLOCK_MAX):
    """The passes of the merge stage over an (ns, n) buffer, n a power of
    two >= 1024: stage log2 n, ascending, over the whole length (the pads
    of a merge sit in the middle, so nothing is pruned)."""
    log_n = n.bit_length() - 1
    if (1 << log_n) != n or n < 1024:
        raise ValueError("bitonic_merge_streams needs power-of-two length "
                         ">= 1024")
    lb = min(block_log(ns, log_block), log_n)
    return _stage(ns, n, num_keys, lb, log_n, True)


def bitonic_sort_streams(x: torch.Tensor, num_keys: int, *,
                         n_valid: int | None = None,
                         log_block: int = LOG_BLOCK_MAX,
                         row_log: int | None = None) -> torch.Tensor:
    """Sort the columns of the (ns, n) int32 buffer ``x`` in place by its
    first ``num_keys`` rows; n must be a power of two, or in rows mode
    (``row_log``) a multiple of 1024 and of the row. Returns ``x``.

    ``n_valid``: number of real elements; every column at index >=
    n_valid must be 0xFFFFFFFF in every stream (the callers pad so).
    """
    for name, args in pass_plan(*x.shape, num_keys, n_valid, log_block,
                                row_log):
        KERNELS[name][0](x, *args)
    return x


def bitonic_merge_streams(x: torch.Tensor, num_keys: int, *,
                          log_block: int = LOG_BLOCK_MAX) -> torch.Tensor:
    """Run one ascending merge stage over the (ns, n) int32 buffer ``x``
    in place: its columns must form one bitonic sequence on the first
    ``num_keys`` rows (an ascending run, then a descending one, as
    ``[a, pads, reverse(b)]``); n is a power of two >= 1024. Returns x."""
    for name, args in merge_plan(x.shape[0], x.shape[1], num_keys, log_block):
        KERNELS[name][0](x, *args)
    return x
