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

K1 and K2 keep 2^e elements per thread in registers and run a layer in
registers, by warp shuffles, or after a change of layout through shared
memory; :func:`block_schedule` and :func:`tail_schedule` state which,
and the tests hold them to the network (csrc/bitonic.cu runs the same
phases).

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

``skip`` predicates a pass on the device, as the reference's
``lax.cond`` around its network: a 1-element int32 tensor on the
buffer's device (or None), read by every CTA first. Where it is
nonzero the pass returns at once and ``x`` keeps its words, with no
host read, so a sort of an ordered input can be captured in a CUDA
graph and replayed on any input. The plain versions take the same flag
and keep ``x`` the same way.

:func:`reverse_ordered` (K8, the same source) is the reference's
``jnp.flip`` branch of a keys-only sort: it writes a nonincreasing input
reversed over the skipped network's output, and returns at once for
any other input.

Stream sets (:data:`STREAM_SETS`): the narrow sets, 1-4 streams with
1-2 keys, run every mode; the wide sets of the 64-bit, argsort and
lexsort paths run the full network only. Above 4 streams a K3 pass
fuses at most 3 layers (:func:`f_max`), so that its registers hold.
"""

from __future__ import annotations

import collections

import torch

from ..config import LOG_BLOCK_MAX
from ..runtime.launcher import profiled
from ..utils.math import cdiv
from ..utils.words import NONDECREASING, NONINCREASING, ordered
from ._build import launch, on_card

__all__ = ["bitonic_sort_streams", "bitonic_merge_streams", "pass_plan",
           "merge_plan", "bitonic_block", "bitonic_tail", "bitonic_global",
           "block_plain", "tail_plain", "global_plain", "reverse_ordered",
           "reverse_plain", "block_log", "f_max", "KERNELS", "STREAM_SETS",
           "NARROW_SETS", "BLOCK_LOG"]

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


# Block (log2 elements) of K1 and K2 by stream count, 11 above 4 streams:
# chosen by timing the network at 2^27 at each size the kernels take. The
# largest block also wins from 2^16 to 2^24 keys, where its grid no longer
# fills the card: fewer launches count for more there (PERF.md), so the
# choice does not depend on n. At 3 streams 2^13 is ahead up to 2^20 keys
# and behind from 2^22.
BLOCK_LOG = {1: 15, 2: 13, 3: 12, 4: 13}


def block_log(ns: int, log_block: int = LOG_BLOCK_MAX) -> int:
    """Shared-memory block (log2) for ns streams, capped at ``log_block``."""
    return min(log_block, BLOCK_LOG.get(ns, 11))


# --- the register design of K1 and K2 --------------------------------------
# Everything from here to the plain versions restates csrc/bitonic.cu
# (elems_log, the low and high layouts, the phases of both kernels) and
# must match it; tests/test_torch_bitonic.py holds it to the network, and
# tools/ab_bitonic.py holds the kernels' barriers to it. Not public API.

E_BIG = 5           # log2 elements a thread owns of one stream above 2^13
SMEM_MAX = 232448   # bytes of shared memory one block may ask for


def design_top(ns: int, e: int) -> int:
    """The largest block (log2) K1 / K2 take with 2^e elements a thread:
    2e + 5, as far as ns streams of it fit in shared memory."""
    top = 2 * e + 5
    while (4 * ns) << top > SMEM_MAX:
        top -= 1
    return top


def elems_log(ns: int, log_block: int) -> int:
    """log2 of the elements a thread of K1 / K2 owns for ns streams in a
    block 2^log_block: 3 above 4 streams, E_BIG for 1 stream in a block
    above 2^13, else 4. 0 where the block is outside e + 5..design_top
    and the per-layer kernels run (one barrier per layer)."""
    e = 3 if ns > 4 else E_BIG if ns == 1 and log_block > 13 else 4
    if not e + 5 <= log_block <= design_top(ns, e):
        return 0
    return e


class Layout(collections.namedtuple("Layout", "slots lanes warps vector")):
    """Which index bit of a block each slot, lane and warp bit of a
    thread's element holds (least significant first), and the words a
    thread moves in one access (``vector``: 4 = 16 bytes)."""

    def word(self, warp: int, lane: int, slot: int) -> int:
        """Block-local index of a thread's slot: its word in shared
        memory, and its offset in the block in device memory."""
        return sum(((v >> k) & 1) << bit
                   for v, bits in ((slot, self.slots), (lane, self.lanes),
                                   (warp, self.warps))
                   for k, bit in enumerate(bits))


def low_layout(e: int, log_block: int) -> Layout:
    """Slot 4q + k holds index warp << (e+5) | q << 7 | lane << 2 | k: the
    layers 0..e+4, and 16-byte accesses a warp makes to 512 contiguous
    bytes."""
    return Layout((0, 1) + tuple(range(7, e + 5)), tuple(range(2, 7)),
                  tuple(range(e + 5, log_block)), 4)


def high_layout(e: int, log_block: int) -> Layout:
    """Slot r holds index r << (L-e) | thread: the layers L-e..L-1, and
    one-word accesses a warp makes to 32 consecutive words."""
    return Layout(tuple(range(log_block - e, log_block)), tuple(range(5)),
                  tuple(range(5, log_block - e)), 1)


# One run of layers of stage ``stage`` under one layout ("low" / "high");
# ``relayout``: the block changes layout through shared memory (write,
# one barrier, read) to get there.
Phase = collections.namedtuple("Phase", "stage layout layers relayout")


def tail_schedule(log_block: int, e: int):
    """K2's phases for a block 2^L (of whatever stage: ``stage`` is None):
    device memory is read straight into the high layout for layers
    L-1..e+5, one change of layout, then layers e+4..0 and the store
    from the low layout."""
    if log_block <= e + 5:
        return [Phase(None, "low", list(range(log_block - 1, -1, -1)), False)]
    return [Phase(None, "high", list(range(log_block - 1, e + 4, -1)), False),
            Phase(None, "low", list(range(e + 4, -1, -1)), True)]


def block_schedule(log_block: int, e: int, row_log: int = 0):
    """K1's phases: stages 1..e+5 in the low layout, in which the block
    is loaded and stored, with no barrier; each later stage goes to the
    high layout for its layers s-1..e+5 and back for e+4..0."""
    phases = []
    for s in range(1, (row_log or log_block) + 1):
        if s <= e + 5:
            phases.append(Phase(s, "low", list(range(s - 1, -1, -1)), False))
        else:
            phases += [Phase(s, "high", list(range(s - 1, e + 4, -1)), True),
                       Phase(s, "low", list(range(e + 4, -1, -1)), True)]
    return phases


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


def _layers(x, ext: int, num_keys: int, layers, skip) -> None:
    """Run the (s, j, asc) layers over x[:, :ext] in place; where the
    1-element tensor ``skip`` is nonzero x keeps its words (a device-side
    select, no host read)."""
    before = None if skip is None else x[:, :ext].clone()
    for s, j, asc in layers:
        _layer(x, ext, num_keys, s, j, asc)
    if before is not None:
        x[:, :ext] = torch.where(skip.view(()) != 0, before, x[:, :ext])


def block_plain(x, ext: int, num_keys: int, log_block: int,
                row_log: int = 0, skip=None) -> None:
    """Plain version of K1: stages 1..log_block over x[:, :ext], or with
    ``row_log`` stages 1..row_log, the last one ascending."""
    top = row_log or log_block
    _layers(x, ext, num_keys, [(s, j, s == row_log)
                               for s in range(1, top + 1)
                               for j in range(s - 1, -1, -1)], skip)


def tail_plain(x, ext: int, num_keys: int, log_block: int, s: int,
               force_asc: bool = False, skip=None) -> None:
    """Plain version of K2: layers log_block-1..0 of stage s."""
    _layers(x, ext, num_keys,
            [(s, j, force_asc) for j in range(log_block - 1, -1, -1)], skip)


def global_plain(x, ext: int, num_keys: int, s: int, j_hi: int,
                 j_lo: int, force_asc: bool = False, skip=None) -> None:
    """Plain version of K3: layers j_hi..j_lo of stage s."""
    _layers(x, ext, num_keys,
            [(s, j, force_asc) for j in range(j_hi, j_lo - 1, -1)], skip)


def reverse_plain(src: torch.Tensor, out: torch.Tensor,
                  flags: torch.Tensor) -> None:
    """Plain version of K8: out = src reversed where ``flags`` (a
    1-element int32 tensor of ``utils.words.order_flags``) says
    nonincreasing and not nondecreasing; else out keeps its words."""
    take = (flags.view(()) & (NONDECREASING | NONINCREASING)) == NONINCREASING
    out.copy_(torch.where(take, src.flip(0), out))


# --- kernel wrappers -----------------------------------------------------

def _check_flag(flag, device, what: str) -> None:
    if flag is not None and (flag.dtype != torch.int32 or flag.numel() != 1
                             or flag.device != device):
        raise ValueError(f"{what} must be one int32 element on the "
                         "buffer's device")


def _ptr(flag):
    return None if flag is None else flag.data_ptr()


def _check(x: torch.Tensor, ext: int, num_keys: int, granule: int,
           narrow: bool = False, skip=None) -> None:
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
    _check_flag(skip, x.device, "skip")


@profiled("bitonic_block", level="kernel")
def bitonic_block(x: torch.Tensor, ext: int, num_keys: int,
                  log_block: int, row_log: int = 0, *,
                  skip: torch.Tensor | None = None) -> torch.Tensor:
    """K1: stages 1..log_block on every 2^log_block block of x[:, :ext];
    with ``row_log`` <= log_block, stages 1..row_log, the last ascending.
    Nothing moves where ``skip`` is set (see the module notes)."""
    _check(x, ext, num_keys, 1 << log_block, narrow=row_log > 0, skip=skip)
    if not 0 <= row_log <= log_block:
        raise ValueError(f"row_log {row_log} is not within the block "
                         f"2^{log_block}")
    if on_card(x):
        launch("bitonic_block", "sortx_bitonic_block", x.device,
               x.data_ptr(), _ptr(skip), ext, x.stride(0), x.shape[0],
               num_keys, log_block, row_log)
    else:
        block_plain(x, ext, num_keys, log_block, row_log, skip)
    return x


@profiled("bitonic_tail", level="kernel")
def bitonic_tail(x: torch.Tensor, ext: int, num_keys: int, log_block: int,
                 s: int, force_asc: bool = False, *,
                 skip: torch.Tensor | None = None) -> torch.Tensor:
    """K2: layers log_block-1..0 of stage s > log_block over x[:, :ext];
    under ``force_asc`` (rows mode, the merge stage) also s == log_block."""
    _check(x, ext, num_keys, 1 << log_block, narrow=force_asc, skip=skip)
    if s < log_block or (s == log_block and not force_asc):
        raise ValueError(f"stage {s} is inside the block 2^{log_block}")
    if on_card(x):
        launch("bitonic_tail", "sortx_bitonic_tail", x.device,
               x.data_ptr(), _ptr(skip), ext, x.stride(0), x.shape[0],
               num_keys, log_block, s, int(force_asc))
    else:
        tail_plain(x, ext, num_keys, log_block, s, force_asc, skip)
    return x


@profiled("bitonic_global", level="kernel")
def bitonic_global(x: torch.Tensor, ext: int, num_keys: int, s: int,
                   j_hi: int, j_lo: int, force_asc: bool = False, *,
                   skip: torch.Tensor | None = None) -> torch.Tensor:
    """K3: layers j_hi..j_lo (at most f_max(ns)) of stage s over
    x[:, :ext]."""
    _check(x, ext, num_keys, 1 << (j_hi + 1), skip=skip)
    fm = f_max(x.shape[0])
    if not 0 <= j_lo <= j_hi < s or j_hi - j_lo >= fm:
        raise ValueError(f"layers {j_hi}..{j_lo} of stage {s}: need "
                         f"j_lo <= j_hi < s and at most {fm} layers")
    if on_card(x):
        launch("bitonic_global", "sortx_bitonic_global", x.device,
               x.data_ptr(), _ptr(skip), ext, x.stride(0), x.shape[0],
               num_keys, s, j_hi, j_lo, int(force_asc))
    else:
        global_plain(x, ext, num_keys, s, j_hi, j_lo, force_asc, skip)
    return x


@profiled("reverse", level="kernel")
def reverse_ordered(src: torch.Tensor, out: torch.Tensor,
                    flags: torch.Tensor) -> torch.Tensor:
    """K8: where ``flags`` (one int32 element of
    ``utils.words.order_flags`` on the buffers' device) says nonincreasing
    and not nondecreasing, write ``src`` reversed over ``out``; otherwise
    leave ``out`` as it is. src and out are contiguous 1-D int32 tensors
    of one length that do not overlap. Returns out."""
    if (src.dim() != 1 or src.dtype != torch.int32 or not src.is_contiguous()
            or out.shape != src.shape or out.dtype != torch.int32
            or not out.is_contiguous() or out.device != src.device):
        raise ValueError("reverse_ordered takes two contiguous 1-D int32 "
                         "tensors of one length on one device")
    if flags is None:
        raise ValueError("reverse_ordered needs the order flags")
    _check_flag(flags, src.device, "flags")
    if src.shape[0] == 0:
        return out
    if on_card(src):
        launch("reverse", "sortx_reverse_ordered", src.device,
               flags.data_ptr(), src.data_ptr(), out.data_ptr(), src.shape[0])
    else:
        reverse_plain(src, out, flags)
    return out


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
                         row_log: int | None = None,
                         skip: torch.Tensor | None = None) -> torch.Tensor:
    """Sort the columns of the (ns, n) int32 buffer ``x`` in place by its
    first ``num_keys`` rows; n must be a power of two, or in rows mode
    (``row_log``) a multiple of 1024 and of the row. Returns ``x``.

    ``n_valid``: number of real elements; every column at index >=
    n_valid must be 0xFFFFFFFF in every stream (the callers pad so).
    ``skip``: every pass returns at once where it is set, so ``x`` comes
    back as it went in.
    """
    for name, args in pass_plan(*x.shape, num_keys, n_valid, log_block,
                                row_log):
        KERNELS[name][0](x, *args, skip=skip)
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
