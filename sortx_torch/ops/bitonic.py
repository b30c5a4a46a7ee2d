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
                                         passes of up to F_MAX layers;
  bitonic_tail    (K2)                   stage s > L, layers L-1..0.

Each wrapper runs its CUDA kernel on a CUDA tensor and its plain PyTorch
version (the same layers as pair reshapes and ``torch.where``) on a CPU
tensor. All of them work in place on the prefix ``x[:, :ext]``.

``n_valid`` prunes pad-only work as the reference does: every index
>= n_valid holds 0xFFFFFFFF in every stream, a stage-s group without a
real element sorts to itself, so stage s only runs over the prefix
``ceil(n_valid / 2^s) * 2^s``. The pads beyond that prefix are never
touched, so they stay 0xFFFFFFFF with no re-padding between stages.
"""

from __future__ import annotations

import torch

from ..config import LOG_BLOCK_MAX
from ..utils.math import cdiv
from ..utils.words import ordered
from ._build import launch, on_card

__all__ = ["bitonic_sort_streams", "pass_plan", "bitonic_block",
           "bitonic_tail", "bitonic_global", "block_plain", "tail_plain",
           "global_plain", "block_log", "F_MAX", "KERNELS"]

# Cross-block layers one global-kernel pass keeps in registers: 2^F_MAX
# words per stream and thread.
F_MAX = 4


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


def _layer(x: torch.Tensor, ext: int, num_keys: int, s: int, j: int) -> None:
    """Layer j of stage s over x[:, :ext], in place."""
    d = 1 << j
    groups = ext // (2 * d)
    v = x[:, :ext].view(x.shape[0], groups, 2, d)
    a, b = v[:, :, 0], v[:, :, 1]
    # group g starts at flat index g * 2^(j+1); its direction is bit s
    desc = ((torch.arange(groups, device=x.device) >> (s - j - 1)) & 1
            ).bool().unsqueeze(1)
    swap = torch.where(desc, _lt(a, b, num_keys), _lt(b, a, num_keys))
    na, nb = torch.where(swap, b, a), torch.where(swap, a, b)
    a.copy_(na)
    b.copy_(nb)


def block_plain(x, ext: int, num_keys: int, log_block: int) -> None:
    """Plain version of K1: stages 1..log_block over x[:, :ext]."""
    for s in range(1, log_block + 1):
        for j in range(s - 1, -1, -1):
            _layer(x, ext, num_keys, s, j)


def tail_plain(x, ext: int, num_keys: int, log_block: int, s: int) -> None:
    """Plain version of K2: layers log_block-1..0 of stage s."""
    for j in range(log_block - 1, -1, -1):
        _layer(x, ext, num_keys, s, j)


def global_plain(x, ext: int, num_keys: int, s: int, j_hi: int,
                 j_lo: int) -> None:
    """Plain version of K3: layers j_hi..j_lo of stage s."""
    for j in range(j_hi, j_lo - 1, -1):
        _layer(x, ext, num_keys, s, j)


# --- kernel wrappers -----------------------------------------------------

def _check(x: torch.Tensor, ext: int, num_keys: int, granule: int) -> None:
    if (x.dim() != 2 or x.dtype != torch.int32 or x.stride(1) != 1
            or (x.shape[0] > 1 and x.stride(0) < x.shape[1])):
        raise ValueError("bitonic streams must be an (ns, n) int32 buffer "
                         "with unit stride along n and disjoint rows")
    if not 1 <= x.shape[0] <= 4 or not 1 <= num_keys <= min(2, x.shape[0]):
        raise ValueError(f"unsupported stream set: {x.shape[0]} streams, "
                         f"{num_keys} keys (1..4 streams, 1..2 keys)")
    if not 0 < ext <= x.shape[1] or ext % granule:
        raise ValueError(f"extent {ext} is not a positive multiple of "
                         f"{granule} within {x.shape[1]}")


def bitonic_block(x: torch.Tensor, ext: int, num_keys: int,
                  log_block: int) -> torch.Tensor:
    """K1: stages 1..log_block on every 2^log_block block of x[:, :ext]."""
    _check(x, ext, num_keys, 1 << log_block)
    if on_card(x):
        launch("bitonic_block", "sortx_bitonic_block", x.device,
               x.data_ptr(), ext, x.stride(0), x.shape[0], num_keys,
               log_block)
    else:
        block_plain(x, ext, num_keys, log_block)
    return x


def bitonic_tail(x: torch.Tensor, ext: int, num_keys: int, log_block: int,
                 s: int) -> torch.Tensor:
    """K2: layers log_block-1..0 of stage s > log_block over x[:, :ext]."""
    _check(x, ext, num_keys, 1 << log_block)
    if s <= log_block:
        raise ValueError(f"stage {s} is inside the block 2^{log_block}")
    if on_card(x):
        launch("bitonic_tail", "sortx_bitonic_tail", x.device,
               x.data_ptr(), ext, x.stride(0), x.shape[0], num_keys,
               log_block, s)
    else:
        tail_plain(x, ext, num_keys, log_block, s)
    return x


def bitonic_global(x: torch.Tensor, ext: int, num_keys: int, s: int,
                   j_hi: int, j_lo: int) -> torch.Tensor:
    """K3: layers j_hi..j_lo (at most F_MAX) of stage s over x[:, :ext]."""
    _check(x, ext, num_keys, 1 << (j_hi + 1))
    if not 0 <= j_lo <= j_hi < s or j_hi - j_lo >= F_MAX:
        raise ValueError(f"layers {j_hi}..{j_lo} of stage {s}: need "
                         f"j_lo <= j_hi < s and at most {F_MAX} layers")
    if on_card(x):
        launch("bitonic_global", "sortx_bitonic_global", x.device,
               x.data_ptr(), ext, x.stride(0), x.shape[0], num_keys, s,
               j_hi, j_lo)
    else:
        global_plain(x, ext, num_keys, s, j_hi, j_lo)
    return x


# --- the whole network ---------------------------------------------------

KERNELS = {   # kernel name -> (wrapper, plain version)
    "bitonic_block": (bitonic_block, block_plain),
    "bitonic_tail": (bitonic_tail, tail_plain),
    "bitonic_global": (bitonic_global, global_plain),
}


def pass_plan(ns: int, n: int, num_keys: int, n_valid: int | None = None,
              log_block: int = LOG_BLOCK_MAX):
    """The passes that sort an (ns, n) buffer, in order, as
    (kernel name, arguments after ``x``) pairs; see the module notes."""
    log_n = n.bit_length() - 1
    if (1 << log_n) != n:
        raise ValueError("bitonic_sort_streams needs power-of-two length")
    nv = n if n_valid is None else min(n_valid, n)
    if n < 2 or nv <= 0:
        return []
    lb = min(block_log(ns, log_block), log_n)
    plan = [("bitonic_block",
             (min(n, cdiv(nv, 1 << lb) << lb), num_keys, lb))]
    for s in range(lb + 1, log_n + 1):
        ext = min(n, cdiv(nv, 1 << s) << s)
        j = s - 1
        while j >= lb:
            j_lo = max(lb, j - F_MAX + 1)
            plan.append(("bitonic_global", (ext, num_keys, s, j, j_lo)))
            j = j_lo - 1
        plan.append(("bitonic_tail", (ext, num_keys, lb, s)))
    return plan


def bitonic_sort_streams(x: torch.Tensor, num_keys: int, *,
                         n_valid: int | None = None,
                         log_block: int = LOG_BLOCK_MAX) -> torch.Tensor:
    """Sort the columns of the (ns, n) int32 buffer ``x`` in place by its
    first ``num_keys`` rows; n must be a power of two. Returns ``x``.

    ``n_valid``: number of real elements; every column at index >=
    n_valid must be 0xFFFFFFFF in every stream (the callers pad so).
    """
    for name, args in pass_plan(*x.shape, num_keys, n_valid, log_block):
        KERNELS[name][0](x, *args)
    return x
