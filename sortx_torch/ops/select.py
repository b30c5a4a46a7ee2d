"""Order statistics without a full sort: ``kth_value``, ``median``,
``top_k``.

Port of ``sortx/ops/select.py``. ``kth_value`` is four rounds of an
8-bit histogram (K5, ops/histogram.py) that pick the bucket holding
rank k, narrowing one byte per round. The reference parks the words
outside the chosen prefix in bucket 0 and subtracts them; here K5
itself counts only the words under the prefix, on the 32-bit radix
image as it is, so a round is one kernel launch and some 256-entry
bookkeeping. The rank and the prefix stay on the device: the rounds
need no host sync.
``top_k`` is the reference's tournament on the row network: rows of L
sort independently, each gives its top k, and one sort of the B*k
candidates finishes (any global top-k element is top-k in its own row).
Ties go to the lowest index, as in ``lax.top_k``, through a
(complemented key, index) ``sort_u64``.
"""

from __future__ import annotations

import torch

from ..config import Config, default_config
from ..runtime.launcher import profiled
from ..utils.words import wrap_i32
from .extras import sort_u64
from .histogram import digit_counts
from .rows import sort_kv_rows, sort_rows
from .sort import _check_keys, _to_radix_u32, sort

__all__ = ["kth_value", "median", "top_k"]


@profiled("kth_value")
def kth_value(keys: torch.Tensor, k, *, config: Config | None = None):
    """The value of rank ``k`` (0-based) in the ascending sort of
    ``keys``, as a 0-d tensor of ``keys.dtype``. ``k`` is an int or a
    0-d integer tensor on the keys' device."""
    cfg = config or default_config()
    _check_keys(keys)
    n = keys.shape[0]
    if n == 0:
        raise ValueError("kth_value of an empty array")
    if isinstance(k, int) and not 0 <= k < n:
        raise ValueError(f"k={k} out of range for n={n}")
    w, undo = _to_radix_u32(keys.contiguous())
    # an int fills the rank on the card (a copy from the host would sync)
    rank = (torch.full((), k, dtype=torch.int64, device=keys.device)
            if isinstance(k, int) else
            torch.as_tensor(k, dtype=torch.int64, device=keys.device))
    prefix = torch.zeros((), dtype=torch.int64, device=keys.device)
    for shift in (24, 16, 8, 0):
        # only the words whose bytes above this round equal the chosen
        # prefix are counted (all of them in the first round)
        hist = digit_counts(w, 8, shift, cfg,
                            prefix=prefix.to(torch.int32).view(1))
        cum = torch.cumsum(hist, 0, dtype=torch.int64)
        # b, rank and prefix stay 1-element tensors: a 0-d index would
        # be read on the host
        b = torch.searchsorted(cum, rank.view(1), right=True)
        rank = rank - torch.where(b > 0, cum[(b - 1).clamp(min=0)], 0)
        prefix = (prefix << 8) | b
    return undo(wrap_i32(prefix.view(())))


@profiled("median")
def median(keys: torch.Tensor, *, config: Config | None = None):
    """Lower median: ``sort(keys)[(n - 1) // 2]`` without the sort."""
    return kth_value(keys, (keys.shape[0] - 1) // 2, config=config)


def _top_k_shape(n: int, k: int):
    """Row geometry (B, L) of the tournament, or None to sort directly."""
    L = 1024
    while L < 2 * k:
        L *= 2
    B = n // L
    # the tournament pays off once the candidates (B*k) are far fewer
    # than n
    if B < 4 or B * k * 4 > n:
        return None
    return B, L


@profiled("top_k")
def top_k(keys: torch.Tensor, k: int, *, return_indices: bool = False,
          config: Config | None = None):
    """The ``k`` largest keys in descending order; with
    ``return_indices`` also their int32 indices, ties to the lowest."""
    cfg = config or default_config()
    _check_keys(keys)
    n = keys.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"k={k} out of range for n={n}")
    u, undo = _to_radix_u32(keys.contiguous())
    dev = keys.device
    geom = _top_k_shape(n, k)
    if geom is None:
        cand_u = u
        cand_idx = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        B, L = geom
        BL = B * L
        # the tail beyond B*L rides along as candidates
        body = u[:BL].view(B, L).view(torch.uint32)
        if return_indices:
            idx = torch.arange(BL, dtype=torch.int32, device=dev).view(B, L)
            rk, ri = sort_kv_rows(body, idx, descending=True, config=cfg)
            cand_idx = torch.cat([
                ri[:, :k].reshape(-1),
                torch.arange(BL, n, dtype=torch.int32, device=dev)])
        else:
            rk = sort_rows(body, descending=True, config=cfg)
        cand_u = torch.cat([rk[:, :k].reshape(-1).view(torch.int32),
                            u[BL:]])
    if not return_indices:
        top = sort(cand_u.view(torch.uint32), descending=True, config=cfg)
        return undo(top[:k].view(torch.int32))
    # (key descending, index ascending): lax.top_k's tie order
    hi, lo = sort_u64((~cand_u).view(torch.uint32),
                      cand_idx.view(torch.uint32), config=cfg)
    return undo(~hi[:k].view(torch.int32)), lo[:k].view(torch.int32)
