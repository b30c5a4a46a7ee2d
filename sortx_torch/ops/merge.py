"""merge / merge_kv: two sorted arrays into one, in one network stage.

Port of ``sortx/ops/merge.py``. ``[a, pads, reverse(b)]`` is a bitonic
sequence, and the last stage of the network (s = log2 n, ascending:
``bitonic.bitonic_merge_streams``, K3 passes then one K2) sorts it:
log n layers instead of the full sort's ~log^2 n / 2. The pads
(0xFFFFFFFF) sit in the middle, so the stage runs over the whole padded
length.

Ties as in ``std::merge``: equal keys take ``a``'s elements first, each
input's own order kept. ``merge_kv`` carries an index stream in the
comparator for it (a: 0..na-1, b: na..na+nb-1, pads 0xFFFFFFFF, which
keep real 0xFFFFFFFF keys ahead of the pads); keys alone need none.

Engines: the network under "network", "hybrid" or "auto" on a CUDA
tensor, as ``sortx`` takes its engine under "pallas" and "hybrid"; the
host path is ``sortx``'s rank arithmetic (element i of a lands at i +
|{b < a[i]}|, element j of b at j + |{a <= b[j]}|) on
``torch.searchsorted`` and a scatter. ``merge_kv``'s network carries
32-bit values; other widths take the host path.

The inputs must each be sorted (ascending, or descending under
``descending``); as in ``sortx`` this is not checked, and unsorted
inputs give an unspecified result.
"""

from __future__ import annotations

import torch

from ..config import Config, default_config, resolve_engine
from ..runtime.launcher import profiled
from ..utils.words import FF, int_view, ordered
from .bitonic import bitonic_merge_streams
from .capacity import check_device_bytes, network_bytes
from .sort import _check_keys, _to_radix_u32

__all__ = ["merge", "merge_kv"]


def _check_pair(a: torch.Tensor, b: torch.Tensor) -> None:
    _check_keys(a)
    _check_keys(b)
    if a.dtype != b.dtype:
        raise TypeError(f"merge inputs must share a dtype, got {a.dtype} "
                        f"vs {b.dtype}")


def _use_network(cfg: Config, t: torch.Tensor) -> bool:
    return resolve_engine(cfg, t) in ("network", "hybrid")


def _merge_host(ka, kb, payloads_a=(), payloads_b=()):
    """Stable positional merge of u32 words ka, kb (int32) and their
    payloads (any dtype of one width): ranks, then a scatter."""
    na, nb = ka.shape[0], kb.shape[0]
    oa, ob = ordered(ka), ordered(kb)
    dev = ka.device
    pos_a = torch.arange(na, device=dev) + torch.searchsorted(ob, oa)
    pos_b = torch.arange(nb, device=dev) + torch.searchsorted(oa, ob,
                                                               side="right")
    outs = []
    for xa, xb in ((ka, kb), *zip(payloads_a, payloads_b)):
        o = torch.zeros(na + nb, dtype=xa.dtype, device=dev)
        o[pos_a] = xa
        o[pos_b] = xb
        outs.append(o)
    return outs


def _merge_network(ka, kb, payloads_a=(), payloads_b=(), *,
                   stable_idx: bool):
    """One ascending merge stage over [a, pads, reverse(b)] of the u32
    words ka, kb and their 32-bit payloads (all int32)."""
    na, nb = ka.shape[0], kb.shape[0]
    nt = na + nb
    N = 1 << max(10, (nt - 1).bit_length())
    rows = 1 + stable_idx + len(payloads_a)
    check_device_bytes(network_bytes(nt, rows), ka.device,
                       f"merge of n={nt}")
    x = torch.empty((rows, N), dtype=torch.int32, device=ka.device)

    def put(t, xa, xb, fill):
        x[t, :na] = xa
        x[t, na:N - nb].fill_(fill)
        x[t, N - nb:] = xb.flip(0)

    put(0, ka, kb, FF)
    if stable_idx:
        put(1, torch.arange(na, dtype=torch.int32, device=ka.device),
            torch.arange(na, nt, dtype=torch.int32, device=ka.device), FF)
    for t, (xa, xb) in enumerate(zip(payloads_a, payloads_b), 1 + stable_idx):
        put(t, xa, xb, 0)
    num_keys = 1 + stable_idx
    bitonic_merge_streams(x, num_keys)
    return [x[0, :nt]] + [x[t, :nt] for t in range(num_keys, rows)]


@profiled("merge")
def merge(a: torch.Tensor, b: torch.Tensor, *, descending: bool = False,
          config: Config | None = None) -> torch.Tensor:
    """Merge two sorted key arrays (u32/i32/f32 or 16-bit, as ``sort``)
    into one sorted array."""
    cfg = config or default_config()
    _check_pair(a, b)
    if a.shape[0] == 0:
        return b
    if b.shape[0] == 0:
        return a
    ka, undo = _to_radix_u32(a.contiguous())
    kb, _ = _to_radix_u32(b.contiguous())
    if descending:
        ka, kb = ~ka, ~kb
    if _use_network(cfg, a):
        (out,) = _merge_network(ka, kb, stable_idx=False)
    else:
        (out,) = _merge_host(ka, kb)
    return undo(~out if descending else out)


@profiled("merge_kv")
def merge_kv(keys_a: torch.Tensor, values_a: torch.Tensor,
             keys_b: torch.Tensor, values_b: torch.Tensor, *,
             descending: bool = False, config: Config | None = None):
    """Merge two sorted key-value arrays; returns ``(keys, values)``.
    Equal keys take ``a``'s elements first, each input's order kept.
    Values share one dtype between the inputs."""
    cfg = config or default_config()
    _check_pair(keys_a, keys_b)
    if values_a.shape != keys_a.shape or values_b.shape != keys_b.shape:
        raise ValueError("keys and values must have the same shape")
    if values_a.dtype != values_b.dtype:
        raise TypeError("merge_kv value dtypes must match")
    if keys_a.shape[0] == 0:
        return keys_b, values_b
    if keys_b.shape[0] == 0:
        return keys_a, values_a
    ka, undo = _to_radix_u32(keys_a.contiguous())
    kb, _ = _to_radix_u32(keys_b.contiguous())
    if descending:
        ka, kb = ~ka, ~kb
    va, vb = int_view(values_a.contiguous()), int_view(values_b.contiguous())
    if values_a.element_size() == 4 and _use_network(cfg, keys_a):
        out_k, out_v = _merge_network(ka, kb, (va,), (vb,), stable_idx=True)
    else:
        out_k, out_v = _merge_host(ka, kb, (va,), (vb,))
    return undo(~out_k if descending else out_k), out_v.view(values_a.dtype)
