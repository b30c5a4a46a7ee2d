"""Batched independent row sorts: ``sort_rows`` / ``sort_kv_rows``.

Port of ``sortx/ops/rows.py``. In a row-major [B, Lp] buffer with Lp a
power of two, every bitonic exchange at distance < Lp stays inside a
row, so sorting all rows ascending is the network in rows mode
(``row_log``, ops/bitonic.py): rows of any length L pad to Lp with
0xFFFFFFFF, and the flat buffer pads to a multiple of the block.

``sort_kv_rows`` carries the in-row position as a second key stream,
(key, pos, value) with two keys, so equal keys keep their in-row order.
``sort_rows(..., return_indices=True)`` runs (key, pos) and returns the
position stream itself as the indices: two streams, where
``sort_kv_rows`` with an ``arange`` payload would carry three.
The same row network (``ops/sort_network.py:network_rows``) is the
hybrid engine's phase sorter, which is why it takes any number of
payload streams.

Engines: "network" (and "auto" on CUDA tensors) runs the row network;
"host" and "hybrid" (and "auto" on CPU tensors) run a stable
``torch.sort`` along the rows, as ``sortx`` runs ``lax.sort`` for every
engine but "pallas". Both give the same result. The TPU's small-size
floor (``rows.py:_FLOOR``) is not carried, as for the 1-D sorts.
"""

from __future__ import annotations

import torch

from ..config import Config, default_config, resolve_engine
from ..runtime.launcher import profiled
from .sort import _check_key_dtype, _to_radix_u32, _value_words
from .sort_host import host_rows
from .sort_network import network_rows

__all__ = ["sort_rows", "sort_kv_rows"]


def _rows_engine(cfg: Config, keys: torch.Tensor):
    return network_rows if resolve_engine(cfg, keys) == "network" \
        else host_rows


def _check(keys: torch.Tensor) -> None:
    if keys.dim() != 2:
        raise ValueError("sort_rows expects a 2D [batch, length] array")
    _check_key_dtype(keys.dtype, "sort_rows")


@profiled("sort_rows")
def sort_rows(keys: torch.Tensor, *, descending: bool = False,
              return_indices: bool = False, config: Config | None = None):
    """Sort every row of a [B, L] tensor independently.

    Keys follow the dtype contract of ``sort`` (u32/i32/f32 and 16-bit
    keys); batch and row length are free. With ``return_indices``
    returns (sorted keys, indices): the int32 [B, L] in-row position of
    the key in each output slot, equal keys in ascending position (also
    under ``descending``), as a stable ``torch.sort`` gives them."""
    cfg = config or default_config()
    _check(keys)
    B, L = keys.shape
    if B == 0 or L <= 1:
        if return_indices:
            return keys, torch.zeros(keys.shape, dtype=torch.int32,
                                     device=keys.device)
        return keys
    k, undo = _to_radix_u32(keys.contiguous())
    if descending:
        k = ~k
    out, *idx = _rows_engine(cfg, keys)([k], positions=return_indices)
    out = undo(~out if descending else out)
    return (out, idx[0]) if return_indices else out


@profiled("sort_kv_rows")
def sort_kv_rows(keys: torch.Tensor, values: torch.Tensor, *,
                 descending: bool = False, config: Config | None = None):
    """Stable per-row key-value sort of [B, L] tensors: values follow
    keys, and equal keys keep their in-row order. Values may be any 8-,
    16-, 32- or 64-bit dtype."""
    cfg = config or default_config()
    _check(keys)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    B, L = keys.shape
    if B == 0 or L <= 1:
        return keys, values
    k, undo = _to_radix_u32(keys.contiguous())
    v, undo_v = _value_words(values.contiguous())
    if descending:
        k = ~k
    ks, *vs = _rows_engine(cfg, keys)([k, *v])
    return undo(~ks if descending else ks), undo_v(*vs)
