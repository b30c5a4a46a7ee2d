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

Engines (:func:`rows_engine`): the rows' radix engine
(``ops/radix_rows.py``: K11 and four K12 passes, one stable 8-bit pass of
every row at once) where it serves the call and is asked for, under
"radix" or under "auto" on a CUDA tensor. It serves keys of at most 32
bits with at most one value word or the indices, R * L < 2^30, and rows
longer than 2^11 words (:data:`RADIX_ROWS_MIN_LOG`). Otherwise "network"
(and "auto" on CUDA tensors) runs the row network; "host" and "hybrid"
(and "auto" on CPU tensors) run a stable ``torch.sort`` along the rows,
as ``sortx`` runs ``lax.sort`` for every engine but "pallas". All give
the same result. The TPU's small-size floor (``rows.py:_FLOOR``) is not
carried, as for the 1-D sorts.
"""

from __future__ import annotations

import torch

from ..config import Config, default_config, device_engine
from ..runtime.launcher import profiled
from .radix import RADIX_MAX_N
from .radix_rows import key_words, radix_rows
from .sort import _check_key_dtype, _to_radix_u32, _value_words
from .sort_host import host_rows
from .sort_network import network_rows

__all__ = ["sort_rows", "sort_kv_rows", "rows_engine",
           "RADIX_ROWS_MIN_LOG"]

# The rows' radix engine takes rows longer than 2^11 words. Timed on an
# H100 against the row network (keys alone, with indices, with a value
# word; 256 and 2048 rows of 2^9 to 2^16): at 2048 rows, where the card's
# work sets the time, the network wins up to rows of 2^11 and the radix
# engine from 2^12 on, for every stream count; at 256 rows the two tie
# or the radix engine wins below that (PERF.md, the rows' engine rule).
RADIX_ROWS_MIN_LOG = 11


def rows_engine(cfg: Config, device_type: str, rows: int, length: int, *,
                value_words: int = 0, positions: bool = False) -> str:
    """The engine of a row sort of [rows, length] keys (at most 32 bits)
    with ``value_words`` payload words, or with ``positions`` the
    indices, on a device of ``device_type``: "radix" where it is asked
    for, or under "auto" on a CUDA tensor, if the rows' radix engine
    serves the call (at most one value word, rows * length < 2^30, rows
    longer than 2^RADIX_ROWS_MIN_LOG); otherwise the engine every op
    resolves to."""
    serves = (value_words <= 1 and rows * length < RADIX_MAX_N
              and length > 1 << RADIX_ROWS_MIN_LOG)
    if serves and (cfg.engine == "radix" or cfg.engine == "auto"
                   and device_type == "cuda"):
        return "radix"
    return device_engine(cfg, device_type)


def _rows_engine(engine: str):
    return network_rows if engine == "network" else host_rows


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
    engine = rows_engine(cfg, keys.device.type, B, L,
                         positions=return_indices)
    if engine == "radix":
        w, kind, narrow = key_words(keys.contiguous())
        out, idx = radix_rows(w, kind, descending, positions=return_indices)
        return (narrow(out), idx) if return_indices else narrow(out)
    k, undo = _to_radix_u32(keys.contiguous())
    if descending:
        k = ~k
    out, *idx = _rows_engine(engine)([k], positions=return_indices)
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
    v, undo_v = _value_words(values.contiguous())
    engine = rows_engine(cfg, keys.device.type, B, L, value_words=len(v))
    if engine == "radix":
        w, kind, narrow = key_words(keys.contiguous())
        ks, vs = radix_rows(w, kind, descending, values=v[0])
        return narrow(ks), undo_v(vs)
    k, undo = _to_radix_u32(keys.contiguous())
    if descending:
        k = ~k
    ks, *vs = _rows_engine(engine)([k, *v])
    return undo(~ks if descending else ks), undo_v(*vs)
