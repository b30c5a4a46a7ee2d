"""Public sort API: keys-only and key-value sorts.

Port of ``sortx/ops/sort.py`` with its signatures and errors. Keys of
u32 / i32 / f32 map to u32 words whose unsigned order is the keys'
natural order (f32: a total order with NaNs at the extremes by sign);
16-bit keys widen exactly first. ``descending`` complements the
participating key bits around an ascending sort, so it stays stable.
Values may be any 8-, 16- or 32-bit dtype and ride as 32-bit words.

Engines: "network" (the bitonic network), "hybrid" (the sample sort,
always stable), "host" (``torch.sort``); see ``config.py``.

Ordered inputs skip the engines: keys whose sort key is already
nondecreasing come back as they are, and a full-width keys-only input
that is nonincreasing only flips (equal keys are indistinguishable).
One host sync reads both flags.

64-bit keys and values are not ported yet (ROADMAP Queue 1 item 7) and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..config import Config, resolve_engine
from ..utils.words import SIGN, monotone
from .capacity import check_device_capacity, network_bytes
from .sort_host import sort_host, sort_kv_host
from .sort_hybrid import hybrid_bytes, sort_hybrid, sort_kv_hybrid
from .sort_network import network_streams, sort_kv_network, sort_network

__all__ = ["sort", "sort_kv"]

_KEYS32 = (torch.uint32, torch.int32, torch.float32)
# 16-bit keys widen exactly to their 32-bit counterpart.
_WIDEN = {torch.uint16: torch.uint32, torch.int16: torch.int32,
          torch.float16: torch.float32, torch.bfloat16: torch.float32}
_DTYPES64 = (torch.uint64, torch.int64, torch.float64)
_NOT_PORTED_64 = ("64-bit {what} are not ported yet (ROADMAP Queue 1 "
                  "item 7), got {dtype}")


def _check_key_dtype(dt: torch.dtype, what: str = "sort",
                     allow64: bool = False) -> None:
    """The key dtypes of ``sortx``'s ``_check_key_dtype``: 64-bit keys,
    which ``sort`` and ``sort_kv`` accept there (``allow64``), are not
    ported yet; the other ops reject them as ``sortx`` does."""
    if dt in _KEYS32 or dt in _WIDEN:
        return
    if dt in _DTYPES64:
        if allow64:
            raise NotImplementedError(_NOT_PORTED_64.format(what="keys",
                                                            dtype=dt))
        raise TypeError(f"{what} does not support 64-bit keys (got {dt})")
    raise TypeError(f"{what} supports u32/i32/f32 (or 16-bit "
                    f"u16/i16/f16/bf16) keys, got {dt}")


def _check_keys(keys: torch.Tensor, allow64: bool = False) -> None:
    if keys.dim() != 1:
        raise ValueError("sort expects a 1D key array")
    _check_key_dtype(keys.dtype, allow64=allow64)


def _resolve_sort_bits(keys: torch.Tensor, sort_bits: int | None) -> int:
    """None -> 32; validate the explicit cases."""
    if sort_bits is None:
        return 32
    if not 1 <= sort_bits <= 32:
        raise ValueError("sort_bits must be in 1..32")
    if keys.dtype != torch.uint32 and sort_bits != 32:
        raise ValueError("partial sort_bits requires uint32 keys "
                         "(the reference's contract, Pprims.cpp:253)")
    return sort_bits


def _to_radix_u32(keys: torch.Tensor):
    """Map keys to u32 words (int32) whose unsigned order is the keys'
    order. Returns (words, undo)."""
    dt = keys.dtype
    if dt == torch.uint16:
        k = keys.view(torch.int16).to(torch.int32) & 0xFFFF
        # back through the int16 of the same low bits
        return k, lambda u: (((u & 0xFFFF) ^ 0x8000) - 0x8000).to(
            torch.int16).view(torch.uint16)
    wide = _WIDEN.get(dt)
    if wide is not None:
        k, undo_wide = _to_radix_u32(keys.to(wide))
        return k, lambda u: undo_wide(u).to(dt)
    if dt == torch.uint32:
        return keys.view(torch.int32), lambda u: u.view(torch.uint32)
    if dt == torch.int32:
        return keys ^ SIGN, lambda u: u ^ SIGN
    # float32: flip all bits of negatives, the sign bit of the rest
    bits = keys.view(torch.int32)
    fwd = bits ^ ((bits >> 31) | SIGN)
    return fwd, lambda u: (u ^ ((~u >> 31) | SIGN)).view(torch.float32)


def _value_words(values: torch.Tensor):
    """Values as 32-bit words (int32). Returns (words, undo)."""
    size = values.element_size()
    if size == 8:
        raise NotImplementedError(_NOT_PORTED_64.format(what="values",
                                                        dtype=values.dtype))
    if size == 4:
        return values.view(torch.int32), lambda w: w.view(values.dtype)
    narrow = {1: torch.int8, 2: torch.int16}[size]
    return (values.view(narrow).to(torch.int32),
            lambda w: w.to(narrow).view(values.dtype))


def _order_mask(sort_bits: int) -> int:
    """All ones over the participating key bits, as an int32 word."""
    return -1 if sort_bits >= 32 else (1 << sort_bits) - 1


def _sort_key(k: torch.Tensor, sort_bits: int) -> torch.Tensor:
    """The bits of the u32 words k that the sort orders by."""
    return k if sort_bits >= 32 else k & _order_mask(sort_bits)


def sort(keys: torch.Tensor, sort_bits: int | None = None, *,
         descending: bool = False, config: Config | None = None
         ) -> torch.Tensor:
    """Stable sort of 1-D keys by their low ``sort_bits`` bits.

    ``sort_bits=None`` means the full key width; partial widths need
    uint32 keys. The result lives on the keys' device.
    """
    cfg = config or Config()
    _check_keys(keys, allow64=True)
    sort_bits = _resolve_sort_bits(keys, sort_bits)
    n = keys.shape[0]
    if n <= 1:
        return keys
    k, undo = _to_radix_u32(keys.contiguous())
    if descending:
        k = k ^ _order_mask(sort_bits)
    up, down = monotone(_sort_key(k, sort_bits))
    if up:
        out = k
    elif down and sort_bits >= 32:
        out = k.flip(0)
    else:
        engine = resolve_engine(cfg, keys)
        if engine == "host":
            out = sort_host(k, sort_bits)
        elif engine == "hybrid":
            check_device_capacity(
                hybrid_bytes(n, 1 if sort_bits >= 32 else 2, cfg),
                keys.device, f"hybrid sort of n={n}")
            out = sort_hybrid(k, sort_bits, cfg)
        else:
            check_device_capacity(
                network_bytes(n, network_streams(n, sort_bits, False, True)),
                keys.device, f"sort of n={n}")
            out = sort_network(k, sort_bits)
    if descending:
        out = out ^ _order_mask(sort_bits)
    return undo(out)


def sort_kv(keys: torch.Tensor, values: torch.Tensor,
            sort_bits: int | None = None, *, stable: bool = True,
            descending: bool = False, config: Config | None = None):
    """Key-value sort on keys; values follow. Stable by default.

    ``stable=False`` lets the network drop its index stream; the order
    of values under equal keys is then unspecified.
    """
    cfg = config or Config()
    _check_keys(keys, allow64=True)
    sort_bits = _resolve_sort_bits(keys, sort_bits)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    n = keys.shape[0]
    if n <= 1:
        return keys, values
    k, undo = _to_radix_u32(keys.contiguous())
    v, undo_v = _value_words(values.contiguous())
    if descending:
        k = k ^ _order_mask(sort_bits)
    engine = resolve_engine(cfg, keys)
    if monotone(_sort_key(k, sort_bits))[0]:
        ks, vs = k, v
    elif engine == "host":
        ks, vs = sort_kv_host(k, v, sort_bits)
    elif engine == "hybrid":
        # always stable, whatever ``stable`` says
        check_device_capacity(
            hybrid_bytes(n, 2 if sort_bits >= 32 else 3, cfg),
            keys.device, f"hybrid sort_kv of n={n}")
        ks, vs = sort_kv_hybrid(k, v, sort_bits, cfg)
    else:
        check_device_capacity(
            network_bytes(n, network_streams(n, sort_bits, True, stable)),
            keys.device, f"sort_kv of n={n}")
        ks, vs = sort_kv_network(k, v, sort_bits, stable=stable)
    if descending:
        ks = ks ^ _order_mask(sort_bits)
    return undo(ks), undo_v(vs)
