"""Public sort API: keys-only and key-value sorts.

Port of ``sortx/ops/sort.py`` with its signatures and errors. Keys of
u32 / i32 / f32 map to u32 words whose unsigned order is the keys'
natural order (f32: a total order with NaNs at the extremes by sign);
16-bit keys widen exactly first. ``descending`` complements the
participating key bits around an ascending sort, so it stays stable.
Values may be any 8-, 16-, 32- or 64-bit dtype and ride as one 32-bit
word, or as a (hi, lo) pair of words.

64-bit keys (u64 / i64 / f64) map to a (hi, lo) pair of u32 words whose
lexicographic order is the keys' order (:func:`_to_radix_u64`; f64 with
the same total order as f32) and sort through ``sort_u64`` /
``sort_kv_u64`` (ops/extras.py): one network pass over both words.

Engines: "radix" (the one-sweep LSD radix sort, ``ops/radix.py``),
"network" (the bitonic network), "hybrid" (the sample sort, always
stable; 64-bit values take the host engine, as ``sortx`` sends them to
XLA), "host" (``torch.sort``); see ``config.py``. :func:`sort_engine`
picks one from what the call's input shows: under "auto" a CUDA tensor
takes the radix engine for a stable sort of keys of at most 32 bits with
at most one value word (n < 2^30), and the network otherwise, so
``stable=False``, 64-bit keys or values and the ops built on the
network (rows, ``merge``) keep it. ``dist_sort``'s on-card sorts follow
the same rule (``parallel/dist_sort.py:_local_engine``).

Ordered inputs take the reference's short cuts (``lax.cond`` in
``sortx/ops/sort_pallas.py:343-350, 442-445``): keys whose sort key is
already nondecreasing come back as they are, and a full-width keys-only
input that is nonincreasing comes back reversed (equal keys are
indistinguishable). On the network engine they are branches on the
device: the order flags (``utils.words.order_flags``) stay on the card
and predicate the network's passes and K8, so ``sort`` and ``sort_kv``
read nothing on the host and can be captured in a CUDA graph. The
hybrid engine reads the flags on the host, as it reads its bucket
totals, and refuses to run under capture. The host engine takes no short
cut: a stable sort of ordered keys is the identity or, for keys alone,
the reversal, so its bits are the same. Nor does the radix engine, for
the same reason: it computes no order flags.
"""

from __future__ import annotations

import torch

from ..config import Config, default_config, device_engine
from ..runtime.launcher import profiled
from ..utils.words import (NONDECREASING, NONINCREASING, SIGN, join64,
                           order_flags, split64)
from .capacity import check_device_bytes, network_bytes, radix_bytes
from .radix import RADIX_MAX_N, sort_kv_radix, sort_radix
from .sort_host import sort_host, sort_kv_host
from .sort_hybrid import (hybrid_bytes, refuse_capture, sort_hybrid,
                          sort_kv_hybrid)
from .sort_network import network_streams, sort_kv_network, sort_network

__all__ = ["sort", "sort_kv", "sort_engine"]

_KEYS32 = (torch.uint32, torch.int32, torch.float32)
# 16-bit keys widen exactly to their 32-bit counterpart.
_WIDEN = {torch.uint16: torch.uint32, torch.int16: torch.int32,
          torch.float16: torch.float32, torch.bfloat16: torch.float32}
_DTYPES64 = (torch.uint64, torch.int64, torch.float64)


def _check_key_dtype(dt: torch.dtype, what: str = "sort",
                     allow64: bool = False) -> None:
    """The key dtypes of ``sortx``'s ``_check_key_dtype``: 64-bit keys
    where ``allow64`` (``sort``, ``sort_kv``, ``argsort``, ``lexsort``)."""
    if dt in _KEYS32 or dt in _WIDEN:
        return
    if dt in _DTYPES64:
        if allow64:
            return
        raise TypeError(f"{what} does not support 64-bit keys (got {dt})")
    wide = " or 64-bit u64/i64/f64" if allow64 else ""
    raise TypeError(f"{what} supports u32/i32/f32 (or 16-bit "
                    f"u16/i16/f16/bf16{wide}) keys, got {dt}")


def _check_keys(keys: torch.Tensor, allow64: bool = False) -> None:
    if keys.dim() != 1:
        raise ValueError("sort expects a 1D key array")
    _check_key_dtype(keys.dtype, allow64=allow64)


def _resolve_sort_bits(keys: torch.Tensor, sort_bits: int | None,
                       what: str = "sort") -> int:
    """None -> the key dtype's full width (32 or 64); validate the
    explicit cases."""
    is64 = keys.dtype in _DTYPES64
    if sort_bits is None:
        return 64 if is64 else 32
    if is64:
        if sort_bits != 64:
            raise ValueError(f"{what}: 64-bit keys sort on the full 64 bits "
                             f"(sort_bits=64 or None), got {sort_bits}")
        return 64
    if not 1 <= sort_bits <= 32:
        raise ValueError("sort_bits must be in 1..32")
    if keys.dtype != torch.uint32 and sort_bits != 32:
        raise ValueError("partial sort_bits requires uint32 keys "
                         "(the reference's contract, Pprims.cpp:253)")
    return sort_bits


def _widen_float16(keys: torch.Tensor) -> torch.Tensor:
    """f16 / bf16 keys as float32, NaNs as ``sortx`` (XLA) widens them:
    bf16 by its bits shifted up, f16 NaNs quieted with their payload kept
    (torch's own conversion does neither)."""
    b = keys.view(torch.int16).to(torch.int32)
    if keys.dtype == torch.bfloat16:
        return (b << 16).view(torch.float32)
    nan = (b & SIGN) | 0x7FC00000 | ((b & 0x3FF) << 13)
    return torch.where(keys.isnan(), nan,
                       keys.to(torch.float32).view(torch.int32)
                       ).view(torch.float32)


def _narrow_float32(f: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """float32 values that are exact in ``dt`` (f16 / bf16) back to it,
    NaNs as XLA narrows them: bf16 to the quiet NaN of their sign, f16
    quieted with the top payload bits kept."""
    bits = f.view(torch.int32)
    nan = (bits >> 16) & 0x8000
    nan = nan | (0x7FC0 if dt == torch.bfloat16
                 else 0x7E00 | ((bits >> 13) & 0x3FF))
    out = torch.where(f.isnan(), nan,
                      f.to(dt).view(torch.int16).to(torch.int32))
    return out.to(torch.int16).view(dt)


def _to_radix_u32(keys: torch.Tensor):
    """Map keys to u32 words (int32) whose unsigned order is the keys'
    order. Returns (words, undo)."""
    dt = keys.dtype
    if dt == torch.uint16:
        k = keys.view(torch.int16).to(torch.int32) & 0xFFFF
        # back through the int16 of the same low bits
        return k, lambda u: (((u & 0xFFFF) ^ 0x8000) - 0x8000).to(
            torch.int16).view(torch.uint16)
    if dt in (torch.float16, torch.bfloat16):
        k, undo_wide = _to_radix_u32(_widen_float16(keys))
        return k, lambda u: _narrow_float32(undo_wide(u), dt)
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


def _to_radix_u64(keys: torch.Tensor):
    """Map 64-bit keys to (hi, lo) u32 words (int32) whose unsigned
    lexicographic order is the keys' order: u64 as they are, i64 with the
    top sign bit flipped, f64 by the f32 transform on the 64-bit image
    (all bits of negatives, the sign bit of the rest). Returns (hi, lo,
    undo) with undo(hi, lo) -> keys' dtype; the words are ``sortx``'s."""
    dt = keys.dtype
    hi, lo = split64(keys.view(torch.int64))
    if dt == torch.uint64:
        return hi, lo, lambda h, l: join64(h, l).view(torch.uint64)
    if dt == torch.int64:
        return hi ^ SIGN, lo, lambda h, l: join64(h ^ SIGN, l)
    neg = hi >> 31                     # all ones where the sign bit is set

    def undo(h, l):
        was_neg = ~h >> 31             # negatives map below the sign bit
        return join64(h ^ (was_neg | SIGN), l ^ was_neg).view(torch.float64)

    return hi ^ (neg | SIGN), lo ^ neg, undo


def _value_words(values: torch.Tensor):
    """Values as 32-bit word streams (int32): one word, or the (hi, lo)
    of a 64-bit value. Returns (tuple of words, undo(*words))."""
    size = values.element_size()
    if size == 8:
        return (split64(values.view(torch.int64)),
                lambda h, l: join64(h, l).view(values.dtype))
    if size == 4:
        return (values.view(torch.int32),), lambda w: w.view(values.dtype)
    narrow = {1: torch.int8, 2: torch.int16}[size]
    return ((values.view(narrow).to(torch.int32),),
            lambda w: w.to(narrow).view(values.dtype))


def sort_engine(cfg: Config, device_type: str, dtype: torch.dtype, n: int,
                *, stable: bool = True, value_words: int = 0) -> str:
    """The engine of a ``sort`` (``value_words`` 0) or ``sort_kv`` of n
    keys of ``dtype`` on a device of ``device_type``: "radix" where it is
    asked for, or under "auto" on a CUDA tensor for a stable sort, if the
    radix engine serves the call (keys of at most 32 bits, at most one
    value word, n < 2^30); otherwise the engine every op resolves to."""
    serves = (dtype not in _DTYPES64 and n < RADIX_MAX_N
              and value_words <= 1)
    if serves and (cfg.engine == "radix" or cfg.engine == "auto"
                   and device_type == "cuda" and stable):
        return "radix"
    return device_engine(cfg, device_type)


def _order_mask(sort_bits: int) -> int:
    """All ones over the participating key bits, as an int32 word."""
    return -1 if sort_bits >= 32 else (1 << sort_bits) - 1


def _sort_key(k: torch.Tensor, sort_bits: int) -> torch.Tensor:
    """The bits of the u32 words k that the sort orders by."""
    return k if sort_bits >= 32 else k & _order_mask(sort_bits)


def _order_on_host(k: torch.Tensor, sort_bits: int):
    """(nondecreasing, nonincreasing) of the sort key, read with one host
    sync: the hybrid engine's short cuts."""
    f = int(order_flags(_sort_key(k, sort_bits)))
    return bool(f & NONDECREASING), bool(f & NONINCREASING)


@profiled("sort")
def sort(keys: torch.Tensor, sort_bits: int | None = None, *,
         descending: bool = False, config: Config | None = None
         ) -> torch.Tensor:
    """Stable sort of 1-D keys by their low ``sort_bits`` bits.

    ``sort_bits=None`` means the full key width; partial widths need
    uint32 keys, and 64-bit keys sort on all 64. The result lives on the
    keys' device.
    """
    cfg = config or default_config()
    _check_keys(keys, allow64=True)
    sort_bits = _resolve_sort_bits(keys, sort_bits)
    n = keys.shape[0]
    if n <= 1:
        return keys
    if sort_bits == 64:
        from .extras import sort_u64_words

        hi, lo, undo64 = _to_radix_u64(keys.contiguous())
        return undo64(*sort_u64_words(hi, lo, descending, cfg))
    k, undo = _to_radix_u32(keys.contiguous())
    if descending:
        k = k ^ _order_mask(sort_bits)
    engine = sort_engine(cfg, keys.device.type, keys.dtype, n)
    if engine == "radix":
        check_device_bytes(radix_bytes(n, 1), keys.device, f"sort of n={n}")
        out = sort_radix(k, sort_bits)
    elif engine == "host":
        out = sort_host(k, sort_bits)
    elif engine == "hybrid":
        refuse_capture("sort")
        up, down = _order_on_host(k, sort_bits)
        if up:
            out = k
        elif down and sort_bits >= 32:
            out = k.flip(0)
        else:
            check_device_bytes(
                hybrid_bytes(n, 1 if sort_bits >= 32 else 2, cfg),
                keys.device, f"hybrid sort of n={n}")
            out = sort_hybrid(k, sort_bits, cfg)
    else:
        check_device_bytes(
            network_bytes(n, network_streams(n, sort_bits, False, True)),
            keys.device, f"sort of n={n}")
        out = sort_network(k, sort_bits, order_flags(_sort_key(k, sort_bits)))
    if descending:
        out = out ^ _order_mask(sort_bits)
    return undo(out)


@profiled("sort_kv")
def sort_kv(keys: torch.Tensor, values: torch.Tensor,
            sort_bits: int | None = None, *, stable: bool = True,
            descending: bool = False, config: Config | None = None):
    """Key-value sort on keys; values follow. Stable by default.

    ``stable=False`` lets the network drop its index stream; the order
    of values under equal keys is then unspecified.
    """
    cfg = config or default_config()
    _check_keys(keys, allow64=True)
    sort_bits = _resolve_sort_bits(keys, sort_bits)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    n = keys.shape[0]
    if n <= 1:
        return keys, values
    if sort_bits == 64:
        from .extras import sort_kv_u64_words

        hi, lo, undo64 = _to_radix_u64(keys.contiguous())
        h2, l2, vs = sort_kv_u64_words(hi, lo, values.contiguous(), stable,
                                       descending, cfg)
        return undo64(h2, l2), vs
    k, undo = _to_radix_u32(keys.contiguous())
    v, undo_v = _value_words(values.contiguous())
    if descending:
        k = k ^ _order_mask(sort_bits)
    engine = sort_engine(cfg, keys.device.type, keys.dtype, n,
                         stable=stable, value_words=len(v))
    if engine == "hybrid":
        refuse_capture("sort_kv")
    if engine == "radix":
        check_device_bytes(radix_bytes(n, 2), keys.device,
                           f"sort_kv of n={n}")
        ks, vs = sort_kv_radix(k, v[0], sort_bits)
        vs = (vs,)
    elif engine == "host" or (engine == "hybrid" and len(v) > 1):
        ks, vs = sort_kv_host(k, v, sort_bits)
    elif engine == "hybrid":
        if _order_on_host(k, sort_bits)[0]:
            ks, vs = k, v
        else:
            # always stable, whatever ``stable`` says
            check_device_bytes(
                hybrid_bytes(n, 2 if sort_bits >= 32 else 3, cfg),
                keys.device, f"hybrid sort_kv of n={n}")
            ks, vs = sort_kv_hybrid(k, v[0], sort_bits, cfg)
            vs = (vs,)
    else:
        check_device_bytes(
            network_bytes(n, network_streams(n, sort_bits, True, stable,
                                             len(v))),
            keys.device, f"sort_kv of n={n}")
        ks, vs = sort_kv_network(k, v, sort_bits, stable=stable,
                                 flags=order_flags(_sort_key(k, sort_bits)))
    if descending:
        ks = ks ^ _order_mask(sort_bits)
    return undo(ks), undo_v(*vs)
