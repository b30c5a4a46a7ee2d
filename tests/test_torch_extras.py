"""The port's 64-bit sorts, argsort, lexsort and sort_kv_u64 against
``sortx``, bit for bit.

The JAX side runs its host engine under a scoped ``jax_enable_x64`` (the
64-bit dtypes exist only there), restored after each use so that later
tests in the same worker keep 32-bit defaults. The port runs both of its
engines on CPU tensors: "host", and "network" (the plain versions of
K1-K3 at the wide stream sets of this slice). ``stable=False`` at
n = 2^k compares values as a multiset per key, as ``test_torch_sort.py``
does; everywhere else the comparator has no ties and outputs agree bit
for bit. Each wide stream set is also held against JAX's network in
interpret mode, at n <= 2^11.
"""

import contextlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sortx
import sortx_torch
from sortx.ops.bitonic import bitonic_sort_streams as jax_sort_streams
from sortx_torch.convert import to_numpy, to_torch
from sortx_torch.ops import bitonic as tb

HOST = sortx.Config(engine="host")
ENGINES = ["host", "network"]
N = 3000                      # ragged: the network pads to 4096


@contextlib.contextmanager
def x64():
    """Scoped x64 mode, restored on exit."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _keys64(rng, dtype, n=N):
    """Duplicate-heavy 64-bit keys with the dtype's extremes (and for
    f64 signed zeros, infinities and NaNs of both signs and payloads)."""
    if dtype == np.uint64:
        k = (rng.randint(0, 40, size=n).astype(np.uint64) << np.uint64(31)) \
            | rng.randint(0, 3, size=n).astype(np.uint64)
        k[rng.randint(0, n, 9)] = np.iinfo(np.uint64).max
        return k
    if dtype == np.int64:
        k = rng.randint(-20, 20, size=n).astype(np.int64) * 3_000_000_019
        k[rng.randint(0, n, 9)] = np.iinfo(np.int64).min
        k[rng.randint(0, n, 9)] = np.iinfo(np.int64).max
        return k
    f = np.round(rng.randn(n) * 8) / 4
    f[rng.randint(0, n, 9)] = -0.0
    f[rng.randint(0, n, 9)] = np.inf
    f[rng.randint(0, n, 9)] = -np.inf
    f[rng.randint(0, n, 9)] = 5e-324
    bits = f.view(np.uint64)
    bits[rng.randint(0, n, 9)] = 0x7FF8000000000001
    bits[rng.randint(0, n, 9)] = 0xFFF8000000000000
    return f


def _keys32(rng, dtype, n=N):
    if dtype == np.uint32:
        k = (rng.randint(0, 97, size=n) * 0x01000193).astype(np.uint32)
        k[rng.randint(0, n, 20)] = 0xFFFFFFFF
        return k
    if dtype in (np.int32, np.uint16, np.int16):
        return rng.randint(-40, 40, size=n).astype(dtype)
    f = np.round(rng.randn(n) * 8).astype(np.float32)
    f[rng.randint(0, n, 9)] = -0.0
    f.view(np.uint32)[rng.randint(0, n, 9)] = 0x7FC00001
    return f.astype(dtype)


def _same(got, want):
    want = np.asarray(want)
    got = to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _cfg(engine):
    return sortx_torch.Config(engine=engine)


DTYPES64 = [np.uint64, np.int64, np.float64]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES64, ids=lambda d: np.dtype(d).name)
def test_sort_64bit_keys(rng, dtype, descending):
    k = _keys64(rng, dtype)
    with x64():
        want = np.asarray(sortx.sort(jnp.asarray(k), descending=descending,
                                     config=HOST))
    for engine in ENGINES:
        _same(sortx_torch.sort(to_torch(k), descending=descending,
                               config=_cfg(engine)), want)


@pytest.mark.parametrize("vdtype", [np.uint32, np.int64],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("dtype", DTYPES64, ids=lambda d: np.dtype(d).name)
def test_sort_kv_64bit_keys(rng, dtype, vdtype):
    """Stable: (hi, lo, idx, value) at (4, 3) for 32-bit values; 64-bit
    values take the host path, as in sortx."""
    k = _keys64(rng, dtype)
    v = (np.arange(N) * 7919).astype(vdtype)
    with x64():
        want = [np.asarray(w) for w in sortx.sort_kv(
            jnp.asarray(k), jnp.asarray(v), descending=True, config=HOST)]
    for engine in ENGINES:
        got = sortx_torch.sort_kv(to_torch(k), to_torch(v), descending=True,
                                  config=_cfg(engine))
        for g, w in zip(got, want):
            _same(g, w)


def _i64(a):
    """The bits of 64-bit arrays, the values of narrower ones, as int64."""
    a = np.asarray(a)
    return a.view(np.int64) if a.itemsize == 8 else a.astype(np.int64)


def _pairs(k, v):
    """(key, value) pairs as int64 rows, sorted: a multiset."""
    p = np.stack([_i64(k), _i64(v)], 1)
    return p[np.lexsort((p[:, 1], p[:, 0]))]


@pytest.mark.parametrize("n", [1 << 12, N])
@pytest.mark.parametrize("dtype", [np.uint64, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_sort_kv_64bit_keys_unstable(rng, dtype, n):
    """(hi, lo, value): 2 keys at 2^12, 3 at ragged n. Keys bit for bit,
    values as a multiset per key."""
    k = _keys64(rng, dtype, n)
    v = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    with x64():
        wk, wv = (np.asarray(w) for w in sortx.sort_kv(
            jnp.asarray(k), jnp.asarray(v), stable=False, config=HOST))
    for engine in ENGINES:
        gk, gv = sortx_torch.sort_kv(to_torch(k), to_torch(v), stable=False,
                                     config=_cfg(engine))
        _same(gk, wk)
        np.testing.assert_array_equal(_pairs(to_numpy(gk), to_numpy(gv)),
                                      _pairs(wk, wv))


@pytest.mark.parametrize("sort_bits", [None, 4, 24])
@pytest.mark.parametrize("vdtype", DTYPES64, ids=lambda d: np.dtype(d).name)
def test_sort_kv_64bit_values(rng, vdtype, sort_bits):
    """64-bit values as (hi, lo) words: stable (key, idx, hi, lo) at
    (4, 2), packed partial bits at (4, 1), partial bits at (5, 2)."""
    n = 1 << 12
    k = _keys32(rng, np.uint32, n)
    v = _keys64(rng, vdtype, n)
    with x64():
        want = [np.asarray(w) for w in sortx.sort_kv(
            jnp.asarray(k), jnp.asarray(v), sort_bits, config=HOST)]
    for engine in ENGINES:
        got = sortx_torch.sort_kv(to_torch(k), to_torch(v), sort_bits,
                                  config=_cfg(engine))
        for g, w in zip(got, want):
            _same(g, w)


def test_sort_kv_64bit_values_unstable(rng):
    k = _keys32(rng, np.uint32)
    v = _keys64(rng, np.int64)
    with x64():
        wk, wv = (np.asarray(w) for w in sortx.sort_kv(
            jnp.asarray(k), jnp.asarray(v), stable=False, config=HOST))
    for engine in ENGINES:
        gk, gv = sortx_torch.sort_kv(to_torch(k), to_torch(v), stable=False,
                                     config=_cfg(engine))
        _same(gk, wk)
        np.testing.assert_array_equal(_pairs(to_numpy(gk), to_numpy(gv)),
                                      _pairs(wk, wv))


def test_64bit_sort_bits_errors(rng):
    k = to_torch(_keys64(rng, np.uint64, 16))
    for fn in (lambda: sortx_torch.sort(k, 32),
               lambda: sortx_torch.sort_kv(k, k, 16),
               lambda: sortx_torch.argsort(k, 8)):
        with pytest.raises(ValueError, match="full 64"):
            fn()
    _same(sortx_torch.sort(k, 64), np.sort(to_numpy(k)))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.uint16, ml_dtypes.bfloat16] + DTYPES64,
                         ids=lambda d: np.dtype(d).name)
def test_argsort(rng, dtype, descending):
    k = (_keys64(rng, dtype) if dtype in DTYPES64
         else _keys32(rng, dtype) if dtype != ml_dtypes.bfloat16
         else _keys32(rng, np.float32).astype(dtype))
    with x64():
        want = np.asarray(sortx.argsort(jnp.asarray(k), descending=descending,
                                        config=HOST))
    for engine in ENGINES:
        _same(sortx_torch.argsort(to_torch(k), descending=descending,
                                  config=_cfg(engine)), want)


def test_argsort_partial_bits_and_tiny(rng):
    k = _keys32(rng, np.uint32)
    want = sortx.argsort(jnp.asarray(k), 4, config=HOST)
    for engine in ENGINES:
        cfg = _cfg(engine)
        _same(sortx_torch.argsort(to_torch(k), 4, config=cfg), want)
        for n in (0, 1):
            _same(sortx_torch.argsort(to_torch(k[:n]), config=cfg),
                  sortx.argsort(jnp.asarray(k[:n]), config=HOST))
        # presorted keys: the identity, without the network
        _same(sortx_torch.argsort(to_torch(np.sort(k)), config=cfg),
              np.arange(N, dtype=np.int32))


LEX_CASES = {
    "one_u32": [np.uint32],
    "u32_i32_f64": [np.uint32, np.int32, np.float64],      # (5, 5)
    "mixed_16bit": [np.uint16, np.float32, np.int16],
    "seven_u32": [np.uint32] * 7,                         # (8, 8)
    "eight_u32_host": [np.uint32] * 8,                    # 9 streams: host
    "two_u64": [np.uint64, np.int64],                     # (5, 5)
}


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("case", LEX_CASES)
def test_lexsort(rng, case, descending):
    cols = []
    for dt in LEX_CASES[case]:
        c = (_keys64(rng, dt) if dt in DTYPES64 else _keys32(rng, dt))
        cols.append(c % 3 if dt in (np.uint32, np.int32) else c)
    with x64():
        want = np.asarray(sortx.lexsort([jnp.asarray(c) for c in cols],
                                        descending=descending, config=HOST))
    for engine in ENGINES:
        _same(sortx_torch.lexsort([to_torch(c) for c in cols],
                                  descending=descending, config=_cfg(engine)),
              want)


@pytest.mark.parametrize("cols, err", [
    ([], ValueError),
    ([np.zeros(4, np.uint32), np.zeros(5, np.uint32)], ValueError),
    ([np.zeros((2, 2), np.uint32)], ValueError),
    ([np.zeros(4, np.int8)], TypeError),
], ids=["empty", "lengths", "2d", "int8"])
def test_lexsort_errors(cols, err):
    with pytest.raises(err):
        sortx.lexsort([jnp.asarray(c) for c in cols], config=HOST)
    with pytest.raises(err):
        sortx_torch.lexsort([to_torch(c) for c in cols])


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("n", [1 << 12, N])
def test_sort_kv_u64(rng, n, stable, descending):
    hi = (rng.randint(0, 9, size=n) * 0x10000001).astype(np.uint32)
    lo = (rng.randint(0, 5, size=n) * 0x3000001).astype(np.uint32)
    lo[::11] = 0xFFFFFFFF
    hi[::13] = 0xFFFFFFFF
    v = rng.randint(0, 2**32, size=n, dtype=np.uint32).view(np.float32)
    want = sortx.sort_kv_u64(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(v),
                             stable=stable, descending=descending,
                             config=HOST)
    for engine in ENGINES:
        got = sortx_torch.sort_kv_u64(to_torch(hi), to_torch(lo), to_torch(v),
                                      stable=stable, descending=descending,
                                      config=_cfg(engine))
        _same(got[0], want[0])
        _same(got[1], want[1])
        if stable:
            _same(got[2], want[2])
        else:
            key = (np.asarray(want[0]).astype(np.uint64) << np.uint64(32)) \
                | np.asarray(want[1])
            np.testing.assert_array_equal(
                _pairs(key, to_numpy(got[2]).view(np.uint32)),
                _pairs(key, np.asarray(want[2]).view(np.uint32)))


def test_sort_kv_u64_errors():
    a = to_torch(np.zeros(4, np.uint32))
    with pytest.raises(TypeError):
        sortx_torch.sort_kv_u64(a.view(torch.int32), a, a)
    with pytest.raises(ValueError):
        sortx_torch.sort_kv_u64(a, a, a[:3])


@pytest.mark.parametrize("vdtype", [np.int64, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_sort_kv_rows_64bit_values(rng, vdtype):
    """Row sorts carry a 64-bit value as two word streams, (key, pos, hi,
    lo) in rows mode."""
    k = _keys32(rng, np.float32, 6 * 700).reshape(6, 700)
    v = _keys64(rng, vdtype, 6 * 700).reshape(6, 700)
    with x64():
        want = [np.asarray(w) for w in sortx.sort_kv_rows(
            jnp.asarray(k), jnp.asarray(v), descending=True, config=HOST)]
    for engine in ENGINES:
        got = sortx_torch.sort_kv_rows(to_torch(k), to_torch(v),
                                       descending=True, config=_cfg(engine))
        for g, w in zip(got, want):
            _same(g, w)


# --- the wide stream sets against JAX's network in interpret mode --------

WIDE = [(3, 3, 2048), (4, 3, 1024), (5, 2, 1024), (4, 4, 1024),
        (5, 5, 2048), (6, 6, 1024), (7, 7, 1024), (8, 8, 1024)]


@pytest.mark.parametrize("ns, nk, n", WIDE, ids=lambda v: str(v))
def test_wide_stream_sets_match_jax_interpret(rng, ns, nk, n):
    """Each wide set as its op builds it: duplicate-heavy key words, a
    tie-free last key (the idx stream), ragged n. JAX's blocks are 2^10
    (K1 only at 1024; K3 and K2 at 2048), the port's its own."""
    nv = n - 77
    streams = np.full((ns, n), 0xFFFFFFFF, np.uint32)
    for t in range(ns):
        streams[t, :nv] = rng.randint(0, 3, size=nv).astype(np.uint32) << 31
    streams[nk - 1, :nv] = rng.permutation(nv).astype(np.uint32)
    lb = 10 + ns.bit_length() - 1          # JAX's block is then 2^10
    out = jax_sort_streams(tuple(jnp.asarray(s) for s in streams), nk,
                           interpret=True, log_block=lb, n_valid=nv)
    want = np.stack([np.asarray(o) for o in out])
    x = to_torch(streams).view(torch.int32)
    tb.bitonic_sort_streams(x, nk, n_valid=nv)
    np.testing.assert_array_equal(to_numpy(x.view(torch.uint32)), want)


# --- convert: 64-bit dtypes cross bit-exactly -----------------------------

def test_convert_round_trips_64bit_extremes():
    u = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1],
                 np.uint64)
    i = np.array([0, -1, 1, -2**63, 2**63 - 1, 2**32, -2**32], np.int64)
    f = np.array([0.0, -0.0, np.inf, -np.inf, 5e-324, -1.5, np.nan])
    f.view(np.uint64)[-1] = 0xFFF8000000000123     # a negative NaN payload
    for a in (u, i, f):
        t = to_torch(a)
        assert t.dtype == {np.uint64: torch.uint64, np.int64: torch.int64,
                           np.float64: torch.float64}[a.dtype.type]
        back = to_numpy(t)
        assert back.dtype == a.dtype
        np.testing.assert_array_equal(back.view(np.uint64), a.view(np.uint64))
        net = sortx_torch.sort(t, config=_cfg("network"))
        _same(net, to_numpy(sortx_torch.sort(t, config=_cfg("host"))))
        if a.dtype != np.float64:
            _same(net, np.sort(a))
