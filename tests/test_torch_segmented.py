"""The port's segmented sorts and scans against ``sortx``, bit for bit.

``sort_segments`` and ``sort_kv_segments`` run one (segment id, key)
sort: ``sort_u64`` at stream set (2, 2) and the stable ``sort_kv_u64``
at (4, 3) on the port's network, its word passes or its multi-word host
sort otherwise. ``scan_segments`` and ``scan_by_key`` take K4's flat
scan minus its value at each segment's start, where ``sortx`` runs an
associative scan; both are mod 2^32 and must agree bit for bit. Offsets
include empty segments, at the ends too.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sortx
import sortx_torch
from sortx_torch.convert import to_numpy, to_torch

HOST = sortx.Config(engine="host")
ENGINES = ["host", "network"]
N = 3000


def _same(got, want):
    want = np.asarray(want)
    got = to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _cfg(engine):
    return sortx_torch.Config(engine=engine)


def _offsets(rng, n, segments=40):
    """S + 1 CUB-style offsets over n: ragged, with empty segments at
    both ends and inside."""
    cuts = np.sort(rng.randint(0, n + 1, size=segments - 3))
    return np.concatenate([[0, 0], cuts, cuts[-1:], [n, n]]).astype(np.int32)


def _keys(rng, dtype, n=N):
    if dtype == np.uint32:
        k = (rng.randint(0, 50, size=n) * 0x03000007).astype(np.uint32)
        k[::17] = 0xFFFFFFFF
        return k
    if dtype in (np.int32, np.int16):
        return rng.randint(-25, 25, size=n).astype(dtype)
    f = (rng.randint(-25, 25, size=n) / 2).astype(np.float32)
    f[::19] = -0.0
    f.view(np.uint32)[::23] = 0xFFC00001
    return f.astype(dtype)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32, np.int16,
                                   ml_dtypes.bfloat16],
                         ids=lambda d: np.dtype(d).name)
def test_sort_segments(rng, dtype, descending):
    k = _keys(rng, dtype)
    for n in (N, 1, 0):
        off = _offsets(rng, n)
        want = sortx.sort_segments(jnp.asarray(k[:n]), jnp.asarray(off),
                                   descending=descending, config=HOST)
        for engine in ENGINES:
            _same(sortx_torch.sort_segments(to_torch(k[:n]),
                                            torch.from_numpy(off),
                                            descending=descending,
                                            config=_cfg(engine)), want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("vdtype", [np.uint32, np.float32, np.int16],
                         ids=lambda d: np.dtype(d).name)
def test_sort_kv_segments(rng, vdtype, descending):
    """Stable within each segment: (segment, key, idx, value) at (4, 3)
    for 32-bit values, the host path for the others."""
    k = _keys(rng, np.float32)
    v = (np.arange(N) * 3 - 999).astype(vdtype)
    off = _offsets(rng, N)
    want = sortx.sort_kv_segments(jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(off), descending=descending,
                                  config=HOST)
    for engine in ENGINES:
        got = sortx_torch.sort_kv_segments(to_torch(k), to_torch(v),
                                           torch.from_numpy(off),
                                           descending=descending,
                                           config=_cfg(engine))
        _same(got[0], want[0])
        _same(got[1], want[1])


def test_segmented_errors():
    k = to_torch(np.arange(4, dtype=np.uint32))
    for call, err in (
            (lambda: sortx_torch.sort_segments(k, torch.tensor([4])),
             ValueError),
            (lambda: sortx_torch.sort_segments(k, torch.zeros(2, 2)),
             ValueError),
            (lambda: sortx_torch.sort_segments(k.to(torch.int8),
                                               torch.tensor([0, 4])),
             TypeError),
            (lambda: sortx_torch.sort_kv_segments(k, k[:3],
                                                  torch.tensor([0, 4])),
             ValueError)):
        with pytest.raises(err):
            call()


def _words(rng, dtype, n=N):
    """Words near 2^31 in magnitude, so the sums wrap."""
    v = rng.randint(2**30, 2**31, size=n).astype(np.int64)
    v[::3] *= -1
    return v.astype(np.int32).view(dtype)


@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32],
                         ids=lambda d: np.dtype(d).name)
def test_scan_segments(rng, dtype, inclusive):
    x = _words(rng, dtype)
    for n in (N, 1, 0):
        off = _offsets(rng, n)
        for totals in (False, True):
            want = sortx.scan_segments(jnp.asarray(x[:n]), jnp.asarray(off),
                                       with_totals=totals,
                                       inclusive=inclusive, config=HOST)
            want = want if totals else (want,)
            for engine in ENGINES:
                got = sortx_torch.scan_segments(
                    to_torch(x[:n]), torch.from_numpy(off),
                    with_totals=totals, inclusive=inclusive,
                    config=_cfg(engine))
                got = got if totals else (got,)
                for g, w in zip(got, want):
                    _same(g, w)


@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("kdtype", [np.uint32, np.float32, np.int16,
                                    np.float16],
                         ids=lambda d: np.dtype(d).name)
def test_scan_by_key(rng, kdtype, inclusive):
    """Runs of equal consecutive keys by value: NaNs never equal, -0.0
    equals +0.0, a key that comes back starts a new run."""
    k = np.repeat(_keys(rng, kdtype), rng.randint(1, 4, size=N))[:N]
    if kdtype in (np.float32, np.float16):
        k[100:110] = 0.0
        k[105:108] = -0.0
        k[200:210] = np.nan
    x = _words(rng, np.uint32)
    for n in (N, 1, 0):
        want = sortx.scan_by_key(jnp.asarray(k[:n]), jnp.asarray(x[:n]),
                                 inclusive=inclusive)
        for engine in ENGINES:
            _same(sortx_torch.scan_by_key(to_torch(k[:n]), to_torch(x[:n]),
                                          inclusive=inclusive,
                                          config=_cfg(engine)), want)


def test_segscan_errors():
    x = to_torch(np.arange(4, dtype=np.int32))
    for call, err in (
            (lambda: sortx_torch.scan_segments(x.float(),
                                               torch.tensor([0, 4])),
             TypeError),
            (lambda: sortx_torch.scan_segments(x.view(2, 2),
                                               torch.tensor([0, 4])),
             ValueError),
            (lambda: sortx_torch.scan_segments(x, torch.tensor([0])),
             ValueError),
            (lambda: sortx_torch.scan_by_key(x, x.float()), TypeError),
            (lambda: sortx_torch.scan_by_key(x, x[:3]), ValueError)):
        with pytest.raises(err):
            call()


@pytest.mark.parametrize("kdtype", [np.float32, np.float64, np.float16,
                                    ml_dtypes.bfloat16],
                         ids=lambda d: np.dtype(d).name)
def test_scan_by_key_subnormal_keys(kdtype):
    """Subnormal float keys group as ``sortx`` groups them under XLA:
    f32, f64 and bf16 subnormals equal zero (flushed), f16 ones keep
    their values (compared as f32, where they are normal). The first
    case is the minimal input of the fault: f32 keys of bits
    [0, 0, 1, 1, 2, 5, 5], values of 1, where the reference gives
    [0, 1, ..., 6]."""
    ints = {2: np.uint16, 4: np.uint32,
            8: np.uint64}[np.dtype(kdtype).itemsize]
    sign = ints(1) << ints(8 * np.dtype(ints).itemsize - 1)
    x = np.ones(7, np.int32)
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", kdtype == np.float64)
    try:
        for bits in ([0, 0, 1, 1, 2, 5, 5],
                     [0, sign, sign | 1, 1, 7, sign | 3, 0]):
            k = np.asarray(bits, ints).view(kdtype)
            want = sortx.scan_by_key(jnp.asarray(k), jnp.asarray(x))
            if kdtype == np.float32 and bits[1] == 0:
                np.testing.assert_array_equal(np.asarray(want), np.arange(7))
            for engine in ENGINES:
                _same(sortx_torch.scan_by_key(to_torch(k), to_torch(x),
                                              config=_cfg(engine)), want)
    finally:
        jax.config.update("jax_enable_x64", old)
