"""The port's keyed ops and unique against ``sortx``, bit for bit.

``partition``, ``reduce_by_key``, ``sum_by_key``, ``run_length_encode``,
``searchsorted``, ``is_sorted`` and ``unique``. ``sortx`` compacts with a
1-bit ``sort_kv``; the port with flags, K4's scan and a scatter into a
``size + 1`` buffer. The fixed-``size`` outputs, ``num_*``, the fill
rules and the run sums mod 2^32 must agree bit for bit, on both of the
port's engines ("host", and "network": the plain K1-K4). Equality of
keys is bitwise on the radix image: -0.0 and +0.0 differ, and NaNs of
the same bits are one key.
"""

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
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8),
                                  np.atleast_1d(want).view(np.uint8))


def _same_all(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def _cfg(engine):
    return sortx_torch.Config(engine=engine)


def _keys(rng, dtype, n=N, distinct=40):
    """Run-heavy keys of ``dtype``: few distinct values, each repeated in
    runs, with float signed zeros and NaNs of two payloads."""
    base = rng.randint(0, distinct, size=n)
    runs = np.repeat(base, rng.randint(1, 5, size=n))[:n]
    if dtype == np.uint32:
        return (runs * 0x05000011).astype(np.uint32)
    if dtype in (np.int32, np.int16, np.uint16):
        return (runs - distinct // 2).astype(dtype)
    f = ((runs - distinct // 2) / 4).astype(np.float32)
    f[runs == 3] = -0.0
    f[runs == 5] = 0.0
    bits = f.view(np.uint32)
    bits[runs == 7] = 0x7FC00001
    bits[runs == 9] = 0xFFC00000
    return f.astype(dtype)


KEY_DTYPES = [np.uint32, np.int32, np.float32, np.uint16, np.int16,
              ml_dtypes.bfloat16]


def _values(rng, dtype, n=N):
    """Values near 2^31 in magnitude, so run sums wrap."""
    v = rng.randint(2**30, 2**31, size=n).astype(np.int64)
    v[::3] *= -1
    return v.astype(np.int32).view(dtype)


# --- partition --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint32, np.float32, np.int16, np.int8,
                                   np.int64], ids=lambda d: np.dtype(d).name)
def test_partition(rng, dtype):
    x = rng.randint(-100, 100, size=N).astype(dtype)
    for n in (0, 1, N):
        mask = rng.rand(n) < 0.3
        want = sortx.partition(jnp.asarray(x[:n]), jnp.asarray(mask),
                               config=HOST) if dtype != np.int64 else (
            np.concatenate([x[:n][mask], x[:n][~mask]]),
            np.int32(mask.sum()))
        for engine in ENGINES:
            _same_all(sortx_torch.partition(to_torch(x[:n]),
                                            torch.from_numpy(mask),
                                            config=_cfg(engine)), want)


def test_partition_errors():
    x = to_torch(np.arange(4, dtype=np.uint32))
    for mask, err in ((torch.ones(4, dtype=torch.int32), TypeError),
                      (torch.ones(3, dtype=torch.bool), ValueError)):
        with pytest.raises(err):
            sortx_torch.partition(x, mask)
    with pytest.raises(ValueError):
        sortx_torch.partition(x.view(2, 2), torch.ones(2, 2, dtype=bool))


# --- reduce_by_key / run_length_encode / sum_by_key -------------------------

@pytest.mark.parametrize("vdtype", [np.int32, np.uint32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("dtype", KEY_DTYPES, ids=lambda d: np.dtype(d).name)
def test_reduce_by_key(rng, dtype, vdtype):
    k = _keys(rng, dtype)
    v = _values(rng, vdtype)
    for size, fill in ((5000, None), (64, None), (1, None), (64, 7)):
        want = sortx.reduce_by_key(jnp.asarray(k), jnp.asarray(v), size,
                                   fill_value=fill, config=HOST)
        for engine in ENGINES:
            _same_all(sortx_torch.reduce_by_key(
                to_torch(k), to_torch(v), size, fill_value=fill,
                config=_cfg(engine)), want)


@pytest.mark.parametrize("dtype", KEY_DTYPES, ids=lambda d: np.dtype(d).name)
def test_run_length_encode(rng, dtype):
    k = _keys(rng, dtype)
    for n, size, fill in ((N, 5000, None), (N, 50, None), (N, 50, 2),
                          (1, 3, None), (0, 4, None), (0, 4, 9)):
        want = sortx.run_length_encode(jnp.asarray(k[:n]), size,
                                       fill_value=fill, config=HOST)
        for engine in ENGINES:
            _same_all(sortx_torch.run_length_encode(
                to_torch(k[:n]), size, fill_value=fill,
                config=_cfg(engine)), want)


@pytest.mark.parametrize("n", [1 << 12, N, 1, 0])
@pytest.mark.parametrize("dtype", [np.uint32, np.float32, np.int16],
                         ids=lambda d: np.dtype(d).name)
def test_sum_by_key(rng, dtype, n):
    """The grouping sort runs stable=False (at 2^12 with one key on the
    network); the sums do not depend on the order within a key."""
    k = rng.permutation(_keys(rng, dtype, max(n, 1)))[:n]
    v = _values(rng, np.int32, n)
    for size in (100, 7):
        want = sortx.sum_by_key(jnp.asarray(k), jnp.asarray(v), size,
                                config=HOST)
        for engine in ENGINES:
            _same_all(sortx_torch.sum_by_key(to_torch(k), to_torch(v), size,
                                             config=_cfg(engine)), want)


@pytest.mark.parametrize("fn", ["reduce_by_key", "sum_by_key"])
def test_reduce_errors(fn):
    k = to_torch(np.arange(4, dtype=np.uint32))
    for args, err in (((k, k.view(torch.float32), 4), TypeError),
                      ((k, k[:3], 4), ValueError),
                      ((k, k, 0), ValueError),
                      ((k.view(torch.int32).to(torch.int8), k, 4),
                       TypeError)):
        with pytest.raises(err):
            getattr(sortx, fn)(*(jnp.asarray(to_numpy(a))
                                 if torch.is_tensor(a) else a for a in args),
                               config=HOST)
        with pytest.raises(err):
            getattr(sortx_torch, fn)(*args)


# --- searchsorted / is_sorted -----------------------------------------------

@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.float16], ids=lambda d: np.dtype(d).name)
def test_searchsorted(rng, dtype, side):
    hay = np.asarray(sortx.sort(jnp.asarray(_keys(rng, dtype)),
                                config=HOST))
    q = _keys(rng, dtype, 500, distinct=60)
    want = sortx.searchsorted(jnp.asarray(hay), jnp.asarray(q), side=side)
    _same(sortx_torch.searchsorted(to_torch(hay), to_torch(q), side=side),
          want)


def test_searchsorted_errors():
    a = to_torch(np.arange(4, dtype=np.uint32))
    for call, err in (
            (lambda: sortx_torch.searchsorted(a, a, side="mid"), ValueError),
            (lambda: sortx_torch.searchsorted(a, a.view(torch.int32)),
             TypeError),
            (lambda: sortx_torch.searchsorted(a, a.view(2, 2)), ValueError)):
        with pytest.raises(err):
            call()


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   ml_dtypes.bfloat16],
                         ids=lambda d: np.dtype(d).name)
def test_is_sorted(rng, dtype):
    k = _keys(rng, dtype)
    asc = np.asarray(sortx.sort(jnp.asarray(k), config=HOST))
    desc = np.asarray(sortx.sort(jnp.asarray(k), descending=True,
                                 config=HOST))
    for x in (k, asc, desc, k[:1], k[:0]):
        for descending in (False, True):
            got = sortx_torch.is_sorted(to_torch(x), descending=descending)
            assert got.dim() == 0
            assert bool(got) == bool(sortx.is_sorted(
                jnp.asarray(x), descending=descending))


# --- unique -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", KEY_DTYPES, ids=lambda d: np.dtype(d).name)
def test_unique(rng, dtype):
    k = rng.permutation(_keys(rng, dtype))
    for n, size, fill in ((N, 5000, None), (N, 20, None), (N, 20, 3),
                          (1, 2, None), (0, 3, None), (0, 3, 1)):
        want = sortx.unique(jnp.asarray(k[:n]), size, fill_value=fill,
                            config=HOST)
        for engine in ENGINES:
            _same_all(sortx_torch.unique(to_torch(k[:n]), size,
                                         fill_value=fill,
                                         config=_cfg(engine)), want)


def test_unique_assume_sorted(rng):
    k = np.sort(_keys(rng, np.int32))
    want = sortx.unique(jnp.asarray(k), 100, assume_sorted=True, config=HOST)
    for engine in ENGINES:
        _same_all(sortx_torch.unique(to_torch(k), 100, assume_sorted=True,
                                     config=_cfg(engine)), want)


def test_unique_merges_nans_of_the_same_bits():
    """``sortx``'s code (not its docstring) merges NaNs of the same bits:
    [nan, nan, 1, -0., 0.] has 4 distinct values, the NaN twice."""
    x = np.array([np.nan, np.nan, 1.0, -0.0, 0.0], np.float32)
    want = sortx.unique(jnp.asarray(x), 6, config=HOST)
    assert int(want[2]) == 4
    for engine in ENGINES:
        vals, counts, num = sortx_torch.unique(to_torch(x), 6,
                                               config=_cfg(engine))
        _same_all((vals, counts, num), want)
        assert num.dim() == 0 and int(num) == 4
        assert to_numpy(counts).tolist() == [1, 1, 1, 2, 0, 0]


def test_unique_errors():
    x = to_torch(np.arange(4, dtype=np.uint32))
    with pytest.raises(ValueError):
        sortx_torch.unique(x, 0)
    with pytest.raises(TypeError):
        sortx_torch.unique(x.to(torch.int8), 4)
    with pytest.raises(ValueError):
        sortx_torch.unique(x.view(2, 2), 4)
