"""The port's sort and sort_kv against ``sortx``'s host engine.

Both of the port's engines run on CPU tensors: "host" (stable
``torch.sort``) and "network" (the bitonic network on the plain
versions of K1-K3). Outputs must match bit for bit, except the values of
``stable=False`` sorts, whose order under equal keys is unspecified:
those are compared as a multiset of (key, value) pairs.
"""

import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import sortx
import sortx_torch
from sortx_torch.convert import to_numpy, to_torch
from sortx_torch.ops.sort_network import packed_partial

HOST = sortx.Config(engine="host")
ENGINES = ["host", "network"]


def _keys(rng, dtype, n):
    """Duplicate-heavy keys of ``dtype`` with the dtype's extremes."""
    if dtype == np.uint32:
        k = (rng.randint(0, 97, size=n) * 0x01000193).astype(np.uint32)
        k[rng.randint(0, n, n // 16)] = 0xFFFFFFFF
        return k
    if dtype == np.int32:
        k = (rng.randint(-50, 50, size=n) * 40_000_003).astype(np.int32)
        k[rng.randint(0, n, 20)] = np.iinfo(np.int32).min
        k[rng.randint(0, n, 20)] = np.iinfo(np.int32).max
        return k
    if dtype in (np.uint16, np.int16):
        info = np.iinfo(dtype)
        return rng.randint(info.min, info.max + 1, size=n).astype(dtype)
    f = np.round(rng.randn(n) * 8).astype(np.float32)
    f[rng.randint(0, n, 20)] = -0.0
    f[rng.randint(0, n, 20)] = np.inf
    f[rng.randint(0, n, 20)] = -np.inf
    if dtype == np.float32:   # NaNs of both signs and several payloads
        bits = f.view(np.uint32)
        bits[rng.randint(0, n, 20)] = 0x7FC00001
        bits[rng.randint(0, n, 20)] = 0xFFC00000
        bits[rng.randint(0, n, 20)] = 0x7F800123
        return f
    return f.astype(dtype)


def _same(got, want):
    want = np.asarray(want)
    got = to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


KEY_DTYPES = [np.uint32, np.int32, np.float32, np.uint16, np.int16,
              np.float16, ml_dtypes.bfloat16]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", KEY_DTYPES,
                         ids=lambda d: np.dtype(d).name)
def test_sort_key_dtypes(rng, dtype, descending):
    k = _keys(rng, dtype, 3000)
    want = sortx.sort(jnp.asarray(k), descending=descending, config=HOST)
    for engine in ENGINES:
        _same(sortx_torch.sort(to_torch(k), descending=descending,
                               config=sortx_torch.Config(engine=engine)),
              want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.int16],
                         ids=lambda d: np.dtype(d).name)
def test_sort_kv_stable_key_dtypes(rng, dtype, descending):
    k = _keys(rng, dtype, 3000)
    v = np.arange(3000, dtype=np.uint32)
    want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v),
                         descending=descending, config=HOST)
    for engine in ENGINES:
        got = sortx_torch.sort_kv(to_torch(k), to_torch(v),
                                  descending=descending,
                                  config=sortx_torch.Config(engine=engine))
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("vdtype", [np.float32, np.int32, np.int16],
                         ids=lambda d: np.dtype(d).name)
def test_sort_kv_value_dtypes(rng, vdtype):
    k = _keys(rng, np.uint32, 2500)
    v = (rng.randn(2500) * 1000).astype(vdtype)
    want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), config=HOST)
    for engine in ENGINES:
        got = sortx_torch.sort_kv(to_torch(k), to_torch(v),
                                  config=sortx_torch.Config(engine=engine))
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("sort_bits", [4, 24])
def test_partial_sort_bits(rng, sort_bits, kv):
    """4 bits at 2^12 packs the index into the key; 24 bits cannot."""
    n = 1 << 12
    assert packed_partial(n, sort_bits) == (sort_bits == 4)
    k = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    k[rng.randint(0, n, 50)] = 0xFFFFFFFF
    v = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    for engine in ENGINES:
        cfg = sortx_torch.Config(engine=engine)
        if kv:
            want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), sort_bits,
                                 config=HOST)
            got = sortx_torch.sort_kv(to_torch(k), to_torch(v), sort_bits,
                                      config=cfg)
            for g, w in zip(got, want):
                _same(g, w)
        else:
            want = sortx.sort(jnp.asarray(k), sort_bits, config=HOST)
            _same(sortx_torch.sort(to_torch(k), sort_bits, config=cfg), want)


def _pairs(k, v):
    p = np.stack([np.asarray(k).astype(np.int64), np.asarray(v).astype(
        np.int64)], 1)
    return p[np.lexsort((p[:, 1], p[:, 0]))]


@pytest.mark.parametrize("n", [1 << 12, 3000])
def test_sort_kv_unstable(rng, n):
    """Keys bit for bit; values as a multiset per equal-key run."""
    k = _keys(rng, np.uint32, n)
    v = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    wk, wv = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), stable=False,
                           config=HOST)
    for engine in ENGINES:
        gk, gv = sortx_torch.sort_kv(to_torch(k), to_torch(v), stable=False,
                                     config=sortx_torch.Config(engine=engine))
        _same(gk, wk)
        np.testing.assert_array_equal(_pairs(to_numpy(gk), to_numpy(gv)),
                                      _pairs(wk, wv))


def _kv_sweep():
    """The reference's KV sweep with cumulative +13 raggedness, to 2^16."""
    out, size = [], 1024
    while size + 13 < 1 << 16:
        size += 13
        out.append(size)
        size *= 2
    return out


@pytest.mark.parametrize("n", _kv_sweep())
def test_sort_kv_ragged_sweep(rng, n):
    k = _keys(rng, np.uint32, n)
    v = np.arange(n, dtype=np.uint32)
    want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), config=HOST)
    got = sortx_torch.sort_kv(to_torch(k), to_torch(v),
                              config=sortx_torch.Config(engine="network"))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("case", ["sorted", "reversed", "sorted_kv",
                                  "low_bits_sorted_kv"])
def test_ordered_inputs_take_the_short_cut(rng, monkeypatch, case):
    """Ordered inputs take the reference's short cut on the network
    engine, as a branch on the device: every pass of the network gets a
    set skip flag, a reversed keys-only input is reversed by K8's plain
    version, and the result equals sortx's host engine."""
    bitonic = importlib.import_module("sortx_torch.ops.bitonic")
    skips, reversals = [], []
    layers, reverse = bitonic._layers, bitonic.reverse_plain

    def spy_layers(x, ext, num_keys, lay, skip):
        skips.append(skip is not None and int(skip) != 0)
        return layers(x, ext, num_keys, lay, skip)

    def spy_reverse(src, out, flags):
        reversals.append(int(flags))
        return reverse(src, out, flags)
    monkeypatch.setattr(bitonic, "_layers", spy_layers)
    monkeypatch.setattr(bitonic, "reverse_plain", spy_reverse)
    net = sortx_torch.Config(engine="network")
    k = np.sort(_keys(rng, np.uint32, 5000))
    v = rng.randint(0, 2**32, size=5000, dtype=np.uint32)
    if case == "reversed":
        k = k[::-1].copy()
    if case == "low_bits_sorted_kv":   # low 4 bits ascending, high bits not
        k = (rng.randint(0, 2**28, size=5000).astype(np.uint32) << 4) | (
            np.sort(rng.randint(0, 16, size=5000)).astype(np.uint32))
    sort_bits = 4 if case == "low_bits_sorted_kv" else None
    if case.endswith("kv"):
        want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), sort_bits,
                             config=HOST)
        got = sortx_torch.sort_kv(to_torch(k), to_torch(v), sort_bits,
                                  config=net)
        _same(got[0], want[0])
        _same(got[1], want[1])
    else:
        _same(sortx_torch.sort(to_torch(k), config=net),
              sortx.sort(jnp.asarray(k), config=HOST))
        assert reversals == [2 if case == "reversed" else 1]
    assert skips and all(skips)


@pytest.mark.parametrize("n", [0, 1, 2])
def test_tiny_inputs(rng, n):
    k = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    v = np.arange(n, dtype=np.float32)
    for engine in ENGINES:
        cfg = sortx_torch.Config(engine=engine)
        _same(sortx_torch.sort(to_torch(k), config=cfg),
              sortx.sort(jnp.asarray(k), config=HOST))
        got = sortx_torch.sort_kv(to_torch(k), to_torch(v), config=cfg)
        want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), config=HOST)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("keys, kw, err", [
    (np.zeros(8, np.int8), {}, TypeError),
    (np.zeros(8, np.uint32), dict(sort_bits=0), ValueError),
    (np.zeros(8, np.uint32), dict(sort_bits=33), ValueError),
    (np.zeros(8, np.int32), dict(sort_bits=16), ValueError),
    (np.zeros((2, 4), np.uint32), {}, ValueError),
], ids=["int8", "bits0", "bits33", "partial_i32", "2d"])
def test_errors_match(keys, kw, err):
    with pytest.raises(err):
        sortx.sort(jnp.asarray(keys), config=HOST, **kw)
    with pytest.raises(err):
        sortx_torch.sort(to_torch(keys), **kw)
    with pytest.raises(err):
        sortx_torch.sort_kv(to_torch(keys), to_torch(keys), **kw)


def test_mismatched_values_raise():
    with pytest.raises(ValueError):
        sortx_torch.sort_kv(to_torch(np.zeros(8, np.uint32)),
                            to_torch(np.zeros(7, np.uint32)))


@pytest.mark.parametrize("what", ["keys", "values"])
def test_64bit_is_not_ported(what):
    """64-bit keys and values, refused before the 64-bit words were
    ported, sort on both engines: here the words on either side of each
    (hi, lo) split, against numpy (tests/test_torch_extras.py holds the
    64-bit ops against ``sortx``)."""
    wide = np.array([2**32, 2**32 - 1, -2**32, -2**32 - 1, 2**31, -2**31,
                     2**31 - 1, np.iinfo(np.int64).min,
                     np.iinfo(np.int64).max, 0, -1, 2**32], np.int64)
    narrow = np.array([3, 1, 3, 0, 2, 1, 0, 3, 2, 2, 1, 0], np.uint32)
    for engine in ENGINES:
        cfg = sortx_torch.Config(engine=engine)
        if what == "keys":
            _same(sortx_torch.sort(to_torch(wide), config=cfg),
                  np.sort(wide, kind="stable"))
        else:
            order = np.argsort(narrow, kind="stable")
            ks, vs = sortx_torch.sort_kv(to_torch(narrow), to_torch(wide),
                                         config=cfg)
            _same(ks, narrow[order])
            _same(vs, wide[order])


@pytest.mark.parametrize("dtype", [np.float16, ml_dtypes.bfloat16],
                         ids=lambda d: np.dtype(d).name)
def test_16bit_float_nans_match_sortx(rng, dtype):
    """NaNs of every sign and payload widen and narrow as ``sortx`` (XLA)
    converts them: f16 quieted with its payload kept, bf16 by its bits
    (back to the quiet NaN of its sign). torch's own f16 / bf16
    conversions lose the sign or the payload, which moved NaNs and
    changed their bits."""
    bits = rng.randint(0, 1 << 16, size=5000).astype(np.uint16)
    bits[::3] |= 0x7C00 if dtype == np.float16 else 0x7F80
    k = bits.view(dtype)
    v = np.arange(5000, dtype=np.int32)
    want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), descending=True,
                         config=HOST)
    for engine in ENGINES:
        cfg = sortx_torch.Config(engine=engine)
        _same(sortx_torch.sort(to_torch(k), config=cfg),
              sortx.sort(jnp.asarray(k), config=HOST))
        got = sortx_torch.sort_kv(to_torch(k), to_torch(v), descending=True,
                                  config=cfg)
        _same(got[0], want[0])
        _same(got[1], want[1])
