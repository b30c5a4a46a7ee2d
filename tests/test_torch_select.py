"""The port's kth_value / median / top_k and sort_u64 against ``sortx``,
bit for bit.

The JAX side runs on its host engine (``lax.sort`` rows and sorts, its
host histogram); the port's side runs both of its engines on CPU
tensors: "host", and "network", which runs K5's and K1-K3's plain
versions (the rows-mode tournament of ``top_k`` included). At
n = 2^15 and k = 16, ``top_k`` takes the tournament (B = 32 rows of
L = 1024); at k = 2000 it sorts directly.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sortx
import sortx_torch
from sortx_torch.convert import to_numpy, to_torch
from sortx_torch.ops.select import _top_k_shape

HOST = sortx.Config(engine="host")
ENGINES = ["host", "network"]
N = 1 << 15


def _keys(rng, dtype, n=N):
    """Tie-heavy keys of dtype with its extremes."""
    if dtype == np.uint32:
        k = (rng.randint(0, 60, size=n) * 0x01000193).astype(np.uint32)
        k[rng.randint(0, n, 40)] = 0xFFFFFFFF
        return k
    if dtype == np.int32:
        k = (rng.randint(-30, 30, size=n) * 40_000_003).astype(np.int32)
        k[rng.randint(0, n, 9)] = np.iinfo(np.int32).min
        return k
    f = np.round(rng.randn(n) * 4).astype(np.float32)
    f[rng.randint(0, n, 20)] = -0.0
    f[rng.randint(0, n, 20)] = -np.inf
    return f.astype(dtype)


def _same(got, want):
    want = np.asarray(want)
    got = to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8))


DTYPES = [np.uint32, np.int32, np.float32, ml_dtypes.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_kth_value_and_median(rng, dtype):
    k = _keys(rng, dtype)
    for engine in ENGINES:
        cfg = sortx_torch.Config(engine=engine)
        for rank in (0, 1, 777, N // 2, N - 1):
            _same(sortx_torch.kth_value(to_torch(k), rank, config=cfg),
                  sortx.kth_value(jnp.asarray(k), rank, config=HOST))
        _same(sortx_torch.median(to_torch(k), config=cfg),
              sortx.median(jnp.asarray(k), config=HOST))


def test_kth_value_takes_a_tensor_rank_and_stays_on_the_device(
        rng, monkeypatch):
    """The four rounds keep rank, prefix and match count as tensors: no
    value comes back to the host inside the op."""
    k = _keys(rng, np.uint32)
    rank = torch.tensor(1234)

    def host_read(*args, **kwargs):
        raise AssertionError("kth_value read a tensor on the host")
    for name in ("item", "tolist", "__int__", "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    got = sortx_torch.kth_value(to_torch(k), rank,
                                config=sortx_torch.Config(engine="network"))
    monkeypatch.undo()
    _same(got, sortx.kth_value(jnp.asarray(k), 1234, config=HOST))


@pytest.mark.parametrize("k", [16, 2000])
@pytest.mark.parametrize("dtype", DTYPES[:3], ids=lambda d: np.dtype(d).name)
def test_top_k_matches_host(rng, dtype, k):
    keys = _keys(rng, dtype)
    assert (_top_k_shape(N, k) is not None) == (k == 16)
    want_v, want_i = sortx.top_k(jnp.asarray(keys), k, return_indices=True,
                                 config=HOST)
    want = sortx.top_k(jnp.asarray(keys), k, config=HOST)
    for engine in ENGINES:
        cfg = sortx_torch.Config(engine=engine)
        got_v, got_i = sortx_torch.top_k(to_torch(keys), k,
                                         return_indices=True, config=cfg)
        _same(got_v, want_v)
        _same(got_i, want_i)
        _same(sortx_torch.top_k(to_torch(keys), k, config=cfg), want)


def test_top_k_ties_go_to_the_lowest_index(rng):
    keys = np.full(N + 77, 5, np.uint32)      # a ragged tail past B * L
    keys[rng.randint(0, N, 30)] = 9
    for engine in ENGINES:
        v, i = sortx_torch.top_k(to_torch(keys), 64, return_indices=True,
                                 config=sortx_torch.Config(engine=engine))
        order = np.argsort(-keys.astype(np.int64), kind="stable")[:64]
        np.testing.assert_array_equal(to_numpy(i), order)
        np.testing.assert_array_equal(to_numpy(v), keys[order])


@pytest.mark.parametrize("n, k", [(N, 16), (N, 64), (N, 2000), (5000, 1024),
                                  (1 << 22, 64), (1 << 27, 64),
                                  (1 << 27, 1024)])
def test_top_k_shape_matches_the_reference(n, k):
    from sortx.ops.select import _top_k_shape as jax_shape
    assert _top_k_shape(n, k) == jax_shape(n, k)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("n", [2, 3000, 9000])
def test_sort_u64_matches(rng, n, descending):
    hi = (rng.randint(0, 9, size=n) * 0x10000001).astype(np.uint32)
    lo = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    lo[::7] = 0xFFFFFFFF
    want = sortx.sort_u64(jnp.asarray(hi), jnp.asarray(lo),
                          descending=descending, config=HOST)
    for engine in ENGINES:
        got = sortx_torch.sort_u64(to_torch(hi), to_torch(lo),
                                   descending=descending,
                                   config=sortx_torch.Config(engine=engine))
        for g, w in zip(got, want):
            _same(g, w)


def test_sort_u64_matches_pallas_interpret(rng):
    """The JAX engine's one (hi, lo) network pass, interpret mode."""
    n = 9000
    hi = (rng.randint(0, 9, size=n) * 0x10000001).astype(np.uint32)
    lo = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    cfg = sortx.Config(engine="pallas", interpret=True, engine_min_n=0,
                       engine_log_block=14)
    want = sortx.sort_u64(jnp.asarray(hi), jnp.asarray(lo), config=cfg)
    got = sortx_torch.sort_u64(to_torch(hi), to_torch(lo),
                               config=sortx_torch.Config(engine="network"))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("call, err", [
    (lambda m, x: m.kth_value(x, 8), ValueError),
    (lambda m, x: m.kth_value(x, -1), ValueError),
    (lambda m, x: m.top_k(x, 0), ValueError),
    (lambda m, x: m.top_k(x, 9), ValueError),
    (lambda m, x: m.kth_value(x[:0], 0), ValueError),
    (lambda m, x: m.top_k(x.reshape(2, 4), 1), ValueError),
], ids=["kth_n", "kth_neg", "top0", "top_n", "empty", "2d"])
def test_errors_match(call, err):
    x = np.arange(8, dtype=np.uint32)
    with pytest.raises(err):
        call(sortx, jnp.asarray(x))
    with pytest.raises(err):
        call(sortx_torch, to_torch(x))


def test_sort_u64_rejects_bad_halves():
    a = to_torch(np.zeros(4, np.uint32))
    with pytest.raises(TypeError):
        sortx_torch.sort_u64(a.view(torch.int32), a)
    with pytest.raises(ValueError):
        sortx_torch.sort_u64(a, a[:3])
