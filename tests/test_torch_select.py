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


# --- kth_value on the filtered histogram (four K5 rounds, no int64 pass) --

def _special_floats(rng, dtype, n=6000):
    """Floats with NaNs of both signs and payloads, signed zeros,
    infinities and ties."""
    f = np.round(rng.randn(n) * 3).astype(np.float32)
    bits = f.view(np.uint32)
    bits[rng.randint(0, n, 30)] = 0x7FC00000          # +NaN
    bits[rng.randint(0, n, 30)] = 0xFFC00001          # -NaN, a payload
    bits[rng.randint(0, n, 30)] = 0x80000000          # -0
    bits[rng.randint(0, n, 30)] = 0x00000000          # +0
    bits[rng.randint(0, n, 9)] = 0x7F800000           # +inf
    bits[rng.randint(0, n, 9)] = 0xFF800000           # -inf
    return bits.view(np.float32).astype(dtype)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", [np.float32, np.float16,
                                   ml_dtypes.bfloat16],
                         ids=lambda d: np.dtype(d).name)
def test_kth_value_of_special_floats(rng, dtype, engine):
    k = _special_floats(rng, dtype)
    n = k.shape[0]
    cfg = sortx_torch.Config(engine=engine)
    for rank in (0, 29, 45, n // 2 - 20, n // 2, n - 60, n - 31, n - 1):
        _same(sortx_torch.kth_value(to_torch(k), rank, config=cfg),
              sortx.kth_value(jnp.asarray(k), rank, config=HOST))
    _same(sortx_torch.median(to_torch(k), config=cfg),
          sortx.median(jnp.asarray(k), config=HOST))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.float16, np.uint16, np.int16],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_kth_value_takes_int_and_tensor_ranks(rng, dtype, engine, as_tensor):
    n = 5003                            # ragged against the 1024-word tile
    if np.dtype(dtype).kind == "f":
        k = _keys(rng, dtype, n)
    elif np.dtype(dtype).itemsize == 4:
        k = _keys(rng, dtype, n)
    else:
        info = np.iinfo(dtype)
        k = rng.randint(info.min, info.max + 1, size=n).astype(dtype)
    cfg = sortx_torch.Config(engine=engine, sort_tile_elems=1024)
    for rank in (0, 1234, n - 1):
        got = sortx_torch.kth_value(
            to_torch(k), torch.tensor(rank) if as_tensor else rank,
            config=cfg)
        _same(got, sortx.kth_value(jnp.asarray(k), rank, config=HOST))


@pytest.mark.parametrize("kind", ["all-equal", "two-valued", "top-byte"])
def test_kth_value_on_crowded_keys(rng, kind):
    """Keys that put whole warps on one digit in every round."""
    n = 7001
    k = {"all-equal": np.full(n, 0xDEADBEEF, np.uint32),
         "two-valued": np.where(rng.randint(0, 2, n) == 1,
                                np.uint32(0x01020304), np.uint32(0xFEFDFCFB)),
         "top-byte": (rng.randint(0, 256, n).astype(np.uint32) << 24)
         | np.uint32(0x00ABCDEF)}[kind].astype(np.uint32)
    for engine in ENGINES:
        cfg = sortx_torch.Config(engine=engine)
        for rank in (0, n // 3, n // 2, n - 1):
            _same(sortx_torch.kth_value(to_torch(k), rank, config=cfg),
                  sortx.kth_value(jnp.asarray(k), rank, config=HOST))


def test_kth_value_runs_four_filtered_rounds_on_the_radix_image(
        rng, monkeypatch):
    """One digit_counts call per byte, on the same int32 image, with the
    running prefix; no histogram of a re-made digit tensor."""
    from sortx_torch.ops import select
    calls = []
    real = select.digit_counts

    def spy(w, bits, shift, cfg, **kw):
        calls.append((w.data_ptr(), w.dtype, bits, shift,
                      int(kw["prefix"]), kw.get("per_tile", False)))
        return real(w, bits, shift, cfg, **kw)
    monkeypatch.setattr(select, "digit_counts", spy)
    k = _keys(rng, np.uint32)
    got = sortx_torch.kth_value(to_torch(k), 4321)
    want = int(np.sort(k)[4321])
    assert int(to_numpy(got)) == want
    assert len({c[0] for c in calls}) == 1 and calls[0][1] == torch.int32
    assert [c[2:4] for c in calls] == [(8, 24), (8, 16), (8, 8), (8, 0)]
    assert [c[4] for c in calls] == [0, want >> 24, want >> 16, want >> 8]
    assert not any(c[5] for c in calls)
