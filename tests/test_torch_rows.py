"""Rows mode of the port's network, and sort_rows / sort_kv_rows, against
``sortx``, bit for bit.

The network is held against ``sortx.ops.bitonic.bitonic_sort_streams``
in rows mode (``row_log``), run in interpret mode; the port's side runs
the plain versions of K1-K3 (CPU tensors) at log_block 10, so K1 alone,
and K1, K3 and K2 with the forced-ascending last stage, all run. The ops
are held against ``sortx``'s host engine and its Pallas engine in
interpret mode. Every comparator here is tie-free on the streams it
carries, so the outputs must agree bit for bit.
"""

import jax.numpy as jnp
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


def _rows_streams(rng, ns, nk, n, row_log, n_valid=None):
    """(ns, n) u32 streams of rows of 2^row_log: duplicate-heavy keys,
    then (for nk = 2) the in-row position, then random payloads."""
    st = rng.randint(0, 2**32, size=(ns, n), dtype=np.uint32)
    st[0] = (rng.randint(0, 40, size=n) * 0x01000193).astype(np.uint32)
    if nk == 2:
        st[1] = np.tile(np.arange(1 << row_log, dtype=np.uint32),
                        n >> row_log)
    if n_valid is not None:
        st[:, n_valid:] = 0xFFFFFFFF
    return st


@pytest.mark.parametrize("ns, nk, n, row_log, n_valid", [
    (1, 1, 1 << 12, 8, None),            # rows below the block: K1 alone
    (1, 1, 1 << 13, 12, None),           # above it: K1, K3, K2 (forced)
    (1, 1, 3 << 11, 11, None),           # a total that is no power of two
    (3, 2, 3 << 11, 11, None),           # the stable (key, pos, value) set
    (2, 2, 1 << 13, 11, 7 << 10),        # pruned pad rows
], ids=["below_block", "above_block", "ragged_total", "kv_set", "pruned"])
def test_rows_network_matches_jax(rng, ns, nk, n, row_log, n_valid):
    st = _rows_streams(rng, ns, nk, n, row_log, n_valid)
    # the JAX network halves its block per doubling of the stream count
    want = jax_sort_streams(tuple(jnp.asarray(s) for s in st), nk,
                            interpret=True,
                            log_block=10 + (ns.bit_length() - 1),
                            n_valid=n_valid, row_log=row_log)
    x = to_torch(st).view(torch.int32)
    kinds = {name for name, _ in tb.pass_plan(ns, n, nk, n_valid, 10,
                                              row_log)}
    assert kinds == ({"bitonic_block"} if row_log <= 10 else
                     {"bitonic_block", "bitonic_global", "bitonic_tail"})
    tb.bitonic_sort_streams(x, nk, n_valid=n_valid, log_block=10,
                            row_log=row_log)
    got = to_numpy(x.view(torch.uint32))
    np.testing.assert_array_equal(got, np.stack([np.asarray(w)
                                                 for w in want]))
    rows = got[0].reshape(-1, 1 << row_log).astype(np.int64)
    assert np.all(np.diff(rows, axis=1) >= 0)


@pytest.mark.parametrize("ns, nk, n, row_log", [
    (1, 1, 3 << 20, 16), (3, 2, 1 << 27, 21), (4, 2, 1 << 14, 10),
    (1, 1, 1 << 27, 10)])
def test_rows_pass_plan_runs_every_row_layer_once(ns, nk, n, row_log):
    """Stages 1..row_log run once each; only the passes of stage row_log
    carry the rows-mode argument, and they force it ascending."""
    lb = tb.block_log(ns)
    layers = []
    for name, args in tb.pass_plan(ns, n, nk, None, row_log=row_log):
        if name == "bitonic_block":
            top = args[3] if len(args) > 3 else args[2]
            assert (len(args) > 3) == (row_log <= lb)
            run = [(s, j) for s in range(1, top + 1)
                   for j in range(s - 1, -1, -1)]
        elif name == "bitonic_global":
            s, j_hi, j_lo = args[2:5]
            assert args[5:] == ((True,) if s == row_log else ())
            run = [(s, j) for j in range(j_hi, j_lo - 1, -1)]
        else:
            s = args[3]
            assert args[4:] == ((True,) if s == row_log else ())
            run = [(s, j) for j in range(lb - 1, -1, -1)]
        layers += run
    assert layers == [(s, j) for s in range(1, row_log + 1)
                      for j in range(s - 1, -1, -1)]


def test_rows_mode_leaves_full_network_plan_alone():
    """Without row_log the plan is the full network's, argument for
    argument: rows mode costs the other sorts nothing."""
    plan = tb.pass_plan(3, 1 << 20, 2, (1 << 19) + 5)
    assert all(len(args) == {"bitonic_block": 3, "bitonic_global": 5,
                             "bitonic_tail": 4}[name] for name, args in plan)


@pytest.mark.parametrize("n, row_log", [(3 << 9, 9), (1 << 12, 13),
                                        (5 << 10, 11)])
def test_rows_mode_rejects_lengths(n, row_log):
    with pytest.raises(ValueError):
        tb.pass_plan(1, n, 1, row_log=row_log)


def test_block_rejects_rows_past_the_block():
    x = torch.zeros((1, 1 << 10), dtype=torch.int32)
    with pytest.raises(ValueError):
        tb.bitonic_block(x, 1 << 10, 1, 10, 11)


def _keys(rng, dtype, shape):
    if dtype == np.uint32:
        k = (rng.randint(0, 97, size=shape) * 0x01000193).astype(np.uint32)
        k.reshape(-1)[rng.randint(0, k.size, k.size // 16)] = 0xFFFFFFFF
        return k
    if dtype == np.int32:
        return (rng.randint(-50, 50, size=shape) * 40_000_003).astype(
            np.int32)
    f = np.round(rng.randn(*shape) * 8).astype(np.float32)
    f.reshape(-1)[rng.randint(0, f.size, 20)] = -0.0
    f.reshape(-1)[rng.randint(0, f.size, 20)] = np.inf
    f.view(np.uint32).reshape(-1)[rng.randint(0, f.size, 20)] = 0x7FC00001
    return f


def _same(got, want):
    want = np.asarray(want)
    got = to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(7, 1000), (3, 1024), (40, 3)])
def test_sort_rows_matches_host(rng, dtype, descending, shape):
    k = _keys(rng, dtype, shape)
    want = sortx.sort_rows(jnp.asarray(k), descending=descending,
                           config=HOST)
    for engine in ENGINES:
        _same(sortx_torch.sort_rows(
            to_torch(k), descending=descending,
            config=sortx_torch.Config(engine=engine)), want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("vdtype", [np.uint32, np.float32, np.int16],
                         ids=lambda d: np.dtype(d).name)
def test_sort_kv_rows_matches_host(rng, dtype, vdtype, descending):
    k = _keys(rng, dtype, (9, 777))
    v = (rng.randn(9, 777) * 1000).astype(vdtype)
    want = sortx.sort_kv_rows(jnp.asarray(k), jnp.asarray(v),
                              descending=descending, config=HOST)
    for engine in ENGINES:
        got = sortx_torch.sort_kv_rows(
            to_torch(k), to_torch(v), descending=descending,
            config=sortx_torch.Config(engine=engine))
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("kv", [False, True])
def test_rows_match_pallas_interpret(rng, kv):
    """The JAX row network itself (interpret mode; 40 x 1000 clears its
    2^15 floor) against the port's: a row length no power of two."""
    cfg = sortx.Config(engine="pallas", interpret=True, engine_min_n=0,
                       engine_log_block=11)
    k = _keys(rng, np.uint32, (40, 1000))
    port = sortx_torch.Config(engine="network")
    if kv:
        v = np.arange(40_000, dtype=np.uint32).reshape(40, 1000)
        want = sortx.sort_kv_rows(jnp.asarray(k), jnp.asarray(v),
                                  config=cfg)
        got = sortx_torch.sort_kv_rows(to_torch(k), to_torch(v), config=port)
    else:
        want = (sortx.sort_rows(jnp.asarray(k), config=cfg),)
        got = (sortx_torch.sort_rows(to_torch(k), config=port),)
    from sortx.ops import rows as jax_rows
    assert jax_rows.last_dispatch == "bitonic-rows"
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("shape", [(0, 5), (5, 1), (5, 0)])
def test_degenerate_rows_come_back(shape):
    k = np.zeros(shape, np.uint32)
    _same(sortx_torch.sort_rows(to_torch(k)), k)
    ks, vs = sortx_torch.sort_kv_rows(to_torch(k), to_torch(k))
    _same(ks, k)
    _same(vs, k)


@pytest.mark.parametrize("keys, err", [
    (np.zeros(8, np.uint32), ValueError),
    (np.zeros((2, 4), np.int8), TypeError),
], ids=["1d", "int8"])
def test_errors_match(keys, err):
    with pytest.raises(err):
        sortx.sort_rows(jnp.asarray(keys), config=HOST)
    with pytest.raises(err):
        sortx_torch.sort_rows(to_torch(keys))
    with pytest.raises(err):
        sortx_torch.sort_kv_rows(to_torch(keys), to_torch(keys))


def test_64bit_row_keys_raise():
    """sortx rejects 64-bit row keys (``_check_key_dtype`` without
    allow64); without x64 mode jax would narrow them before it could."""
    wide = to_torch(np.zeros((2, 4), np.int64))
    with pytest.raises(TypeError, match="64-bit"):
        sortx_torch.sort_rows(wide)


def test_mismatched_values_raise():
    with pytest.raises(ValueError):
        sortx_torch.sort_kv_rows(to_torch(np.zeros((2, 4), np.uint32)),
                                 to_torch(np.zeros((2, 5), np.uint32)))
