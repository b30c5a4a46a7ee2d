"""The port's merge and merge_kv against ``sortx``, bit for bit.

The port runs both of its merge engines on CPU tensors: "host" (the
rank arithmetic on ``torch.searchsorted``) and "network" (one ascending
merge stage on the plain versions of K3 and K2). ``sortx`` runs its host
engine. The merge stage itself is also held against JAX's
``bitonic_merge_streams`` in interpret mode, at n <= 2^12, where the
port's stage is one K2 pass with s == L.
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
from sortx.ops.bitonic import bitonic_merge_streams as jax_merge_streams
from sortx_torch.convert import to_numpy, to_torch
from sortx_torch.ops import bitonic as tb

HOST = sortx.Config(engine="host")
ENGINES = ["host", "network"]


@contextlib.contextmanager
def x64():
    """Scoped x64 mode, restored on exit."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _same(got, want):
    want = np.asarray(want)
    got = to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _cfg(engine):
    return sortx_torch.Config(engine=engine)


def _sorted_keys(rng, dtype, n, descending=False):
    """Sorted, duplicate-heavy keys of ``dtype`` in ``sortx.sort``'s
    total order (float NaNs, infinities and signed zeros included)."""
    if n == 0:
        return np.zeros(0, dtype)
    if dtype == np.uint32:
        k = (rng.randint(0, 60, size=n) * 0x04000001).astype(np.uint32)
        k[rng.randint(0, n, max(1, n // 20))] = 0xFFFFFFFF
    elif dtype in (np.int32, np.int16):
        k = rng.randint(-30, 30, size=n).astype(dtype)
    else:
        f = np.round(rng.randn(n) * 4).astype(np.float32)
        f[rng.randint(0, n, max(1, n // 20))] = -0.0
        f[rng.randint(0, n, max(1, n // 20))] = np.inf
        f.view(np.uint32)[rng.randint(0, n, max(1, n // 30))] = 0x7FC00001
        k = f.astype(dtype)
    return np.asarray(sortx.sort(jnp.asarray(k), descending=descending,
                                 config=HOST))


SIZES = [(3000, 1234), (1, 1), (1, 700), (513, 511), (1024, 1024),
         (0, 9), (9, 0)]
DTYPES = [np.uint32, np.int32, np.float32, np.int16, ml_dtypes.bfloat16]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_merge(rng, dtype, descending):
    for na, nb in SIZES:
        a = _sorted_keys(rng, dtype, na, descending)
        b = _sorted_keys(rng, dtype, nb, descending)
        want = sortx.merge(jnp.asarray(a), jnp.asarray(b),
                           descending=descending, config=HOST)
        for engine in ENGINES:
            _same(sortx_torch.merge(to_torch(a), to_torch(b),
                                    descending=descending,
                                    config=_cfg(engine)), want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("vdtype", [np.uint32, np.float32, np.int16,
                                    np.int64],
                         ids=lambda d: np.dtype(d).name)
def test_merge_kv(rng, vdtype, descending):
    """Equal keys take a's values first, each input's order kept; 32-bit
    values ride the network (key, idx, value) at (3, 2), other widths
    take the host path, as in ``sortx``."""
    for na, nb in SIZES:
        ka = _sorted_keys(rng, np.float32, na, descending)
        kb = _sorted_keys(rng, np.float32, nb, descending)
        va = (np.arange(na) * 7 + 1).astype(vdtype)
        vb = -(np.arange(nb) * 5 + 3).astype(vdtype)
        with x64():
            want = sortx.merge_kv(jnp.asarray(ka), jnp.asarray(va),
                                  jnp.asarray(kb), jnp.asarray(vb),
                                  descending=descending, config=HOST)
            want = [np.asarray(w) for w in want]
        for engine in ENGINES:
            got = sortx_torch.merge_kv(to_torch(ka), to_torch(va),
                                       to_torch(kb), to_torch(vb),
                                       descending=descending,
                                       config=_cfg(engine))
            _same(got[0], want[0])
            _same(got[1], want[1])


def test_merge_kv_all_ties_and_ff_keys():
    """All-equal keys come out a before b; real 0xFFFFFFFF keys stay
    ahead of the network's pads (whose idx is 0xFFFFFFFF too)."""
    for key in (0, 0xFFFFFFFF):
        ka = np.full(600, key, np.uint32)
        kb = np.full(700, key, np.uint32)
        va = np.arange(600, dtype=np.int32)
        vb = np.arange(600, 1300, dtype=np.int32)
        for engine in ENGINES:
            k, v = sortx_torch.merge_kv(to_torch(ka), to_torch(va),
                                        to_torch(kb), to_torch(vb),
                                        config=_cfg(engine))
            _same(k, np.full(1300, key, np.uint32))
            _same(v, np.arange(1300, dtype=np.int32))


@pytest.mark.parametrize("call, err", [
    (lambda a, b, f: sortx_torch.merge(a, b.view(torch.int32)), TypeError),
    (lambda a, b, f: sortx_torch.merge(a.view(1, -1), b), ValueError),
    (lambda a, b, f: sortx_torch.merge(f, f), TypeError),
    (lambda a, b, f: sortx_torch.merge_kv(a, a, b, b[:2]), ValueError),
    (lambda a, b, f: sortx_torch.merge_kv(a, a, b, b.view(torch.int32)),
     TypeError),
], ids=["dtypes", "2d", "int8", "value_shape", "value_dtypes"])
def test_merge_errors(call, err):
    a = to_torch(np.arange(4, dtype=np.uint32))
    b = to_torch(np.arange(3, dtype=np.uint32))
    with pytest.raises(err):
        call(a, b, torch.zeros(4, dtype=torch.int8))


def test_merge_plan_shape():
    """The stage s = log2 n over the whole length: K3 passes of at most
    f_max(ns) layers for s-1..L, then one K2 ascending; at n <= 2^L K2
    alone with s == L."""
    for ns, n in ((1, 1 << 20), (3, 1 << 16), (5, 1 << 16), (1, 1 << 12),
                  (3, 1 << 10)):
        plan = tb.merge_plan(ns, n, 2)
        s, lb = n.bit_length() - 1, min(tb.block_log(ns), n.bit_length() - 1)
        layers = [j for name, args in plan if name == "bitonic_global"
                  for j in range(args[3], args[4] - 1, -1)]
        assert layers == list(range(s - 1, lb - 1, -1))
        assert all(args[:3] == (n, 2, s) and args[-1] is True
                   and args[3] - args[4] < tb.f_max(ns)
                   for name, args in plan[:-1])
        assert plan[-1] == ("bitonic_tail", (n, 2, lb, s, True))
    with pytest.raises(ValueError):
        tb.merge_plan(1, 3000, 1)
    with pytest.raises(ValueError):
        tb.merge_plan(1, 512, 1)


@pytest.mark.parametrize("ns, nk, n", [(1, 1, 1024), (1, 1, 4096),
                                       (3, 2, 2048)],
                         ids=lambda v: str(v))
def test_merge_stage_matches_jax_interpret(rng, ns, nk, n):
    """[a, pads, reverse(b)] through JAX's merge stage in interpret mode
    (its block 2^10: K2 alone at 1024, K3 then K2 above) and the port's
    (K2 alone, s == L)."""
    na = int(rng.randint(1, n - 100))
    nb = n - na - 37
    a = np.sort(rng.randint(0, 50, size=na)).astype(np.uint32)
    b = np.sort(rng.randint(0, 50, size=nb)).astype(np.uint32)
    streams = np.zeros((ns, n), np.uint32)
    streams[0] = np.concatenate([a, np.full(37, 0xFFFFFFFF), b[::-1]])
    if ns == 3:
        streams[1] = np.concatenate([np.arange(na), np.full(37, 0xFFFFFFFF),
                                     np.arange(na, na + nb)[::-1]])
        streams[2] = rng.randint(0, 2**32, size=n, dtype=np.uint32)
        streams[2, na:na + 37] = 0             # pads tie on (key, idx)
    lb = 10 + ns.bit_length() - 1              # JAX's block is then 2^10
    out = jax_merge_streams(tuple(jnp.asarray(s) for s in streams), nk,
                            interpret=True, log_block=lb)
    want = np.stack([np.asarray(o) for o in out])
    s = n.bit_length() - 1
    assert tb.merge_plan(ns, n, nk) == [("bitonic_tail",
                                         (n, nk, s, s, True))]
    x = to_torch(streams).view(torch.int32)
    tb.bitonic_merge_streams(x, nk)
    np.testing.assert_array_equal(to_numpy(x.view(torch.uint32)), want)
    np.testing.assert_array_equal(want[0], np.sort(streams[0]))
