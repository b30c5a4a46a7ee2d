"""``sort_rows(..., return_indices=True)``, the top-p sampler's row sort,
against ``sortx`` and against the plain reference, bit for bit.

The JAX side is ``sortx.sort_kv_rows(keys, tile(arange(L)))`` on its
host engine: the stable row sort whose payload is the in-row position.
The port's side runs both of its engines on CPU tensors: "host" (a
stable ``torch.sort`` along the rows) and "network", the row network's
plain schedule (the CPU mirror of K1-K3) at a block of 2^10 elements, so
that rows of 4100 (padded to 2^13) run K3 and K2 above the block, with
the forced-ascending last stage. The plain reference, the benchmark's
(``portbench/reference/topp_rows.py``), makes probabilities from seeded
words as the sampler cell does and sorts them with ``torch.sort``. A
sort only moves words, so every comparison is exact.
"""

import collections
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sortx
import sortx_torch
from portbench import spec
from sortx_torch.convert import to_numpy, to_torch
from sortx_torch.ops import bitonic as tb
from sortx_torch.ops import sort_network

# the plain reference of the benchmark's sampler cell
REF = spec.load_module(Path(__file__).resolve().parents[1] / "portbench" /
                       "reference" / "topp_rows.py")
probabilities, sort_probs = REF.probabilities, REF.sort_probs

HOST = sortx.Config(engine="host")
ENGINES = ["host", "network"]
LOG_BLOCK = 10


@pytest.fixture
def small_block(monkeypatch):
    """The row network's block at 2^10 for two streams, so short rows run
    every kind of pass."""
    monkeypatch.setitem(tb.BLOCK_LOG, 2, LOG_BLOCK)


def _keys(rng, dtype, shape):
    """Tie-heavy keys of ``dtype`` with its extremes: for floats also
    +-0.0, +-inf and NaNs of both signs; for u32 the words 0 and
    0xFFFFFFFF, which a descending sort maps onto the pads' key."""
    size = int(np.prod(shape))
    if dtype == np.uint32:
        k = (rng.randint(0, 97, size=size) * 0x01000193).astype(np.uint32)
        k[rng.randint(0, size, size // 16)] = 0xFFFFFFFF
        k[rng.randint(0, size, size // 16)] = 0
    elif dtype in (np.int32, np.int16, np.uint16):
        info = np.iinfo(dtype)
        k = (rng.randint(0, 80, size=size) * 7
             - (280 if info.min < 0 else 0)).astype(dtype)
        k[rng.randint(0, size, 9)] = info.min
        k[rng.randint(0, size, 9)] = info.max
    else:
        f = np.round(rng.randn(size) * 8).astype(np.float32)
        f[rng.randint(0, size, 20)] = -0.0
        f[rng.randint(0, size, 20)] = 0.0
        f[rng.randint(0, size, 10)] = np.inf
        f[rng.randint(0, size, 10)] = -np.inf
        f.view(np.uint32)[rng.randint(0, size, 10)] = 0x7FC00001
        f.view(np.uint32)[rng.randint(0, size, 10)] = 0xFFC00000
        k = f.astype(dtype)
    return k.reshape(shape)


def _same(got, want):
    want = np.asarray(want)
    got = to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8))


DTYPES = [np.uint32, np.int32, np.float32, np.uint16, np.int16, np.float16,
          ml_dtypes.bfloat16]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(1, 1000), (3, 1000), (2, 4100),
                                   (5, 1024), (40, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_indices_match_sort_kv_rows_of_positions(rng, small_block, shape,
                                                 dtype, descending, engine):
    k = _keys(rng, dtype, shape)
    pos = np.tile(np.arange(shape[1], dtype=np.int32), (shape[0], 1))
    want_k, want_i = sortx.sort_kv_rows(jnp.asarray(k), jnp.asarray(pos),
                                        descending=descending, config=HOST)
    got_k, got_i = sortx_torch.sort_rows(
        to_torch(k), descending=descending, return_indices=True,
        config=sortx_torch.Config(engine=engine))
    _same(got_k, want_k)
    _same(got_i, want_i)
    assert got_i.is_contiguous()
    # the keys alone are sort_rows' without the flag
    _same(got_k, to_numpy(sortx_torch.sort_rows(
        to_torch(k), descending=descending,
        config=sortx_torch.Config(engine=engine))))


@pytest.mark.parametrize("engine", ENGINES + ["auto"])
@pytest.mark.parametrize("batch, vocab", [(4, 1000), (2, 4100), (1, 1000)])
def test_topp_sort_matches_the_plain_reference(small_block, batch, vocab,
                                               engine):
    gen = torch.Generator().manual_seed(batch * vocab)
    words = torch.randint(-2**31, 2**31, (batch * vocab,), dtype=torch.int32,
                          generator=gen)
    probs = probabilities(words, vocab)
    want_p, want_i = sort_probs(probs)
    got_p, got_i = sortx_torch.sort_rows(
        probs, descending=True, return_indices=True,
        config=sortx_torch.Config(engine=engine))
    assert got_p.dtype == torch.float32 and got_i.dtype == torch.int32
    assert torch.equal(got_p.view(torch.int32), want_p.view(torch.int32))
    assert torch.equal(got_i, want_i)
    assert torch.equal(probs.gather(1, got_i.long()), got_p)


def test_the_plain_reference_holds_tied_probabilities():
    """At the vocabulary's width the float32 probabilities tie often, so
    the order of ties (the stability) is part of what is compared."""
    gen = torch.Generator().manual_seed(7)
    words = torch.randint(-2**31, 2**31, (129_280,), dtype=torch.int32,
                          generator=gen)
    probs = probabilities(words, 129_280)
    values, _ = sort_probs(probs)
    assert int((values[:, 1:] == values[:, :-1]).sum()) > 100
    assert bool((probs > 0).all()) and bool(torch.isfinite(probs).all())


@pytest.fixture
def streams(monkeypatch):
    """(streams, comparator keys) of every row network run."""
    seen = []
    real = sort_network.bitonic_sort_streams

    def spy(x, num_keys, **kw):
        seen.append((x.shape[0], num_keys))
        return real(x, num_keys, **kw)

    monkeypatch.setattr(sort_network, "bitonic_sort_streams", spy)
    return seen


@pytest.mark.parametrize("call, want", [
    ("sort_rows", (1, 1)),
    ("sort_rows_indices", (2, 2)),
    ("sort_kv_rows", (3, 2)),
    ("top_k_indices", (2, 2)),
])
def test_stream_counts_of_the_row_network(rng, streams, call, want):
    """The indices ride as the position stream itself: two streams, no
    payload; the other row sorts keep their stream counts."""
    net = sortx_torch.Config(engine="network")
    k = to_torch(_keys(rng, np.uint32, (4, 1000)))
    if call == "sort_rows":
        sortx_torch.sort_rows(k, config=net)
    elif call == "sort_rows_indices":
        sortx_torch.sort_rows(k, return_indices=True, config=net)
    elif call == "sort_kv_rows":
        sortx_torch.sort_kv_rows(k, k, config=net)
    else:       # the tournament's rows: 32 rows of 1024
        sortx_torch.top_k(to_torch(_keys(rng, np.uint32, (1 << 15,))), 16,
                          return_indices=True, config=net)
    assert streams[0] == want


def test_the_pass_plan_at_the_vocabulary_width():
    """256 x 129,280 keys pad to rows of 2^17: with the position stream,
    K1 and four stages of K3 + K2 (9 passes); through sort_kv_rows with
    an arange payload, three streams and 12 passes."""
    def kinds(ns):
        n = 256 << 17
        plan = tb.pass_plan(ns, n, 2, n, row_log=17)
        return collections.Counter(name for name, _ in plan)
    assert kinds(2) == {"bitonic_block": 1, "bitonic_global": 4,
                        "bitonic_tail": 4}
    assert kinds(3) == {"bitonic_block": 1, "bitonic_global": 6,
                        "bitonic_tail": 5}


@pytest.mark.parametrize("shape", [(0, 5), (5, 1), (5, 0)])
def test_degenerate_rows_give_zero_indices(shape):
    k = np.zeros(shape, np.float32)
    got_k, got_i = sortx_torch.sort_rows(to_torch(k), return_indices=True)
    _same(got_k, k)
    _same(got_i, np.zeros(shape, np.int32))


@pytest.mark.parametrize("engine", ENGINES + ["radix"])
def test_the_rows_engine_opens_its_span(rng, engine):
    # rows longer than 2^11 take the rows' radix engine under "radix"
    k = to_torch(_keys(rng, np.float32, (3, 3000 if engine == "radix"
                                         else 1000)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sortx_torch.sort_rows(k, descending=True, return_indices=True,
                              config=sortx_torch.Config(engine=engine))
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("sortx_torch.")]
    names = sorted(name for name, *_ in spans)
    want = ["sortx_torch.api.sort_rows", "sortx_torch.engine.rows"]
    driver = {"network": "sortx_torch.driver.bitonic",
              "radix": "sortx_torch.driver.radix_rows"}.get(engine)
    if driver:
        want.insert(1, driver)
    assert names == want
    (api,) = [s for s in spans if s[0] == "sortx_torch.api.sort_rows"]
    (eng,) = [s for s in spans if s[0] == "sortx_torch.engine.rows"]
    assert api[1] <= eng[1] and eng[2] <= api[2]
    if engine == "radix":
        # the engine's buffers come first, under its own span
        (drv,) = [s for s in spans if s[0] == driver]
        assert eng[1] < drv[1] and drv[2] <= eng[2]
