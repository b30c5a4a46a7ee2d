"""The port's ops as single device programs, the counterpart of ``sortx``
under ``jax.jit``.

A ``sortx`` op traces into one XLA program with no host read, so it runs
inside a user's ``jit``; its ordered-input short cuts are ``lax.cond``
branches on the device. The port's counterpart is a capture into a
``torch.cuda.CUDAGraph``, which needs the same property: no read of op
data on the host and no output shape that depends on the data. Here, on
the CPU:

- every op of the capture list runs under ``FakeTensorMode`` (which
  raises on a host read of data and on a data-dependent shape) with
  ``Config(engine="network")``, and ``sort`` / ``sort_kv``, rows
  longer than 2^11 and ``top_k_rows`` also with
  ``Config(engine="radix")``, and makes no
  tensor from host data
  (on the card that is an upload, which syncs and cannot be captured);
- each op the reference tests under ``jax.jit`` equals
  ``jax.jit(sortx.<op>)`` bit for bit on the same numpy input;
- ``sort`` / ``sort_kv`` on the network engine, on ordered, reversed,
  all-equal and nearly sorted inputs, equal ``sortx`` under its host
  engine bit for bit (the reference returns a presorted input as it is,
  values in input order, also for ``stable=False``);
- the plain K1-K3 with the skip flag set return their buffer unchanged,
  and K8's plain version reverses only a nonincreasing input.

The card's side (capture, replay, ``set_sync_debug_mode``) is in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import sortx
import sortx_torch
from sortx_torch.convert import to_numpy, to_torch
from sortx_torch.ops import bitonic as tb
from sortx_torch.utils.words import order_flags

HOST = sortx.Config(engine="host")
NET = sortx_torch.Config(engine="network")
RADIX = sortx_torch.Config(engine="radix")
N = 3000


def _same(got, want):
    want = np.asarray(want)
    got = to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8))


def _sorted_pair(rng, na, nb):
    return (np.sort(rng.randint(0, 2**32, na, dtype=np.uint32)),
            np.sort(rng.randint(0, 2**32, nb, dtype=np.uint32)))


def _inputs(seed: int = 0) -> dict:
    """The numpy inputs of the capture list, from a seed."""
    rng = np.random.RandomState(seed)
    u32 = (rng.randint(0, 97, N) * 0x01000193).astype(np.uint32)
    a, b = _sorted_pair(rng, 1500, 700)
    return dict(
        u32=u32, u32p2=u32[:2048].copy(),
        i32=rng.randint(-2**31, 2**31, N, dtype=np.int64).astype(np.int32),
        f32=np.round(rng.randn(N) * 8).astype(np.float32),
        u16=rng.randint(0, 2**16, N).astype(np.uint16),
        bf16=np.round(rng.randn(N) * 8).astype(ml_dtypes.bfloat16),
        u64=rng.randint(0, 2**63, N, dtype=np.int64).astype(np.uint64),
        f64=rng.randn(N),
        v32=rng.randint(0, 2**32, N, dtype=np.uint32),
        v64=rng.randint(-2**62, 2**62, N, dtype=np.int64),
        x32=rng.randint(-50, 50, N).astype(np.int32),
        a=a, b=b, va=rng.randint(0, 99, a.size).astype(np.int32),
        vb=rng.randint(0, 99, b.size).astype(np.int32),
        offsets=np.array([0, 0, 17, 900, 900, 2400, N], np.int64),
        rank=np.array(1234, np.int64),
        rows=rng.randint(0, 2**32, (6, 500), dtype=np.uint32),
        rvals=rng.randint(0, 2**31, (6, 500)).astype(np.int32),
        long_rows=np.round(rng.randn(2, 2100) * 8).astype(np.float32),
        long_rvals=rng.randint(-128, 128, (2, 2100)).astype(np.int8),
        row_lengths=np.array([500, 0, 1, 37, 64, 499], np.int32))


def _kv(t, **kw):
    return sortx_torch.sort_kv(t["u32"], t["v32"], config=NET, **kw)


# name -> the op on a dict of tensors, under the network engine. The list
# the port's graph capture covers (chip_smoke.py's "graph" phase).
OPS = {
    "sort u32": lambda t: sortx_torch.sort(t["u32"], config=NET),
    "sort u32 2^k": lambda t: sortx_torch.sort(t["u32p2"], config=NET),
    "sort i32": lambda t: sortx_torch.sort(t["i32"], config=NET),
    "sort f32": lambda t: sortx_torch.sort(t["f32"], config=NET),
    "sort u16": lambda t: sortx_torch.sort(t["u16"], config=NET),
    "sort bf16": lambda t: sortx_torch.sort(t["bf16"], config=NET),
    "sort u64": lambda t: sortx_torch.sort(t["u64"], config=NET),
    "sort f64": lambda t: sortx_torch.sort(t["f64"], config=NET),
    "sort sort_bits=12 (packed)":
        lambda t: sortx_torch.sort(t["u32"], 12, config=NET),
    "sort sort_bits=24":
        lambda t: sortx_torch.sort(t["u32"], 24, config=NET),
    "sort descending":
        lambda t: sortx_torch.sort(t["u32"], descending=True, config=NET),
    "sort_kv stable": _kv,
    "sort_kv unstable": lambda t: _kv(t, stable=False),
    "sort_kv unstable 2^k": lambda t: sortx_torch.sort_kv(
        t["u32p2"], t["v32"][:2048], stable=False, config=NET),
    "sort_kv sort_bits=12": lambda t: sortx_torch.sort_kv(
        t["u32"], t["v32"], 12, config=NET),
    "sort_kv 64-bit values": lambda t: sortx_torch.sort_kv(
        t["u32"], t["v64"], config=NET),
    "sort_kv unstable 64-bit values": lambda t: sortx_torch.sort_kv(
        t["u32"], t["v64"], stable=False, config=NET),
    "scan with total": lambda t: sortx_torch.scan(
        t["x32"], with_total=True, config=NET),
    "entry": lambda t: sortx_torch.entry(t["u32"], t["v32"], config=NET),
    "argsort": lambda t: sortx_torch.argsort(t["u32"], config=NET),
    "argsort u64": lambda t: sortx_torch.argsort(t["u64"], config=NET),
    "lexsort": lambda t: sortx_torch.lexsort((t["v32"], t["u32"]),
                                             config=NET),
    "merge": lambda t: sortx_torch.merge(t["a"], t["b"], config=NET),
    "merge_kv": lambda t: sortx_torch.merge_kv(t["a"], t["va"], t["b"],
                                               t["vb"], config=NET),
    "sort_segments": lambda t: sortx_torch.sort_segments(
        t["u32"], t["offsets"], config=NET),
    "scan_segments": lambda t: sortx_torch.scan_segments(
        t["x32"], t["offsets"], with_totals=True, config=NET),
    "kth_value rank tensor": lambda t: sortx_torch.kth_value(
        t["u32"], t["rank"], config=NET),
    "median": lambda t: sortx_torch.median(t["f32"], config=NET),
    "top_k": lambda t: sortx_torch.top_k(t["u32"], 40, config=NET),
    "top_k with indices": lambda t: sortx_torch.top_k(
        t["u32"], 40, return_indices=True, config=NET),
    "unique": lambda t: sortx_torch.unique(t["u32"], 64, config=NET),
    "histogram": lambda t: sortx_torch.histogram(t["u32"], 8, 24,
                                                 config=NET),
    "histogram per tile": lambda t: sortx_torch.histogram(
        t["u32"], 4, 0, per_tile=True, config=NET),
    "sort u32 radix": lambda t: sortx_torch.sort(t["u32"], config=RADIX),
    "sort f32 radix descending": lambda t: sortx_torch.sort(
        t["f32"], descending=True, config=RADIX),
    "sort sort_bits=12 radix":
        lambda t: sortx_torch.sort(t["u32"], 12, config=RADIX),
    "sort_kv stable radix": lambda t: sortx_torch.sort_kv(
        t["u32"], t["v32"], config=RADIX),
    "sort_rows": lambda t: sortx_torch.sort_rows(t["rows"], config=NET),
    "sort_rows with indices": lambda t: sortx_torch.sort_rows(
        t["rows"], descending=True, return_indices=True, config=NET),
    "sort_kv_rows": lambda t: sortx_torch.sort_kv_rows(
        t["rows"], t["rvals"], config=NET),
    "sort_rows radix with indices": lambda t: sortx_torch.sort_rows(
        t["long_rows"], descending=True, return_indices=True, config=RADIX),
    "sort_kv_rows radix": lambda t: sortx_torch.sort_kv_rows(
        t["long_rows"], t["long_rvals"], config=RADIX),
    "top_k_rows with lengths": lambda t: sortx_torch.top_k_rows(
        t["rows"], 64, lengths=t["row_lengths"], config=NET),
    "top_k_rows radix": lambda t: sortx_torch.top_k_rows(
        t["long_rows"], 100, config=RADIX),
}


class _NoUploads(TorchDispatchMode):
    """Fails where the op makes a tensor from host data (``torch.tensor``,
    ``as_tensor`` of a Python number): on the card an upload."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func is not torch.ops.aten.lift_fresh.default, (
            "a tensor made from host data")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_runs_without_a_host_read(op):
    """Under FakeTensorMode a host read of data or a data-dependent shape
    raises: the op is one device program, as under ``jax.jit``."""
    real = {k: to_torch(v) for k, v in _inputs().items()}
    with FakeTensorMode() as mode:
        t = {k: mode.from_tensor(v) for k, v in real.items()}
        with _NoUploads():
            out = OPS[op](t)
    leaves = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
    assert leaves and all(o.device.type == "cpu" for o in leaves)


def test_jit_sort_without_profile_rows(tmp_path, rng):
    """``test_runtime.py::test_profile_rows_not_emitted_under_user_jit``'s
    sort, against ``jax.jit(sortx.sort)``."""
    keys = rng.randint(0, 2**32, size=4096, dtype=np.uint32)
    want = jax.jit(lambda k: sortx.sort(k))(jnp.asarray(keys))
    _same(sortx_torch.sort(to_torch(keys), config=NET), want)


def test_jit_merge(rng):
    a, b = _sorted_pair(rng, 2048, 1024)
    want = jax.jit(sortx.merge)(jnp.asarray(a), jnp.asarray(b))
    _same(sortx_torch.merge(to_torch(a), to_torch(b), config=NET), want)


def test_jit_sort_segments(rng):
    keys = rng.randint(0, 2**32, size=4096, dtype=np.uint32)
    offsets = np.array([0, 0, 100, 1000, 1001, 3000, 3000, 4096], np.int32)
    want = jax.jit(lambda k, o: sortx.sort_segments(k, o))(
        jnp.asarray(keys), jnp.asarray(offsets))
    _same(sortx_torch.sort_segments(to_torch(keys), to_torch(offsets),
                                    config=NET), want)


def test_jit_scan_segments(rng):
    x = rng.randint(0, 100, size=8192).astype(np.int32)
    offsets = np.array([0, 5, 5, 4000, 8000, 8192], np.int32)
    want = jax.jit(lambda a, o: sortx.scan_segments(a, o, with_totals=True))(
        jnp.asarray(x), jnp.asarray(offsets))
    got = sortx_torch.scan_segments(to_torch(x), to_torch(offsets),
                                    with_totals=True, config=NET)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("rank", [0, 25_000, 49_999])
def test_jit_kth_value_with_a_rank_tensor(rng, rank):
    keys = np.repeat(rng.randint(0, 50, size=100).astype(np.uint32), 500)
    rng.shuffle(keys)
    want = jax.jit(lambda x, k: sortx.kth_value(x, k))(
        jnp.asarray(keys), jnp.int32(rank))
    got = sortx_torch.kth_value(to_torch(keys),
                                torch.tensor(rank, dtype=torch.int32),
                                config=NET)
    _same(got, want)


def test_jit_unique(rng):
    x = rng.randint(0, 64, size=8192).astype(np.uint32)
    want = jax.jit(lambda a: sortx.unique(a, 64))(jnp.asarray(x))
    got = sortx_torch.unique(to_torch(x), 64, config=NET)
    for g, w in zip(got, want):
        _same(g, w)


def _ordered_keys(rng, kind, n):
    k = (rng.randint(0, 40, n) * 0x01000193).astype(np.uint32)
    if kind == "nondecreasing":
        return np.sort(k)
    if kind == "nonincreasing":
        return np.sort(k)[::-1].copy()
    if kind == "all-equal":
        return np.full(n, k[0], np.uint32)
    s = np.sort(k)            # nearly sorted: two neighbours swapped
    i = n // 3
    s[i], s[i + 1] = s[i + 1] + 1, s[i]
    return s


ORDER = ["nondecreasing", "nonincreasing", "all-equal", "nearly sorted"]


@pytest.mark.parametrize("n", [2048, 3001])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("sort_bits", [None, 5, 20])
@pytest.mark.parametrize("kind", ORDER)
def test_ordered_sort_matches_the_reference(rng, kind, sort_bits,
                                            descending, n):
    k = _ordered_keys(rng, kind, n)
    want = sortx.sort(jnp.asarray(k), sort_bits, descending=descending,
                      config=HOST)
    _same(sortx_torch.sort(to_torch(k), sort_bits, descending=descending,
                           config=NET), want)


@pytest.mark.parametrize("n", [2048, 3001])
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("sort_bits", [None, 5])
@pytest.mark.parametrize("kind", ORDER)
def test_ordered_sort_kv_matches_the_reference(rng, kind, sort_bits,
                                               descending, stable, n):
    """Bit for bit, values included: a presorted input keeps its values'
    order under ``stable=False`` too, as the reference's branch does."""
    k = _ordered_keys(rng, kind, n)
    v = rng.randint(0, 2**32, n, dtype=np.uint32)
    got = sortx_torch.sort_kv(to_torch(k), to_torch(v), sort_bits,
                              stable=stable, descending=descending,
                              config=NET)
    want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), sort_bits,
                         descending=descending, config=HOST)
    _same(got[0], want[0])
    presorted = kind == "all-equal" or sort_bits is None and kind == (
        "nonincreasing" if descending else "nondecreasing")
    if stable or presorted:
        _same(got[1], want[1])
    else:   # the network's own order of values under equal keys
        pairs = lambda ks, vs: np.sort(  # noqa: E731
            ks.astype(np.uint64) << 32 | vs)
        np.testing.assert_array_equal(
            pairs(to_numpy(got[0]), to_numpy(got[1])), pairs(k, v))


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("kind", ORDER)
def test_ordered_wide_stream_sets_match_the_reference(rng, kind, stable):
    """The stream sets that carry 64-bit values as (hi, lo) words, and
    argsort's (masked key, index), on ordered inputs: a skipped network
    gives back every stream as it came, so the outputs are the
    reference's permutation of the input."""
    n = 2048
    k = _ordered_keys(rng, kind, n)
    v = rng.randint(-2**62, 2**62, n, dtype=np.int64)
    perm = np.asarray(sortx.argsort(jnp.asarray(k), config=HOST))
    ks, vs = sortx_torch.sort_kv(to_torch(k), to_torch(v), stable=stable,
                                 config=NET)
    _same(ks, k[perm])
    if stable or kind in ("nondecreasing", "all-equal"):
        _same(vs, v[perm])
    else:   # the network's own order of values under equal keys
        assert sorted(zip(to_numpy(ks), to_numpy(vs))) == sorted(zip(k, v))
    _same(sortx_torch.argsort(to_torch(k), config=NET), perm)


@pytest.mark.parametrize("kind", ORDER)
def test_order_flags(rng, kind):
    k = to_torch(_ordered_keys(rng, kind, 999)).view(torch.int32)
    up = kind in ("nondecreasing", "all-equal")
    down = kind in ("nonincreasing", "all-equal")
    f = order_flags(k)
    assert f.dtype == torch.int32 and f.shape == ()
    assert int(f) == up | down << 1


PLAIN = {   # name -> (plain version, its arguments after x) on (ns, 2^12)
    "block": (tb.block_plain, (1 << 12, 2, 10)),
    "block rows": (tb.block_plain, (1 << 12, 1, 10, 6)),
    "tail": (tb.tail_plain, (1 << 12, 2, 10, 12)),
    "global": (tb.global_plain, (1 << 12, 2, 12, 11, 10)),
}


@pytest.mark.parametrize("name", sorted(PLAIN))
@pytest.mark.parametrize("flag", [0, 1, 3])
def test_plain_network_passes_keep_x_where_skip_is_set(rng, name, flag):
    plain, args = PLAIN[name]
    x = torch.from_numpy(rng.randint(-2**31, 2**31, (3, 1 << 12),
                                     dtype=np.int64).astype(np.int32))
    want = x.clone()
    if not flag:
        plain(want, *args)
    got = x.clone()
    plain(got, *args, skip=torch.tensor([flag], dtype=torch.int32))
    assert torch.equal(got, want)
    assert flag or not torch.equal(got, x)


@pytest.mark.parametrize("flag", [0, 1, 2, 3])
def test_reverse_plain_reverses_only_a_nonincreasing_input(rng, flag):
    src = torch.from_numpy(rng.randint(0, 100, 777).astype(np.int32))
    out = torch.from_numpy(rng.randint(0, 100, 777).astype(np.int32))
    want = src.flip(0) if flag == 2 else out.clone()
    tb.reverse_ordered(src, out, torch.tensor(flag, dtype=torch.int32))
    assert torch.equal(out, want)
