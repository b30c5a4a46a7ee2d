"""The radix engine (``sortx_torch/ops/radix.py``) against ``sortx``'s
host engine, on CPU tensors.

On the CPU the engine runs the plain versions of K9 and K10, which follow
the kernels' schedule (the warps' slots, the tiles in ticket order). A
stable sort's output is unique, so on every path the engine takes,
``Config(engine="radix")`` must equal the reference bit for bit, values
included. The dispatch (``ops/sort.py:sort_engine``) is a pure function
of what the call's input shows; its table is held here too, with the
distributed layer's own choice, which stays on the network.
"""

import importlib
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sortx
import sortx_torch
from sortx_torch.config import resolve_engine
from sortx_torch.convert import to_numpy, to_torch
from sortx_torch.ops import radix as rx
from sortx_torch.ops import radix_rows as rr
from sortx_torch.ops import rows as rows_mod
from sortx_torch.ops.sort import sort_engine

ds = importlib.import_module("sortx_torch.parallel.dist_sort")
HOST = sortx.Config(engine="host")
RADIX = sortx_torch.Config(engine="radix")


def _same(got, want):
    want = np.asarray(want)
    got = to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _and_words(rng, n, m):
    """u32 keys of CUB's entropy series: the AND of m uniform words (m = 5
    is entropy 0.201; m = 0 all keys equal)."""
    if m == 0:
        return np.full(n, 0x9E3779B9, np.uint32)
    k = np.full(n, 0xFFFFFFFF, np.uint32)
    for _ in range(m):
        k &= rng.randint(0, 2**32, size=n, dtype=np.uint32)
    return k


def _keys(rng, dtype, n):
    """Keys of ``dtype`` with ties and the dtype's edge values: floats with
    NaNs of both signs and several payloads, -0.0, infinities and
    subnormals."""
    if dtype == np.uint32:
        k = rng.randint(0, 2**32, size=n, dtype=np.uint32)
        k[rng.randint(0, n, n // 8)] = k[0]
        return k
    if dtype == np.int32:
        k = rng.randint(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
        k[rng.randint(0, n, 20)] = np.iinfo(np.int32).min
        k[rng.randint(0, n, 20)] = np.iinfo(np.int32).max
        return k
    if dtype in (np.uint16, np.int16):
        info = np.iinfo(dtype)
        return rng.randint(info.min, info.max + 1, size=n).astype(dtype)
    f = np.round(rng.randn(n) * 8).astype(np.float32)
    f[rng.randint(0, n, 20)] = -0.0
    f[rng.randint(0, n, 20)] = 0.0
    f[rng.randint(0, n, 20)] = np.inf
    f[rng.randint(0, n, 20)] = -np.inf
    if dtype == np.float32:
        bits = f.view(np.uint32)
        bits[rng.randint(0, n, 20)] = 0x7FC00001      # NaN, a payload
        bits[rng.randint(0, n, 20)] = 0xFFC00000      # -NaN
        bits[rng.randint(0, n, 20)] = 0x7F800123      # signalling NaN
        bits[rng.randint(0, n, 20)] = 0x00000001      # subnormals
        bits[rng.randint(0, n, 20)] = 0x807FFFFF
        return f
    f = f.astype(dtype)
    bits = f.view(np.uint16)
    bits[rng.randint(0, n, 20)] = 0x0001              # subnormal
    bits[rng.randint(0, n, 20)] = 0x7FC1 if dtype == ml_dtypes.bfloat16 \
        else 0x7E01                                    # NaN
    return f


KEY_DTYPES = [np.uint32, np.int32, np.float32, np.uint16, np.int16,
              np.float16, ml_dtypes.bfloat16]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", KEY_DTYPES, ids=lambda d: np.dtype(d).name)
def test_radix_sort_key_dtypes(rng, dtype, descending):
    k = _keys(rng, dtype, 3000)
    want = sortx.sort(jnp.asarray(k), descending=descending, config=HOST)
    _same(sortx_torch.sort(to_torch(k), descending=descending, config=RADIX),
          want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.float16],
                         ids=lambda d: np.dtype(d).name)
def test_radix_sort_kv_key_dtypes(rng, dtype, descending):
    k = _keys(rng, dtype, 3000)
    v = np.arange(3000, dtype=np.uint32)
    want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v),
                         descending=descending, config=HOST)
    got = sortx_torch.sort_kv(to_torch(k), to_torch(v),
                              descending=descending, config=RADIX)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("vdtype", [np.int8, np.uint8, np.int16,
                                    np.float16, np.int32, np.float32],
                         ids=lambda d: np.dtype(d).name)
def test_radix_sort_kv_value_widths(rng, vdtype):
    """8-, 16- and 32-bit values ride as one word and come back as they
    went in, in the stable order."""
    k = _and_words(rng, 2500, 3)
    v = (rng.randn(2500) * 100).astype(vdtype)
    want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), config=HOST)
    got = sortx_torch.sort_kv(to_torch(k), to_torch(v), config=RADIX)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("sort_bits", [1, 7, 8, 9, 31])
def test_radix_partial_sort_bits(rng, sort_bits, kv, descending):
    """ceil(sort_bits / 8) passes, the last digit narrower; the bits above
    sort_bits ride along and break no tie."""
    n = 1 << 12
    k = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    k[rng.randint(0, n, 50)] = 0xFFFFFFFF
    v = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    if kv:
        want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), sort_bits,
                             descending=descending, config=HOST)
        got = sortx_torch.sort_kv(to_torch(k), to_torch(v), sort_bits,
                                  descending=descending, config=RADIX)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        want = sortx.sort(jnp.asarray(k), sort_bits, descending=descending,
                          config=HOST)
        _same(sortx_torch.sort(to_torch(k), sort_bits, descending=descending,
                               config=RADIX), want)


def _ordered(rng, kind, n):
    k = _and_words(rng, n, 2)
    if kind == "sorted":
        return np.sort(k)
    if kind == "reversed":
        return np.sort(k)[::-1].copy()
    return _and_words(rng, n, {"entropy 0.201": 5, "all equal": 0}[kind])


@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("kind", ["entropy 0.201", "all equal", "sorted",
                                  "reversed"])
def test_radix_heavy_ties_and_ordered_inputs(rng, kind, kv):
    """Tie-heavy and ordered keys, with no order flags: the stable passes
    give a sorted input back as it is, and equal keys of a reversed one in
    their input order, as the reference does."""
    n = 5000
    k = _ordered(rng, kind, n)
    v = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    if kv:
        want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), config=HOST)
        got = sortx_torch.sort_kv(to_torch(k), to_torch(v), config=RADIX)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        _same(sortx_torch.sort(to_torch(k), config=RADIX),
              sortx.sort(jnp.asarray(k), config=HOST))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1023, 4095, 4096, 4097, 1 << 14,
                               (1 << 14) + 13])
def test_radix_sizes(rng, n):
    """Ragged n, one tile and its edges, and n of 0 to 2 (sort returns
    n <= 1 as it is)."""
    k = _and_words(rng, n, 1)
    v = np.arange(n, dtype=np.uint32)
    _same(sortx_torch.sort(to_torch(k), config=RADIX),
          sortx.sort(jnp.asarray(k), config=HOST))
    want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), config=HOST)
    for g, w in zip(sortx_torch.sort_kv(to_torch(k), to_torch(v),
                                        config=RADIX), want):
        _same(g, w)


@pytest.mark.parametrize("sort_bits", [3, 16, 32])
@pytest.mark.parametrize("n", [1 << 10, 3000, 1 << 14])
def test_plain_schedule_matches_the_reference(rng, n, sort_bits):
    """radix_sort_streams on the u32 words themselves (K9's plain offsets,
    then each K10 pass's plain version) against the reference's stable
    sort of the same keys by their low bits; the inputs are not
    written."""
    k = _and_words(rng, n, 2)
    v = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    kt, vt = to_torch(k).view(torch.int32), to_torch(v).view(torch.int32)
    keep = kt.clone(), vt.clone()
    ks, vs = rx.radix_sort_streams(kt, sort_bits, vt)
    wk, wv = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), sort_bits,
                           config=HOST)
    _same(ks.view(torch.uint32), wk)
    _same(vs.view(torch.uint32), wv)
    assert torch.equal(kt, keep[0]) and torch.equal(vt, keep[1])


@pytest.mark.parametrize("sort_bits", [5, 8, 20, 32])
def test_plain_offsets_are_the_digit_starts(rng, sort_bits):
    """K9's plain version: row p holds the exclusive running count of
    pass p's digits, the last digit sort_bits - 8 (passes - 1) wide."""
    k = _and_words(rng, 3001, 1)
    got = rx.offsets_plain(to_torch(k).view(torch.int32), sort_bits)
    passes = -(-sort_bits // 8)
    assert got.shape == (passes, 256) and got.dtype == torch.int32
    for p in range(passes):
        width = min(8, sort_bits - 8 * p)
        counts = np.bincount((k >> (8 * p)) & ((1 << width) - 1),
                             minlength=256)
        np.testing.assert_array_equal(got[p].numpy(),
                                      np.cumsum(counts) - counts)


def test_one_pass_is_stable_across_tiles_and_warps(rng):
    """A single K10 pass on 4-bit digits over several tiles: each digit's
    words keep their input order (tiles in ticket order, warps and slots
    in order), the values with them."""
    n = 3 * rx.RADIX_TILE + 517
    k = torch.from_numpy(rng.randint(0, 16, n).astype(np.int32) << 4)
    v = torch.arange(n, dtype=torch.int32)
    offsets = rx.offsets_plain(k >> 4, 4)[0]
    out, vout = rx.onesweep_plain(k, 4, 4, offsets, v)
    order = torch.sort(k, stable=True).indices
    assert torch.equal(out, k[order]) and torch.equal(vout, v[order])


# --- the dispatch ----------------------------------------------------------

U32, F64 = torch.uint32, torch.float64
BIG = 1 << 27
DISPATCH = [  # (engine, device, key dtype, n, stable, value words) -> engine
    ("auto", "cuda", U32, BIG, True, 0, "radix"),
    ("auto", "cuda", torch.int32, BIG, True, 0, "radix"),
    ("auto", "cuda", torch.float32, 5, True, 0, "radix"),
    ("auto", "cuda", torch.bfloat16, BIG, True, 0, "radix"),
    ("auto", "cuda", torch.uint16, BIG, True, 0, "radix"),
    ("auto", "cuda", U32, BIG, True, 1, "radix"),
    ("auto", "cuda", torch.float16, 2, True, 1, "radix"),
    ("auto", "cuda", U32, (1 << 30) - 1, True, 1, "radix"),
    ("auto", "cuda", torch.float32, 256 * 129_280, True, 1, "radix"),
    ("auto", "cuda", U32, 1 << 30, True, 0, "network"),
    ("auto", "cuda", U32, BIG, False, 1, "network"),
    ("auto", "cuda", U32, BIG, True, 2, "network"),
    ("auto", "cuda", torch.uint64, BIG, True, 0, "network"),
    ("auto", "cuda", F64, BIG, True, 1, "network"),
    ("auto", "cpu", U32, BIG, True, 0, "host"),
    ("auto", "cpu", U32, BIG, True, 1, "host"),
    ("radix", "cpu", U32, BIG, True, 0, "radix"),
    ("radix", "cuda", U32, BIG, False, 1, "radix"),
    ("radix", "cuda", U32, BIG, True, 2, "network"),
    ("radix", "cpu", torch.int64, BIG, True, 0, "network"),
    ("network", "cuda", U32, BIG, True, 0, "network"),
    ("network", "cpu", U32, BIG, True, 1, "network"),
    ("hybrid", "cuda", U32, BIG, True, 1, "hybrid"),
    ("host", "cuda", U32, BIG, True, 0, "host"),
]


@pytest.mark.parametrize("engine, device, dtype, n, stable, words, want",
                         DISPATCH)
def test_sort_engine_dispatch(engine, device, dtype, n, stable, words, want):
    cfg = sortx_torch.Config(engine=engine)
    assert sort_engine(cfg, device, dtype, n, stable=stable,
                       value_words=words) == want


@pytest.mark.parametrize("engine, want", [("auto", "network"),
                                          ("radix", "network"),
                                          ("network", "network"),
                                          ("hybrid", "hybrid")])
def test_other_ops_and_dist_keep_their_engine_on_a_card(engine, want):
    """Every op but sort / sort_kv and the long row sorts (their rule
    is ``test_rows_engine_rule``'s) resolves "radix" to the network;
    dist_sort's local sorts of u32 words follow sort / sort_kv: the radix
    engine under "auto" and "radix", with the re-sort as the merge; the
    network (the merge tree) under "network"."""
    cfg = sortx_torch.Config(engine=engine)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    assert resolve_engine(cfg, on_card) == want
    local = ds._local_engine(cfg, "cuda", torch.uint32, 1 << 20, 0)
    assert local == {"auto": "radix", "radix": "radix", "network": "bitonic",
                     "hybrid": "xla"}[engine]
    assert ds._merge_mode(local, 4) == (
        "tree" if local == "bitonic" else "sort")


# --- the rows' engine rule (ops/rows.py:rows_engine) -----------------------

SAMPLER = (256, 129_280)
ROWS_DISPATCH = {  # id -> (engine, device, R, L, value words, indices, want)
    "sampler": ("auto", "cuda", *SAMPLER, 0, True, "radix"),
    "sampler keys alone": ("auto", "cuda", *SAMPLER, 0, False, "radix"),
    "sampler 32-bit values": ("auto", "cuda", *SAMPLER, 1, False, "radix"),
    "2^11 with indices": ("auto", "cuda", 256, 1 << 11, 0, True, "network"),
    "2^11 + 1 with indices": ("auto", "cuda", 256, (1 << 11) + 1, 0, True,
                              "radix"),
    "2^11 keys alone": ("auto", "cuda", 256, 1 << 11, 0, False, "network"),
    "2^11 + 1 keys alone": ("auto", "cuda", 256, (1 << 11) + 1, 0, False,
                            "radix"),
    "2^11 32-bit values": ("auto", "cuda", 256, 1 << 11, 1, False,
                           "network"),
    "2^13 with indices": ("auto", "cuda", 256, 1 << 13, 0, True, "radix"),
    "64-bit values": ("auto", "cuda", *SAMPLER, 2, False, "network"),
    "R L = 2^30": ("auto", "cuda", 1 << 14, 1 << 16, 0, True, "network"),
    "network": ("network", "cuda", *SAMPLER, 0, True, "network"),
    "radix on the CPU": ("radix", "cpu", *SAMPLER, 0, True, "radix"),
    "radix, short rows": ("radix", "cuda", 256, 1 << 11, 0, True, "network"),
    "auto on the CPU": ("auto", "cpu", *SAMPLER, 0, True, "host"),
    "hybrid": ("hybrid", "cuda", *SAMPLER, 0, True, "hybrid"),
    "host": ("host", "cuda", *SAMPLER, 0, True, "host"),
}


@pytest.mark.parametrize("case", list(ROWS_DISPATCH))
def test_rows_engine_rule(case):
    """The rows' radix engine where it serves and is asked for: rows
    longer than 2^11 words, at most one value word, R L < 2^30, whatever
    the stream count; the 1-D sorts' rule is sort_engine's, which the
    rows do not change."""
    engine, device, R, L, words, indices, want = ROWS_DISPATCH[case]
    cfg = sortx_torch.Config(engine=engine)
    assert rows_mod.rows_engine(cfg, device, R, L, value_words=words,
                                positions=indices) == want


def test_one_rows_pass_is_stable_across_a_rows_tiles(rng):
    """A single plain K12 pass on the second digit (4 bits of it used)
    over rows of three tiles: each row's words of each digit keep their
    input order, the positions made by the pass, and every row moves
    inside itself."""
    R, L = 3, 2 * 6144 + 517
    k = torch.from_numpy(rng.randint(0, 16, (R, L)).astype(np.int32) << 8)
    offsets = rr.offsets_rows_plain(k, "u32", False)
    out, pos = rr.onesweep_rows_plain(k, 1, offsets[:, 1], "u32", False,
                                      positions=True)
    order = torch.sort(k >> 8, dim=1, stable=True).indices
    assert torch.equal(pos.long(), order)
    assert torch.equal(out, k.gather(1, order))


@pytest.mark.parametrize("kind", sorted(rr.KINDS))
@pytest.mark.parametrize("descending", [False, True])
def test_the_rows_order_map_is_the_sorts(rng, kind, descending):
    """K11 / K12's order map on the caller's words is ``_to_radix_u32``'s
    (complemented under descending), and the last pass's inverse undoes
    it."""
    from sortx_torch.ops.sort import _to_radix_u32
    w = torch.from_numpy(rng.randint(-2**31, 2**31, 4000, dtype=np.int64)
                         .astype(np.int32))
    w[:8] = torch.tensor([0, -1, 1, -2**31, 2**31 - 1, 0x7FC00001,
                          -0x7FFFFFFF, 0x00800000], dtype=torch.int32)
    keys = w.view({"u32": torch.uint32, "i32": torch.int32,
                   "f32": torch.float32}[kind])
    want = _to_radix_u32(keys)[0]
    got = rr.encode_plain(w, kind, descending)
    assert torch.equal(got, ~want if descending else want)
    assert torch.equal(rr.decode_plain(got, kind, descending), w)


@pytest.mark.parametrize("case", ["n", "sort_bits", "scratch", "tile",
                                  "rows 1-D", "rows kind", "rows pass",
                                  "rows positions past pass 0",
                                  "rows offsets"])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(case):
    k = torch.zeros(100, dtype=torch.int32)
    rows = k.view(4, 25)
    off = torch.zeros(4, 4, 256, dtype=torch.int32)
    with pytest.raises(ValueError):
        if case == "rows 1-D":
            rr.radix_rows_histogram(k, "u32", False)
        elif case == "rows kind":
            rr.radix_rows_histogram(rows, "f16", False)
        elif case == "rows pass":
            rr.radix_rows_onesweep(rows, rows.clone(), off, 4, "u32", False)
        elif case == "rows positions past pass 0":
            rr.radix_rows_onesweep(rows, rows.clone(), off, 1, "u32", False,
                                   values_out=rows.clone())
        elif case == "rows offsets":
            rr.radix_rows_onesweep(rows, rows.clone(), off[:, :3].clone(), 0,
                                   "u32", False)
        elif case == "n":
            rx.radix_histogram(k[:0], 32)
        elif case == "sort_bits":
            rx.radix_histogram(k, 33)
        elif case == "scratch":
            rx.radix_onesweep(k, k.clone(), torch.zeros(256), 0, 8)
        else:
            rx.radix_onesweep(k, k.clone(), torch.zeros(256, dtype=torch.int32),
                              0, 9)
