"""``top_k_rows``, the per-row top-k over rows of their own lengths (the
select of DeepSeek-V3.2's sparse-attention indexer), on CPU tensors.

The port's side runs the plain versions of K13 and K14 in the kernels'
schedule and the row network's plain passes: under the default engine,
"radix" and "network" alike (a CPU tensor never reaches a kernel). It is
held bit for bit against:

- the benchmark's plain reference (``portbench/reference/dsa_topk.py``:
  causal rows of scores from seeded words, a stable descending
  ``torch.sort`` of each row masked with -inf past its length);
- ``sortx.top_k(row[:length], min(k, length), return_indices=True)``
  row by row on JAX-CPU, the frozen reference, for u32, i32 and f32;
- a stable sort of each row's mapped words (the order of ``sort``), on
  the edge cases of the contract: all-equal rows, ties across the cut, a
  bucket that holds more than k keys, lengths of 0, 1, < k, = k and = L,
  and no lengths.

Keys past a row's length are +inf (or the dtype's largest) and are never
selected.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sortx
import sortx_torch
from portbench import spec
from sortx_torch.convert import to_numpy, to_torch
from sortx_torch.ops import topk_rows as tr
from sortx_torch.ops.radix_rows import encode_plain, key_words
from sortx_torch.utils.words import as_u64

REF = spec.load_module(Path(__file__).resolve().parents[1] / "portbench" /
                       "reference" / "dsa_topk.py")
HOST = sortx.Config(engine="host")
ENGINES = [None, "radix", "network"]


def _cfg(engine):
    return None if engine is None else sortx_torch.Config(engine=engine)


def _same(got, want):
    want, got = (to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)
                 for t in (want, got))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8))


def _by_words(keys: torch.Tensor, k: int, lengths):
    """(values, indices) of each row's min(k, length) largest keys by the
    unsigned order of their mapped words, ties to the lowest index, then
    the dtype's lowest and -1: a stable sort of the words."""
    R, L = keys.shape
    w, kind, narrow = key_words(keys)
    u = encode_plain(w, kind, True).to(torch.int64) & 0xFFFFFFFF
    n = (torch.full((R,), L) if lengths is None else lengths.to(torch.int64))
    u = torch.where(torch.arange(L) < n[:, None], u, 1 << 40)
    order = torch.sort(u, dim=1, stable=True).indices[:, :k]
    kept = torch.arange(order.shape[1]) < n[:, None]
    words = w.gather(1, order).masked_fill(~kept, tr._LOWEST[keys.dtype])
    vals, idx = narrow(words), order.to(torch.int32).masked_fill(~kept, -1)
    if order.shape[1] < k:      # k > L: the slots past L are padding
        pad = k - order.shape[1]
        vals = torch.cat([vals, narrow(torch.full(
            (R, pad), tr._LOWEST[keys.dtype], dtype=torch.int32))], 1)
        idx = torch.cat([idx, torch.full((R, pad), -1, dtype=torch.int32)],
                        1)
    return vals, idx


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("rows, context, k", [(8, 3000, 300), (6, 20, 16),
                                              (5, 40_000, 2048)])
def test_matches_the_plain_reference(engine, rows, context, k):
    """The cell's path at small sizes: seeded words laid into causal rows
    (+inf past each row's end), then the select against the reference's
    stable sort of the masked rows. Rows of 15..20 keys give fewer than
    k = 16 keys and padded slots."""
    gen = torch.Generator().manual_seed(rows * context + k)
    n = int(REF.row_lengths(rows, context).sum())
    words = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                          generator=gen)
    scores, lengths = REF.causal_scores(words, rows, context)
    got = sortx_torch.top_k_rows(scores, k, lengths=lengths,
                                 config=_cfg(engine))
    want = REF.top_k_rows(scores, lengths, k)
    for g, w in zip(got, want):
        _same(g, w)
    assert torch.isfinite(got[0][got[1] >= 0]).all()


def _row_keys(rng, dtype, shape):
    """Tie-heavy keys of ``dtype``: a few hundred values (for f32 also
    -inf), so ties cross every cut."""
    size = int(np.prod(shape))
    if dtype == np.uint32:
        k = (rng.randint(0, 300, size=size) * 0x01000193).astype(np.uint32)
        k[rng.randint(0, size, 9)] = 0xFFFFFFFF
    elif dtype == np.int32:
        k = (rng.randint(-150, 150, size=size) * 7_000_003).astype(np.int32)
        k[rng.randint(0, size, 9)] = np.iinfo(np.int32).min
    else:
        k = np.round(rng.randn(size) * 40).astype(np.float32) + 0.5
        k[rng.randint(0, size, 9)] = -np.inf
    return k.reshape(shape)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32],
                         ids=lambda d: np.dtype(d).name)
def test_each_row_matches_sortx_top_k(rng, dtype):
    L, k = 3000, 100
    lengths = np.array([L, 0, 1, 37, k, 1500], np.int32)
    keys = _row_keys(rng, dtype, (len(lengths), L))
    for engine in ENGINES:
        vals, idx = sortx_torch.top_k_rows(to_torch(keys), k,
                                           lengths=to_torch(lengths),
                                           config=_cfg(engine))
        vals, idx = to_numpy(vals), to_numpy(idx)
        for r, n in enumerate(lengths):
            m = min(k, int(n))
            if m:
                wv, wi = sortx.top_k(jnp.asarray(keys[r, :n]), m,
                                     return_indices=True, config=HOST)
                _same(vals[r, :m], wv)
                _same(idx[r, :m], wi)
            assert (idx[r, m:] == -1).all()
            _same(vals[r, m:], np.full(k - m, _lowest(dtype), dtype))


def _lowest(dtype):
    return -np.inf if np.dtype(dtype).kind == "f" else np.iinfo(dtype).min


def _edge(name: str, L: int, k: int) -> torch.Tensor:
    R = 6
    gen = torch.Generator().manual_seed(len(name))
    if name == "all equal":
        return torch.full((R, L), 2.5)
    if name == "ties across the cut":   # the k-th key repeats on both sides
        x = torch.randint(0, 6, (R, L), generator=gen).to(torch.float32)
        return x
    if name == "crowded bucket":        # > k keys share their top 24 bits
        x = 1.0 + torch.randint(0, 4, (R, L), generator=gen) * 2.0**-23
        x[:, ::97] = 3.0                # and a few winners above them
        return x
    return torch.randn((R, L), generator=gen)


EDGES = ["all equal", "ties across the cut", "crowded bucket", "random"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", EDGES)
def test_the_edge_cases_of_the_contract(name, engine):
    """Lengths of L, 0, 1, < k, = k and > k in one call, and no lengths,
    against a stable sort of the mapped words."""
    L, k = 5000, 700
    keys = _edge(name, L, k)
    for lengths in (torch.tensor([L, 0, 1, k - 1, k, 2 * k],
                                 dtype=torch.int32), None):
        got = sortx_torch.top_k_rows(keys, k, lengths=lengths,
                                     config=_cfg(engine))
        want = _by_words(keys, k, lengths)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.uint32,
                                   torch.bfloat16, torch.float16,
                                   torch.int16, torch.uint16])
def test_key_dtypes_and_k_past_the_rows(dtype):
    """Every key dtype of ``sort``, k = 1 and k longer than the rows (every
    row then ends in padded slots)."""
    gen = torch.Generator().manual_seed(7)
    base = torch.randint(-60, 60, (4, 300), generator=gen)
    keys = (base.to(dtype) if dtype.is_floating_point or dtype in (
        torch.int32, torch.int16) else (base + 60).to(torch.int32).to(dtype))
    lengths = torch.tensor([300, 2, 0, 150], dtype=torch.int32)
    for k in (1, 299, 400):
        got = sortx_torch.top_k_rows(keys, k, lengths=lengths)
        want = _by_words(keys, k, lengths)
        assert got[0].dtype == dtype and got[1].dtype == torch.int32
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("engine", ENGINES)
def test_keys_past_a_rows_length_are_never_selected(engine):
    """+inf past each row's length (the largest key there is) would win
    every slot if it were read."""
    gen = torch.Generator().manual_seed(11)
    L, k = 20_000, 256
    lengths = torch.tensor([L, 19_999, 10_000, 300, 256, 255, 1, 0],
                           dtype=torch.int32)
    keys = torch.randn((len(lengths), L), generator=gen)
    keys[torch.arange(L) >= lengths[:, None]] = float("inf")
    vals, idx = sortx_torch.top_k_rows(keys, k, lengths=lengths,
                                       config=_cfg(engine))
    assert not torch.isposinf(vals).any()
    assert (idx < lengths[:, None]).all()
    kept = torch.arange(k) < lengths[:, None]
    assert ((idx >= 0) == kept).all()


def test_empty_shapes_and_k_zero():
    keys = torch.randn(3, 10)
    v, i = sortx_torch.top_k_rows(keys, 0)
    assert v.shape == i.shape == (3, 0)
    v, i = sortx_torch.top_k_rows(torch.empty(0, 10), 5)
    assert v.shape == i.shape == (0, 5)
    v, i = sortx_torch.top_k_rows(torch.empty(2, 0, dtype=torch.int32), 3)
    assert (v == torch.iinfo(torch.int32).min).all() and (i == -1).all()


@pytest.mark.parametrize("bad", ["k", "lengths dtype", "lengths shape",
                                 "keys dim", "keys dtype"])
def test_what_the_op_refuses(bad):
    keys, k = torch.randn(3, 10), 4
    lengths = torch.full((3,), 10, dtype=torch.int32)
    if bad == "k":
        k = -1
    elif bad == "lengths dtype":
        lengths = lengths.long()
    elif bad == "lengths shape":
        lengths = lengths[:2]
    elif bad == "keys dim":
        keys = keys.view(-1)
    else:
        keys = keys.double()
    with pytest.raises((ValueError, TypeError)):
        sortx_torch.top_k_rows(keys, k, lengths=lengths)


def test_the_rounds_and_the_gather_keep_the_kernels_state():
    """The plain K13's row state (need, bucket, its size), K14's counters
    and buffer (here the whole row: every key shares its top 11 bits),
    then K15's state narrowed to the k-th key's word and its ties to
    keep; the winners first, then the kept ties, each with its mapped
    word, index and own word; the later slots sort last."""
    keys = torch.tensor([[5, 9, 7, 9, 9, 1, 9, 3]], dtype=torch.int32)
    w, kind, _ = key_words(keys)
    enc = encode_plain(w, kind, True)
    t = int(enc[0, 2])                                # the word of 7
    scratch = torch.empty(tr.scratch_words(1, 8), dtype=torch.int32)
    state = tr.topk_rows_histogram(w, None, kind, 5, scratch)
    assert state[:, 0].tolist() == [5, (t & 0xFFFFFFFF) >> 21, 8]
    out = torch.empty((3, 1, 8), dtype=torch.int32)
    tr.topk_rows_gather(w, None, kind, 5, scratch, *out)
    assert tr.row_taken(scratch, 1, 8).tolist() == [[0, 8]]
    words, index = tr.row_buffer(scratch, 1, 8)
    assert torch.equal(words, enc) and index[0].tolist() == list(range(8))
    tr.topk_rows_buffer_select(w, None, kind, 5, -77, scratch, *out)
    assert state[1, 0] == t and state[0, 0] == 1   # 9 9 9 9 then one 7
    assert out[1, 0].tolist() == [1, 3, 4, 6, 2, -1, -1, -1]
    assert out[2, 0].tolist() == [9, 9, 9, 9, 7, -77, -77, -77]
    assert (out[0, 0, 5:] == -1).all()


def _bucket_row(rng, L: int, bucket: int, above: int) -> torch.Tensor:
    """A row of L float32 keys: ``above`` in [4, 8), ``bucket`` distinct
    ones in [1, 1.25) (one bucket of K13's 11-bit digit) and the rest in
    [0, 0.5), in random order."""
    x = np.concatenate([rng.uniform(4, 8, above),
                        1 + np.arange(bucket) * 2.0**-23 * 7,
                        rng.uniform(0, 0.5, L - above - bucket)])
    return torch.from_numpy(rng.permutation(x).astype(np.float32))


def _buffer_case(name: str, rng):
    """(keys, lengths, k, the rows whose select reads only its buffer)."""
    L = 20_000
    cap = tr.buffer_cap(L)                            # 1250
    if name == "buffered":         # scores spread over many buckets
        keys = torch.from_numpy(rng.randn(5, L).astype(np.float32) * 3)
        return keys, None, 300, 5
    if name.startswith("cap"):     # the k-th key's bucket at cap - 1 ..
        size = cap + int(name[3:] or 0)
        keys = torch.stack([_bucket_row(rng, L, size, 100)
                            for _ in range(3)])
        return keys, None, 600, 3 if size <= cap else 0
    if name == "all equal":        # one bucket a row: short rows fit
        lengths = torch.tensor([L, 0, 1, 700, cap, cap + 1],
                               dtype=torch.int32)
        return torch.full((6, L), -1.5), lengths, 700, 4
    if name == "three values":     # ties at the cut, across every chunk
        keys = torch.from_numpy(rng.randint(0, 3, (4, 3 * tr.CHUNK)).astype(
            np.float32))
        return keys, None, 2048, 0
    if name == "ties across chunks":   # 16 ties around two chunk edges
        keys = torch.from_numpy(rng.uniform(0, 1, (3, 40_000)).astype(
            np.float32))
        keys[:, rng.choice(40_000, 50, replace=False)] = 5.0
        ties = np.r_[tr.CHUNK - 4:tr.CHUNK + 4, 2 * tr.CHUNK - 3:
                     2 * tr.CHUNK + 5]
        keys[:, ties] = 3.0
        keys[1, ties[0]] = 3.25       # row 1: a winner inside the bucket
        return keys, None, 55, 3
    # rows no longer than k (L <= k): every key kept
    keys = torch.from_numpy(rng.randn(5, 300).astype(np.float32))
    lengths = torch.tensor([300, 0, 1, 5, 299], dtype=torch.int32)
    return keys, lengths, 400, 5


BUFFER_CASES = ["buffered", "cap-1", "cap", "cap+1", "all equal",
                "three values", "ties across chunks", "short rows"]


@pytest.mark.parametrize("name", BUFFER_CASES)
def test_rows_read_their_buffer_or_fall_back(rng, name):
    """Rows whose k-th key's bucket fits their buffer finish the select
    on it; larger buckets (all-equal and three-valued rows, one key past
    the buffer) read the row again: either way each row equals a stable
    sort of its mapped words, and the CPU's count of buffered rows grows
    by the rows that fit."""
    keys, lengths, k, buffered = _buffer_case(name, rng)
    before = tr.buffer_counts("cpu")
    got = sortx_torch.top_k_rows(keys, k, lengths=lengths)
    after = tr.buffer_counts("cpu")
    for g, w in zip(got, _by_words(keys, k, lengths)):
        _same(g, w)
    assert (after[0] - before[0], after[1] - before[1]) == (
        buffered, keys.shape[0])


@pytest.mark.parametrize("name", ["buffered", "ties across chunks"])
def test_winners_above_the_bucket_come_from_the_full_read(rng, name):
    """K14's winners are exactly the keys above each row's bucket: its
    counter, and the kept keys K15 adds after them, split min(k, length)
    into the two reads' shares."""
    keys, lengths, k, _ = _buffer_case(name, rng)
    R, L = keys.shape
    w, kind, _ = key_words(keys)
    scratch = torch.empty(tr.scratch_words(R, L), dtype=torch.int32)
    state = tr.topk_rows_histogram(w, lengths, kind, k, scratch).clone()
    out = torch.empty((3, R, k), dtype=torch.int32)
    tr.topk_rows_gather(w, lengths, kind, k, scratch, *out)
    taken = tr.row_taken(scratch, R, L)
    top = as_u64(encode_plain(w, kind, True)) >> (32 - tr.TOP_BITS)
    assert torch.equal(taken[:, 0], (top < state[1][:, None]).sum(1).to(
        torch.int32))
    assert torch.equal(taken[:, 1], state[2])        # the bucket, buffered
    assert (taken[:, 0] > 0).all() and (state[0] > 0).all()
    assert torch.equal(taken[:, 0] + state[0], torch.full((R,), k).to(
        torch.int32))


def test_the_op_opens_its_spans():
    """api.top_k_rows holds engine.topk_rows, which holds driver.topk_rows
    (the rounds, the gather and the row network's driver)."""
    keys = torch.randn(4, 3000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sortx_torch.top_k_rows(keys, 100)
    ev = {e.name: e for e in prof.events()
          if e.name.startswith("sortx_torch.")}
    for name in ("api.top_k_rows", "engine.topk_rows", "driver.topk_rows",
                 "driver.bitonic"):
        assert f"sortx_torch.{name}" in ev, name
    api, eng, drv = (ev[f"sortx_torch.{n}"].time_range for n in (
        "api.top_k_rows", "engine.topk_rows", "driver.topk_rows"))
    assert api.start <= eng.start <= drv.start
    assert drv.end <= eng.end <= api.end
