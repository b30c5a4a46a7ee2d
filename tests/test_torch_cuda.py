"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode) and skip without one. They import neither jax nor sortx, so they
run on a machine that has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import sortx_torch
from portbench import spec
from sortx_torch.ops import bitonic as tb
from sortx_torch.ops import radix as rx
from sortx_torch.ops import sort_hybrid
from sortx_torch.ops._build import launches
from sortx_torch.ops.radix_kernels import histogram_plain, tile_histogram
from sortx_torch.ops.scan import scan_plain, tile_scan
from sortx_torch.ops.shuffle import (CHUNK_ELEMS, apply_runs,
                                     apply_runs_plain, build_piece_plan,
                                     move_runs, move_runs_plain)

# the plain reference of the benchmark's sampler cell
REF = spec.load_module(Path(__file__).resolve().parents[1] / "portbench" /
                       "reference" / "topp_rows.py")
probabilities, sort_probs = REF.probabilities, REF.sort_probs

pytestmark = pytest.mark.cuda

STREAM_SETS = sorted(tb.NARROW_SETS)
# the full-network-only sets of the 64-bit, argsort and lexsort paths
WIDE_SETS = sorted(tb.STREAM_SETS - tb.NARROW_SETS)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _words(seed, shape, dup=True):
    rng = np.random.RandomState(seed)
    if dup:   # duplicate-heavy, so the key comparisons tie often
        return torch.from_numpy(
            (rng.randint(0, 64, size=shape) * 0x1000193).astype(np.int32))
    return torch.from_numpy(rng.randint(-2**31, 2**31, size=shape).astype(
        np.int32))


@pytest.mark.parametrize("ns, nk", STREAM_SETS)
@pytest.mark.parametrize("kernel", ["block", "tail", "global4", "global2"])
def test_kernel_matches_plain(dev, ns, nk, kernel):
    n = 1 << 17
    x = _words(ns * 10 + nk, (ns, n))
    if nk == 2:                      # tie-free second key, as idx is
        x[1] = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    lb = tb.block_log(ns)
    name, fn, plain, args = {
        "block": ("bitonic_block", tb.bitonic_block, tb.block_plain,
                  (n, nk, lb)),
        "tail": ("bitonic_tail", tb.bitonic_tail, tb.tail_plain,
                 (n, nk, lb, 17)),
        "global4": ("bitonic_global", tb.bitonic_global, tb.global_plain,
                    (n, nk, 17, 16, 13)),
        "global2": ("bitonic_global", tb.bitonic_global, tb.global_plain,
                    (n, nk, 14, 13, 12)),
    }[kernel]
    got = x.to(dev)
    want = x.to(dev)
    before = launches[name]
    fn(got, *args)
    plain(want, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert launches[name] == before + 1


@pytest.mark.parametrize("ns, nk", STREAM_SETS)
def test_network_with_pruned_extent(dev, ns, nk):
    n, nv = 1 << 16, (1 << 14) + 77
    x = torch.full((ns, n), -1, dtype=torch.int32)
    x[:, :nv] = _words(ns, (ns, nv), dup=False)
    got = tb.bitonic_sort_streams(x.to(dev), nk, n_valid=nv)
    want = tb.bitonic_sort_streams(x.clone(), nk, n_valid=nv)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [1, 1023, 1024, 5000, (1 << 20) + 13])
@pytest.mark.parametrize("inclusive", [False, True])
def test_scan_matches_plain(dev, n, inclusive):
    x = _words(n, n, dup=False).to(dev)
    out, total = tile_scan(x, inclusive=inclusive)
    pout, ptotal = scan_plain(x, inclusive)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(total, ptotal)


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("sort_bits", [None, 4, 24])
def test_sort_kv_network_matches_host(dev, stable, sort_bits):
    n = (1 << 17) + 13
    k = _words(1, n).view(torch.uint32)
    v = torch.arange(n, dtype=torch.int32)
    net = sortx_torch.sort_kv(k.to(dev), v.to(dev), sort_bits, stable=stable)
    host = sortx_torch.sort_kv(k, v, sort_bits, stable=stable)
    assert torch.equal(net[0].cpu(), host[0])
    if stable:
        assert torch.equal(net[1].cpu(), host[1])
    else:   # unstable: the same (key, value) pairs
        pairs = []
        for ks, vs in ((net[0].cpu(), net[1].cpu()), host):
            p = np.stack([ks.view(torch.int32).numpy(), vs.numpy()], 1)
            pairs.append(p[np.lexsort((p[:, 1], p[:, 0]))])
        np.testing.assert_array_equal(*pairs)


# --- rows mode of K1-K3 (sort_rows, the hybrid's phases) -----------------

@pytest.mark.parametrize("ns, nk", STREAM_SETS)
@pytest.mark.parametrize("kernel", ["block_rows", "tail_asc", "global_asc"])
def test_rows_mode_kernel_matches_plain(dev, ns, nk, kernel):
    n = 1 << 15
    x = _words(ns * 10 + nk + 7, (ns, n))
    if nk == 2:                      # the in-row position, as the rows pass
        x[1] = torch.arange(n) % (1 << 12)
    lb = tb.block_log(ns)
    name, fn, plain, args = {
        "block_rows": ("bitonic_block", tb.bitonic_block, tb.block_plain,
                       (n, nk, lb, lb - 2)),
        "tail_asc": ("bitonic_tail", tb.bitonic_tail, tb.tail_plain,
                     (n, nk, lb, 15, True)),
        "global_asc": ("bitonic_global", tb.bitonic_global, tb.global_plain,
                       (n, nk, 15, 14, 12, True)),
    }[kernel]
    got = x.to(dev)
    want = x.to(dev)
    before = launches[name]
    fn(got, *args)
    plain(want, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert launches[name] == before + 1


@pytest.mark.parametrize("ns, nk", [(1, 1), (3, 2), (4, 2)])
@pytest.mark.parametrize("row_log", [9, 16])
def test_rows_network_matches_plain(dev, ns, nk, row_log):
    n = 3 << 16
    x = _words(row_log + ns, (ns, n))
    if nk == 2:
        x[1] = torch.arange(n) % (1 << row_log)
    got = tb.bitonic_sort_streams(x.to(dev), nk, row_log=row_log)
    want = tb.bitonic_sort_streams(x.clone(), nk, row_log=row_log)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("L", [1000, 1 << 12])
def test_sort_kv_rows_matches_host(dev, L):
    k = _words(L, (300, L))
    v = torch.arange(300 * L, dtype=torch.int32).view(300, L)
    got = sortx_torch.sort_kv_rows(k.to(dev), v.to(dev), descending=True)
    want = sortx_torch.sort_kv_rows(k, v, descending=True)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("L", [1000, 1 << 12])
def test_sort_rows_indices_match_host(dev, L):
    k = _words(L + 1, (300, L))
    got = sortx_torch.sort_rows(k.to(dev), descending=True,
                                return_indices=True)
    want = sortx_torch.sort_rows(k, descending=True, return_indices=True)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_topp_rows_at_the_vocabulary_width(dev):
    """The top-p sampler's row sort, 256 x 129,280 float32 probabilities
    descending with their indices, against the plain reference
    (``portbench/reference/topp_rows.py``) bit for bit, in the 9 launches
    of the row network at two streams (K1, 4 x K3, 4 x K2)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    words = torch.randint(-2**31, 2**31, (256 * 129_280,),
                          dtype=torch.int32, generator=gen, device=dev)
    probs = probabilities(words, 129_280)
    want_p, want_i = sort_probs(probs)
    torch.cuda.synchronize()
    launches.clear()
    got_p, got_i = sortx_torch.sort_rows(probs, descending=True,
                                         return_indices=True)
    torch.cuda.synchronize()
    assert dict(launches) == {"bitonic_block": 1, "bitonic_global": 4,
                              "bitonic_tail": 4}
    assert torch.equal(got_p.view(torch.int32), want_p.view(torch.int32))
    assert torch.equal(got_i, want_i)


# --- K5, the tile histogram ----------------------------------------------

@pytest.mark.parametrize("n", [1, 5000, (1 << 20) + 13])
@pytest.mark.parametrize("radix, shift", [(256, 24), (16, 30), (256, 0),
                                          (2, 31)])
def test_histogram_matches_plain(dev, n, radix, shift):
    x = _words(n + shift, n, dup=False)
    x[: n // 2] = 7                  # one digit for half the tile: skew
    got = tile_histogram(x.to(dev), shift, radix=radix, tile_elems=16384)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), histogram_plain(x, shift, radix, 16384))


# --- K6 and K7, the movers -------------------------------------------------

def _runs(seed, n, chunk):
    """Destination-sorted runs with gaps and zero-length runs."""
    rng = np.random.RandomState(seed)
    src, dst, ln, pos = [], [], [], 0
    while True:
        pos += int(rng.randint(0, 300))
        length = int(rng.choice([0, 1, 7, 900, 3 * chunk // 2]))
        if pos + length > 4 * chunk:
            break
        src.append(int(rng.randint(0, n - length + 1)))
        dst.append(pos)
        ln.append(length)
        pos += length
    return [torch.tensor(a, dtype=torch.int32) for a in (src, dst, ln)]


@pytest.mark.parametrize("ns", [1, 2, 3, 4])
def test_move_runs_matches_plain(dev, ns):
    chunk, n = 2048, 20_000
    srcs = [_words(t, n, dup=False) for t in range(ns)]
    fills = [0xFFFFFFFF, 0, 5, 0x80000000][:ns]
    runs = _runs(ns, n, chunk)
    got = move_runs([s.to(dev) for s in srcs], *(r.to(dev) for r in runs),
                    4 * chunk, fills=fills, chunk=chunk)
    want = move_runs_plain(srcs, *runs, 4 * chunk, fills)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_apply_runs_matches_plain(dev):
    chunk = CHUNK_ELEMS
    n = 8 * chunk
    rng = np.random.RandomState(3)
    cuts = np.sort(rng.choice(np.arange(1, n), size=500, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    lens = np.diff(bounds)
    perm = rng.permutation(len(lens))
    starts = np.concatenate([[0], np.cumsum(lens[perm])[:-1]])[
        np.argsort(perm)]
    plan = build_piece_plan(starts, bounds[:-1], lens, n)
    src = _words(4, n, dup=False)
    got = apply_runs(src.to(dev), plan, n)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), apply_runs_plain(src, plan, n))


def _edge_runs(seed, kind, out_len, src_len):
    """Destination-sorted runs in [0, out_len) of one kind: "tiny" (1-3
    words, short gaps: thousands of pieces a chunk), "mixed" (0 to 3000
    words), "single" (one run over all of out_len) or "gappy" (long
    gaps); sources start anywhere in [-8, src_len + 8), so some reads
    fall outside the source."""
    if kind == "single":
        return [0], [0], [out_len]
    rng = np.random.RandomState(seed)
    lengths, gap = {"tiny": ([1, 2, 3], 2), "mixed": ([0, 1, 5, 37, 700, 3000],
                                                      40),
                    "gappy": ([1, 4, 300], 900)}[kind]
    src, dst, ln, pos = [], [], [], 0
    while True:
        pos += int(rng.randint(0, gap + 1))
        length = int(rng.choice(lengths))
        if pos + length > out_len:
            return src, dst, ln
        src.append(int(rng.randint(-8, src_len + 9)))
        dst.append(pos)
        ln.append(length)
        pos += length


def _on_card(plan, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in plan.items()}


@pytest.mark.parametrize("chunk", [1, 3, 1000, 4096, 4097, 8192, 1 << 16])
@pytest.mark.parametrize("kind", ["tiny", "mixed", "single", "gappy"])
def test_apply_runs_edges_match_plain(dev, chunk, kind):
    """Every kind of chunk (off the 16-byte grid too), pieces of 1-3
    words, thousands of pieces in a chunk, one run over everything,
    gaps, reads past either end, a source whose length is not a multiple
    of 4, and the plan as numpy and as CUDA tensors."""
    out_len = chunk * -(-20_000 // chunk)
    src_len = out_len // 2 + 4 * 1001 + 3
    src = _words(chunk + len(kind), src_len, dup=False)
    plan = build_piece_plan(*_edge_runs(chunk, kind, out_len, src_len),
                            out_len, chunk)
    want = apply_runs_plain(src, plan, out_len, chunk)
    for p in (plan, _on_card(plan, dev)):
        got = apply_runs(src.to(dev), p, out_len, chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("view", [0, 1, 2, 3])
def test_apply_runs_every_residue(dev, view):
    """Pieces whose source and destination differ by every residue mod
    4, on a source view 0-3 words off the 16-byte grid: the 16-byte
    loads, the word loads and the edges of each."""
    chunk, out_len = 2048, 4 * 2048
    src, dst, ln, pos = [], [], [], 0
    for r in range(64):
        length = (5, 64, 515, 1, 2, 3, 4, 17)[r % 8]
        pos += r % 3
        if pos + length > out_len:
            break
        src.append(pos + r % 4 + 8 * (r % 5))
        dst.append(pos)
        ln.append(length)
        pos += length
    base = _words(10 + view, out_len + 64, dup=False)
    plan = build_piece_plan(src, dst, ln, out_len, chunk)
    want = apply_runs_plain(base[view:], plan, out_len, chunk)
    got = apply_runs(base.to(dev)[view:], _on_card(plan, dev), out_len,
                     chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_apply_runs_thousands_of_pieces_and_empty_ones(dev):
    """A hand-made plan: 5000 one- and two-word pieces in one chunk
    (several batches of the kernel's shared memory), with empty pieces
    among them: at batches' edges, and one that begins inside the piece
    before it, which ends a batch."""
    chunk = 16384
    rng = np.random.RandomState(11)
    lens = rng.randint(0, 3, size=5000)
    lens[[0, 1024, 1025, 2047, 2048, 4999]] = 0
    lens[1023] = 2
    gaps = rng.randint(0, 2, size=5000)
    dst = np.cumsum(gaps + lens) - lens
    dst[1024] = dst[1023] + 1
    plan = {"piece_src": rng.randint(0, 9000, size=5000).astype(np.int32),
            "piece_dst_off": dst.astype(np.int32),
            "piece_len": lens.astype(np.int32),
            "chunk_first": np.array([0, 5000], np.int32),
            "chunk_count": np.array([5000, 0], np.int32)}
    src = _words(12, 9001, dup=False)
    want = apply_runs_plain(src, plan, 2 * chunk, chunk)
    got = apply_runs(src.to(dev), _on_card(plan, dev), 2 * chunk,
                     chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("ns", [1, 2, 3, 4])
@pytest.mark.parametrize("chunk", [1, 1000, 4097, 16384])
def test_move_runs_edges_match_plain(dev, ns, chunk):
    """K6 on the same edges: tiny, long and empty runs, thousands in a
    chunk, fills, and source views off the 16-byte grid."""
    out_len = chunk * -(-20_000 // chunk)
    n = 12_003
    runs = [torch.tensor(a, dtype=torch.int32) for a in _edge_runs(
        ns + chunk, "tiny" if chunk > 1000 else "mixed", out_len, n)]
    base = [_words(20 + t, n + 3, dup=False) for t in range(ns)]
    srcs = [b[t:t + n] for t, b in enumerate(base)]
    fills = [0xFFFFFFFF, 0, 5, 0x80000000][:ns]
    got = move_runs([b.to(dev)[t:t + n] for t, b in enumerate(base)],
                    *(r.to(dev) for r in runs), out_len, fills=fills,
                    chunk=chunk)
    want = move_runs_plain(srcs, *runs, out_len, fills)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# --- the hybrid engine and the order statistics ---------------------------

@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("sort_bits", [None, 12])
def test_hybrid_matches_host(dev, kv, sort_bits):
    n = (1 << 20) + 13
    k = _words(5, n, dup=False).view(torch.uint32)
    v = torch.arange(n, dtype=torch.int32)
    cfg = sortx_torch.Config(engine="hybrid", engine_tile_elems=1 << 17)
    if kv:
        got = sortx_torch.sort_kv(k.to(dev), v.to(dev), sort_bits, config=cfg)
        want = sortx_torch.sort_kv(k, v, sort_bits)
    else:
        got = (sortx_torch.sort(k.to(dev), sort_bits, config=cfg),)
        want = (sortx_torch.sort(k, sort_bits),)
    assert sort_hybrid.last_dispatch == "hybrid"
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_order_statistics_match_cpu(dev):
    k = (_words(6, 1 << 20) ^ _words(7, 1 << 20, dup=False) % 3)
    assert torch.equal(sortx_torch.kth_value(k.to(dev), 12345).cpu(),
                       sortx_torch.kth_value(k, 12345))
    for kk in (16, 1024):
        got = sortx_torch.top_k(k.to(dev), kk, return_indices=True)
        want = sortx_torch.top_k(k, kk, return_indices=True)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


# --- the wide stream sets and the merge stage (slice 3) --------------------

def _tie_free(x, nk):
    """Make key stream nk-1 a permutation, as the idx stream is."""
    n = x.shape[1]
    x[nk - 1] = torch.randperm(n, generator=torch.Generator().manual_seed(nk))
    return x


@pytest.mark.parametrize("ns, nk", WIDE_SETS)
@pytest.mark.parametrize("kernel", ["block", "tail", "global_max",
                                    "global1"])
def test_wide_kernel_matches_plain(dev, ns, nk, kernel):
    n = 1 << 15
    x = _tie_free(_words(ns * 16 + nk, (ns, n)), nk)
    lb = tb.block_log(ns)
    fm = tb.f_max(ns)
    name, fn, plain, args = {
        "block": ("bitonic_block", tb.bitonic_block, tb.block_plain,
                  (n, nk, lb)),
        "tail": ("bitonic_tail", tb.bitonic_tail, tb.tail_plain,
                 (n, nk, lb, 15)),
        "global_max": ("bitonic_global", tb.bitonic_global, tb.global_plain,
                       (n, nk, 15, 14, 15 - fm)),
        "global1": ("bitonic_global", tb.bitonic_global, tb.global_plain,
                    (n, nk, 14, 12, 12)),
    }[kernel]
    got = x.to(dev)
    want = x.to(dev)
    before = launches[name]
    fn(got, *args)
    plain(want, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert launches[name] == before + 1


@pytest.mark.parametrize("ns, nk", WIDE_SETS)
def test_wide_network_with_pruned_extent(dev, ns, nk):
    n, nv = 1 << 16, (1 << 14) + 77
    x = torch.full((ns, n), -1, dtype=torch.int32)
    x[:, :nv] = _words(ns + 40, (ns, nv))
    got = tb.bitonic_sort_streams(x.to(dev), nk, n_valid=nv)
    want = tb.bitonic_sort_streams(x.clone(), nk, n_valid=nv)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("ns, nk", [(1, 1), (3, 2)])
@pytest.mark.parametrize("n", [1 << 10, 1 << 12, 1 << 13, 1 << 17])
def test_merge_stage_matches_plain(dev, ns, nk, n):
    """At n <= 2^L the stage is one K2 pass with s == L."""
    rng = np.random.RandomState(n + ns)
    na = int(rng.randint(1, n))
    a = np.sort(rng.randint(0, 500, size=na))
    b = np.sort(rng.randint(0, 500, size=n - na))
    x = _words(n, (ns, n), dup=False)
    x[0] = torch.from_numpy(np.concatenate([a, b[::-1]]).astype(np.int32))
    if nk == 2:
        x[1] = torch.arange(n)
    got = tb.bitonic_merge_streams(x.to(dev), nk)
    want = tb.bitonic_merge_streams(x.clone(), nk)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want[0], torch.sort(x[0]).values)


def _u64_keys(seed, n, dtype):
    rng = np.random.RandomState(seed)
    k = (rng.randint(0, 40, size=n).astype(np.uint64) << np.uint64(33)) | \
        rng.randint(0, 4, size=n).astype(np.uint64)
    if dtype == torch.float64:
        return torch.from_numpy(rng.randint(-30, 30, size=n) / 4.0)
    t = torch.from_numpy(k.view(np.int64))
    return t.view(torch.uint64) if dtype == torch.uint64 else t - (1 << 40)


@pytest.mark.parametrize("dtype", [torch.uint64, torch.int64, torch.float64])
@pytest.mark.parametrize("n", [5000, 1 << 16])
def test_64bit_ops_match_cpu(dev, dtype, n):
    k = _u64_keys(n, n, dtype)
    v = torch.arange(n, dtype=torch.int32)
    v64 = torch.arange(n, dtype=torch.int64) * -7
    for got, want in (
            (sortx_torch.sort(k.to(dev)), sortx_torch.sort(k)),
            (sortx_torch.sort(k.to(dev), descending=True),
             sortx_torch.sort(k, descending=True)),
            (sortx_torch.argsort(k.to(dev)), sortx_torch.argsort(k)),
            (sortx_torch.sort_kv(k.to(dev), v.to(dev))[1],
             sortx_torch.sort_kv(k, v)[1]),
            (sortx_torch.sort_kv(v.to(dev) % 97, v64.to(dev))[1],
             sortx_torch.sort_kv(v % 97, v64)[1])):
        assert torch.equal(got.cpu().view(torch.int64 if got.element_size()
                                          == 8 else torch.int32),
                           want.view(torch.int64 if want.element_size() == 8
                                     else torch.int32))


@pytest.mark.parametrize("n", [1000, (1 << 16) + 13])
def test_unstable_64bit_values_match_cpu(dev, n):
    """(key, hi, lo) with three keys at ragged n: bit-exact."""
    k = _words(n, n).view(torch.uint32)
    v = torch.arange(n, dtype=torch.int64) * 3
    got = sortx_torch.sort_kv(k.to(dev), v.to(dev), stable=False)
    want = sortx_torch.sort_kv(k, v, stable=False,
                               config=sortx_torch.Config(engine="network"))
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[1].cpu(), want[1])


def test_lexsort_and_merge_match_cpu(dev):
    n = 20_000
    rng = np.random.RandomState(11)
    cols = [torch.from_numpy(rng.randint(0, 3, size=n).astype(np.int32))
            for _ in range(7)]
    cols[2] = cols[2].to(torch.float64)           # two words: 8 streams
    for c in (cols[:1], cols[:3], cols):
        assert torch.equal(sortx_torch.lexsort([x.to(dev) for x in c]).cpu(),
                           sortx_torch.lexsort(c))
    a = torch.sort(_words(1, 7000)).values
    b = torch.sort(_words(2, 5000)).values
    assert torch.equal(sortx_torch.merge(a.to(dev), b.to(dev)).cpu(),
                       sortx_torch.merge(a, b))
    va, vb = torch.arange(7000, dtype=torch.int32), torch.arange(5000,
                                                                 dtype=torch.int32)
    got = sortx_torch.merge_kv(a.to(dev), va.to(dev), b.to(dev), vb.to(dev))
    want = sortx_torch.merge_kv(a, va, b, vb)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_keyed_and_segmented_ops_match_cpu(dev):
    n = (1 << 16) + 5
    k = _words(3, n) % 50
    v = _words(4, n, dup=False)
    off = torch.tensor([0, 0, 7, 7, 1000, 30_000, n - 1, n])
    for name, args in (
            ("unique", (k, 64)), ("run_length_encode", (k, 64)),
            ("reduce_by_key", (k, v, 64)), ("sum_by_key", (k, v, 64)),
            ("partition", (v, k > 20)),
            ("sort_segments", (v, off)), ("sort_kv_segments", (k, v, off)),
            ("scan_segments", (v, off)), ("scan_by_key", (k, v))):
        fn = getattr(sortx_torch, name)
        got = fn(*(a.to(dev) if torch.is_tensor(a) else a for a in args))
        want = fn(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), name


@pytest.mark.parametrize("dtype", [torch.uint32, torch.float32,
                                   torch.float16, torch.bfloat16])
def test_glue_on_unsigned_and_float_keys_matches_cpu(dev, dtype):
    """uint32 keys (which torch cannot gather or compare on the card) and
    16-bit floats with NaNs of both signs through the keyed, merge and
    segmented ops."""
    n = 40_000
    w = _words(7, n) % 97
    if dtype == torch.uint32:
        k = w.view(torch.uint32)
    else:
        k = (w.to(torch.float32) / 4 - 10).to(dtype)
        k[::31] = float("nan")
        k[::37] = -float("nan")
        k[::41] = -0.0
    v = _words(8, n, dup=False)
    off = torch.tensor([0, 5, 5, 20_000, 39_999, n])
    sk = sortx_torch.sort(k)
    for name, args in (
            ("sort", (k,)), ("argsort", (k,)), ("unique", (k, 128)),
            ("run_length_encode", (k, 4096)), ("reduce_by_key", (k, v, 4096)),
            ("sum_by_key", (k, v, 128)), ("sort_segments", (k, off)),
            ("sort_kv_segments", (k, v, off)), ("scan_by_key", (k, v)),
            ("merge", (sk[:n // 2], sk[n // 2:])),
            ("searchsorted", (sk, k)), ("lexsort", ([v, k],))):
        fn = getattr(sortx_torch, name)
        on = [[x.to(dev) for x in a] if isinstance(a, list)
              else a.to(dev) if torch.is_tensor(a) else a for a in args]
        got, want = fn(*on), fn(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(_bits(g.cpu()), _bits(w))
                   for g, w in zip(got, want)), name


def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


# --- K1 and K2 at every block size (the register design, slice 4) ----------

# every block from 2^10 to the one the library picks, for the narrow sets
BLOCKS = [(ns, nk, lb) for ns, nk in STREAM_SETS
          for lb in range(10, tb.block_log(ns) + 1)]
# the ends of the design's range and the per-layer kernels below it, for
# a narrow and the widest set; 14: one stream between its two designs
EDGE_BLOCKS = [(ns, nk, lb) for ns, nk in ((1, 1), (3, 2), (8, 8))
               for lb in (1, 2, 7, 8, 9, 14) if 4 * ns << lb <= 64 << 10]


def _run_block_mode(dev, x, nk, lb, mode):
    n = x.shape[1]
    name, args = {
        "block": ("bitonic_block", (n, nk, lb)),
        "block_rows": ("bitonic_block", (n, nk, lb, max(lb - 2, 1))),
        "block_row_is_block": ("bitonic_block", (n, nk, lb, lb)),
        "tail": ("bitonic_tail", (n, nk, lb, lb + 1)),
        "tail_asc": ("bitonic_tail", (n, nk, lb, lb + 2, True)),
        "tail_merge": ("bitonic_tail", (n, nk, lb, lb, True)),
    }[mode]
    fn, plain = tb.KERNELS[name]
    got, want = x.to(dev), x.to(dev)
    before = launches[name]
    fn(got, *args)
    plain(want, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert launches[name] == before + 1


@pytest.mark.parametrize("ns, nk, lb", BLOCKS)
@pytest.mark.parametrize("mode", ["block", "block_rows", "block_row_is_block",
                                  "tail", "tail_asc", "tail_merge"])
def test_block_kernels_match_plain_at_every_block(dev, ns, nk, lb, mode):
    """Duplicate-heavy words in every stream: pairs tie on all keys, and
    a tied pair must stay put in registers, shuffles and shared memory."""
    _run_block_mode(dev, _words(lb * 64 + ns * 8 + nk, (ns, 8 << lb)), nk,
                    lb, mode)


@pytest.mark.parametrize("ns, nk, lb", EDGE_BLOCKS)
@pytest.mark.parametrize("mode", ["block", "tail"])
def test_block_kernels_match_plain_at_the_edges(dev, ns, nk, lb, mode):
    _run_block_mode(dev, _words(lb + ns, (ns, 8 << lb)), nk, lb, mode)


@pytest.mark.parametrize("ns, nk", [(1, 1), (3, 2), (5, 5)])
@pytest.mark.parametrize("mode", ["block", "tail"])
def test_block_kernels_take_streams_off_the_16_byte_grid(dev, ns, nk, mode):
    lb = 10
    n = 4 << lb
    x = _words(ns, (ns, n + 4)).to(dev)[:, 1:n + 1]
    want = x.clone()
    name = "bitonic_" + mode
    args = (n, nk, lb) if mode == "block" else (n, nk, lb, lb + 1)
    tb.KERNELS[name][0](x, *args)
    tb.KERNELS[name][1](want, *args)
    torch.cuda.synchronize()
    assert torch.equal(x, want)


# --- K4 as a look-back scan and K5 with its prefix filter -------------------

def _scan_input(kind, n, dev):
    """n words: near 2^31 in magnitude (the sum wraps), all ones (it
    wraps every step), or the former as a view shifted by one word."""
    if kind == "ones":
        return torch.full((n,), -1, dtype=torch.int32, device=dev)
    rng = np.random.RandomState(n % 1000)
    x = rng.randint(2**30, 2**31, size=n + 1).astype(np.int32)
    x[::3] = -x[::3]
    x = torch.from_numpy(x).to(dev)
    return x[1:] if kind == "shifted" else x[:n]


@pytest.mark.parametrize("n", [1, 31, 1023, 8191, 8192, 8193, (1 << 20) + 7,
                               1 << 27])
@pytest.mark.parametrize("kind", ["wrapping", "ones", "shifted"])
@pytest.mark.parametrize("tile", [8192, 1 << 18])
def test_scan_lookback_matches_plain(dev, n, kind, tile):
    """``tile`` is what a config hands down (the port's default and the
    reference's): the kernel runs, on its own tile, under both."""
    x = _scan_input(kind, n, dev)
    for inclusive in (False, True):
        before = launches["scan"]
        out, total = tile_scan(x, inclusive=inclusive, tile_elems=tile)
        pout, ptotal = scan_plain(x, inclusive)
        torch.cuda.synchronize()
        assert torch.equal(out, pout) and torch.equal(total, ptotal)
        assert launches["scan"] == before + 1


def test_scan_repeats_give_the_same_bits(dev):
    """A race in the look-back would change a prefix between runs."""
    x = _scan_input("wrapping", (1 << 22) + 9, dev)
    first = tile_scan(x)
    want = scan_plain(x)
    assert torch.equal(first[0], want[0]) and torch.equal(first[1], want[1])
    for _ in range(20):
        out, total = tile_scan(x)
        assert torch.equal(out, first[0]) and torch.equal(total, first[1])


@pytest.mark.parametrize("tile", [1024, 3072, 1 << 14, 1 << 15, 1 << 18])
@pytest.mark.parametrize("inclusive", [False, True])
def test_scan_runs_under_every_tile_a_config_accepts(dev, tile, inclusive):
    """Any positive multiple of 1024, the reference's default 2^18
    included, launches the kernel and gives the plain version's bits."""
    x = _scan_input("wrapping", (1 << 20) + 7, dev)
    cfg = sortx_torch.Config(scan_tile_elems=tile)
    before = launches["scan"]
    out, total = sortx_torch.scan(x, with_total=True, inclusive=inclusive,
                                  config=cfg)
    want = scan_plain(x, inclusive)
    assert launches["scan"] == before + 1
    assert torch.equal(out, want[0]) and torch.equal(total, want[1])


@pytest.mark.parametrize("tile", [1000, 512, 0, -1024])
def test_scan_rejects_a_tile_no_config_accepts(dev, tile):
    x = _scan_input("ones", 10_000, dev)
    with pytest.raises(ValueError):
        tile_scan(x, tile_elems=tile)


def test_scan_on_a_side_stream(dev):
    x = _scan_input("wrapping", (1 << 22) + 5, dev)
    want = scan_plain(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out, total = sortx_torch.scan(x, with_total=True)
    side.synchronize()
    assert torch.equal(out, want[0]) and torch.equal(total, want[1])


def test_interleaved_scans_share_no_scratch(dev):
    """Two scans in flight at once, on two streams, each with its own
    descriptors and ticket; then two back to back on one stream."""
    a = _scan_input("wrapping", (1 << 24) + 1, dev)
    b = _scan_input("ones", (1 << 24) - 3, dev)
    want_a, want_b = scan_plain(a), scan_plain(b)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for _ in range(5):
        for x, st in ((a, streams[0]), (b, streams[1])):
            with torch.cuda.stream(st):
                got.append(tile_scan(x))
    got += [tile_scan(a), tile_scan(b)]
    torch.cuda.synchronize()
    for i, (out, total) in enumerate(got):
        want = want_b if i % 2 else want_a
        assert torch.equal(out, want[0]) and torch.equal(total, want[1])


def _hist_words(kind, n, dev):
    rng = np.random.RandomState(n % 997)
    if kind == "uniform":
        x = rng.randint(-2**31, 2**31, size=n).astype(np.int32)
    elif kind == "equal":
        x = np.full(n, 0x5A5A5A5A, np.int32)
    else:
        x = (rng.randint(0, 2, size=n).astype(np.uint32) * 0x11111111
             + 0x01020304).astype(np.uint32).view(np.int32)
    return torch.from_numpy(x).to(dev)


def _prefix_of_middle(x, hi_shift):
    mid = x[x.shape[0] // 2].view(1).to(torch.int64) & 0xFFFFFFFF
    return (mid >> min(hi_shift, 31)).to(torch.int32)


@pytest.mark.parametrize("kind", ["uniform", "equal", "two"])
@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("shift", [0, 7, 24, "top"])
def test_histogram_kinds_match_plain(dev, kind, bits, shift):
    """Every digit width, on the tensor and on a view shifted by one
    word, at a ragged n: per tile and whole, with and without a prefix."""
    shift = 32 - bits if shift == "top" else shift
    n = (1 << 18) + 13
    buf = _hist_words(kind, n + 1, dev)
    for x in (buf[:n], buf[1:]):
        prefix = _prefix_of_middle(x, shift + bits)
        for tile, kw in ((16384, {}), (16384, {"per_tile": False}),
                         (16384, {"prefix": prefix}),
                         (1000, {"per_tile": False, "prefix": prefix})):
            before = launches["histogram"]
            got = tile_histogram(x, shift, radix=1 << bits, tile_elems=tile,
                                 **kw)
            want = histogram_plain(x, shift, 1 << bits, tile,
                                   kw.get("prefix"))
            if not kw.get("per_tile", True):
                want = want.sum(0, dtype=torch.int32)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert launches["histogram"] == before + 1


@pytest.mark.parametrize("kind", ["uniform", "equal", "two"])
@pytest.mark.parametrize("shift", [24, 16, 8, 0])
@pytest.mark.parametrize("n", [1 << 27, (1 << 20) - 12345])
def test_histogram_rounds_of_kth_value_match_plain(dev, kind, shift, n):
    x = _hist_words(kind, n, dev)
    prefix = _prefix_of_middle(x, shift + 8)
    want = histogram_plain(x, shift, 256, 16384, prefix)
    got = tile_histogram(x, shift, radix=256, tile_elems=16384, prefix=prefix)
    whole = tile_histogram(x, shift, radix=256, tile_elems=16384,
                           per_tile=False, prefix=prefix)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(whole, want.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32,
                                   torch.float16, torch.bfloat16])
def test_kth_value_and_median_match_cpu(dev, dtype):
    n = (1 << 20) + 77
    w = _words(9, n, dup=False)
    if dtype.is_floating_point:
        k = (w % 2001).to(torch.float32).div(8).sub(100).to(dtype)
        k[::31] = float("nan")
        k[::37] = -float("nan")
        k[::41] = -0.0
    else:
        k = w.view(dtype)
    on = k.to(dev)
    before = launches["histogram"]
    for rank in (0, 12345, n // 2, n - 1, torch.tensor(4321)):
        r = rank.to(dev) if torch.is_tensor(rank) else rank
        assert torch.equal(_bits(sortx_torch.kth_value(on, r).cpu()),
                           _bits(sortx_torch.kth_value(k, rank)))
    assert torch.equal(_bits(sortx_torch.median(on).cpu()),
                       _bits(sortx_torch.median(k)))
    assert launches["histogram"] == before + 6 * 4


# --- the runtime layer, the facade and the out-of-core sort on the card ---


def test_buffer_nonblocking_write_completes(dev):
    from sortx_torch.runtime import Buffer, SyncObject, allocate_device

    device = allocate_device()
    assert device.torch_device == torch.device("cuda", 0)
    assert device.n_cores == torch.cuda.get_device_properties(
        0).multi_processor_count
    host = np.random.RandomState(3).randint(0, 2**32, size=1 << 22,
                                            dtype=np.uint32)
    buf = Buffer(device, np.uint32, 1 << 22)
    assert buf.array.is_cuda
    sync = buf.write(host, blocking=False)
    assert isinstance(sync, SyncObject) and sync._event is not None
    sync.wait()
    assert sync.is_complete
    np.testing.assert_array_equal(buf.read(), host)
    buf.destroy()
    device.check_leaks()


def test_parallel_primitives_with_n_short(dev):
    from sortx_torch.runtime import Buffer, allocate_device

    device = allocate_device()
    pp = sortx_torch.ParallelPrimitives(device)
    size, n = 1 << 20, (1 << 20) - 1000 + 13
    rng = np.random.RandomState(4)
    keys = rng.randint(0, 2**32, size=size, dtype=np.uint32)
    vals = np.arange(size, dtype=np.uint32)
    kb, vb = Buffer(device, np.uint32, size), Buffer(device, np.uint32, size)
    kb.write(keys)
    vb.write(vals)
    pp.radix_sort_kv(kb, vb, n)
    order = np.argsort(keys[:n], kind="stable")
    np.testing.assert_array_equal(kb.read(), np.concatenate(
        [keys[:n][order], keys[n:]]))
    np.testing.assert_array_equal(vb.read(), np.concatenate(
        [vals[:n][order], vals[n:]]))
    kb.write(keys)
    pp.radix_sort(kb, n)
    np.testing.assert_array_equal(kb.read()[:n], np.sort(keys[:n]))
    dst = Buffer(device, np.uint32, size)
    dst.fill(7)
    total = pp.scan(dst, kb, n, with_total=True)
    wide = np.sort(keys[:n]).astype(np.uint64)
    assert total.dtype == torch.uint32 and total.is_cuda
    assert int(total.view(torch.int32)) & 0xFFFFFFFF == int(
        wide.sum() & 0xFFFFFFFF)
    np.testing.assert_array_equal(dst.read()[:n], ((np.cumsum(wide) - wide)
                                                   & 0xFFFFFFFF))
    assert np.all(dst.read()[n:] == 7)
    for b in (kb, vb, dst):
        b.destroy()
    device.check_leaks()


def test_sort_large_chunks_on_the_card(dev):
    rng = np.random.RandomState(5)
    n, chunk = 1 << 22, 1 << 20
    k = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    launches.clear()
    np.testing.assert_array_equal(sortx_torch.sort_large(k, chunk_elems=chunk),
                                  np.sort(k))
    # each chunk is a radix sort: K9 and four K10 passes, no network
    assert launches["radix_histogram"] == 4
    assert launches["radix_onesweep"] == 16
    assert launches["bitonic_block"] == 0
    kf = rng.randn(n).astype(np.float32)
    v = np.arange(n, dtype=np.int32)
    ks, vs = sortx_torch.sort_kv_large(kf, v, chunk_elems=chunk,
                                       descending=True)
    order = np.argsort(-kf, kind="stable")
    np.testing.assert_array_equal(ks, kf[order])
    np.testing.assert_array_equal(vs, v[order])


def test_kernel_rows_equal_launches(dev, tmp_path):
    """At level="kernel" each kernel launch writes one row, named as the
    kernel: the rows of one sort_kv count what _build.launches counts."""
    import collections

    from sortx_torch.runtime import toggle_profiling

    csv = tmp_path / "prof.csv"
    k = _words(6, 1 << 20, dup=True).to(dev)
    v = torch.arange(1 << 20, dtype=torch.int32, device=dev)
    launches.clear()
    toggle_profiling(True, str(csv), level="kernel")
    try:
        sortx_torch.sort_kv(k, v)
    finally:
        toggle_profiling(False, level="op")
    rows = collections.Counter(r.split(",")[0]
                               for r in csv.read_text().splitlines())
    assert rows.pop("sort_kv") == 1
    # the radix engine: K9 once, K10 once a pass
    assert rows == collections.Counter(launches) and len(rows) == 2


def test_no_rows_while_a_graph_is_captured(dev, tmp_path):
    """A sort captured into a CUDA graph writes no profile row and does
    not synchronise; the replayed graph sorts."""
    from sortx_torch.ops.sort_network import sort_network
    from sortx_torch.runtime import toggle_profiling

    csv = tmp_path / "prof.csv"
    src = _words(7, 1 << 18, dup=False).to(dev)
    keys = src.clone()
    sort_network(keys, 32)                  # builds, warms the allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    toggle_profiling(True, str(csv), level="kernel")
    try:
        with torch.cuda.graph(graph):
            out = sort_network(keys, 32)
    finally:
        toggle_profiling(False, level="op")
    assert not csv.exists() or csv.read_text() == ""
    graph.replay()
    torch.cuda.synchronize()
    want = torch.sort(src.to(torch.int64) & 0xFFFFFFFF).values
    assert torch.equal(out.to(torch.int64) & 0xFFFFFFFF, want)


def test_device_capacity_keys_on_the_card(dev):
    from sortx_torch.ops.out_of_core import device_capacity_keys

    budget = int(torch.cuda.mem_get_info()[1] * 0.90)
    assert device_capacity_keys(1) == 1 << ((budget // 8).bit_length() - 1)
    assert device_capacity_keys(3) == 1 << ((budget // 24).bit_length() - 1)


# --- the ops inside a CUDA graph -------------------------------------------

def _graph_keys(kind, n, dev, seed=0):
    """u32 keys of one kind: random (ties), sorted, reversed, all equal."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randint(0, 1 << 20, (n,), device=dev, generator=g,
                      dtype=torch.int32)
    if kind in ("nondecreasing", "nonincreasing"):
        k = torch.sort(k, descending=kind == "nonincreasing").values
    elif kind == "all-equal":
        k = k[:1].expand(n).clone()
    return k.view(torch.uint32)


GRAPH_KINDS = ["random", "nondecreasing", "nonincreasing", "all-equal"]
HOST = sortx_torch.Config(engine="host")


def _same_tree(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(a, b))


def _capture(run, static):
    """Warm run(static) up on a side stream, then capture it; returns
    (graph, its outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(static)
    return graph, out


GRAPH_OPS = {   # name -> (run(static, config), the host engine holds it)
    "sort": (lambda st, cfg=None: sortx_torch.sort(st["k"], config=cfg),
             True),
    "sort_kv": (lambda st, cfg=None: sortx_torch.sort_kv(
        st["k"], st["v"], config=cfg), True),
    "sort_kv unstable": (lambda st, cfg=None: sortx_torch.sort_kv(
        st["k"], st["v"], stable=False), False),
    "scan": (lambda st, cfg=None: sortx_torch.scan(
        st["k"].view(torch.int32), with_total=True, config=cfg), True),
    "entry": (lambda st, cfg=None: sortx_torch.entry(st["k"], st["v"],
                                                     config=cfg), True),
    "kth_value": (lambda st, cfg=None: sortx_torch.kth_value(
        st["k"], st["r"], config=cfg), True),
}


@pytest.mark.parametrize("n", [1 << 20, (1 << 19) + 13])
@pytest.mark.parametrize("op", sorted(GRAPH_OPS))
def test_capture_and_replay_follow_new_inputs(dev, op, n):
    """Captured once, replayed on random, sorted, reversed and all-equal
    keys (and kth_value on a new rank): each replay equals the eager call
    bit for bit, and that the host engine's (unstable sort_kv: its keys,
    and its values where the keys came sorted)."""
    run, by_host = GRAPH_OPS[op]
    vals = torch.arange(n, dtype=torch.int32, device=dev).flip(0)
    static = {"k": _graph_keys("random", n, dev), "v": vals.clone(),
              "r": torch.full((), n // 3, dtype=torch.int32, device=dev)}
    graph, out = _capture(run, static)
    cases = [(kind, {"k": _graph_keys(kind, n, dev, 1)})
             for kind in GRAPH_KINDS]
    cases.append(("another rank", {"r": torch.full(
        (), n - 2, dtype=torch.int32, device=dev)}))
    for kind, new in cases:
        for k, t in new.items():
            static[k].copy_(t)
        graph.replay()
        eager = run(static)
        assert _same_tree(out, eager), kind
        if by_host:
            assert _same_tree(eager, run(static, HOST)), kind
        else:
            assert _same_tree(eager[0], sortx_torch.sort(static["k"]))
            if kind in ("nondecreasing", "all-equal"):
                assert torch.equal(eager[1], static["v"]), kind


# the capture list's ops at 2^16 on the network engine (on a CUDA tensor
# "auto" is the network)
SYNC_OPS = {
    "sort u32": lambda t: sortx_torch.sort(t["k"]),
    "sort f32": lambda t: sortx_torch.sort(t["f"]),
    "sort i16": lambda t: sortx_torch.sort(t["k"].to(torch.int16)),
    "sort u64": lambda t: sortx_torch.sort(t["w"].view(torch.uint64)),
    "sort sort_bits=8": lambda t: sortx_torch.sort(t["k"], 8),
    "sort sort_bits=20": lambda t: sortx_torch.sort(t["k"], 20),
    "sort descending": lambda t: sortx_torch.sort(t["k"], descending=True),
    "sort ragged": lambda t: sortx_torch.sort(t["k"][:-13]),
    "sort_kv stable": lambda t: sortx_torch.sort_kv(t["k"], t["v"]),
    "sort_kv unstable": lambda t: sortx_torch.sort_kv(t["k"], t["v"],
                                                      stable=False),
    "sort_kv 64-bit values": lambda t: sortx_torch.sort_kv(t["k"], t["w"]),
    "scan": lambda t: sortx_torch.scan(t["v"], with_total=True),
    "entry": lambda t: sortx_torch.entry(t["k"], t["v"]),
    "argsort": lambda t: sortx_torch.argsort(t["k"]),
    "lexsort": lambda t: sortx_torch.lexsort((t["v"], t["k"])),
    "merge": lambda t: sortx_torch.merge(t["a"], t["b"]),
    "merge_kv": lambda t: sortx_torch.merge_kv(
        t["a"], t["v"][:t["a"].shape[0]], t["b"], t["v"][:t["b"].shape[0]]),
    "sort_segments": lambda t: sortx_torch.sort_segments(t["k"], t["o"]),
    "scan_segments": lambda t: sortx_torch.scan_segments(
        t["v"], t["o"], with_totals=True),
    "kth_value": lambda t: sortx_torch.kth_value(t["k"], t["r"]),
    "median": lambda t: sortx_torch.median(t["f"]),
    "top_k": lambda t: sortx_torch.top_k(t["f"], 64, return_indices=True),
    "unique": lambda t: sortx_torch.unique(t["k"], 100),
    "histogram": lambda t: sortx_torch.histogram(t["k"], 8, 12),
    "sort_rows": lambda t: sortx_torch.sort_rows(t["k"].view(16, -1)),
    "sort_kv_rows": lambda t: sortx_torch.sort_kv_rows(
        t["k"].view(16, -1), t["v"].view(16, -1)),
}


@pytest.mark.parametrize("op", sorted(SYNC_OPS))
def test_op_makes_no_implicit_sync(dev, op):
    n = 1 << 16
    g = torch.Generator(device=dev).manual_seed(5)
    k = _graph_keys("random", n, dev)
    t = {"k": k, "v": torch.arange(n, dtype=torch.int32, device=dev),
         "f": torch.randn(n, generator=g, device=dev),
         "w": torch.randint(-2**62, 2**62, (n,), generator=g, device=dev),
         "a": torch.sort(k[:n // 2].view(torch.int32)).values.view(
             torch.uint32),
         "b": torch.sort(k[n // 2:].view(torch.int32)).values.view(
             torch.uint32),
         "o": torch.tensor([0, 5, 5, 999, n], device=dev),
         "r": torch.full((), 77, dtype=torch.int32, device=dev)}
    SYNC_OPS[op](t)                       # builds, warms the allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        SYNC_OPS[op](t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_hybrid_refuses_capture(dev):
    keys = _graph_keys("random", 1 << 16, dev)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="hybrid engine reads its bucket"):
        with torch.cuda.graph(graph):
            sortx_torch.sort(keys, config=sortx_torch.Config(engine="hybrid"))


def test_no_profile_rows_while_public_ops_are_captured(dev, tmp_path):
    """The port's side of the reference's
    ``test_profile_rows_not_emitted_under_user_jit``: no op, step or
    kernel row while a graph is captured; the replay sorts."""
    from sortx_torch.runtime import toggle_profiling

    csv = tmp_path / "prof.csv"
    keys = _graph_keys("random", 1 << 18, dev)
    vals = torch.arange(1 << 18, dtype=torch.int32, device=dev)
    run = lambda: sortx_torch.entry(keys, vals)  # noqa: E731
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    toggle_profiling(True, str(csv), level="kernel")
    try:
        with torch.cuda.graph(graph):
            out = run()
    finally:
        toggle_profiling(False, level="op")
    assert not csv.exists() or csv.read_text() == ""
    graph.replay()
    assert _same_tree(out, sortx_torch.entry(keys, vals, config=HOST))


def test_capture_with_no_warm_up_in_a_new_process(dev, tmp_path):
    """A process that captures sort, sort_kv and scan before any eager
    call: the kernels' once-a-device shared-memory attributes are then
    set while the stream captures, which CUDA allows."""
    import subprocess
    import sys

    code = """if True:
        import torch, sortx_torch
        from sortx_torch.ops import _build
        _build.library()
        n = 1 << 20
        k = torch.randint(0, 1 << 30, (n,), device="cuda",
                          dtype=torch.int32).view(torch.uint32)
        v = torch.arange(n, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = (sortx_torch.sort(k), *sortx_torch.sort_kv(k, v),
                   *sortx_torch.scan(v, with_total=True))
        g.replay()
        ref = torch.sort(k.view(torch.int32), stable=True)
        assert torch.equal(out[0].view(torch.int32), ref.values)
        assert torch.equal(out[2], ref.indices.to(torch.int32))
        assert int(out[4]) == (n * (n - 1) // 2) % 2**32 - 2**32 * (
            (n * (n - 1) // 2) % 2**32 >= 2**31)
        print("captured cold")
    """
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0 and "captured cold" in res.stdout, res.stderr


@pytest.mark.parametrize("n", [1, 3, 1 << 10, (1 << 20) + 5])
@pytest.mark.parametrize("flag", [0, 1, 2, 3])
def test_reverse_matches_plain(dev, n, flag):
    src = _words(n, n, dup=False).to(dev)
    got = _words(n + 1, n, dup=False).to(dev)
    want = got.clone()
    flags = torch.full((), flag, dtype=torch.int32, device=dev)
    before = launches["reverse"]
    tb.reverse_ordered(src, got, flags)
    tb.reverse_plain(src, want, flags)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if n > 1:
        assert torch.equal(got, src.flip(0)) == (flag == 2)
    assert launches["reverse"] == before + 1


@pytest.mark.parametrize("ns, nk", sorted(tb.STREAM_SETS))
@pytest.mark.parametrize("kernel", ["block", "tail", "global"])
@pytest.mark.parametrize("skip", [0, 1])
def test_skip_flag_on_the_card(dev, ns, nk, kernel, skip):
    """K1-K3 with the flag set leave the buffer as it is, at every
    stream set; with it clear they equal the plain version."""
    n = 1 << 15
    x = _words(ns * 3 + nk, (ns, n), dup=False)
    lb = min(tb.block_log(ns), 12)
    fn, plain, args = {
        "block": (tb.bitonic_block, tb.block_plain, (n, nk, lb)),
        "tail": (tb.bitonic_tail, tb.tail_plain, (n, nk, lb, 15)),
        "global": (tb.bitonic_global, tb.global_plain,
                   (n, nk, 15, 14, 15 - tb.f_max(ns))),
    }[kernel]
    got = x.to(dev)
    want = x.clone()
    flag = torch.full((1,), skip, dtype=torch.int32)
    plain(want, *args, skip=flag)
    fn(got, *args, skip=flag.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got.cpu(), x) == bool(skip)


# --- the distributed layer, one rank per card over NCCL -------------------


def _nccl_rank(rank: int, env: dict, n: int, out: str) -> None:
    """One of D ranks, started as torchrun starts one: dist_sort,
    stable dist_sort_kv and dist_scan of its shard of a seeded global
    array, each held bit for bit against its slice of the single-card
    op of the whole array, made on its own card."""
    import json
    import os

    import torch.distributed as dist

    from sortx_torch.parallel import init_multihost, shard_1d

    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    init_multihost()
    try:
        mesh = sortx_torch.make_sort_mesh()
        dev = torch.device("cuda", rank)
        gen = torch.Generator(device=dev).manual_seed(11)
        keys = torch.randint(0, 2**32, (n,), device=dev, generator=gen,
                             dtype=torch.int64).to(torch.int32)
        u = keys.view(torch.uint32)
        values = torch.arange(n, dtype=torch.int32, device=dev)

        def mine(t):
            return shard_1d(t, mesh).clone()

        def same(got, want):
            return (got.device == dev and got.shape == want.shape
                    and torch.equal(got.view(torch.int32),
                                    want.view(torch.int32)))

        wk, wv = sortx_torch.sort_kv(u, values)
        ws, wt = sortx_torch.scan(keys, with_total=True)
        launches.clear()
        ks, vs = sortx_torch.dist_sort_kv(mine(u), mine(values), mesh=mesh)
        s, t = sortx_torch.dist_scan(mine(keys), with_total=True, mesh=mesh)
        res = {"backend": dist.get_backend(),
               "card": torch.cuda.current_device(),
               "sort": same(sortx_torch.dist_sort(mine(u), mesh=mesh),
                            mine(sortx_torch.sort(u))),
               "sort_kv": same(ks, mine(wk)) and same(vs, mine(wv)),
               "scan": same(s, mine(ws)) and same(t, wt),
               "launches": dict(launches)}
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def test_dist_ops_across_cards_match_the_single_card_ops(dev, tmp_path):
    import json

    import torch.multiprocessing as mp

    from sortx_torch.parallel.multihost import simulate_hosts_flags

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards: NCCL takes one rank a card")
    d = min(torch.cuda.device_count(), 4)
    mp.spawn(_nccl_rank, args=(simulate_hosts_flags(d), 1 << 20,
                               str(tmp_path)), nprocs=d, join=True)
    for r in range(d):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["backend"] == "nccl" and res["card"] == r
        assert res["sort"] and res["sort_kv"] and res["scan"], res
        # "auto" on a card: the radix engine's local sorts and re-sorts
        assert all(res["launches"].get(k, 0) > 0 for k in
                   ("radix_histogram", "radix_onesweep", "scan")), res
        assert not any(res["launches"].get(k, 0) for k in
                       ("bitonic_block", "bitonic_tail",
                        "bitonic_global")), res


# --- the radix engine: K9 and K10 ------------------------------------------

def _radix_words(kind, n, dev, seed=0):
    """n u32 words (int32) on the card: uniform, CUB's entropy 0.201 (the
    AND of five uniform words) or all equal."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def uniform():
        return torch.randint(-2**31, 2**31, (n,), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)
    if kind == "all equal":
        return torch.full((n,), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    k = uniform()
    if kind == "entropy 0.201":
        for _ in range(4):
            k &= uniform()
    return k


def _radix_walk(keys, bits, values):
    """K9, then each K10 pass, each against its plain version on the same
    input; returns the last pass's (keys, values)."""
    n = keys.shape[0]
    before = launches["radix_histogram"], launches["radix_onesweep"]
    scratch = torch.empty(rx.scratch_words(n, rx.radix_passes(bits)),
                          dtype=torch.int32, device=keys.device)
    offsets = rx.radix_histogram(keys, bits, scratch)
    want = rx.offsets_plain(keys, bits)
    torch.cuda.synchronize()
    assert torch.equal(offsets, want)
    src, vsrc = keys, values
    for p in range(rx.radix_passes(bits)):
        db = min(8, bits - 8 * p)
        region = torch.zeros(rx.scratch_words(n, 1), dtype=torch.int32,
                             device=keys.device)
        out = torch.empty_like(src)
        vout = None if values is None else torch.empty_like(values)
        rx.radix_onesweep(src, out, want[p].contiguous(), 8 * p, db,
                          region=region, values=vsrc, values_out=vout)
        pk, pv = rx.onesweep_plain(src, 8 * p, db, want[p], vsrc)
        torch.cuda.synchronize()
        assert torch.equal(out, pk), (p, db)
        assert values is None or torch.equal(vout, pv), (p, db)
        src, vsrc = out, vout
    passes = rx.radix_passes(bits)
    assert (launches["radix_histogram"], launches["radix_onesweep"]) == (
        before[0] + 1, before[1] + passes)
    return src, vsrc


@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("bits", [32, 12])
@pytest.mark.parametrize("n", [1 << 20, 1 << 27, (1 << 26) + 13])
def test_radix_kernels_match_plain(dev, n, bits, kv):
    keys = _radix_words("uniform", n, dev, seed=n + bits)
    values = (torch.arange(n, dtype=torch.int32, device=dev) if kv
              else None)
    ks, vs = _radix_walk(keys, bits, values)
    order = torch.sort(keys.to(torch.int64) & ((1 << bits) - 1),
                       stable=True).indices
    assert torch.equal(ks, keys[order])
    assert vs is None or torch.equal(vs, values[order])


@pytest.mark.parametrize("bits", [32, 9, 3])
@pytest.mark.parametrize("kind", ["entropy 0.201", "all equal"])
@pytest.mark.parametrize("n", [1, 4095, 4097, (1 << 20) + 7])
def test_radix_kernels_on_tied_words_match_plain(dev, n, kind, bits):
    keys = _radix_words(kind, n, dev, seed=3)
    _radix_walk(keys, bits, torch.arange(n, dtype=torch.int32, device=dev))


RADIX_CALLS = {   # name -> op(keys, values, config)
    "sort u32": lambda k, v, c: sortx_torch.sort(k.view(torch.uint32),
                                                 config=c),
    "sort i32 descending": lambda k, v, c: sortx_torch.sort(
        k, descending=True, config=c),
    "sort f32": lambda k, v, c: sortx_torch.sort(k.view(torch.float32),
                                                 config=c),
    "sort bf16": lambda k, v, c: sortx_torch.sort(
        k.view(torch.bfloat16)[::2].contiguous(), config=c),
    "sort sort_bits=20": lambda k, v, c: sortx_torch.sort(
        k.view(torch.uint32), 20, config=c),
    "sort_kv stable": lambda k, v, c: sortx_torch.sort_kv(
        k.view(torch.uint32), v, config=c),
    "sort_kv stable int16 values descending": lambda k, v, c:
        sortx_torch.sort_kv(k, v.to(torch.int16), descending=True, config=c),
    "sort_kv stable sort_bits=9": lambda k, v, c: sortx_torch.sort_kv(
        k.view(torch.uint32), v, 9, config=c),
}
NETWORK = sortx_torch.Config(engine="network")


@pytest.mark.parametrize("kind", ["uniform", "entropy 0.201"])
@pytest.mark.parametrize("n", [1 << 20, (1 << 22) + 13])
@pytest.mark.parametrize("op", sorted(RADIX_CALLS))
def test_auto_takes_the_radix_engine_and_equals_the_network(dev, op, n,
                                                            kind):
    """Under "auto" a stable sort of a CUDA tensor runs K9 and K10 and
    no network pass, and gives the network engine's bits."""
    keys = _radix_words(kind, n, dev, seed=7)
    vals = torch.arange(n, dtype=torch.int32, device=dev).flip(0)
    want = RADIX_CALLS[op](keys, vals, NETWORK)
    torch.cuda.synchronize()
    launches.clear()
    got = RADIX_CALLS[op](keys, vals, None)
    torch.cuda.synchronize()
    assert _same_tree(got, want)
    assert launches["radix_histogram"] == 1 and launches["radix_onesweep"] > 0
    assert not any(launches[k] for k in ("bitonic_block", "bitonic_tail",
                                         "bitonic_global", "reverse"))


@pytest.mark.parametrize("op", ["sort", "sort_kv"])
def test_radix_capture_and_replay(dev, op):
    """The radix path captured once under "auto" (one memset, K9, four
    K10 launches) and replayed on random, sorted, reversed and all-equal
    keys: each replay equals the network engine's eager call."""
    n = (1 << 20) + 13
    run = GRAPH_OPS[op][0]
    static = {"k": _graph_keys("random", n, dev),
              "v": torch.arange(n, dtype=torch.int32, device=dev).flip(0)}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(static)
    torch.cuda.current_stream().wait_stream(side)
    launches.clear()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(static)
    assert launches["radix_histogram"] == 1
    assert launches["radix_onesweep"] == 4
    for kind in GRAPH_KINDS:
        static["k"].copy_(_graph_keys(kind, n, dev, 2))
        graph.replay()
        torch.cuda.synchronize()
        assert _same_tree(out, run(static, NETWORK)), kind


# case -> (Config fields, value dtype; the local engine and merge of
# dist_sort, and of stable dist_sort_kv, at D = 4)
DIST_ENGINES = {
    "auto": ({}, torch.int32, ("radix", "sort"), ("radix", "sort")),
    "network": ({"engine": "network"}, torch.int32, ("bitonic", "tree"),
                ("bitonic", "tree")),
    "64-bit values": ({}, torch.int64, ("radix", "sort"),
                      ("bitonic", "tree")),
}


def _gloo_dist_rank(rank: int, d: int, tmp: str, n: int, name: str) -> None:
    """One of d gloo ranks sharing card 0: dist_sort and stable
    dist_sort_kv of its shard under the config and values DIST_ENGINES
    names, held against its slice of the single-card ops; writes the
    local engine and merge each call took and its launches."""
    import datetime
    import importlib
    import json

    import torch.distributed as dist

    from sortx_torch.parallel import shard_1d

    ds = importlib.import_module("sortx_torch.parallel.dist_sort")
    fields, vdtype = DIST_ENGINES[name][:2]
    cfg = sortx_torch.Config(**fields)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=d, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        dev = torch.device("cuda", 0)
        mesh = sortx_torch.make_sort_mesh()
        keys = _radix_words("uniform", n, dev, seed=5).view(torch.uint32)
        vals = torch.arange(n, dtype=vdtype, device=dev)
        wk, wv = sortx_torch.sort_kv(keys, vals)
        launches.clear()
        out = sortx_torch.dist_sort(shard_1d(keys, mesh).clone(), mesh=mesh,
                                    config=cfg)
        res = {"engine": ds.last_local_engine, "merge": ds.last_local_merge,
               "launches": dict(launches)}
        launches.clear()
        ks, vs = sortx_torch.dist_sort_kv(shard_1d(keys, mesh).clone(),
                                          shard_1d(vals, mesh).clone(),
                                          mesh=mesh, config=cfg)
        res.update(
            sort=torch.equal(out.view(torch.int32),
                             shard_1d(wk, mesh).view(torch.int32)),
            sort_kv=(torch.equal(ks.view(torch.int32),
                                 shard_1d(wk, mesh).view(torch.int32))
                     and torch.equal(vs, shard_1d(wv, mesh))),
            kv_engine=ds.last_local_engine, kv_merge=ds.last_local_merge,
            kv_launches=dict(launches))
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", sorted(DIST_ENGINES))
def test_four_rank_dist_sort_engines(dev, tmp_path, name):
    """dist_sort's local sorts and merge: under "auto" the radix engine
    and the re-sort (K9 / K10, no network pass); an explicit network
    engine, or 64-bit values (two value words) under "auto", keep the
    network and its merge tree. Four gloo ranks sharing the card, 2^18
    keys in all, each rank's outputs its slice of the single-card ops'."""
    import json

    import torch.multiprocessing as mp

    d = 4
    mp.spawn(_gloo_dist_rank, args=(d, str(tmp_path), 1 << 18, name),
             nprocs=d, join=True)
    want_sort, want_kv = DIST_ENGINES[name][2:]
    for r in range(d):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["sort"] and res["sort_kv"], res
        assert (res["engine"], res["merge"]) == want_sort, res
        assert (res["kv_engine"], res["kv_merge"]) == want_kv, res
        for (engine, _), counts in ((want_sort, res["launches"]),
                                    (want_kv, res["kv_launches"])):
            radix = counts.get("radix_onesweep", 0)
            network = counts.get("bitonic_global", 0)
            if engine == "radix":
                assert radix > 0 and network == 0, res
            else:
                assert network > 0 and radix == 0, res
