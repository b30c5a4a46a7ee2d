"""The port's run movers against ``sortx.ops.shuffle``, bit for bit.

The JAX side runs its Pallas movers (``move_runs``, K6, and
``apply_runs``, K7) in interpret mode on the cases of
``tests/test_shuffle.py``: gaps, zero-length runs, two streams, fills,
radix-style partitions. The port's side runs on CPU tensors, where the
wrappers run their plain versions. The piece plan is numpy on both
sides and must agree array for array; ``apply_runs`` also takes it as
tensors (as the reference takes ``jnp`` arrays).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sortx.ops.shuffle as jsh
from sortx_torch.convert import to_numpy, to_torch
from sortx_torch.ops import shuffle as tsh
from tests.test_shuffle import _numpy_apply, _radix_run_set


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def _check(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = to_numpy(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _move_both(srcs, starts, dsts, lens, out_len, chunk, fills=None):
    want = jsh.move_runs(tuple(jnp.asarray(s) for s in srcs),
                         jnp.asarray(starts), jnp.asarray(dsts),
                         jnp.asarray(lens), out_len, fills=fills,
                         chunk=chunk, interpret=True)
    got = tsh.move_runs(tuple(to_torch(s) for s in srcs), _i32(starts),
                        _i32(dsts), _i32(lens), out_len, fills=fills,
                        chunk=chunk)
    _check(got, want)
    return got


def test_move_runs_gaps_keep_the_fill(rng):
    src = rng.randint(0, 2**32, size=6000, dtype=np.uint32)
    starts, lens, dsts = [100, 3000, 5000], [900, 1500, 777], [50, 2000, 6000]
    got = _move_both([src], starts, dsts, lens, 4 * 2048, 2048,
                     fills=(0xFFFFFFFF,))
    np.testing.assert_array_equal(
        to_numpy(got[0])[:50], np.full(50, 0xFFFFFFFF, np.uint32))


def test_move_runs_two_streams_radix_plan(rng):
    n = 1 << 15
    src, starts, dsts, lens, _ = _radix_run_set(rng, n, 4, 8)
    vals = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    got = _move_both([src, vals], starts, dsts, lens, n, 2048,
                     fills=(0xFFFFFFFF, 7))
    np.testing.assert_array_equal(to_numpy(got[1]),
                                  _numpy_apply(vals, starts, dsts, lens, n))


def test_move_runs_zero_length_runs(rng):
    src = rng.randint(0, 2**32, size=4096, dtype=np.uint32)
    _move_both([src], [0, 10, 10, 2048], [0, 10, 10, 600], [10, 0, 500, 0],
               2048, 2048)


def test_move_runs_keeps_each_streams_dtype(rng):
    f = rng.randn(3000).astype(np.float32)
    i = rng.randint(-2**31, 2**31, size=3000).astype(np.int32)
    got = tsh.move_runs((to_torch(f), to_torch(i)), _i32([5]), _i32([1]),
                        _i32([2000]), 2048, chunk=1024)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got[0])[1:2001], f[5:2005])
    assert to_numpy(got[1])[0] == 0 and to_numpy(got[1])[2001:].sum() == 0


def test_chunk_run_index_matches_jax(rng):
    chunk, out_len = 1024, 8 * 1024
    dsts, lens, pos = [], [], 0
    while True:
        pos += int(rng.randint(0, 300))
        ln = int(rng.randint(0, 900))
        if pos + ln > out_len:
            break
        dsts.append(pos)
        lens.append(ln)
        pos += ln
    want = jsh.chunk_run_index(jnp.asarray(np.int32(dsts)),
                               jnp.asarray(np.int32(lens)), out_len, chunk)
    got = tsh.chunk_run_index(_i32(dsts), _i32(lens), out_len, chunk)
    _check(got, want)


def _ragged_runs(rng, n, cuts):
    """Runs tiling [0, n) in destination order, read from a shuffled
    concatenation of the same segments (tests/test_shuffle.py)."""
    c = np.sort(rng.choice(np.arange(1, n), size=cuts, replace=False))
    bounds = np.concatenate([[0], c, [n]])
    lens = np.diff(bounds)
    perm = rng.permutation(len(lens))
    starts = np.concatenate([[0], np.cumsum(lens[perm])[:-1]])[
        np.argsort(perm)]
    return starts, bounds[:-1], lens


def _plans(rng, name):
    """(src, runs, out_len, chunk) of a named case."""
    chunk = tsh.CHUNK_ELEMS
    n = 4 * chunk
    if name == "swap":
        return np.arange(2 * chunk, dtype=np.uint32), (
            [0, chunk], [chunk, 0], [chunk] * 2), 2 * chunk, chunk
    if name == "ragged":
        src = rng.randint(0, 2**32, size=n, dtype=np.uint32)
        return src, _ragged_runs(rng, n, 37), n, chunk
    if name == "single":
        src = rng.randint(0, 2**32, size=n, dtype=np.uint32)
        return src, ([0], [0], [n]), n, chunk
    if name == "8-bit":   # one 8-bit digit pass: runs of ~2 words, and empty
        n = 4 * 2048
        src, starts, dsts, lens, _ = _radix_run_set(rng, n, 16, 256)
        return src, (starts, dsts, lens), n, 2048
    n = 8 * chunk
    src, starts, dsts, lens, _ = _radix_run_set(rng, n, 4, 16)
    return src, (starts, dsts, lens), n, chunk


@pytest.mark.parametrize("name", ["swap", "ragged", "single", "radix",
                                  "8-bit"])
def test_apply_runs_matches_jax(rng, name):
    src, runs, n, chunk = _plans(rng, name)
    want_plan = jsh.build_piece_plan(*runs, n, chunk)
    plan = tsh.build_piece_plan(*runs, n, chunk)
    assert plan.keys() == want_plan.keys()
    for key in plan:
        assert plan[key].dtype == np.int32
        np.testing.assert_array_equal(plan[key], want_plan[key])
    want = jsh.apply_runs(jnp.asarray(src), want_plan, n, chunk=chunk,
                          interpret=True)
    got = tsh.apply_runs(to_torch(src), plan, n, chunk=chunk)
    _check([got], [want])
    np.testing.assert_array_equal(to_numpy(got), _numpy_apply(src, *runs, n))


@pytest.mark.parametrize("name", ["ragged", "radix", "8-bit"])
def test_apply_runs_takes_a_plan_of_tensors(rng, name):
    """The plan as int32 tensors on the source's device, as the
    reference takes it as jnp arrays."""
    src, runs, n, chunk = _plans(rng, name)
    plan = tsh.build_piece_plan(*runs, n, chunk)
    want = jsh.apply_runs(jnp.asarray(src),
                          {k: jnp.asarray(v) for k, v in plan.items()}, n,
                          chunk=chunk, interpret=True)
    got = tsh.apply_runs(to_torch(src),
                         {k: torch.from_numpy(v) for k, v in plan.items()},
                         n, chunk=chunk)
    _check([got], [want])
    plain = tsh.apply_runs_plain(
        to_torch(src), {k: torch.from_numpy(v) for k, v in plan.items()}, n,
        chunk)
    _check([plain], [want])


@pytest.mark.parametrize("chunk", [1, 3, 1000, 4097])
def test_apply_runs_any_chunk_matches_the_run_loop(rng, chunk):
    """Chunks off the reference's 128-lane grid, which the port takes:
    gaps stay 0, and so do reads past the source's end."""
    out_len = chunk * -(-6000 // chunk)
    src = rng.randint(1, 2**32, size=3001, dtype=np.uint32)
    starts, dsts, lens, pos = [], [], [], 0
    while True:
        pos += int(rng.randint(0, 50))
        ln = int(rng.choice([1, 2, 3, 40, 900]))
        if pos + ln > out_len:
            break
        starts.append(int(rng.randint(0, 3001)))
        dsts.append(pos)
        lens.append(ln)
        pos += ln
    plan = tsh.build_piece_plan(starts, dsts, lens, out_len, chunk)
    got = to_numpy(tsh.apply_runs(to_torch(src), plan, out_len, chunk=chunk))
    padded = np.concatenate([src, np.zeros(900, np.uint32)])
    want = np.zeros(out_len, np.uint32)
    for s, d, ln in zip(starts, dsts, lens):
        want[d:d + ln] = padded[s:s + ln]
    np.testing.assert_array_equal(got, want)


def test_plan_tensors_pass_through_or_upload_once(rng):
    """int32 tensors on the device are used as they are; a numpy plan (or
    tensors elsewhere, or of another dtype) becomes slices of one
    buffer, so it costs one copy to the device."""
    src, runs, n, chunk = _plans(rng, "ragged")
    plan = tsh.build_piece_plan(*runs, n, chunk)
    tensors = {k: torch.from_numpy(v) for k, v in plan.items()}
    got = tsh._plan_tensors(tensors, torch.device("cpu"))
    assert [t.data_ptr() for t in got] == [
        tensors[k].data_ptr() for k in tsh._PLAN_KEYS]
    for mixed in (plan, dict(tensors, piece_len=plan["piece_len"]
                             .astype(np.int64))):
        got = tsh._plan_tensors(mixed, torch.device("cpu"))
        for key, t in zip(tsh._PLAN_KEYS, got):
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), plan[key])
    got = tsh._plan_tensors(plan, torch.device("cpu"))
    assert len({t.untyped_storage().data_ptr() for t in got}) == 1


def test_apply_runs_gaps_are_zero(rng):
    src = rng.randint(1, 2**32, size=3000, dtype=np.uint32)
    plan = tsh.build_piece_plan([5, 2500], [10, 9000], [2990, 800], 16384,
                                chunk=4096)
    got = to_numpy(tsh.apply_runs(to_torch(src), plan, 16384, chunk=4096))
    np.testing.assert_array_equal(got[10:3000], src[5:2995])
    assert not got[:10].any() and not got[3000:9000].any()
    # the second run reads past the source's end: those words are 0
    np.testing.assert_array_equal(got[9000:9500], src[2500:3000])
    assert not got[9500:].any()


@pytest.mark.parametrize("call", [
    lambda s: tsh.move_runs(s, _i32([0]), _i32([0]), _i32([1]), 1000,
                            chunk=512),
    lambda s: tsh.move_runs((s,) * 5, _i32([0]), _i32([0]), _i32([1]), 512,
                            chunk=512),
    lambda s: tsh.move_runs(s, _i32([0]), _i32([0]), _i32([1]), 512,
                            fills=(0, 0), chunk=512),
    lambda s: tsh.move_runs(s.to(torch.int16), _i32([0]), _i32([0]),
                            _i32([1]), 512, chunk=512),
    lambda s: tsh.apply_runs(s, tsh.build_piece_plan([0], [0], [8], 1024,
                                                     512), 2048, chunk=512),
], ids=["ragged_out", "streams", "fills", "int16", "plan_chunks"])
def test_bad_calls_raise(call):
    with pytest.raises(ValueError):
        call(torch.zeros(1024, dtype=torch.int32))
