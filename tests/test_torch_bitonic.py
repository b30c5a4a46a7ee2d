"""The port's bitonic network against the JAX network, bit for bit.

The JAX side runs ``sortx.ops.bitonic.bitonic_sort_streams`` in
interpret mode at log_block 10, so at n = 2^12 its kernels A, D and B
all run. The port's side runs the plain versions of K1-K3 (CPU tensors)
in the port's own pass plan, also at log_block 10, so that all three
run too. Every comparator here is tie-free on the
streams it carries (or carries every stream), so the outputs must agree
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sortx.ops.bitonic import bitonic_sort_streams as jax_sort_streams
from sortx_torch.convert import to_numpy, to_torch
from sortx_torch.ops import bitonic as tb

N = 1 << 12


def _jax(streams: np.ndarray, num_keys: int, n_valid=None) -> np.ndarray:
    out = jax_sort_streams(tuple(jnp.asarray(s) for s in streams), num_keys,
                           interpret=True, log_block=10, n_valid=n_valid)
    return np.stack([np.asarray(o) for o in out])


def _port(streams: np.ndarray, num_keys: int, n_valid=None,
          log_block=tb.LOG_BLOCK_MAX) -> np.ndarray:
    x = to_torch(streams).view(torch.int32)
    tb.bitonic_sort_streams(x, num_keys, n_valid=n_valid, log_block=log_block)
    return to_numpy(x.view(torch.uint32))


def _dup_keys(rng, n):
    """Duplicate-heavy u32 keys with some legitimate 0xFFFFFFFF keys."""
    k = (rng.randint(0, 97, size=n) * 0x01000193).astype(np.uint32)
    k[rng.randint(0, n, n // 16)] = 0xFFFFFFFF
    return k


def _case(name, rng):
    """(streams, num_keys, n_valid) of each stream set under test."""
    if name == "keys_only":
        return _dup_keys(rng, N)[None], 1, None
    if name == "key_idx_value":            # the stable-KV stream set
        st = np.stack([_dup_keys(rng, N),
                       rng.permutation(N).astype(np.uint32),
                       rng.randint(0, 2**32, size=N, dtype=np.uint32)])
        return st, 2, None
    # ragged: the unstable-KV stream set at ragged n, (key, value) keys
    nv = N - 1000
    st = np.stack([_dup_keys(rng, N),
                   rng.randint(0, 2**32, size=N, dtype=np.uint32)])
    st[:, nv:] = 0xFFFFFFFF
    return st, 2, nv


@pytest.mark.parametrize("name", ["keys_only", "key_idx_value", "ragged"])
def test_network_matches_jax(rng, name):
    streams, nk, nv = _case(name, rng)
    got = _port(streams, nk, nv, log_block=10)
    np.testing.assert_array_equal(got, _jax(streams, nk, nv))
    # and it sorted: the key order is nondecreasing over the real prefix
    keys = got[0][:nv].astype(np.int64)
    assert np.all(np.diff(keys) >= 0)


@pytest.mark.parametrize("log_block", [10, 11, 12])
def test_pass_plan_does_not_change_output(rng, log_block):
    """Strict swaps make the output independent of the block size."""
    streams, nk, nv = _case("ragged", rng)
    np.testing.assert_array_equal(_port(streams, nk, nv, log_block),
                                  _port(streams, nk, nv))


@pytest.mark.parametrize("ns,nk,n,nv", [
    (1, 1, 1 << 27, 1 << 27), (2, 1, 1 << 27, 1 << 27),
    (3, 2, 1 << 27, (1 << 26) + 13), (4, 2, 1 << 12, 1000)])
def test_pass_plan_runs_every_layer_once(ns, nk, n, nv):
    """The plan runs layers s-1..0 of every stage s in order, each over
    the prefix of the stage-s groups that hold a real element, and fuses
    at most f_max(ns) layers into one global pass."""
    lb = min(tb.block_log(ns), n.bit_length() - 1)
    layers = []
    for name, args in tb.pass_plan(ns, n, nk, nv):
        ext, keys = args[:2]
        assert keys == nk
        if name == "bitonic_block":
            assert args[2] == lb
            run = [(s, j) for s in range(1, lb + 1)
                   for j in range(s - 1, -1, -1)]
        elif name == "bitonic_global":
            s, j_hi, j_lo = args[2:]
            assert j_lo >= lb and j_hi - j_lo < tb.f_max(ns)
            run = [(s, j) for j in range(j_hi, j_lo - 1, -1)]
        else:
            assert args[2] == lb
            run = [(args[3], j) for j in range(lb - 1, -1, -1)]
        top = max(s for s, _ in run)
        assert ext == min(n, -(-nv // (1 << top)) << top)
        layers += run
    log_n = n.bit_length() - 1
    assert layers == [(s, j) for s in range(1, log_n + 1)
                      for j in range(s - 1, -1, -1)]


def test_pruned_tail_stays_padded(rng):
    """Columns past the pruned extent are never written."""
    n, nv = 1 << 13, 1100
    x = torch.full((2, n), -1, dtype=torch.int32)
    x[:, :nv] = torch.from_numpy(
        rng.randint(-2**31, 2**31, size=(2, nv)).astype(np.int32))
    tb.bitonic_sort_streams(x, 2, n_valid=nv)
    assert torch.all(x[:, nv:] == -1)
    order = np.lexsort((to_numpy(x[1, :nv].view(torch.uint32)),
                        to_numpy(x[0, :nv].view(torch.uint32))))
    assert np.array_equal(order, np.arange(nv))


@pytest.mark.parametrize("kernel", ["block", "tail", "global"])
def test_plain_kernel_equals_its_layers(rng, kernel):
    """Each wrapper on a CPU tensor runs exactly its layers of the network."""
    n, lb = 1 << 12, 10
    x = torch.from_numpy(rng.randint(-2**31, 2**31, size=(3, n)).astype(
        np.int32))
    want = x.clone()
    if kernel == "block":
        tb.bitonic_block(x, n, 2, lb)
        layers = [(s, j) for s in range(1, lb + 1) for j in range(s - 1, -1, -1)]
    elif kernel == "tail":
        tb.bitonic_tail(x, n, 2, lb, 12)
        layers = [(12, j) for j in range(lb - 1, -1, -1)]
    else:
        tb.bitonic_global(x, n, 2, 12, 11, 10)
        layers = [(12, 11), (12, 10)]
    for s, j in layers:
        tb._layer(want, n, 2, s, j)
    assert torch.equal(x, want)


@pytest.mark.parametrize("bad", [
    dict(shape=(5, 1024), nk=1),          # too many streams
    dict(shape=(2, 1024), nk=3),          # too many keys
    dict(shape=(1, 1024), nk=1, ext=1000),  # extent off the block grid
])
def test_wrapper_rejects_unsupported_sets(bad):
    x = torch.zeros(bad["shape"], dtype=torch.int32)
    with pytest.raises(ValueError):
        tb.bitonic_block(x, bad.get("ext", bad["shape"][1]), bad["nk"], 10)


# --- the register design of K1 and K2: layouts and phases --------------------

def _designs():
    """(ns, L, e) of every block the register kernels are built for: each
    stream count at every block size elems_log gives it."""
    return [(ns, lb, tb.elems_log(ns, lb)) for ns in (1, 2, 3, 4, 5, 8)
            for lb in range(1, tb.LOG_BLOCK_MAX + 1) if tb.elems_log(ns, lb)]


DESIGNS = _designs()
MODES = [(ns, lb, e, row_log) for ns, lb, e in DESIGNS
         for row_log in ((0, lb, lb - 2, 1) if ns <= 4 else (0,))]


def _layout(name, e, lb):
    return {"low": tb.low_layout, "high": tb.high_layout}[name](e, lb)


def test_register_design_serves_every_block_the_library_picks():
    """block_log's choice for each stream count, and every smaller block
    from 2^10 up (short inputs, rows mode), runs the register design."""
    for ns in range(1, 9):
        for lb in range(10, tb.block_log(ns) + 1):
            assert tb.elems_log(ns, lb), (ns, lb)
    assert {(ns, lb) for ns, lb, _ in DESIGNS} >= {(1, 15), (2, 13), (4, 13)}
    assert tb.elems_log(1, 8) == 0 and tb.elems_log(8, 12) == 0
    assert tb.elems_log(2, 14) == 0


@pytest.mark.parametrize("ns,e,top", [(1, 4, 13), (4, 4, 13), (1, 5, 15),
                                      (1, 6, 15), (5, 3, 11), (8, 3, 11)])
def test_design_top_is_two_layouts_deep_and_fits_shared_memory(ns, e, top):
    """The largest block of the design: 2e + 5 (the high layout's slots
    reach down to the low layout's top layer), or what ns streams leave
    of the 227 KB a block may ask for."""
    assert tb.design_top(ns, e) == top <= 2 * e + 5
    assert (4 * ns) << top <= tb.SMEM_MAX
    assert top == 2 * e + 5 or (4 * ns) << (top + 1) > tb.SMEM_MAX


@pytest.mark.parametrize("ns,lb,e", DESIGNS)
def test_layouts_assign_every_index_bit_once(ns, lb, e):
    for name in ("low", "high"):
        lay = _layout(name, e, lb)
        assert len(lay.slots) == e and len(lay.lanes) == 5
        assert sorted(lay.slots + lay.lanes + lay.warps) == list(range(lb))
        words = {lay.word(w, lane, r) for w in range(1 << len(lay.warps))
                 for lane in range(32) for r in range(1 << e)}
        assert words == set(range(1 << lb))


@pytest.mark.parametrize("ns,lb,e", DESIGNS)
def test_tail_phases_run_layers_once_in_order(ns, lb, e):
    """K2: layers L-1..0 once each, in order, each on a slot or lane bit
    of its phase's layout; one change of layout (at most 4 allowed)."""
    phases = tb.tail_schedule(lb, e)
    assert [j for p in phases for j in p.layers] == list(range(lb - 1, -1, -1))
    for p in phases:
        lay = _layout(p.layout, e, lb)
        assert set(p.layers) <= set(lay.slots + lay.lanes)
    assert not phases[0].relayout          # loaded straight into its layout
    assert phases[-1].layout == "low"      # stored with 16-byte accesses
    assert sum(p.relayout for p in phases) == (lb > e + 5) <= 4


@pytest.mark.parametrize("ns,lb,e,row_log", MODES)
def test_block_phases_run_the_network_once_in_order(ns, lb, e, row_log):
    """K1: every (s, j) of stages 1..L (1..row_log in rows mode) once, in
    order, each on a slot or lane bit of its phase's layout; no change of
    layout below stage e + 6, two for each stage from there."""
    phases = tb.block_schedule(lb, e, row_log)
    top = row_log or lb
    assert [(p.stage, j) for p in phases for j in p.layers] == [
        (s, j) for s in range(1, top + 1) for j in range(s - 1, -1, -1)]
    for p in phases:
        lay = _layout(p.layout, e, lb)
        assert set(p.layers) <= set(lay.slots + lay.lanes)
        assert p.relayout == (p.stage > e + 5)
    assert phases[0].layout == phases[-1].layout == "low"
    barriers = sum(p.relayout for p in phases)
    # against one barrier per layer, top (top + 1) / 2, layer by layer
    assert barriers == 2 * max(0, top - e - 5) <= 2 * e


@pytest.mark.parametrize("ns,lb,e", DESIGNS)
def test_layouts_have_no_bank_conflict(ns, lb, e):
    """Stream t of a block starts at word t * 2^L of shared memory, a
    multiple of 32, so banks follow the block-local word. High layout:
    the 32 lanes of a warp touch 32 distinct banks for each slot. Low
    layout: a thread moves 4 consecutive words from a 16-byte boundary,
    and each quarter warp (the unit a 16-byte access is served in)
    covers the 32 banks once; a whole warp's access is 512 contiguous
    bytes, in shared and in device memory alike."""
    high, low = tb.high_layout(e, lb), tb.low_layout(e, lb)
    assert (high.vector, low.vector) == (1, 4)
    for warp in range(1 << len(high.warps)):
        for r in range(1 << e):
            words = [high.word(warp, lane, r) for lane in range(32)]
            assert len({w % 32 for w in words}) == 32
            assert words == list(range(words[0], words[0] + 32))
        for q in range(0, 1 << e, 4):
            quads = [[low.word(warp, lane, q + k) for k in range(4)]
                     for lane in range(32)]
            for quad in quads:
                assert quad[0] % 4 == 0
                assert quad == list(range(quad[0], quad[0] + 4))
            for part in range(4):
                banks = [w % 32 for quad in quads[8 * part:8 * part + 8]
                         for w in quad]
                assert sorted(banks) == list(range(32))
            flat = [w for quad in quads for w in quad]
            assert flat == list(range(flat[0], flat[0] + 128))


@pytest.mark.parametrize("ns,lb,e,row_log", [
    m for m in MODES if m[1] in (10, 11, 13, 15)])
def test_phases_as_plain_layers_sort_like_the_plain_kernel(rng, ns, lb, e,
                                                           row_log):
    """Running the phases' layers one by one gives block_plain's output:
    the schedule is the same network, whatever the layouts."""
    nk = min(ns, 2)
    n = 2 << lb
    x = torch.from_numpy((rng.randint(0, 50, size=(ns, n)) * 0x1000193)
                         .astype(np.int32))
    want = x.clone()
    tb.block_plain(want, n, nk, lb, row_log)
    for p in tb.block_schedule(lb, e, row_log):
        for j in p.layers:
            tb._layer(x, n, nk, p.stage, j, p.stage == row_log)
    assert torch.equal(x, want)
