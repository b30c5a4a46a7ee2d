"""The plan of the port's distributed sort against sortx's, in-process.

The buffer bounds and layouts the exchanges and merges depend on are
plain functions in both packages (``sortx/parallel/dist_sort.py`` and
``sortx_torch/parallel/dist_sort.py``); they are held equal here on
golden and random inputs, as tests/test_dist_plan.py pins the
reference's, and the port's plan is run through a numpy model of the
exchange. No process group is needed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sortx
import sortx_torch

REF = importlib.import_module("sortx.parallel.dist_sort")
PORT = importlib.import_module("sortx_torch.parallel.dist_sort")
MS = (0, 1, 7, 64, 1000, 1024, 4099, 65_536, (1 << 24) + 13, 1 << 25)


@pytest.mark.parametrize("d", range(1, 9))
def test_buffer_bounds_match_sortx(d):
    """_recv_buf_len (over sample counts about the one the sort takes)
    and _tree_cell_cap, on every receive buffer they meet."""
    for m in MS:
        for s in {0, 1, d, min(64, m), d ** 3, m} - ({0} if m else set()):
            buf = REF._recv_buf_len(m, d, s)
            assert PORT._recv_buf_len(m, d, s) == buf
            assert PORT._tree_cell_cap(buf, m, d) == REF._tree_cell_cap(
                buf, m, d)


@pytest.mark.parametrize("d", range(1, 9))
def test_samples_and_merge_match_sortx(d):
    """The port's sample count is the reference's inline rule for its
    ragged exchange (dist_sort.py:1095-1098), and its merge is the
    reference's under the default config, for every engine (the port's
    "radix", which the reference lacks, as any engine but the
    network)."""
    for m in MS:
        assert PORT._samples(m, d) == min(max(d, min(64, m)), m)
    for engine in ("bitonic", "xla", "radix"):
        assert PORT._merge_mode(engine, d) == REF._resolve_merge_mode(
            sortx.Config(), engine, d)


U32 = torch.uint32
# (Config fields, device, key dtype, words the re-sort may hold, value
# words) -> (local engine, merge at D = 4)
LOCAL_ENGINE = {
    "auto on a card": (dict(), "cuda", U32, 1 << 20, 0, "radix", "sort"),
    "auto, one value word": (dict(), "cuda", U32, 1 << 20, 1, "radix",
                             "sort"),
    "auto, f32 keys": (dict(), "cuda", torch.float32, 1 << 20, 1, "radix",
                       "sort"),
    "auto, 64-bit values": (dict(), "cuda", U32, 1 << 20, 2, "bitonic",
                            "tree"),
    "auto, 2^30 words": (dict(), "cuda", U32, 1 << 30, 0, "bitonic",
                         "tree"),
    "engine network": (dict(engine="network"), "cuda", U32, 1 << 20, 0,
                       "bitonic", "tree"),
    "engine host": (dict(engine="host"), "cuda", U32, 1 << 20, 0, "xla",
                    "sort"),
    "engine hybrid": (dict(engine="hybrid"), "cuda", U32, 1 << 20, 0, "xla",
                      "sort"),
    "auto on the host": (dict(), "cpu", U32, 1 << 20, 0, "xla", "sort"),
    "engine radix on the host": (dict(engine="radix"), "cpu", U32, 1 << 20,
                                 1, "radix", "sort"),
}


@pytest.mark.parametrize("case", sorted(LOCAL_ENGINE))
def test_local_engine_follows_sort_engine(case):
    """The engine of a rank's local sort and re-sort, a pure function of
    what the call shows: "auto" on a card is the radix engine where the
    single-card sort's rule gives it (keys of at most 32 bits, at most
    one value word, fewer than 2^30 words), and the merge is then the
    re-sort. CPU tensors under "auto" keep the host engine."""
    fields, device, dtype, n, nv, want, merge = LOCAL_ENGINE[case]
    got = PORT._local_engine(sortx_torch.Config(**fields), device, dtype, n,
                             nv)
    assert got == want
    assert PORT._merge_mode(got, 4) == merge


def _plans(dests, d: int):
    """Every rank's (sizes, offsets) and (send_out_off, recv_sizes), by
    the port and by the reference."""
    port, ref = [], []
    for dest in dests:
        port.append([t.numpy() for t in PORT._segment_layout(
            torch.as_tensor(dest, dtype=torch.int64), d)])
        ref.append([np.asarray(a) for a in REF._segment_layout(
            jnp.asarray(dest, jnp.int32), d)])
    c = np.stack([s for s, _ in port])
    outs = [[t.numpy() for t in PORT._plan_from_counts(torch.as_tensor(c),
                                                        me)]
            for me in range(d)]
    routs = [[np.asarray(a) for a in REF._plan_from_counts(jnp.asarray(c),
                                                           me)]
             for me in range(d)]
    for a, b in zip(port + outs, ref + routs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    return c, [o for _, o in port], outs


def test_plan_golden_small():
    """The hand-checked D = 2 plan of tests/test_dist_plan.py."""
    c, offs, outs = _plans([np.array([0, 0, 0, 1]), np.array([0, 0, 1, 1])],
                           2)
    assert c.tolist() == [[3, 1], [2, 2]]
    assert offs[0].tolist() == [0, 3] and offs[1].tolist() == [0, 2]
    assert outs[0][0].tolist() == [0, 0] and outs[1][0].tolist() == [3, 1]
    assert outs[0][1].tolist() == [3, 2] and outs[1][1].tolist() == [1, 2]


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
def test_plans_match_sortx_on_random_destinations(d):
    """Random monotone destinations (empty segments, all-in-one skew):
    the same layouts and count matrices."""
    rng = np.random.RandomState(d)
    m = int(rng.randint(1, 300))
    dests = [np.sort(rng.randint(0, d, size=m)) for _ in range(d)]
    if d % 3 == 0:
        dests[rng.randint(d)] = np.full(m, rng.randint(d))
    c, offs, outs = _plans(dests, d)
    for me in range(d):
        assert outs[me][1].sum() == c[:, me].sum()


@pytest.mark.parametrize("case", ["uniform", "all_equal", "one_hot"])
def test_port_plan_reconstructs_the_global_order(case):
    """The port's plan run through a numpy model of the ragged exchange:
    the received runs, sorted within each rank, are the global order,
    and exact splitters balance the ranks (tests/test_dist_plan.py's
    model, on the port's functions)."""
    rng = np.random.RandomState(123)
    d, m = 4, 64
    keys = {"uniform": rng.randint(0, 1000, size=(d, m)),
            "all_equal": np.full((d, m), 7),
            "one_hot": np.full((d, m), 42)}[case]
    if case == "one_hot":
        keys[2, 5] = 1
    enc = []
    for s in range(d):
        order = np.argsort(keys[s], kind="stable")
        enc.append((keys[s][order].astype(np.int64) << 16) | (s << 8)
                   | np.arange(m)[order])
    glob = np.sort(np.concatenate(enc))
    dests = [np.searchsorted(glob, e) // m for e in enc]
    c, offs, outs = _plans(dests, d)
    got = []
    for j in range(d):
        buf = np.full(2 * m, -1, np.int64)
        for i in range(d):
            n_ij = c[i, j]
            o = outs[i][0][j]
            buf[o:o + n_ij] = enc[i][offs[i][j]:offs[i][j] + n_ij]
        got.extend(np.sort(buf[:c[:, j].sum()]).tolist())
    np.testing.assert_array_equal(np.array(got), glob)
    assert c.sum(0).tolist() == [m] * d


def test_tree_merge_unit():
    """_merge_runs_tree on constructed left-packed runs (one of them a
    whole shard, one empty), as tests/test_dist.py's test_tree_merge_unit
    runs the reference's: the stable order of the valid prefix, then
    0xFFFFFFFF pads."""
    rng = np.random.RandomState(123)
    m, d = 1024, 4
    sizes = [100, 0, 1024, 60]
    runs = [np.sort(rng.randint(0, 50, size=s).astype(np.uint32))
            for s in sizes]
    buf = PORT._recv_buf_len(m, d, 64)
    total = sum(sizes)
    arr = np.full(buf, 0xFFFFFFFF, np.uint32)
    arr[:total] = np.concatenate(runs)
    pos = np.arange(buf, dtype=np.int32)
    k = torch.from_numpy(arr.view(np.int32))
    out_k, out_p = PORT._merge_runs_tree((k, torch.from_numpy(pos)), 2,
                                         sizes, buf, m, d)
    order = np.argsort(arr[:total], kind="stable")
    np.testing.assert_array_equal(out_k.numpy().view(np.uint32)[:total],
                                  arr[order])
    np.testing.assert_array_equal(out_p.numpy()[:total], pos[order])
    assert np.all(out_k.numpy()[total:] == -1)
    ko, = PORT._merge_runs_tree((k,), 1, sizes, buf, m, d)
    np.testing.assert_array_equal(ko.numpy().view(np.uint32)[:total],
                                  arr[order])
