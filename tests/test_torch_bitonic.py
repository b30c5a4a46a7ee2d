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
    at most F_MAX layers into one global pass."""
    lb = tb.block_log(ns)
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
            assert j_lo >= lb and j_hi - j_lo < tb.F_MAX
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
