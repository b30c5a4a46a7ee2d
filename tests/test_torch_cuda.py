"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode) and skip without one. They import neither jax nor sortx, so they
run on a machine that has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import sortx_torch
from sortx_torch.ops import bitonic as tb
from sortx_torch.ops._build import launches
from sortx_torch.ops.scan import scan_plain, tile_scan

pytestmark = pytest.mark.cuda

STREAM_SETS = [(1, 1), (2, 1), (2, 2), (3, 1), (3, 2), (4, 1), (4, 2)]


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
    n = 1 << 15
    x = _words(ns * 10 + nk, (ns, n))
    if nk == 2:                      # tie-free second key, as idx is
        x[1] = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    lb = tb.block_log(ns)
    name, fn, plain, args = {
        "block": ("bitonic_block", tb.bitonic_block, tb.block_plain,
                  (n, nk, lb)),
        "tail": ("bitonic_tail", tb.bitonic_tail, tb.tail_plain,
                 (n, nk, lb, 15)),
        "global4": ("bitonic_global", tb.bitonic_global, tb.global_plain,
                    (n, nk, 15, 14, 11)),
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
