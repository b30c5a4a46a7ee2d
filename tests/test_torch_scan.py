"""The port's scan against ``sortx.scan``, bit for bit.

The JAX side runs its Pallas tile kernel in interpret mode at a small
ragged size, and its host engine at 2^20 and ragged sizes. The port's
side runs on CPU tensors: the plain version of K4 (``torch.cumsum`` in
int64, wrapped to 32 bits) through both of its engines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sortx
import sortx_torch
from sortx_torch.convert import config_from_sortx, to_numpy, to_torch
from sortx_torch.ops.scan import tile_scan

HOST = sortx.Config(engine="host")
PORT_ENGINES = [sortx_torch.Config(engine="host"),
                sortx_torch.Config(engine="network", scan_tile_elems=1024)]


def _data(rng, n, dtype):
    """Words near 2^31 in magnitude, so every prefix sum wraps."""
    x = rng.randint(2**30, 2**31, size=n, dtype=np.int64)
    x[::3] = -x[::3]
    return (x & 0xFFFFFFFF).astype(np.uint32).view(dtype)


def _both(x, cfg_jax, cfg_port, **kw):
    want = sortx.scan(jnp.asarray(x), with_total=True, config=cfg_jax, **kw)
    got = sortx_torch.scan(to_torch(x), with_total=True, config=cfg_port,
                           **kw)
    for w, g in zip(want, got):
        w, g = np.asarray(w), to_numpy(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("inclusive", [False, True])
def test_scan_matches_pallas_interpret(rng, inclusive):
    x = _data(rng, 5000, np.uint32)
    cfg = sortx.Config(engine="pallas", interpret=True, scan_tile_elems=1024)
    _both(x, cfg, config_from_sortx(cfg), inclusive=inclusive)


@pytest.mark.parametrize("n", [1, 1023, 5000, 1 << 20, (1 << 20) + 13])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("inclusive", [False, True])
def test_scan_matches_host_engine(rng, n, dtype, inclusive):
    x = _data(rng, n, dtype)
    for cfg in PORT_ENGINES:
        _both(x, HOST, cfg, inclusive=inclusive)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_scan_empty(dtype):
    x = np.zeros(0, dtype)
    _both(x, HOST, sortx_torch.Config())
    got = sortx_torch.scan(to_torch(x))
    assert got.shape == (0,) and to_numpy(got).dtype == dtype


def test_scan_without_total_and_exclusive_default(rng):
    x = _data(rng, 3000, np.uint32)
    want = np.asarray(sortx.scan(jnp.asarray(x), config=HOST))
    got = to_numpy(sortx_torch.scan(to_torch(x)))
    np.testing.assert_array_equal(got, want)


def test_tile_scan_plain_version(rng):
    """K4's wrapper on a CPU tensor: its plain version, exclusive."""
    x = torch.from_numpy(_data(rng, 4097, np.int32))
    out, total = tile_scan(x, tile_elems=1024)
    x64 = x.to(torch.int64)
    want = (torch.cumsum(x64, 0) - x64) & 0xFFFFFFFF
    assert torch.equal(out.to(torch.int64) & 0xFFFFFFFF, want)
    assert int(total) & 0xFFFFFFFF == int(x64.sum()) & 0xFFFFFFFF


@pytest.mark.parametrize("bad, err", [
    (np.zeros((2, 4), np.int32), ValueError),
    (np.zeros(4, np.float32), TypeError),
    (np.zeros(4, np.int16), TypeError),
])
def test_scan_errors_match(bad, err):
    with pytest.raises(err):
        sortx.scan(jnp.asarray(bad), config=HOST)
    with pytest.raises(err):
        sortx_torch.scan(to_torch(bad))
