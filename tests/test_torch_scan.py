"""The port's scan against ``sortx.scan``, bit for bit.

The JAX side runs its Pallas tile kernel in interpret mode at a small
ragged size, and its host engine at 2^20 and ragged sizes. The port's
side runs on CPU tensors: the plain version of K4 (``torch.cumsum`` in
int64, wrapped to 32 bits) through both of its engines, and the
kernel's schedule (tile scans, aggregates, look-back in any order)
stated in tensor operations here, ``lookback_plain``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sortx
import sortx_torch
from sortx_torch.convert import config_from_sortx, to_numpy, to_torch
from sortx_torch.ops.scan import SCAN_TILE, scan_plain, tile_scan
from sortx_torch.utils.words import wrap_i32

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
    with pytest.raises(ValueError):
        tile_scan(x, tile_elems=1000)
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


# --- K4's schedule: local tile scans and the look-back over aggregates ---

def lookback_plain(x, inclusive=False, tile_elems=SCAN_TILE, order=None):
    """K4's schedule in tensor operations: (scan, total) of 1-D int32
    words.

    Each tile of ``tile_elems`` words is scanned alone (mod 2^32) and
    gives its aggregate; a tile's exclusive prefix is the sum of the
    aggregates before it. ``order`` (tile numbers, each once) replays the
    look-back tile by tile: every tile has published its aggregate, and
    the tiles then finish in that order, each walking back over
    aggregates to the nearest tile that already holds its inclusive
    prefix. The result does not depend on ``order`` or ``tile_elems``.
    """
    n = x.shape[0]
    tiles = -(-n // tile_elems)
    padded = torch.zeros(tiles * tile_elems, dtype=torch.int64)
    padded[:n] = x
    local = wrap_i32(torch.cumsum(padded.view(tiles, tile_elems), 1))
    aggregate = local[:, -1].to(torch.int64)
    if order is None:
        exclusive = torch.cumsum(aggregate, 0) - aggregate
    else:
        exclusive = torch.zeros_like(aggregate)
        done = [False] * tiles      # has published its inclusive prefix
        for t in (int(t) for t in order):
            back = t - 1
            while back >= 0 and not done[back]:
                exclusive[t] += aggregate[back]
                back -= 1
            if back >= 0:
                exclusive[t] += exclusive[back] + aggregate[back]
            done[t] = True
    exclusive = wrap_i32(exclusive)
    out = wrap_i32(local.to(torch.int64) + exclusive.view(-1, 1)).view(-1)[:n]
    total = wrap_i32(exclusive[-1].to(torch.int64) + aggregate[-1])
    return (out if inclusive else wrap_i32(out.to(torch.int64) - x)), total


def _orders(rng, tiles):
    return {"prefix": None, "forward": range(tiles),
            "backward": range(tiles - 1, -1, -1),
            "shuffled": rng.permutation(tiles)}


@pytest.mark.parametrize("order", ["prefix", "forward", "backward",
                                   "shuffled"])
@pytest.mark.parametrize("tile", [1024, 2048, 8192])
@pytest.mark.parametrize("n", [1, 1023, 8192, 8193, 20_001])
@pytest.mark.parametrize("inclusive", [False, True])
def test_lookback_schedule_matches_plain_and_host(rng, n, tile, inclusive,
                                                  order):
    """Whatever the tile and the order in which the tiles finish their
    look-back, the schedule gives scan_plain's and sortx.scan's bits."""
    x = _data(rng, n, np.int32)
    got = lookback_plain(torch.from_numpy(x), inclusive, tile,
                         _orders(rng, -(-n // tile))[order])
    plain = scan_plain(torch.from_numpy(x), inclusive)
    want = sortx.scan(jnp.asarray(x), with_total=True, inclusive=inclusive,
                      config=HOST)
    for g, p, w in zip(got, plain, want):
        assert g.dtype == torch.int32 and torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1, 5000, 1 << 14])
@pytest.mark.parametrize("inclusive", [False, True])
def test_lookback_schedule_matches_pallas_interpret(rng, n, inclusive):
    x = _data(rng, n, np.int32)
    cfg = sortx.Config(engine="pallas", interpret=True, scan_tile_elems=1024)
    want = sortx.scan(jnp.asarray(x), with_total=True, inclusive=inclusive,
                      config=cfg)
    got = lookback_plain(torch.from_numpy(x), inclusive, 2048,
                         rng.permutation(-(-n // 2048)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("inclusive", [False, True])
def test_lookback_schedule_wraps_on_all_ones(inclusive):
    """0xFFFFFFFF words: the running sum wraps at every step."""
    n = 5000
    x = torch.full((n,), -1, dtype=torch.int32)
    out, total = lookback_plain(x, inclusive, 1024, range(4, -1, -1))
    steps = torch.arange(1 if inclusive else 0, n + (1 if inclusive else 0))
    assert torch.equal(out, (-steps).to(torch.int32))
    assert int(total) == -n
    both = sortx_torch.scan(x.view(torch.uint32), with_total=True,
                            inclusive=inclusive)
    assert torch.equal(both[0].view(torch.int32), out)
    assert int(both[1].view(torch.int32)) == -n


@pytest.mark.parametrize("tile", [1024, 3072, 8192, 1 << 15, 1 << 18])
def test_scan_takes_every_tile_a_config_accepts(rng, tile):
    """``scan_tile_elems`` never changes the scan: any positive multiple
    of 1024 runs, the reference's default (2^18) included."""
    x = _data(rng, 20_001, np.uint32)
    cfg = sortx.Config(engine="pallas", scan_tile_elems=tile)
    assert config_from_sortx(cfg).scan_tile_elems == tile
    _both(x, HOST, config_from_sortx(cfg))


def test_scan_under_the_reference_default_config(rng):
    cfg = config_from_sortx(sortx.Config())
    assert cfg.scan_tile_elems == sortx.Config().scan_tile_elems
    _both(_data(rng, 9001, np.int32), HOST, cfg)


def test_scan_of_a_shifted_view_matches(rng):
    """A view that starts one word into its storage (off the 16-byte
    grid on the card)."""
    x = _data(rng, 9001, np.uint32)
    got = sortx_torch.scan(to_torch(x)[1:], with_total=True)
    want = sortx.scan(jnp.asarray(x[1:]), with_total=True, config=HOST)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
