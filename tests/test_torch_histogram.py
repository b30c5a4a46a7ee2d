"""The port's histogram (K5's plain version and the public op) against
``sortx``, bit for bit.

The JAX side runs its Pallas ``tile_histogram`` in interpret mode and
its public ``histogram`` on the Pallas engine (interpret mode, which
pads the last tile and subtracts the pads) and on the host engine. The
port's side runs on CPU tensors, where K5's wrapper runs its plain
version, which bounds the last tile instead of padding it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sortx
import sortx_torch
from sortx.ops.radix_kernels import tile_histogram as jax_tile_histogram
from sortx_torch.convert import config_from_sortx, to_numpy, to_torch
from sortx_torch.ops.histogram import histogram_tile
from sortx_torch.ops.radix_kernels import histogram_plain, tile_histogram

HOST = sortx.Config(engine="host")
ENGINES = ["host", "network"]


def _words(rng, n, dtype=np.uint32):
    x = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    x[: n // 3] = 0xFFFFFFFF            # the pad word is also a real key
    return x.view(dtype)


@pytest.mark.parametrize("radix, shift", [(256, 24), (16, 30), (256, 0),
                                          (2, 31), (128, 5)])
def test_tile_histogram_matches_pallas_interpret(rng, radix, shift):
    tile_rows = 16
    x = _words(rng, 3 * tile_rows * 128)
    want = np.asarray(jax_tile_histogram(
        jnp.asarray(x).reshape(-1, 128), jnp.int32(shift), radix=radix,
        tile_rows=tile_rows, interpret=True))[:, :radix]
    got = tile_histogram(to_torch(x).view(torch.int32), shift, radix=radix,
                         tile_elems=tile_rows * 128)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("n", [1, 4096, 10_001])
@pytest.mark.parametrize("bits, shift", [(8, 24), (4, 30), (8, 28),
                                         (3, 0)])
def test_histogram_per_tile_matches_pallas(rng, n, bits, shift):
    """Ragged n, and shift + bits > 32, where the pads' digit is not the
    top bucket: the TPU's pad correction and the port's bounded last
    tile must agree."""
    x = _words(rng, n)
    cfg = sortx.Config(engine="pallas", interpret=True,
                       sort_tile_elems=2048)
    port = config_from_sortx(cfg)
    assert port.engine == "network"
    for per_tile in (True, False):
        want = sortx.histogram(jnp.asarray(x), bits, shift,
                               per_tile=per_tile, config=cfg)
        got = sortx_torch.histogram(to_torch(x), bits, shift,
                                    per_tile=per_tile, config=port)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.uint32, np.int32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("per_tile", [False, True])
@pytest.mark.parametrize("tile", [1 << 10, 1 << 14, 1 << 20, 1 << 30])
def test_histogram_matches_host(rng, dtype, per_tile, tile):
    """The host engine at tiles clamped both ways (8 and 2048 rows)."""
    x = _words(rng, 70_001, dtype)
    cfg = sortx.Config(engine="host", sort_tile_elems=tile)
    want = np.asarray(sortx.histogram(jnp.asarray(x), 8, 16,
                                      per_tile=per_tile, config=cfg))
    for engine in ENGINES:
        port = sortx_torch.Config(engine=engine, sort_tile_elems=tile)
        got = to_numpy(sortx_torch.histogram(to_torch(x), 8, 16,
                                             per_tile=per_tile, config=port))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_histogram_tile_is_the_references():
    for tile, rows in ((1 << 10, 8), (1 << 14, 128), (1 << 20, 2048)):
        assert histogram_tile(sortx_torch.Config(sort_tile_elems=tile)) == \
            rows * 128


def test_plain_histogram_bounds_the_last_tile(rng):
    x = torch.from_numpy(_words(rng, 5000).view(np.int32))
    counts = histogram_plain(x, 28, 16, 2048)
    assert counts.shape == (3, 16)
    assert counts.sum(1).tolist() == [2048, 2048, 904]


@pytest.mark.parametrize("per_tile", [False, True])
def test_empty_shapes_match(per_tile):
    x = np.zeros(0, np.uint32)
    want = sortx.histogram(jnp.asarray(x), 5, per_tile=per_tile,
                           config=HOST)
    got = sortx_torch.histogram(to_torch(x), 5, per_tile=per_tile)
    assert got.shape == tuple(want.shape) and got.dtype == torch.int32
    assert not got.any()


@pytest.mark.parametrize("x, kw, err", [
    (np.zeros((2, 4), np.uint32), {}, ValueError),
    (np.zeros(4, np.float32), {}, TypeError),
    (np.zeros(4, np.uint32), dict(bits=0), ValueError),
    (np.zeros(4, np.uint32), dict(bits=9), ValueError),
    (np.zeros(4, np.uint32), dict(shift=32), ValueError),
    (np.zeros(4, np.uint32), dict(shift=-1), ValueError),
], ids=["2d", "f32", "bits0", "bits9", "shift32", "shift-1"])
def test_errors_match(x, kw, err):
    with pytest.raises(err):
        sortx.histogram(jnp.asarray(x), config=HOST, **kw)
    with pytest.raises(err):
        sortx_torch.histogram(to_torch(x), **kw)


# --- the prefix filter (a round of kth_value inside K5) -------------------

def _round_keys(rng, kind, n=20_001):
    if kind == "uniform":
        return rng.randint(0, 2**32, size=n, dtype=np.uint32)
    if kind == "all-equal":
        return np.full(n, 0x5A5A5A5A, np.uint32)
    if kind == "two-valued":
        return (rng.randint(0, 2, size=n).astype(np.uint32) * 0x11111111
                + 0x01020304).astype(np.uint32)
    # few distinct bytes at every level: each round narrows a crowd
    return (rng.randint(0, 3, size=(n, 4)).astype(np.uint32)
            * np.array([1 << 24, 1 << 16, 1 << 8, 1], np.uint32)).sum(
                1).astype(np.uint32)


@pytest.mark.parametrize("kind", ["uniform", "all-equal", "two-valued",
                                  "nested"])
@pytest.mark.parametrize("shift", [24, 16, 8, 0])
def test_filtered_histogram_is_the_references_round(rng, kind, shift):
    """The reference's round of kth_value parks the words outside the
    prefix in bucket 0 and subtracts them (sortx/ops/select.py:60-68);
    the plain version of K5 with the prefix gives the same 256 counts,
    per tile too."""
    x = _round_keys(rng, kind)
    n = x.shape[0]
    chosen = int(x[n // 2]) >> (shift + 8) if shift < 24 else 0
    u = jnp.asarray(x)
    m = u >> jnp.uint32(shift)
    match = (m >> jnp.uint32(8)) == jnp.uint32(chosen)
    digit = jnp.where(match, m & jnp.uint32(0xFF), jnp.uint32(0))
    want = np.asarray(sortx.histogram(digit, bits=8, shift=0, config=HOST))
    want = want.copy()
    want[0] += int(match.sum()) - n
    xi = to_torch(x).view(torch.int32)
    prefix = torch.tensor([chosen], dtype=torch.int32)
    rows = histogram_plain(xi, shift, 256, 2048, prefix)
    assert rows.shape == (-(-n // 2048), 256) and rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.sum(0).numpy(), want)
    assert int(rows.sum()) == int(match.sum())
    for per_tile in (True, False):      # K5's wrapper on a CPU tensor
        got = tile_histogram(xi, shift, radix=256, tile_elems=2048,
                             per_tile=per_tile, prefix=prefix)
        assert torch.equal(got, rows if per_tile
                           else rows.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("bits, shift", [(8, 24), (4, 30), (1, 31), (8, 28)])
def test_prefix_is_ignored_where_no_bits_lie_above_the_digit(rng, bits,
                                                             shift):
    x = torch.from_numpy(_words(rng, 5000).view(np.int32))
    prefix = torch.tensor([123], dtype=torch.int32)
    assert torch.equal(histogram_plain(x, shift, 1 << bits, 1024, prefix),
                       histogram_plain(x, shift, 1 << bits, 1024))


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("shift", [0, 7, 23])
def test_filtered_histogram_matches_numpy(rng, bits, shift):
    """Every digit width: counts of the digit among the words whose bits
    above it equal the prefix (negative int32: a u32 above 2^31)."""
    x = _words(rng, 9000)
    x[::5] = x[0]                       # a crowd under one prefix
    hi = shift + bits
    chosen = int(x[0]) >> hi
    keep = (x >> np.uint32(hi)) == chosen
    want = np.bincount((x[keep] >> np.uint32(shift)) & ((1 << bits) - 1),
                       minlength=1 << bits)
    prefix = torch.from_numpy(np.array([chosen], np.uint32).view(np.int32))
    got = tile_histogram(to_torch(x).view(torch.int32), shift,
                         radix=1 << bits, tile_elems=1024, per_tile=False,
                         prefix=prefix)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("prefix", [
    torch.zeros(1, dtype=torch.int64), torch.zeros(2, dtype=torch.int32)],
    ids=["int64", "two"])
def test_tile_histogram_rejects_a_bad_prefix(prefix):
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tile_histogram(x, 0, radix=256, tile_elems=1024, prefix=prefix)
