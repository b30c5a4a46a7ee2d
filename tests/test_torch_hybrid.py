"""The port's hybrid sample-sort engine against ``sortx``'s, bit for bit.

The JAX side runs ``Config(engine="hybrid")`` in interpret mode with the
shrunken geometry of ``tests/test_engine.py`` (tiles of 4096, mover
chunks of 2048), so several tiles, buckets and chunks are exercised;
the port's side runs the same configuration through
``config_from_sortx`` on CPU tensors, where the row network (K1-K3 in
rows mode) and the run mover (K6) run their plain versions.
"""

import contextlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sortx
import sortx_torch
from sortx.ops import sort_pallas as jax_engine
from sortx_torch.convert import config_from_sortx, to_numpy, to_torch
from sortx_torch.ops import sort_hybrid

N = 20_003
JAX_HYBRID = sortx.Config(engine="hybrid", interpret=True, engine_min_n=0,
                          engine_tile_elems=4096, engine_chunk_elems=2048)
HYBRID = config_from_sortx(JAX_HYBRID)


def _same(got, want):
    want = np.asarray(want)
    got = to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_config_maps_across():
    assert HYBRID == sortx_torch.Config(engine="hybrid",
                                        scan_tile_elems=1 << 18,
                                        engine_tile_elems=4096,
                                        engine_chunk_elems=2048)
    cfg = config_from_sortx(sortx.Config(
        engine="hybrid", engine_buckets=64, engine_headroom=1.5,
        engine_phase_sort="xla", sort_tile_elems=1 << 12))
    assert (cfg.engine_buckets, cfg.engine_headroom, cfg.engine_phase_sort,
            cfg.sort_tile_elems) == (64, 1.5, "host", 1 << 12)


def test_hybrid_keys(rng):
    k = rng.randint(0, 2**32, size=N, dtype=np.uint32)
    want = sortx.sort(jnp.asarray(k), config=JAX_HYBRID)
    assert jax_engine.last_dispatch == "hybrid"
    got = sortx_torch.sort(to_torch(k), config=HYBRID)
    assert sort_hybrid.last_dispatch == "hybrid"
    _same(got, want)
    _same(got, np.sort(k))


@pytest.mark.parametrize("sort_bits", [None, 12])
def test_hybrid_stable_kv(rng, sort_bits):
    k = (rng.randint(0, 97, size=N) * 0x01000193).astype(np.uint32)
    k[rng.randint(0, N, 300)] = 0xFFFFFFFF
    v = np.arange(N, dtype=np.uint32)
    want = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v), sort_bits,
                         config=JAX_HYBRID)
    got = sortx_torch.sort_kv(to_torch(k), to_torch(v), sort_bits,
                              config=HYBRID)
    assert sort_hybrid.last_dispatch == "hybrid"
    for g, w in zip(got, want):
        _same(g, w)


def test_hybrid_partial_bits_keys(rng):
    k = rng.randint(0, 2**32, size=N, dtype=np.uint32)
    want = sortx.sort(jnp.asarray(k), 7, config=JAX_HYBRID)
    _same(sortx_torch.sort(to_torch(k), 7, config=HYBRID), want)
    assert sort_hybrid.last_dispatch == "hybrid"


@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=lambda d: np.dtype(d).name)
def test_hybrid_signed_and_float_keys(rng, dtype):
    """Splitters compare in unsigned word order, through ``ordered``."""
    k = (rng.randn(N) * 1e6).astype(dtype)
    want = sortx.sort(jnp.asarray(k), descending=True,
                      config=sortx.Config(engine="host"))
    _same(sortx_torch.sort(to_torch(k), descending=True, config=HYBRID),
          want)
    assert sort_hybrid.last_dispatch == "hybrid"


@pytest.mark.parametrize("case", ["all_equal", "two_values"])
def test_hybrid_skew(rng, case):
    """All-equal keys take the ordered short cut before any engine; keys
    drawn from {3, 0xFFFFFFFF} overflow a bucket, and the network sorts."""
    n = 10_000
    k = (np.full(n, 0xDEAD, np.uint32) if case == "all_equal" else
         rng.choice(np.array([3, 0xFFFFFFFF], np.uint32), size=n))
    v = np.arange(n, dtype=np.uint32)
    sort_hybrid.last_dispatch = None
    _same(sortx_torch.sort(to_torch(k), config=HYBRID),
          sortx.sort(jnp.asarray(k), config=JAX_HYBRID))
    assert sort_hybrid.last_dispatch == (
        None if case == "all_equal" else "hybrid-overflow")
    got = sortx_torch.sort_kv(to_torch(k), to_torch(v), config=HYBRID)
    order = np.argsort(k, kind="stable")
    _same(got[0], k[order])
    _same(got[1], v[order])


def test_small_n_hands_over_to_the_network(rng):
    k = rng.randint(0, 2**32, size=5000, dtype=np.uint32)
    _same(sortx_torch.sort(to_torch(k), config=HYBRID), np.sort(k))
    assert sort_hybrid.last_dispatch == "network-small"


@pytest.mark.parametrize("n, reason", [
    (1 << 30, None), (1_300_000_000, "network-large"),
    (3 << 29, "network-large"), (1 << 31, "network-large")])
def test_int32_tables_bound_the_engine(n, reason):
    """At 2^31 words of bucket rows or compacted output the int32 run
    tables and chunk ends would wrap (from about 1.3e9 keys the bucket
    rows hold exactly 2^31), so those sizes go to the network engine."""
    cfg = sortx_torch.Config(engine="hybrid")
    S, L, B, cap, chunk, _ = sort_hybrid._params(n, cfg)
    wraps = max(B * cap, -(-S * L // chunk) * chunk) >= 1 << 31
    assert wraps == (reason is not None)
    assert sort_hybrid._network_reason(n, cfg) == reason


@pytest.mark.parametrize("kv", [False, True], ids=["keys", "kv"])
def test_too_large_for_int32_runs_the_network(rng, monkeypatch, kv):
    monkeypatch.setattr(sort_hybrid, "_INDEX_LIMIT", 1 << 14)
    monkeypatch.setattr(sort_hybrid, "_engine", None)   # must not run
    k = rng.randint(0, 2**32, size=N, dtype=np.uint32)
    v = np.arange(N, dtype=np.uint32)
    order = np.argsort(k, kind="stable")
    if kv:
        got = sortx_torch.sort_kv(to_torch(k), to_torch(v), config=HYBRID)
        _same(got[0], k[order])
        _same(got[1], v[order])
    else:
        _same(sortx_torch.sort(to_torch(k), config=HYBRID), k[order])
    assert sort_hybrid.last_dispatch == "network-large"


def test_step_hook_sees_every_step(rng, monkeypatch):
    seen = []

    def hook(name):
        seen.append(name)
        return contextlib.nullcontext()
    monkeypatch.setattr(sort_hybrid, "step_hook", hook)
    k = rng.randint(0, 2**32, size=N, dtype=np.uint32)
    _same(sortx_torch.sort(to_torch(k), config=HYBRID), np.sort(k))
    assert seen == ["tiles", "phase A", "partition plan", "partition move",
                    "phase B", "compaction"]


def test_hybrid_runs_two_mover_passes(rng, monkeypatch):
    """The partition and the compaction: two K6 calls per sort."""
    calls = []
    real = sort_hybrid.move_runs

    def spy(*args, **kwargs):
        calls.append(args[4])
        return real(*args, **kwargs)
    monkeypatch.setattr(sort_hybrid, "move_runs", spy)
    k = rng.randint(0, 2**32, size=N, dtype=np.uint32)
    _same(sortx_torch.sort(to_torch(k), config=HYBRID), np.sort(k))
    S, L, B, cap, chunk, _ = sort_hybrid._params(N, HYBRID)
    assert calls == [B * cap, -(-S * L // chunk) * chunk]


def test_host_phase_sort_matches_the_network(rng):
    k = (rng.randint(0, 500, size=N) * 0x00C0FFEE).astype(np.uint32)
    v = rng.randint(0, 2**32, size=N, dtype=np.uint32)
    cfg = config_from_sortx(sortx.Config(
        engine="hybrid", engine_phase_sort="xla", engine_tile_elems=4096,
        engine_chunk_elems=2048))
    got = sortx_torch.sort_kv(to_torch(k), to_torch(v), config=cfg)
    assert sort_hybrid.last_dispatch == "hybrid"
    want = sortx_torch.sort_kv(to_torch(k), to_torch(v), config=HYBRID)
    for g, w in zip(got, want):
        _same(g, to_numpy(w))


def _sweep():
    sizes = [8192, 20_003, 65_535, 1 << 16, 100_003, 1 << 20,
             (1 << 22) + 7, 1 << 27, 3 << 25, 1 << 30]
    cfgs = [sortx.Config(), JAX_HYBRID,
            sortx.Config(engine_buckets=48, engine_headroom=1.3),
            sortx.Config(engine_phase_sort="xla"),
            sortx.Config(engine_tile_elems=1 << 16,
                         engine_chunk_elems=3 << 10)]
    return [(n, c) for n in sizes for c in range(len(cfgs))], cfgs


@pytest.mark.parametrize("n, c", _sweep()[0])
def test_params_match_the_reference(n, c):
    cfg = _sweep()[1][c]
    assert sort_hybrid._params(n, config_from_sortx(cfg)) == \
        jax_engine._params(n, cfg)


def test_hybrid_bytes_count_the_three_buffers():
    cfg = sortx_torch.Config()
    S, L, B, cap, chunk, _ = sort_hybrid._params(1 << 27, cfg)
    assert (S, L, B, cap) == (64, 1 << 21, 564, 1 << 18)
    assert sort_hybrid.hybrid_bytes(1 << 27, 2, cfg) == 4 * 2 * (
        (1 << 27) + 564 * (1 << 18) + (1 << 27))


def test_sort_dispatch_reaches_the_hybrid(monkeypatch, rng):
    port_sort = importlib.import_module("sortx_torch.ops.sort")

    def other(*args, **kwargs):
        raise AssertionError("another engine ran under engine='hybrid'")
    for name in ("sort_host", "sort_kv_host", "sort_network",
                 "sort_kv_network"):
        monkeypatch.setattr(port_sort, name, other)
    k = rng.randint(0, 2**32, size=N, dtype=np.uint32)
    _same(sortx_torch.sort(to_torch(k), config=HYBRID), np.sort(k))


def _reference_samples(S, L, B, alpha, device):
    """sortx's sample positions and splitter ranks (sort_pallas.py:164-166)."""
    idx = (torch.arange(alpha, device=device) + 1) * (L // (alpha + 1))
    ranks = (torch.arange(B - 1, device=device) + 1) * (S * alpha) // B
    return idx, ranks


def test_even_samples_keep_uniform_keys_in_the_engine(rng, monkeypatch):
    """The reference's samples stop short of each tile's top (a floor of
    L / (alpha+1) per step), so its top bucket overflows cap on uniform
    keys; the port's even samples and centred ranks keep every bucket
    near the mean. The output is the same either way."""
    cfg = sortx_torch.Config(engine="hybrid", engine_tile_elems=4096,
                             engine_chunk_elems=1024, engine_buckets=64)
    k = rng.randint(0, 2**32, size=N, dtype=np.uint32)
    _same(sortx_torch.sort(to_torch(k), config=cfg), np.sort(k))
    assert sort_hybrid.last_dispatch == "hybrid"
    monkeypatch.setattr(sort_hybrid, "_splitter_samples", _reference_samples)
    _same(sortx_torch.sort(to_torch(k), config=cfg), np.sort(k))
    assert sort_hybrid.last_dispatch == "hybrid-overflow"
