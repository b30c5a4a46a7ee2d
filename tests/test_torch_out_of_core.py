"""The port's out-of-core sorts and host library against ``sortx``.

``sortx_torch.sort_large`` / ``sort_kv_large`` sort each chunk on the
device (here ``device="cpu"``: the engines' plain versions) and merge
the runs with the port's own host library (``sortx_torch/csrc/
host_sort.cpp``, built with the host C++ compiler at first use). Small
``chunk_elems`` give 3-5 runs with a ragged last run; every output is
held bit for bit against ``sortx.sort_large`` / ``sort_kv_large`` on
JAX-CPU (or, where the reference's own library is not built,
``sortx.sort`` / ``sort_kv`` of the whole input, which the out-of-core
contract equals).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sortx
import sortx_torch
from sortx.runtime import native as ref_native
from sortx_torch.ops import out_of_core as oc
from sortx_torch.runtime import launcher, native
from sortx_torch.utils.errors import CapacityError

CPU = {"device": "cpu"}
# (chunk_elems, n): 5, 3 and 4 runs, the last one ragged
GEOMETRY = [(1 << 12, 4 * 4096 + 77), (1 << 13, 2 * 8192 + 1000),
            (1 << 14, 3 * 16384 + 5)]


def _keys(rng, dtype, n, dup=False):
    if dup:
        k = rng.randint(0, 50, size=n).astype(np.uint32) * 0x01000193
    else:
        k = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    if dtype == np.float32:
        k[::97] = 0x80000000          # -0.0
        k[::101] = 0x7FC00001         # NaN with a payload
    return k.view(dtype)


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _want_sort(k, chunk, sort_bits=32, descending=False):
    if ref_native.available():
        return sortx.sort_large(k, sort_bits, descending=descending,
                                chunk_elems=chunk)
    return sortx.sort(jnp.asarray(k), sort_bits, descending=descending)


def _want_sort_kv(k, v, chunk, descending=False):
    if ref_native.available():
        return sortx.sort_kv_large(k, v, descending=descending,
                                   chunk_elems=chunk)
    return sortx.sort_kv(jnp.asarray(k), jnp.asarray(v),
                         descending=descending)


@pytest.mark.parametrize("chunk, n", GEOMETRY)
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32],
                         ids=lambda d: np.dtype(d).name)
def test_sort_large_matches_sortx(rng, dtype, chunk, n):
    k = _keys(rng, dtype, n)
    _same(sortx_torch.sort_large(k, chunk_elems=chunk, **CPU),
          _want_sort(k, chunk))


@pytest.mark.parametrize("sort_bits, descending", [(16, False), (16, True),
                                                   (32, True), (5, True)])
def test_sort_large_partial_bits_and_descending(rng, sort_bits, descending):
    chunk, n = GEOMETRY[0]
    k = _keys(rng, np.uint32, n, dup=sort_bits == 32)
    _same(sortx_torch.sort_large(k, sort_bits, descending=descending,
                                 chunk_elems=chunk, **CPU),
          _want_sort(k, chunk, sort_bits, descending))


def test_sort_large_on_the_network_engine(rng):
    """The chunks take the engine the config names: here the network's
    plain versions, as K1-K3 on a card."""
    chunk, n = GEOMETRY[1]
    k = _keys(rng, np.float32, n)
    cfg = sortx_torch.Config(engine="network")
    _same(sortx_torch.sort_large(k, chunk_elems=chunk, config=cfg, **CPU),
          _want_sort(k, chunk))
    v = np.arange(n, dtype=np.int32)
    for got, want in zip(sortx_torch.sort_kv_large(k, v, chunk_elems=chunk,
                                                   config=cfg, **CPU),
                         _want_sort_kv(k, v, chunk)):
        _same(got, want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("vdtype", [np.int32, np.float32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("kdtype", [np.uint32, np.int32, np.float32],
                         ids=lambda d: np.dtype(d).name)
def test_sort_kv_large_matches_sortx(rng, kdtype, vdtype, descending):
    """Stable on duplicate-heavy keys; values ride as u32 views."""
    chunk, n = GEOMETRY[2]
    k = _keys(rng, kdtype, n, dup=True)
    v = (np.arange(n, dtype=np.int32) if vdtype == np.int32
         else rng.randn(n).astype(np.float32))
    ks, vs = sortx_torch.sort_kv_large(k, v, descending=descending,
                                       chunk_elems=chunk, **CPU)
    wk, wv = _want_sort_kv(k, v, chunk, descending)
    _same(ks, wk)
    _same(vs, wv)


@pytest.mark.parametrize("n", [0, 1, 1000, 1 << 12])
def test_single_chunk_takes_the_short_cut(rng, monkeypatch, n):
    """One chunk (or none) is the device's sort alone: no merge runs."""
    def no_merge(*a, **k):
        raise AssertionError("host_merge called for one chunk")

    monkeypatch.setattr(native, "host_merge", no_merge)
    k = _keys(rng, np.int32, n)
    got = sortx_torch.sort_large(k, chunk_elems=1 << 12, **CPU)
    _same(got, np.asarray(sortx.sort(jnp.asarray(k))))
    v = np.arange(n, dtype=np.float32)
    ks, vs = sortx_torch.sort_kv_large(k, v, chunk_elems=1 << 12, **CPU)
    wk, wv = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v))
    _same(ks, wk)
    _same(vs, wv)


def test_validation_errors():
    """The reference's errors (``sortx/ops/out_of_core.py:91-97,
    136-139``), raised before any device is touched."""
    u32 = np.zeros(8, np.uint32)
    for call, err in (
            (lambda: sortx_torch.sort_large(np.zeros((4, 4), np.uint32)),
             ValueError),
            (lambda: sortx_torch.sort_large(u32, 0), ValueError),
            (lambda: sortx_torch.sort_large(u32, 33), ValueError),
            (lambda: sortx_torch.sort_large(np.zeros(8, np.int32), 12),
             ValueError),
            (lambda: sortx_torch.sort_large(np.zeros(8, np.uint8)),
             TypeError),
            (lambda: sortx_torch.sort_kv_large(u32, u32[:7]), ValueError),
            (lambda: sortx_torch.sort_kv_large(u32.reshape(2, 4),
                                               u32.reshape(2, 4)),
             ValueError),
            (lambda: sortx_torch.sort_kv_large(u32, np.zeros(8, np.int16)),
             TypeError),
            (lambda: sortx_torch.sort_kv_large(np.zeros(8, np.uint8), u32),
             TypeError)):
        with pytest.raises(err):
            call()


def test_cuda_device_without_a_card_raises(monkeypatch):
    """Nothing falls back to the CPU: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k = np.arange(16, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sortx_torch.sort_large(k)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sortx_torch.sort_kv_large(k, k, device="cuda")


def _runs(rng, sizes, high=2**32):
    runs = [np.sort(rng.randint(0, high, size=s).astype(np.uint32))
            for s in sizes]
    return np.concatenate(runs), np.cumsum([0] + list(sizes))


@pytest.mark.parametrize("sizes", [(1000, 1, 0, 4096, 333), (5,),
                                   (0, 0), (70_000, 70_001)])
def test_host_merge_matches_numpy(rng, sizes):
    keys, off = _runs(rng, sizes)
    np.testing.assert_array_equal(native.host_merge(keys, off),
                                  np.sort(keys))


def test_host_merge_kv_is_stable(rng):
    """Equal keys keep run order: the merged values are the stable
    argsort of the concatenated runs."""
    keys, off = _runs(rng, (2048, 1024, 3000), high=13)
    vals = np.arange(keys.shape[0], dtype=np.uint32)
    ko, vo = native.host_merge(keys, off, values=vals)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ko, keys[order])
    np.testing.assert_array_equal(vo, vals[order])


@pytest.mark.parametrize("with_values", [False, True])
def test_host_merge_matches_sortx(rng, with_values):
    if not ref_native.available():
        pytest.skip("the reference's libsortx_host.so is not built "
                    "(make -C csrc)")
    keys, off = _runs(rng, (3000, 17, 4096, 1), high=200)
    vals = rng.randint(0, 2**32, size=keys.shape[0], dtype=np.uint32)
    v = vals if with_values else None
    got, want = native.host_merge(keys, off, v), ref_native.host_merge(
        keys, off, v)
    for g, w in zip(got if with_values else (got,),
                    want if with_values else (want,)):
        np.testing.assert_array_equal(g, w)


def test_host_library_sort_and_scan(rng):
    keys = rng.randint(0, 2**32, size=5000, dtype=np.uint32)
    vals = np.arange(5000, dtype=np.uint32)
    np.testing.assert_array_equal(native.host_sort(keys), np.sort(keys))
    order = np.argsort(keys & 0xFFF, kind="stable")
    np.testing.assert_array_equal(native.host_sort(keys, 12), keys[order])
    ks, vs = native.host_sort_kv(keys, vals, 12)
    np.testing.assert_array_equal(ks, keys[order])
    np.testing.assert_array_equal(vs, vals[order])
    out, total = native.host_scan(keys)
    wide = keys.astype(np.uint64)
    np.testing.assert_array_equal(out, ((np.cumsum(wide) - wide)
                                        & 0xFFFFFFFF).astype(np.uint32))
    assert total == np.uint32(wide.sum() & 0xFFFFFFFF)


def test_host_merge_validation(rng):
    keys, off = _runs(rng, (10, 10))
    with pytest.raises(ValueError):
        native.host_merge(keys, [0, 10, 19])
    with pytest.raises(ValueError):
        native.host_merge(keys, [0, 12, 10, 20])
    with pytest.raises(ValueError):
        native.host_merge(keys, off, values=keys[:5])


def test_host_library_build_raises(monkeypatch, tmp_path):
    """A failed build raises, and so does a missing compiler; the
    library is built into a fresh directory here, then loaded."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    assert not native.available()
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("--sortx-no-such-option",))
    with pytest.raises(RuntimeError, match="host library build failed"):
        native.build_native()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C"):
        native.build_native()
    assert not native.available()


def _fake_card(monkeypatch, total):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (total // 2, total))


def test_capacity_error_raised(monkeypatch):
    """A fake 1 GB card turns an oversized sort into a typed
    CapacityError naming sort_large."""
    _fake_card(monkeypatch, 1 << 30)
    with pytest.raises(CapacityError, match="sortx_torch.sort_large"):
        oc.check_device_capacity(1 << 28, 1)
    oc.check_device_capacity(1 << 24, 1)
    assert oc.device_capacity_keys(1) == 1 << 26  # 0.9 GB / 8 B per key
    assert oc.device_capacity_keys(3) == 1 << 25
    assert sortx_torch.ops.device_capacity_keys is oc.device_capacity_keys


def test_capacity_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert oc.device_capacity_keys(1) is None
    oc.check_device_capacity(1 << 40, 4)


def test_sort_large_profile_row(rng, tmp_path):
    csv = tmp_path / "prof.csv"
    k = _keys(rng, np.uint32, 5000)
    launcher.toggle_profiling(True, str(csv))
    try:
        sortx_torch.sort_large(k, chunk_elems=1 << 12, **CPU)
    finally:
        launcher.toggle_profiling(False)
    rows = csv.read_text().splitlines()
    assert sum(r.startswith("sort_large,") for r in rows) == 1
    assert sum(r.startswith("sort,") for r in rows) == 2   # one per chunk
