"""The flagship slice end to end, the import boundary, and convert.py."""

import ast
import dataclasses
import inspect
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import sortx
import sortx_torch
from __graft_entry__ import entry as graft_entry
from sortx_torch.convert import config_from_sortx, to_numpy, to_torch

PKG = pathlib.Path(sortx_torch.__file__).parent


@pytest.mark.parametrize("engine", ["auto", "network"])
def test_flagship_matches_graft_entry(engine):
    """sort_kv then scan of the sorted keys, bit for bit on all outputs."""
    fn, (keys, values) = graft_entry()
    want = fn(keys, values)
    got = sortx_torch.entry(to_torch(np.asarray(keys)),
                            to_torch(np.asarray(values)),
                            config=sortx_torch.Config(engine=engine))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = to_numpy(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_import_leaves_jax_out():
    """A fresh interpreter imports sortx_torch without jax or sortx."""
    code = ("import sys; before = set(sys.modules); import sortx_torch; "
            "import sortx_torch.convert, sortx_torch.runtime.native; "
            "new = {m.split('.')[0] for m in set(sys.modules) - before}; "
            "bad = new & {'jax', 'jaxlib', 'sortx'}; "
            "assert not bad, bad; print('clean')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_sortx(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "sortx"), \
                f"{path} imports {name}"


def _patterns(dtype):
    """Every byte pattern family of the dtype, NaN payloads included."""
    rng = np.random.RandomState(123)
    raw = rng.randint(0, 256, size=4096).astype(np.uint8)
    return raw.view(np.dtype(dtype))


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.uint16, np.int16, np.float16,
                                   ml_dtypes.bfloat16],
                         ids=lambda d: np.dtype(d).name)
def test_convert_round_trip(dtype):
    a = _patterns(dtype)
    src = a.copy()
    t = to_torch(src)
    src.view(np.uint8)[:] = 0          # the tensor holds its own copy
    b = to_numpy(t)
    assert b.dtype == a.dtype and b.shape == a.shape
    assert np.array_equal(b.view(np.uint8), a.view(np.uint8))


def test_config_from_sortx():
    cfg = config_from_sortx(sortx.Config(engine="pallas",
                                         scan_tile_elems=1 << 18,
                                         engine_log_block=17))
    assert cfg == sortx_torch.Config(engine="network",
                                     scan_tile_elems=1 << 18)
    assert config_from_sortx(sortx.Config(engine="host")).engine == "host"
    assert config_from_sortx(sortx.Config()).engine == "auto"
    assert config_from_sortx(sortx.Config(engine="hybrid")).engine == "hybrid"
    # the reference's schedule fields have no counterpart: dist_sort runs
    # one schedule
    assert config_from_sortx(sortx.Config(
        dist_exchange="ring", dist_local_merge="rank")) == config_from_sortx(
            sortx.Config())
    assert not [f.name for f in dataclasses.fields(sortx_torch.Config)
                if f.name.startswith("dist_")]


def test_config_rejects_bad_fields():
    for kw in (dict(engine="pallas"), dict(scan_tile_elems=1000),
               dict(scan_tile_elems=0), dict(scan_tile_elems=-1024),
               dict(sort_tile_elems=100), dict(engine_chunk_elems=0),
               dict(engine_headroom=0.9), dict(engine_phase_sort="xla"),
               dict(engine_tile_elems=0), dict(engine_buckets=-1)):
        with pytest.raises(ValueError):
            sortx_torch.Config(**kw)


def test_flagship_total_is_the_wrapped_sum():
    """The scan's total is the sum of the keys' int32 words mod 2^32."""
    rng = np.random.RandomState(123)
    k = rng.randint(0, 2**32, size=5000, dtype=np.uint32)
    v = np.arange(5000, dtype=np.uint32)
    ks, vs, s, total = sortx_torch.entry(to_torch(k), to_torch(v))
    assert int(to_numpy(total).view(np.uint32)) == int(
        k.astype(np.uint64).sum() & 0xFFFFFFFF)
    want = sortx.scan(jnp.asarray(to_numpy(ks).view(np.int32)),
                      config=sortx.Config(engine="host"))
    np.testing.assert_array_equal(to_numpy(s), np.asarray(want))


def _call_shape(fn):
    """(name, kind, default) of each parameter: the signature without its
    annotations, which name torch types in the port."""
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


# Keyword-only parameters the port adds to an op of the reference:
# sort_rows returns the in-row indices beside the keys on request.
PORT_ONLY = {"sort_rows": ("return_indices",)}


def _same_call_shape(port_fn, ref_fn):
    """The reference's parameters, plus at most a keyword-only ``device``
    at the end and the port's own keyword-only parameters of
    :data:`PORT_ONLY`, each defaulting to what the reference does."""
    got, want = _call_shape(port_fn), _call_shape(ref_fn)
    if got and got[-1][:2] == ("device", inspect.Parameter.KEYWORD_ONLY):
        got = got[:-1]
    extra = PORT_ONLY.get(port_fn.__name__, ())
    got = [p for p in got if not (
        p[0] in extra and p[1] == inspect.Parameter.KEYWORD_ONLY
        and p[2] is False)]
    return got == want


@pytest.mark.parametrize("name", sorted(sortx.__all__))
def test_top_level_surface(name):
    """Every top-level name of sortx exists in sortx_torch, with the
    reference's signature. ``Config`` is the one exception: its fields
    are the port's own (sortx_torch/config.py)."""
    assert name in sortx_torch.__all__ and hasattr(sortx_torch, name)
    ref, port = getattr(sortx, name), getattr(sortx_torch, name)
    if name == "Config" or not callable(ref):
        return
    assert _same_call_shape(port, ref), (inspect.signature(port),
                                         inspect.signature(ref))
    if name == "ParallelPrimitives":
        for meth in ("radix_sort", "radix_sort_kv", "scan"):
            assert _same_call_shape(getattr(port, meth), getattr(ref, meth))


@pytest.mark.parametrize("name", sorted(sortx.runtime.__all__))
def test_runtime_surface(name):
    """sortx.runtime's names exist in sortx_torch.runtime; its functions
    keep the reference's signatures (warmup adds ``device``)."""
    ref, port = getattr(sortx.runtime, name), getattr(sortx_torch.runtime,
                                                      name)
    if inspect.isfunction(ref):
        assert _same_call_shape(port, ref), (inspect.signature(port),
                                             inspect.signature(ref))


@pytest.mark.parametrize("name", sorted(sortx.parallel.__all__))
def test_parallel_surface(name):
    """sortx.parallel's names exist in sortx_torch.parallel, its functions
    with the reference's signatures (init_multihost adds ``device``), its
    constants equal."""
    assert name in sortx_torch.parallel.__all__
    ref, port = getattr(sortx.parallel, name), getattr(sortx_torch.parallel,
                                                       name)
    if callable(ref):
        assert _same_call_shape(port, ref), (inspect.signature(port),
                                             inspect.signature(ref))
    else:
        assert port == ref


def test_ops_surface():
    for name in ("sort_large", "sort_kv_large", "check_device_capacity",
                 "device_capacity_keys", "sort_xla", "sort_kv_xla"):
        assert name in sortx_torch.ops.__all__
        assert hasattr(sortx.ops, name)
    for name in ("sort_large", "sort_kv_large", "check_device_capacity",
                 "device_capacity_keys"):
        assert _same_call_shape(getattr(sortx_torch.ops, name),
                                getattr(sortx.ops, name)), name
    assert sortx_torch.__version__ == sortx.__version__
