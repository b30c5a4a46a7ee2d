"""The port's runtime layer and ``ParallelPrimitives`` facade.

The counterpart of each case of ``tests/test_runtime.py`` on a CPU
``SortxDevice`` (``DeviceConfig(platform="cpu")``), and the facade held
against ``sortx.ParallelPrimitives`` on JAX-CPU, bit for bit, on the
same inputs.
"""

import collections
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sortx
import sortx_torch
from sortx_torch.convert import to_numpy, to_torch
from sortx_torch.ops import bitonic as tb
from sortx_torch.runtime import (Buffer, DeviceConfig, Launcher,
                                 MirroredArray, MirrorState, Stopwatch,
                                 SyncObject, allocate_device,
                                 capture_next_op, device_count, profiler,
                                 replay, replay_op, toggle_profiling)

CPU = DeviceConfig(platform="cpu")


@pytest.fixture
def dev():
    d = allocate_device(CPU)
    yield d
    d.check_leaks()


@pytest.fixture
def csv(tmp_path):
    """Profiling on into a fresh CSV; off (at op level) afterwards."""
    path = tmp_path / "prof.csv"
    toggle_profiling(True, str(path))
    yield path
    toggle_profiling(False, level="op")


def _rows(path):
    return path.read_text().splitlines() if path.exists() else []


def _u32(rng, n):
    return rng.randint(0, 2**32, size=n, dtype=np.uint32)


def test_device_allocate_and_introspect(dev):
    assert dev.n_cores >= 1
    assert dev.platform == "cpu" and dev.name == "cpu"
    assert device_count("cpu") == 1
    assert dev.memory_stats() == {} and dev.hbm_bytes is None
    dev.wait_for_completion()


def test_auto_device_is_the_card(monkeypatch):
    """"auto" is the GPU; without one it raises (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_count() == 0
    for cfg in (None, DeviceConfig(platform="gpu")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            allocate_device(cfg)
    with pytest.raises(IndexError):
        allocate_device(DeviceConfig(platform="cpu", device_idx=1))
    with pytest.raises(ValueError):
        allocate_device(DeviceConfig(platform="tpu"))


def test_buffer_roundtrip(rng, dev):
    buf = Buffer(dev, np.uint32, 1024)
    assert buf.dtype == torch.uint32 and buf.array.device.type == "cpu"
    host = _u32(rng, 1024)
    buf.write(host)
    np.testing.assert_array_equal(buf.read(), host)
    assert dev.memory_usage == 1024 * 4 and buf.nbytes == 4096
    np.testing.assert_array_equal(buf.read(10), host[:10])
    buf.write(host[::-1], 100)            # the first 100 only
    np.testing.assert_array_equal(buf.read(), np.concatenate(
        [host[::-1][:100], host[100:]]))
    with pytest.raises(ValueError):
        buf.write(np.zeros(2000, np.uint32))
    buf.destroy()


def test_buffer_nonblocking_write_on_the_cpu(rng, dev):
    buf = Buffer(dev, torch.float32, 64)
    host = rng.randn(64).astype(np.float32)
    sync = buf.write(host, blocking=False)
    assert isinstance(sync, SyncObject) and sync.is_complete
    sync.wait()
    np.testing.assert_array_equal(buf.read(), host)
    assert torch.equal(buf.read(blocking=False), torch.from_numpy(host))
    buf.destroy()


def test_buffer_fill_clear_and_resize(dev):
    buf = Buffer(dev, np.int32, 256)
    buf.fill(7)
    assert np.all(buf.read() == 7)
    buf.clear()
    assert np.all(buf.read() == 0)
    buf.fill(-3)
    buf.set_size(512)  # set_size zeroes, does NOT preserve contents
    assert buf.size == 512 and np.all(buf.read() == 0)
    assert dev.memory_usage == 512 * 4
    u = Buffer(dev, np.uint32, 8)
    u.fill(0xFFFFFFFE)
    np.testing.assert_array_equal(u.read(), np.full(8, 0xFFFFFFFE,
                                                    np.uint32))
    f = Buffer(dev, np.float32, 8)
    f.fill(-0.0)
    assert np.all(f.read().view(np.uint32) == 0x80000000)
    for b in (buf, u, f):
        b.destroy()


def test_buffer_device_to_device_copy(rng, dev):
    a, b = Buffer(dev, np.uint32, 128), Buffer(dev, np.uint32, 128)
    host = _u32(rng, 128)
    a.write(host)
    b.write_buffer(a)
    np.testing.assert_array_equal(b.read(), host)
    c = Buffer(dev, np.uint32, 256)
    c.write_buffer(a, 100)
    np.testing.assert_array_equal(c.read()[:100], host[:100])
    assert np.all(c.read()[100:] == 0)
    for x in (a, b, c):
        x.destroy()


def test_buffer_leak_detected():
    d = allocate_device(CPU)
    buf = Buffer(d, np.uint32, 64)
    with pytest.raises(RuntimeError, match="leak"):
        d.check_leaks()
    buf.destroy()
    d.check_leaks()


def test_buffer_map_semantics(dev):
    buf = Buffer(dev, np.uint32, 64)
    host = buf.get_host_ptr()
    host[:] = np.arange(64, dtype=np.uint32)
    buf.return_host_ptr(host)
    np.testing.assert_array_equal(buf.read(), np.arange(64, dtype=np.uint32))
    with pytest.raises(ValueError):
        buf.array = torch.zeros(64, dtype=torch.int32)
    buf.destroy()


def test_mirrored_array_coherence():
    arr = MirroredArray(np.int32, 128, device="cpu")
    assert arr.state == MirrorState.CPU_DIRTY
    arr[0:4] = [1, 2, 3, 4]
    dev_arr = arr.device_view()  # sync to device
    assert arr.state == MirrorState.CLEAN
    assert isinstance(dev_arr, torch.Tensor) and dev_arr[3] == 4
    arr.set_device_result(dev_arr * 2)
    assert arr.state == MirrorState.GPU_DIRTY
    assert arr[1] == 4  # pulls back from device
    assert arr.state == MirrorState.CLEAN
    arr.prepare_access_gpu()[0] = 9
    assert arr.state == MirrorState.GPU_DIRTY
    assert arr.prepare_access_cpu()[0] == 9
    arr.set_size(256)   # grows preserving contents
    assert arr[1] == 4 and arr.size == 256
    with pytest.raises(ValueError):
        arr.set_device_result(torch.zeros(256, dtype=torch.int64))
    assert MirroredArray(np.uint32).state == MirrorState.UNINITIALIZED


def test_stopwatch_splits():
    sw = Stopwatch()
    sw.start()
    x = torch.arange(1024) * 2
    sw.split(x)
    sw.stop()
    assert sw.get_ms() >= 0 and sw.n_splits == 3
    assert len(sw.split_times_ms()) == 2


def test_launcher_profiling_csv(rng, csv):
    launch = Launcher(lambda k: sortx_torch.sort(k), "sort_u32")
    launch(to_torch(_u32(rng, 1024)))
    rows = _rows(csv)
    # the wrapper's row plus the library's own op row
    assert sum(r.startswith("sort_u32,") for r in rows) == 1
    assert any(r.startswith("sort,") for r in rows)


def test_launcher_capture_replay(tmp_path, rng):
    """serializeToFile / deserializeFromFile round trip."""
    path = str(tmp_path / "launch.npz")
    launch = Launcher(lambda k, b: sortx_torch.sort(k, b), "sort_u32",
                      static_config={"sort_bits": 32})
    keys = to_torch(_u32(rng, 2048))
    out1 = launch.capture(path, keys, 20)
    out2 = replay(path, {"sort_u32": launch.fn})
    assert out2.dtype == torch.uint32
    np.testing.assert_array_equal(to_numpy(out1), to_numpy(out2))


def test_log_writer(tmp_path):
    from sortx_torch.utils.log import Channel, LogWriter
    lw = LogWriter(str(tmp_path / "t.log"), Channel.ERROR)
    lw.write(Channel.ERROR, "boom")
    lw.write(Channel.DEBUG, "hidden")  # filtered by channel mask
    lw.close()
    content = (tmp_path / "t.log").read_text()
    assert "boom" in content and "hidden" not in content
    assert "[ERROR]" in content


def _pp_pair(dev):
    from sortx.runtime import Buffer as RefBuffer
    from sortx.runtime import allocate_device as ref_device

    rdev = ref_device()
    return (sortx.ParallelPrimitives(rdev), rdev,
            lambda dt, n: RefBuffer(rdev, dt, n),
            sortx_torch.ParallelPrimitives(dev),
            lambda dt, n: Buffer(dev, dt, n))


@pytest.mark.parametrize("n", [None, 700])
def test_parallel_primitives_facade(rng, dev, n):
    """Pprims-shaped facade, in-place buffer semantics, against
    sortx.ParallelPrimitives: the same buffers and totals, bit for bit;
    with n short of the buffer the tail stays as it was."""
    rpp, rdev, rbuf, pp, buf = _pp_pair(dev)
    size = 1024
    keys = (rng.randint(0, 64, size=size) * 0x10204081).astype(np.uint32)
    vals = _u32(rng, size)
    words = rng.randint(0, 2**32, size=size, dtype=np.uint32)
    pairs = []

    def both(dt, host):
        r, p = rbuf(dt, size), buf(dt, size)
        r.write(host)
        p.write(host)
        pairs.append((r, p))
        return r, p

    rk, pk = both(jnp.uint32, keys)
    rpp.radix_sort(rk, n)
    pp.radix_sort(pk, n)
    rk2, pk2 = both(jnp.uint32, keys)
    rv, pv = both(jnp.uint32, vals)
    rpp.radix_sort_kv(rk2, rv, n)
    pp.radix_sort_kv(pk2, pv, n)
    rp, pp_ = both(jnp.uint32, keys)
    rpp.radix_sort(rp, n, 12)
    pp.radix_sort(pp_, n, 12)
    for dt in (jnp.int32, jnp.uint32):
        rs, ps = both(dt, words.view(dt))
        rd, pd = both(dt, np.full(size, 5, dt))
        want = rpp.scan(rd, rs, n, with_total=True)
        got = pp.scan(pd, ps, n, with_total=True)
        assert got.dim() == 0
        assert got.dtype == (torch.uint32 if dt == jnp.uint32
                             else torch.int32)
        assert np.asarray(want).dtype == to_numpy(got).dtype
        assert to_numpy(got) == np.asarray(want)
        assert pp.scan(pd, ps, n) is None
    for r, p in pairs:
        np.testing.assert_array_equal(p.read(), r.read())
        r.destroy()
        p.destroy()
    rdev.check_leaks()


def test_facade_short_n_leaves_the_tail(rng, dev):
    pp = sortx_torch.ParallelPrimitives(dev)
    keys = _u32(rng, 512)
    b = Buffer(dev, np.uint32, 512)
    b.write(keys)
    pp.radix_sort(b, 300)
    out = b.read()
    np.testing.assert_array_equal(out[:300], np.sort(keys[:300]))
    np.testing.assert_array_equal(out[300:], keys[300:])
    b.destroy()


def test_facade_defaults(dev, monkeypatch):
    cfg = sortx_torch.Config(engine="host")
    assert sortx_torch.ParallelPrimitives(dev, cfg).config is cfg
    assert (sortx_torch.ParallelPrimitives(dev).config
            is sortx_torch.default_config())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sortx_torch.ParallelPrimitives()


def test_default_config(monkeypatch):
    old = sortx_torch.default_config()
    cfg = sortx_torch.Config(engine="host")
    try:
        sortx_torch.set_default_config(cfg)
        assert sortx_torch.default_config() is cfg
    finally:
        sortx_torch.set_default_config(old)
    assert sortx_torch.default_config() is old


@pytest.mark.parametrize("env, engine", [("pallas", "network"),
                                         ("network", "network"),
                                         ("hybrid", "hybrid"),
                                         ("host", "host"), (None, "auto")])
def test_default_engine_from_the_environment(env, engine):
    """SORTX_ENGINE takes the reference's names too: pallas is the
    network."""
    environ = dict(os.environ)
    environ.pop("SORTX_ENGINE", None)
    if env:
        environ["SORTX_ENGINE"] = env
    code = ("import sortx_torch; "
            "print(sortx_torch.default_config().engine)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=environ, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             sortx_torch.__file__)))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == engine


def test_profiler_trace(tmp_path):
    with profiler.trace(str(tmp_path / "tr")) as d:
        with profiler.annotate("op"):
            torch.arange(128).sum()
    files = list((tmp_path / "tr").iterdir())
    assert d == str(tmp_path / "tr") and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "op" for e in events)
    with pytest.raises(RuntimeError):
        profiler.stop_trace()


def test_warmup_on_the_cpu(monkeypatch):
    from sortx_torch.runtime import warmup
    warmup(sizes=(1024, 3000), kv=True, scan_too=True, device="cpu")
    warmup(sizes=(2048,), config=sortx_torch.Config(engine="network"),
           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        warmup()


def test_enable_cache_moves_both_build_dirs(monkeypatch, tmp_path):
    from sortx_torch.ops import _build
    from sortx_torch.runtime import enable_cache, native

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    d = str(tmp_path / "cache")
    assert enable_cache(d) == d and os.path.isdir(d)
    assert str(_build.BUILD_DIR) == d and str(native.BUILD_DIR) == d


def test_library_ops_emit_profile_rows(rng, csv):
    """A plain library call emits a row per op when profiling is on."""
    keys = to_torch(_u32(rng, 4096))
    vals = torch.arange(4096, dtype=torch.int32)
    xs = to_torch(rng.randint(0, 50, size=4096).astype(np.int32))
    sortx_torch.sort(keys)
    sortx_torch.sort_kv(keys, vals)
    sortx_torch.scan(xs)
    a, b = (sortx_torch.sort(keys[:2048]), sortx_torch.sort(keys[2048:]))
    sortx_torch.merge(a, b)
    rows = _rows(csv)
    for op in ("sort,", "sort_kv,", "scan,", "merge,"):
        assert any(r.startswith(op) for r in rows), (op, rows)
    name, ms, shapes = rows[0].split(",", 2)
    assert float(ms) >= 0.0 and "torch.uint32" in shapes
    assert not any(r.startswith("bitonic") for r in rows)   # op level


def test_profiling_kernel_level_rows_network_passes(rng, csv):
    """level="kernel": each kernel wrapper call of the network (its plain
    version on the CPU) emits one row, named as the kernel."""
    toggle_profiling(True, level="kernel")
    n = (1 << 16) + 13
    keys = _u32(rng, n)
    out = sortx_torch.sort(to_torch(keys),
                           config=sortx_torch.Config(engine="network"))
    np.testing.assert_array_equal(to_numpy(out), np.sort(keys))
    rows = collections.Counter(r.split(",")[0] for r in _rows(csv))
    plan = collections.Counter(name for name, _ in tb.pass_plan(
        1, 1 << 17, 1, n))
    assert set(plan) == {"bitonic_block", "bitonic_tail", "bitonic_global"}
    for name, count in plan.items():
        assert rows[name] == count
    assert rows["sort"] == 1
    xs = to_torch(rng.randint(0, 50, size=5000).astype(np.int32))
    sortx_torch.scan(xs, config=sortx_torch.Config(engine="network"))
    assert collections.Counter(
        r.split(",")[0] for r in _rows(csv))["scan"] == 2   # op + kernel


@pytest.mark.parametrize("level", ["op", "step", "kernel"])
def test_profiling_step_rows_by_level(csv, level):
    """A named step (runtime.launcher.profiled_step) adds its row at
    level "step" and "kernel", and none at level "op"."""
    from sortx_torch.runtime.launcher import profiled_step

    toggle_profiling(True, level=level)
    with profiled_step("op/a step", torch.device("cpu")):
        pass
    rows = [r.split(",")[0] for r in _rows(csv)]
    assert rows == ([] if level == "op" else ["op/a step"])


def test_capture_next_op_and_replay_op(tmp_path, rng):
    """The library's own ops register for capture / replay: arm a one-shot
    capture, call a plain public op, replay from the file by name."""
    path = str(tmp_path / "cap.npz")
    keys = to_torch(_u32(rng, 4096))
    capture_next_op(path)
    out1 = sortx_torch.sort(keys, 16)
    assert os.path.exists(path)
    out2 = replay_op(path)
    np.testing.assert_array_equal(to_numpy(out1), to_numpy(out2))
    # one-shot: the next call does not overwrite the capture
    mtime = os.path.getmtime(path)
    sortx_torch.sort(keys)
    assert os.path.getmtime(path) == mtime

    # kwargs with a Config dataclass round trip
    path2 = str(tmp_path / "cap2.npz")
    cfg = sortx_torch.Config(engine="network")
    vals = torch.arange(4096, dtype=torch.int32)
    capture_next_op(path2, match="sort_kv")
    ks1, vs1 = sortx_torch.sort_kv(keys, vals, config=cfg)
    ks2, vs2 = replay_op(path2)
    np.testing.assert_array_equal(to_numpy(ks1), to_numpy(ks2))
    np.testing.assert_array_equal(to_numpy(vs1), to_numpy(vs2))
    # a numpy-in op replays with numpy
    path3 = str(tmp_path / "cap3.npz")
    capture_next_op(path3)
    big = _u32(rng, 5000)
    got = sortx_torch.sort_large(big, chunk_elems=2048, device="cpu")
    np.testing.assert_array_equal(replay_op(path3), got)


def test_capture_match_filter_skips_nonmatching(tmp_path, rng):
    path = str(tmp_path / "cap.npz")
    keys = to_torch(_u32(rng, 2048))
    capture_next_op(path, match="scan")
    sortx_torch.sort(keys)                       # filtered out
    assert not os.path.exists(path)
    sortx_torch.scan(torch.arange(2048, dtype=torch.int32))
    assert os.path.exists(path)


def test_capture_array_kwarg_replays(tmp_path, rng):
    """Tensor keyword arguments survive the capture / replay round
    trip."""
    path = str(tmp_path / "cap.npz")
    keys = to_torch(_u32(rng, 2048))
    vals = torch.arange(2048, dtype=torch.int32)
    capture_next_op(path)
    ks1, vs1 = sortx_torch.sort_kv(keys, values=vals)
    ks2, vs2 = replay_op(path)
    np.testing.assert_array_equal(to_numpy(ks1), to_numpy(ks2))
    np.testing.assert_array_equal(to_numpy(vs1), to_numpy(vs2))


def test_capture_unserializable_arg_skips_not_crashes(tmp_path, rng):
    """An armed capture never fails the user's op: lexsort's list of
    tensors is not capturable, so the capture is skipped."""
    path = str(tmp_path / "cap.npz")
    a = to_torch(rng.randint(0, 16, size=1024).astype(np.uint32))
    b = to_torch(rng.randint(0, 16, size=1024).astype(np.uint32))
    capture_next_op(path)
    out = sortx_torch.lexsort([a, b])
    assert out.shape == (1024,)
    assert not os.path.exists(path)
