"""The port's spans on the profiler's clock and the distributed sort's
event-timed steps (``runtime/launcher.py:span``, ``profiled_step``,
``runtime/profiler.py:step_ms``), and the benchmark's readers of them
(``portbench/metrics/*_host_ms.short.py``, ``dist_*_dev_ms.py``).

The CPU tests run the network engine on CPU tensors (the kernels' plain
versions, so no launch spans). The tests marked ``cuda`` need a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_spans.py
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sortx_torch
from sortx_torch.ops import _build
from sortx_torch.runtime import launcher, profiler

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import cell, spec, tracing  # noqa: E402

pbhelp = spec.load_module(REPO / "portbench" / "tests" / "pbhelp.py")
NETWORK = sortx_torch.Config(engine="network")
CPU = torch.autograd.DeviceType.CPU


def _reader(name: str):
    return spec.load_module(REPO / "portbench" / "metrics" / f"{name}.py")


def _keys(n: int, device="cpu", seed: int = 0) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    words = rng.randint(-2**31, 2**31, size=n).astype(np.int32)
    return torch.from_numpy(words).to(device).view(torch.uint32)


def _port_spans(prof) -> list:
    """(name, start_ns, end_ns) of the port's spans on the host."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("sortx_torch.") and e.device_type() == CPU]


def _sort(keys):
    return sortx_torch.sort(keys, config=NETWORK)


def _sort_kv(keys):
    vals = torch.arange(keys.shape[0], dtype=torch.int32)
    return sortx_torch.sort_kv(keys, vals, config=NETWORK)


@pytest.fixture
def counted(monkeypatch):
    """Every profiler range opened (the spans' own, ``record_function``),
    counted by name."""
    opened = collections.Counter()

    def counting(real):
        def make(name, *args, **kw):
            opened[name] += 1
            return real(name, *args, **kw)
        return make

    monkeypatch.setattr(launcher, "_range", counting(launcher._range))
    rf = counting(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", rf)
    return opened


@pytest.mark.parametrize("run", [_sort, _sort_kv])
def test_no_range_opens_without_a_profiler(counted, run):
    keys = _keys(3000)
    run(keys)
    assert not launcher.tracing() and sum(counted.values()) == 0
    with profile(activities=[ProfilerActivity.CPU]):
        run(keys)
    assert counted["sortx_torch.engine.network"] == 1
    assert counted["sortx_torch.driver.bitonic"] == 1


@pytest.mark.parametrize("run, op", [(_sort, "sort"), (_sort_kv, "sort_kv")])
def test_spans_nest_api_engine_driver(run, op):
    keys = _keys(5000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run(keys)
    spans = _port_spans(prof)
    assert sorted(name for name, *_ in spans) == [
        f"sortx_torch.api.{op}", "sortx_torch.driver.bitonic",
        "sortx_torch.engine.network"]
    (api,) = [s for s in spans if s[0] == f"sortx_torch.api.{op}"]
    (eng,) = [s for s in spans if s[0] == "sortx_torch.engine.network"]
    (drv,) = [s for s in spans if s[0] == "sortx_torch.driver.bitonic"]
    assert api[1] <= eng[1] < drv[1] < drv[2] <= eng[2] <= api[2]
    # the spans leave the result as it was
    again = run(keys)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    again if isinstance(again, tuple) else (again,)):
        assert torch.equal(a, b)


@launcher.profiled("spans_demo_inner")
def _inner(x):
    return x + 1


@launcher.profiled("spans_demo")
def _demo(x):
    with launcher.profiled_step("demo/first", x.device):
        x = x * 2
    x = _inner(x)                  # a nested op: still the same call
    for _ in range(2):
        with launcher.profiled_step("demo/second", x.device):
            x = x - 1
    return x


def test_steps_are_kept_per_call_only_under_a_profiler():
    profiler.step_ms(clear=True)
    x = torch.arange(64)
    _demo(x)
    assert profiler.step_ms() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _demo(x)
        _demo(x)
    calls = profiler.step_ms()
    assert [sorted(c) for c in calls] == [["demo/first", "demo/second"]] * 2
    assert all(ms >= 0.0 for c in calls for ms in c.values())
    names = [name for name, *_ in _port_spans(prof)]
    assert names.count("sortx_torch.api.spans_demo") == 2
    assert names.count("sortx_torch.api.spans_demo_inner") == 2
    assert names.count("sortx_torch.dist.first") == 2
    assert names.count("sortx_torch.dist.second") == 4
    assert len(profiler.step_ms(clear=True)) == 2
    assert profiler.step_ms() == []


def test_the_step_store_keeps_only_the_last_calls():
    profiler.step_ms(clear=True)
    x = torch.arange(4)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(launcher.STEP_CALLS_KEPT + 3):
            _demo(x)
    assert len(profiler.step_ms(clear=True)) == launcher.STEP_CALLS_KEPT


def test_step_rows_and_events_together(tmp_path):
    """The synchronised rows at level="step" are written as before while
    the profiler also keeps the steps."""
    csv = tmp_path / "rows.csv"
    profiler.step_ms(clear=True)
    launcher.toggle_profiling(True, str(csv), level="step")
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            _demo(torch.arange(8))
    finally:
        launcher.toggle_profiling(False, level="op")
    rows = [r.split(",")[0] for r in csv.read_text().splitlines()]
    assert rows.count("demo/second") == 2 and "spans_demo" in rows
    assert len(profiler.step_ms(clear=True)) == 1


# --- the readers, on hand-made slices --------------------------------------

def _reading(sl):
    return cell.Reading(sl, [], {}, 0, 0, 0)


def _three(sl):
    return [_reader(f"{m}_host_ms.short").read(_reading(sl))
            for m in ("api", "driver", "launch")]


NESTED = [  # one call: api > engine > driver > three launches
    (100, 900, "sortx_torch.api.sort"),
    (150, 850, "sortx_torch.engine.network"),
    (160, 190, "aten::full"),                 # not the port's: not read
    (200, 800, "sortx_torch.driver.bitonic"),
    (250, 300, "sortx_torch.launch.bitonic_block"),
    (400, 450, "sortx_torch.launch.bitonic_global"),
    (500, 560, "sortx_torch.launch.bitonic_tail"),
    (520, 530, "cudaLaunchKernel"),
]
# two engine spans that overlap, a driver span inside both
OVERLAP = [(0, 100, "sortx_torch.api.sort"),
           (10, 60, "sortx_torch.engine.network"),
           (40, 90, "sortx_torch.engine.network"),
           (50, 70, "sortx_torch.driver.bitonic")]
# window 100..200: an api span and launches that cross its edges
CLIPPED = [(50, 250, "sortx_torch.api.sort"),
           (90, 110, "sortx_torch.launch.bitonic_block"),
           (190, 260, "sortx_torch.launch.bitonic_tail"),
           (300, 400, "sortx_torch.api.sort")]


@pytest.mark.parametrize("t0, t1, host, calls, want", [
    (0, 1000, NESTED, 2, [200e-6 / 2, 440e-6 / 2, 160e-6 / 2]),
    (0, 100, OVERLAP, 1, [80e-6, 20e-6, 0.0]),
    (100, 200, CLIPPED, 1, [80e-6, 0.0, 20e-6]),
], ids=["nested", "overlapping", "clipped"])
def test_span_readers_split_the_api_time_by_innermost_span(t0, t1, host,
                                                           calls, want):
    sl = tracing.Slice(t0, t1, [], host, calls)
    got = _three(sl)
    assert got == pytest.approx(want, abs=1e-12)
    api = [(max(s, t0), min(e, t1)) for s, e, name in host
           if name.startswith("sortx_torch.api.") and min(e, t1) > max(s, t0)]
    assert sum(got) == pytest.approx(
        sum(b - a for a, b in api) / 1e6 / calls)


def test_span_readers_read_nothing_without_the_ports_spans():
    plain = tracing.Slice(0, 100, [], [(0, 50, "aten::sort")], 1)
    assert _three(plain) == [None, None, None]
    assert _three(None) == [None, None, None]


def test_span_readers_on_a_traced_cpu_slice():
    """On real spans: the three readers add up to the mean api span."""
    keys = _keys(4096)
    _sort(keys)
    sl = tracing.record(lambda: _sort(keys), 3, warm=1)
    api = [e - s for s, e, name in sl.host if name == "sortx_torch.api.sort"]
    assert len(api) == 3
    got = _three(sl)
    assert got[0] > 0 and got[1] > 0 and got[2] == 0.0
    assert sum(got) == pytest.approx(sum(api) / 1e6 / 3, rel=1e-2)


def test_short_cell_traced_on_the_cpu_reports_the_span_metrics(tmp_path,
                                                               monkeypatch):
    monkeypatch.setenv("SORTX_ENGINE", "network")
    root = pbhelp.small_root(tmp_path)
    job = pbhelp.job(root, "sort_u32.short_2e20", trace=1)
    p = subprocess.run([sys.executable, str(REPO / "portbench" / "run.py"),
                        "--rank-job", json.dumps(job)], capture_output=True,
                       text=True, timeout=240, cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["api_host_ms.short"] > 0 and m["driver_host_ms.short"] > 0
    assert m["launch_host_ms.short"] == 0.0          # no launches on the CPU


def test_dist_dev_readers_read_the_steps_on_gloo_ranks(tmp_path, monkeypatch,
                                                       capfd):
    monkeypatch.setenv("SORTX_ENGINE", "network")
    root = pbhelp.small_root(tmp_path)
    r = pbhelp.run_ranks(root, "dist_sort_u32.uniform_4x2e27", capfd,
                         trace=1)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == {"dist_merge_ms", "dist_exchange_ms",
                      "dist_merge_dev_ms", "dist_exchange_dev_ms"}
    assert m["dist_merge_dev_ms"] > 0 and m["dist_exchange_dev_ms"] > 0


def test_dist_dev_readers_without_steps_read_nothing():
    profiler.step_ms(clear=True)
    for name in ("dist_merge_dev_ms", "dist_exchange_dev_ms"):
        assert _reader(name).read(_reading(None)) is None


# --- on a card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 20, (1 << 16) + 13])
def test_launch_spans_count_the_launches(dev, n):
    keys = _keys(n, dev)
    sortx_torch.sort(keys)
    torch.cuda.synchronize()
    _build.launches.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sortx_torch.sort(keys)
        torch.cuda.synchronize()
    spans = collections.Counter(
        name.removeprefix("sortx_torch.launch.")
        for name, *_ in _port_spans(prof)
        if name.startswith("sortx_torch.launch."))
    assert spans == _build.launches and sum(spans.values()) > 0


@pytest.mark.cuda
def test_a_traced_capture_keeps_no_steps_and_replays(dev):
    static = _keys(1 << 18, dev)

    @launcher.profiled("spans_demo_capture")
    def run(k):
        with launcher.profiled_step("demo/sort", k.device):
            return sortx_torch.sort(k)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(static)
    torch.cuda.current_stream().wait_stream(side)
    profiler.step_ms(clear=True)
    graph = torch.cuda.CUDAGraph()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.cuda.graph(graph):
            out = run(static)
    assert profiler.step_ms() == []
    for seed in (1, 2):
        keys = _keys(1 << 18, dev, seed)
        static.copy_(keys)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, sortx_torch.sort(keys))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run(static)
    (step,) = profiler.step_ms(clear=True)
    assert list(step) == ["demo/sort"] and step["demo/sort"] > 0


@pytest.mark.cuda
def test_span_off_cost(dev):
    """Prints the cost of one span with no profiler running."""
    import timeit

    def one():
        with launcher.span("launch", "x"):
            pass

    def bare():
        pass

    n = 200_000
    cost = (min(timeit.repeat(one, number=n, repeat=5))
            - min(timeit.repeat(bare, number=n, repeat=5))) / n
    print(f"span off-cost: {cost * 1e6:.3f} us a span "
          f"({torch.cuda.get_device_name(dev)} host)")
    assert cost < 5e-6
