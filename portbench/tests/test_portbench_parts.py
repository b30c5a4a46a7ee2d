"""The benchmark's parts on the CPU: every file found by its name, the
arithmetic of its metrics on synthetic events, the key generator, and
the checks that nothing it runs imports jax or sortx.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import ast
import json
import re
import statistics
import subprocess
import sys

import pytest
import torch

import pbhelp
from portbench import cell, keygen, peaks, spec, stats, tracing

BENCH = json.loads((pbhelp.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS)
def test_every_part_of_a_cell_loads_by_name(workload):
    c = spec.load_cell(workload)
    op = c.module("ops", c.config["op"])
    ref = c.module("reference", c.config["op"])
    assert callable(op.call) and callable(op.control) and op.BYTES_PER_KEY
    assert ref.OUTPUTS and callable(ref.expected)
    assert c.traffic["keys_per_card"] > 0 and c.traffic["pool"] > 0
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end:
        assert callable(c.module("end_to_end", m["name"]).read)
    for m in c.per_layer:
        assert callable(c.module("metrics", m["name"]).read)


def test_benchmark_json_keeps_to_its_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (pbhelp.REPO / c["file"]).is_file()
        assert json.loads((pbhelp.REPO / c["file"]).read_text())["name"] \
            == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    layers = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in layers and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_union_and_idle_share_on_synthetic_spans():
    # window 0..100; busy 10..30 and 20..40 (overlap) and 60..70
    sl = tracing.Slice(0, 100, [(10, 30, "kernel", "a"),
                                (20, 40, "gpu_memcpy", "b"),
                                (60, 70, "kernel", "a")], [], 2)
    assert tracing.union(sl.device) == (40, [(40, 60)])
    assert tracing.busy_ns(sl) == 40
    assert tracing.idle_share(sl) == pytest.approx(60.0)
    assert tracing.activity_s(sl) == pytest.approx(50e-9)
    assert tracing.device_ops(sl) == [["a", pytest.approx(30e-9)],
                                      ["b", pytest.approx(20e-9)]]
    assert tracing.idle_share(tracing.Slice(0, 1, [], [], 1)) is None


def test_idle_gaps_are_named_by_what_the_host_was_in():
    sl = tracing.Slice(0, 100, [(10, 30, "kernel", "k"),
                                (60, 70, "kernel", "k")],
                       [(35, 58, "cudaDeviceSynchronize"),
                        (0, 100, "aten::sort")], 1)
    gaps = dict(map(tuple, tracing.idle_gaps(sl)))
    assert gaps == {"aten::sort": pytest.approx(40e-9),     # 0..10, 70..100
                    "aten::sort > cudaDeviceSynchronize":
                        pytest.approx(30e-9)}


def test_from_events_clips_to_the_annotation():
    ev = [(tracing.ANNOTATION, "user_annotation", 100, 50),
          ("bitonic", "kernel", 90, 20), ("bitonic", "kernel", 140, 30),
          ("Memset (Device)", "gpu_memset", 120, 5),
          ("Context Sync", "cuda_sync", 100, 50),
          (tracing.ANNOTATION, "gpu_user_annotation", 100, 50),
          ("cudaLaunchKernel", "cuda_runtime", 101, 2)]
    sl = tracing.from_events(ev, calls=3)
    assert (sl.t0, sl.t1, sl.calls) == (100, 150, 3)
    assert sorted(sl.device) == [(100, 110, "kernel", "bitonic"),
                                 (120, 125, "gpu_memset", "Memset (Device)"),
                                 (140, 150, "kernel", "bitonic")]
    assert sl.host == [(101, 103, "cudaLaunchKernel")]
    assert tracing.from_events(ev[1:4], 1) is None


class _Event:
    """A kineto event as a torch without ``activity_type`` gives it."""

    def __init__(self, name, cuda, start, dur):
        self._n, self._cuda, self._s, self._d = name, cuda, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_events_are_classified_without_activity_types():
    ev = tracing.classify([
        _Event(tracing.ANNOTATION, False, 0, 100),
        _Event(tracing.ANNOTATION, True, 0, 100),
        _Event("nccl:all_to_all", False, 10, 5),
        _Event("nccl:all_to_all", True, 12, 8),
        _Event("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
               True, 12, 8),
        _Event("Memcpy DtoD (Device -> Device)", True, 30, 4),
        _Event("Memset (Device)", True, 40, 1),
        _Event("Context Sync", True, 50, 20)])
    assert [k for _, k, *_ in ev] == [
        "user_annotation", "gpu_user_annotation", "cpu_op",
        "gpu_user_annotation", "kernel", "gpu_memcpy", "gpu_memset",
        "cuda_sync"]
    sl = tracing.from_events(ev, 1)
    assert [d[2] for d in sl.device] == ["kernel", "gpu_memcpy", "gpu_memset"]


def test_kernel_names_lose_templates_and_namespaces():
    k = tracing.kernel_name
    assert k("void (anonymous namespace)::bitonic_global_kernel<1, 1, 4>("
             "unsigned int*, int const*, long long") == "bitonic_global_kernel"
    assert k("void at::native::vectorized_elementwise_kernel<4, at::native::"
             "FillFunctor<int>, std::array<char*, 1u") == \
        "vectorized_elementwise_kernel"
    assert k("(anonymous namespace)::reverse_kernel(int const*, int*, "
             "long long)") == "reverse_kernel"
    assert k("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD (Device -> Device)"


def test_roofline_share_reads_least_time_over_activity():
    reader = spec.load_module(pbhelp.REPO / "portbench/metrics/"
                              "roofline_share.py")
    n = 1 << 27
    # two calls, each with 10 ms of device activity
    sl = tracing.Slice(0, 30_000_000, [(0, 10_000_000, "kernel", "k"),
                                       (15_000_000, 25_000_000, "kernel",
                                        "k")], [], 2)
    r = cell.Reading(sl, [], {}, 0, n, 8)
    least = n * 8 / peaks.HBM_BYTES_PER_S
    assert reader.read(r) == pytest.approx(100 * least / 0.010)
    assert reader.read(cell.Reading(None, [], {}, 0, n, 8)) is None
    assert peaks.least_seconds(3.35e12) == (1.0, "bytes")
    assert peaks.least_seconds(0, 67e12 / 4) == (1.0, "operations")


def test_p95_is_of_all_calls_and_the_spread_uses_python_quartiles():
    lat = list(range(1, 101))                 # 1..100
    assert stats.percentile(lat, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    w = cell.Window(10, 100, 1, [2.0], [x / 1e3 for x in lat], 3.5)
    p95 = spec.load_module(pbhelp.REPO / "portbench/end_to_end/"
                           "call_ms_p95.py")
    rate = spec.load_module(pbhelp.REPO / "portbench/end_to_end/"
                            "keys_per_s.py")
    assert p95.read(w) == pytest.approx(95.0)
    assert rate.read(w) == pytest.approx(500.0)
    dist_rate = spec.load_module(pbhelp.REPO / "portbench/end_to_end/"
                                 "dist_keys_per_s.py")
    assert dist_rate.read(cell.Window(10, 100, 4, [2.0, 2.5, 1.0], [],
                                      1.0)) == pytest.approx(1600.0)
    vals = [1.0, 1.1, 0.9, 1.05, 0.95, 1.2]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def test_step_metrics_take_the_slowest_rank():
    merge = spec.load_module(pbhelp.REPO / "portbench/metrics/"
                             "dist_merge_ms.py")
    exch = spec.load_module(pbhelp.REPO / "portbench/metrics/"
                            "dist_exchange_ms.py")
    steps = {"dist_sort/merge tree": [4.0, 6.0], "dist_sort": [20.0, 22.0],
             "dist_sort/exchange ragged": [1.0, 1.5],
             "dist_sort/rebalance ragged": [9.0, 9.0]}
    r = cell.Reading(None, [], steps, 2, 8, 8)
    assert merge.read(r) == 5.0 and exch.read(r) == 1.25
    assert merge.COMBINE == exch.COMBINE == "max"
    assert cell._combine("max", [1.0, None, 3.0]) == 3.0
    assert cell._combine("mean", [1.0, 3.0]) == 2.0
    assert cell._combine("mean", [None]) is None


def test_keys_come_from_the_seed_alone():
    tr = {"keys_per_card": 1000, "distribution": {"and_words": 1}}
    a = keygen.make_keys(tr, 2**33 + 5, 0, 1, "cpu")
    assert a.dtype == torch.uint32 and a.shape == (1000,)
    assert torch.equal(a, keygen.make_keys(tr, 2**33 + 5, 0, 1, "cpu"))
    assert not torch.equal(a, keygen.make_keys(tr, 2**33 + 5, 1, 1, "cpu"))
    assert not torch.equal(a, keygen.make_keys(tr, 2**33 + 6, 0, 1, "cpu"))
    words = a.view(torch.int32)
    assert int((words < 0).sum()) > 300                 # the top bit is drawn
    equal = keygen.make_keys({**tr, "distribution": {"and_words": 0}}, 7, 0,
                             0, "cpu")
    assert int(equal.view(torch.int32).unique().numel()) == 1
    skew = keygen.make_keys({**tr, "distribution": {"and_words": 5}}, 7, 0,
                            0, "cpu").view(torch.int32)
    ones = sum(int(((skew >> b) & 1).sum()) for b in range(32))
    assert ones < 32 * 1000 / 16                        # ~1/32 of the bits
    up = keygen.make_keys({**tr, "distribution": {"order": "sorted"}}, 7, 0,
                          0, "cpu").view(torch.int32) ^ keygen.SIGN
    assert bool((up[1:] >= up[:-1]).all())


def test_the_reservoir_keeps_the_same_calls_for_a_seed():
    def kept(seed):
        r = cell.Reservoir(3, seed)
        for i in range(1000):
            r.offer(i, i % 2, None)
        return [i for i, _, _ in r.kept]
    assert kept(11) == kept(11) != kept(12)
    assert max(kept(11)) > 3


def test_banned_modules_compare_top_level_names_whole():
    found = spec.banned_modules(["sortx_torch", "sortx_torch.ops", "jaxlib",
                                 "sortx.ops.sort", "jaxtyping", "flax.core",
                                 "sortxx", "jax"])
    assert found == ["flax.core", "jax", "jaxlib", "sortx.ops.sort"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_sortx():
    for path in (pbhelp.REPO / "portbench").rglob("*.py"):
        assert not spec.banned_modules(_imports(path)), path


def test_the_references_import_nothing_of_the_port():
    for path in (pbhelp.REPO / "portbench" / "reference").glob("*.py"):
        names = {n.split(".")[0] for n in _imports(path)}
        assert names <= {"torch", "numpy", "math"}, (path, names)


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import cell, spec\n"
            "for w in %r:\n"
            "    c = spec.load_cell(w)\n"
            "    c.module('ops', c.config['op'])\n"
            "    c.module('reference', c.config['op'])\n"
            "print(spec.banned_modules(sys.modules))\n"
            % (str(pbhelp.REPO), CELLS))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_on_the_card_a_cell_runs_correct_at_test_size(tmp_path):
    """On a CUDA card: each one-card cell at test size, its control and
    the kept outputs against the reference (``-m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = pbhelp.small_root(tmp_path, keys_per_card=1 << 16)
    for w in ("sort_u32.uniform_2e27", "sort_kv_u32.uniform_2e27",
              "sort_u32.short_2e20"):
        j = pbhelp.job(root, w)
        j["device"] = "cuda"
        assert cell.run_rank(j)["correct"] is True
        j["control"] = True
        assert cell.run_rank(j)["correct"] is False
