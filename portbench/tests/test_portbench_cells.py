"""Runs of the benchmark's cells on the CPU at test sizes: the result line,
the control and the faults under the timed path, a cell added by files
alone, and run.py's refusal without a card.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

import pbhelp
import sortx_torch
# the modules, which the packages' functions of the same names shadow
sort_mod = importlib.import_module("sortx_torch.ops.sort")
dist_mod = importlib.import_module("sortx_torch.parallel.dist_sort")

ONE_CARD = ("sort_u32.uniform_2e27", "sort_kv_u32.uniform_2e27",
            "sort_u32.short_2e20")
DIST = "dist_sort_u32.uniform_4x2e27"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def network(monkeypatch):
    """The port's network engine on CPU tensors (its kernels' plain
    versions), as a CUDA card would run it; the patched engine functions
    come back after the test."""
    monkeypatch.setattr(sort_mod, "sort_network", sort_mod.sort_network)
    monkeypatch.setattr(sort_mod, "sort_kv_network",
                        sort_mod.sort_kv_network)
    monkeypatch.setenv("SORTX_ENGINE", "network")
    old = sortx_torch.default_config()
    sortx_torch.set_default_config(sortx_torch.Config(engine="network"))
    yield
    sortx_torch.set_default_config(old)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pbhelp.small_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ONE_CARD)
def test_result_line_has_the_contract_keys(root, network, workload, trace):
    r = pbhelp.run_cpu(root, workload, trace=trace)
    extra = ["breakdown"] if trace else []
    assert list(r) == KEYS + extra + ["checks"]      # the checks come last
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["metrics"]) <= {m["name"] for m in bench["per_layer"]}
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])}
        assert set(r["metrics"]) == want and "setup_s" in want
        assert all(m["value"] > 0 for m in r["metrics"].values())
    for c in r["checks"].values():
        assert c == {"value": 0, "limit": 0}


@pytest.fixture(scope="module")
def tied_root(tmp_path_factory):
    """Test sizes hold no tied keys at entropy 1.000 (2^27 uniform keys
    hold about 2M tied pairs): entropy 0.337 gives them ties."""
    return pbhelp.small_root(tmp_path_factory.mktemp("tied"),
                             distribution={"and_words": 4})


@pytest.mark.parametrize("workload", ONE_CARD)
def test_control_is_not_correct(tied_root, network, workload):
    r = pbhelp.run_cpu(tied_root, workload, control=True)
    assert r["correct"] is False and r["failed"] > 0
    assert max(c["value"] for c in r["checks"].values()) > 0


def test_sort_kv_control_breaks_only_stability(tied_root, network):
    """The unstable sort_kv keeps the keys right and moves tied values."""
    r = pbhelp.run_cpu(tied_root, "sort_kv_u32.uniform_2e27", control=True)
    assert r["checks"]["keys_mismatch"]["value"] == 0
    assert r["checks"]["values_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("workload", ONE_CARD)
def test_a_fault_under_the_timed_path_is_not_correct(root, network,
                                                     workload, fault):
    r = pbhelp.run_cpu(root, workload,
                       hooks=[(str(pbhelp.FAULTS), fault)])
    assert r["correct"] is False
    assert r["failed"] == min(r["attempted"], 3)


@pytest.fixture
def dist_network(monkeypatch):
    monkeypatch.setenv("SORTX_ENGINE", "network")
    for name in ("_shard_sort", "_exchange_all"):
        monkeypatch.setattr(dist_mod, name, getattr(dist_mod, name))


def test_dist_cell_runs_on_gloo_ranks(root, dist_network, capfd):
    r = pbhelp.run_ranks(root, DIST, capfd)
    assert list(r) == KEYS + ["checks"]
    assert r["correct"] is True and r["device"]["count"] == 4
    assert set(r["metrics"]) == {"dist_keys_per_s", "setup_s"}


def test_dist_traced_run_reads_the_step_rows(root, dist_network, capfd):
    r = pbhelp.run_ranks(root, DIST, capfd, trace=1)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"dist_merge_ms", "dist_exchange_ms"}


@pytest.mark.parametrize("fault", ["control", "dist_state_unchanged",
                                   "dist_half_left_out", "exchange_left_out",
                                   "dist_answer_altered"])
def test_dist_fault_is_not_correct(root, dist_network, capfd, fault):
    if fault == "control":
        r = pbhelp.run_ranks(root, DIST, capfd, control=True)
    else:
        r = pbhelp.run_ranks(root, DIST, capfd,
                             hooks=[(str(pbhelp.FAULTS), fault)])
    assert r["correct"] is False and r["failed"] > 0


def test_run_py_without_a_card_fails_and_prints_no_result():
    """This machine's torch has no CUDA card: no fall-back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    p = subprocess.run([sys.executable, str(pbhelp.REPO / "portbench" /
                                            "run.py"),
                        "--workload", ONE_CARD[2], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120,
                       cwd=pbhelp.REPO)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "no CUDA card" in p.stderr


@pytest.mark.parametrize("kind,metric,trace", [
    ("metrics", "roofline_share", 1), ("end_to_end", "keys_per_s", 0)])
def test_a_reader_that_loads_jax_gets_no_result(tmp_path, kind, metric,
                                                trace):
    """A metric's reader that imports (a stub of) jax, after the window:
    the run exits with 1, names the module and prints no result."""
    (tmp_path / "bench").mkdir()
    root = pbhelp.small_root(tmp_path / "bench")
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("STUB = True\n")
    path = root / "portbench" / kind / f"{metric}.py"
    path.write_text("import jax  # noqa: F401\n" + path.read_text())
    job = pbhelp.job(root, ONE_CARD[0], trace=trace)
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "stub"))
    p = subprocess.run([sys.executable, str(pbhelp.REPO / "portbench" /
                                            "run.py"),
                        "--rank-job", json.dumps(job)], capture_output=True,
                       text=True, timeout=240, cwd=pbhelp.REPO, env=env)
    assert p.returncode == 1, p.stderr[-3000:]
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert "'jax'" in p.stderr.strip().splitlines()[-1]


def test_a_new_cell_is_files_and_an_entry(tmp_path, network):
    """A skewed mix and a metric of its own, added without editing any
    file the benchmark has: a traffic file, a metric file and entries."""
    root = pbhelp.small_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    (root / "portbench" / "traffic" / "skewed_2e12.json").write_text(
        json.dumps({"keys_per_card": 4096, "pool": 2, "checked_calls": 2,
                    "trace_calls": 3,
                    "distribution": {"and_words": 5, "order": "random"}}))
    (root / "portbench" / "metrics" / "calls_traced.py").write_text(
        "def read(r):\n    return float(r.slice.calls) if r.slice else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sort_u32.skewed_2e12",
                               "config": "sort_u32", "traffic": "skewed_2e12",
                               "chips": 1, "why": "entropy 0.201"})
    for m in bench["end_to_end"]:
        if m["name"] in ("keys_per_s", "call_ms_p95"):
            m["workloads"].append("sort_u32.skewed_2e12")
    bench["per_layer"].append({
        "name": "calls_traced", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "device", "moves": "keys_per_s",
        "workloads": ["sort_u32.skewed_2e12"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    r = pbhelp.run_cpu(root, "sort_u32.skewed_2e12")
    assert r["correct"] is True
    assert set(r["metrics"]) == {"keys_per_s", "call_ms_p95", "setup_s"}
    r = pbhelp.run_cpu(root, "sort_u32.skewed_2e12", trace=1)
    assert r["metrics"]["calls_traced"]["value"] == 3.0
