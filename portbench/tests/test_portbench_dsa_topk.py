"""The indexer's top-k cell and the entropy cell, run on the CPU at test
sizes, with faults planted under the indexer's timed path, and the
readers of the indexer's metrics on synthetic slices.

The indexer cell runs in a copy of the benchmark whose configuration
keeps 64 of the last 8 rows' 2993 to 3000 scores; the port runs the plain
versions of K13 and K14 and the row network's plain passes.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import pytest
import torch

import pbhelp
from portbench import cell, spec, tracing

topk_mod = importlib.import_module("sortx_torch.ops.topk_rows")

DSA = "dsa_topk_f32.prefill_4096x131072"
ENTROPY = "sort_u32.entropy_0p201_2e27"
FAULTS = Path(__file__).resolve().parent / "dsa_faults.py"
ROWS, CONTEXT, K = 8, 3000, 64
KEYS = sum(CONTEXT - ROWS + 1 + t for t in range(ROWS))


def _dsa_root(tmp, **traffic):
    """A copy of the benchmark at test sizes whose indexer cell keeps the
    top ``K`` of ``ROWS`` causal rows of a ``CONTEXT``-token prompt."""
    root = pbhelp.small_root(tmp, **traffic)
    path = root / "portbench" / "configs" / "dsa_topk_f32.json"
    config = json.loads(path.read_text())
    config.update(chunk_tokens=ROWS, context_tokens=CONTEXT, index_topk=K)
    path.write_text(json.dumps(config))
    path = root / "portbench" / "traffic" / "prefill_4096x131072.json"
    mix = json.loads(path.read_text())
    mix.update(keys_per_card=KEYS)
    path.write_text(json.dumps(mix))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _dsa_root(tmp_path_factory.mktemp("dsa"))


@pytest.fixture(scope="module")
def tied_root(tmp_path_factory):
    """Scores from words of entropy 0.337 tie often, across the cut too."""
    return _dsa_root(tmp_path_factory.mktemp("dsa_tied"),
                     distribution={"and_words": 4})


@pytest.fixture
def select(monkeypatch):
    """The select a planted fault patches comes back after the test."""
    monkeypatch.setattr(topk_mod, "topk_rows_select",
                        topk_mod.topk_rows_select)


@pytest.mark.parametrize("tied", [False, True])
def test_the_indexer_cell_is_correct(root, tied_root, tied):
    r = pbhelp.run_cpu(tied_root if tied else root, DSA)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"] == {"values_mismatch": {"value": 0, "limit": 0},
                           "indices_mismatch": {"value": 0, "limit": 0}}
    assert set(r["metrics"]) == {"keys_per_s", "call_ms_p95", "setup_s"}


def test_the_bfloat16_control_is_not_correct(root):
    r = pbhelp.run_cpu(root, DSA, control=True)
    assert r["correct"] is False
    assert r["checks"]["values_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", ["lengths_ignored", "index_altered",
                                   "ties_reversed"])
def test_a_fault_under_the_select_is_not_correct(tied_root, select, fault):
    r = pbhelp.run_cpu(tied_root, DSA, hooks=[(str(FAULTS), fault)])
    assert r["correct"] is False
    assert r["failed"] == min(r["attempted"], pbhelp.SMALL["checked_calls"])
    assert r["checks"]["indices_mismatch"]["value"] > 0


def test_the_indexer_inputs_come_from_the_seed(root):
    c = spec.load_cell(DSA, root)
    op = c.module("ops", c.config["op"])
    state = op.setup(torch.device("cpu"), c.config, 1)
    words = torch.randint(-2**31, 2**31, (KEYS,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(3))
    scores, lengths, k = op.inputs(state, words.view(torch.uint32))
    assert scores.shape == (ROWS, CONTEXT) and k == K
    assert lengths.tolist() == list(range(CONTEXT - ROWS + 1, CONTEXT + 1))
    past = torch.arange(CONTEXT) >= lengths[:, None]
    assert torch.isposinf(scores[past]).all()
    assert torch.isfinite(scores[~past]).all()
    assert torch.equal(op.inputs(state, words.view(torch.uint32))[0], scores)


def test_the_traced_indexer_cell_reads_its_spans(root):
    """On the CPU the trace holds no kernel: the span reader reads, the
    kernel readers give nothing and are left out of the line."""
    r = pbhelp.run_cpu(root, DSA, trace=1)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["topk_rows_host_ms"] > 0
    assert not {"topk_rows_kernels_per_call", "topk_rows_histogram_roofline",
                "topk_rows_gather_roofline"} & set(m)


def test_the_entropy_cell_is_correct(root):
    r = pbhelp.run_cpu(root, ENTROPY)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"keys_per_s", "call_ms_p95", "setup_s"}


def _reader(name):
    return spec.load_module(pbhelp.REPO / "portbench" / "metrics" /
                            f"{name}.py")


def _slice(device, host=(), calls=2):
    return tracing.Slice(0, 100_000_000, list(device), list(host), calls)


def test_the_indexer_readers_on_a_synthetic_slice():
    k = "kernel"
    n = 528_484_352
    hist, gather = 0.8e6, 1.2e6          # ns a launch
    dev = [(0, 10_000, "gpu_memset", "Memset (Device)")]
    t = 10_000
    for call in range(2):
        for _ in range(4):
            dev.append((t, t + hist, k, "void (anonymous namespace)::"
                        "topk_rows_histogram_kernel<true, false>(...)"))
            t += hist
        dev.append((t, t + gather, k, "topk_rows_gather_kernel"))
        t += gather
        dev.append((t, t + 300_000, k, "bitonic_block_kernel"))
        t += 300_000
    host = [(0, 40_000_000, "sortx_torch.api.top_k_rows"),
            (1_000_000, 39_000_000, "sortx_torch.engine.topk_rows"),
            (2_000_000, 30_000_000, "sortx_torch.driver.topk_rows"),
            (3_000_000, 13_000_000, "sortx_torch.driver.bitonic"),
            (14_000_000, 15_000_000, "sortx_torch.launch.topk_rows_gather")]
    r = cell.Reading(_slice(dev, host), [], {}, 0, n, 4)
    # engine: 38 ms less the driver's 28; driver: 28 less 10 and 1
    assert _reader("topk_rows_host_ms").read(r) == pytest.approx(
        (10 + 17) / 2)
    assert _reader("topk_rows_kernels_per_call").read(r) == 13 / 2
    least = 4 * n / 3.35e12
    assert _reader("topk_rows_histogram_roofline").read(r) == \
        pytest.approx(100 * least / (hist / 1e9))
    least = 4 * n / 3.35e12
    assert _reader("topk_rows_gather_roofline").read(r) == \
        pytest.approx(100 * least / (gather / 1e9))


@pytest.mark.parametrize("name", ["topk_rows_host_ms",
                                  "topk_rows_kernels_per_call",
                                  "topk_rows_histogram_roofline",
                                  "topk_rows_gather_roofline"])
def test_the_indexer_readers_read_nothing_without_the_select(name):
    """A program without the select's spans and kernels (the parent's, a
    row sort, or no trace) gives no reading, and no reader raises."""
    rows = _slice([(0, 10, "kernel", "radix_rows_onesweep_kernel")],
                  [(0, 20, "sortx_torch.engine.rows")])
    for sl in (None, _slice([]), rows):
        r = cell.Reading(sl, [], {}, 0, 1000, 4)
        assert _reader(name).read(r) is None


@pytest.mark.cuda
def test_on_the_card_the_new_cells_run_correct_at_test_size(tied_root):
    """On a CUDA card (``-m cuda``): the indexer cell at test size (K13,
    K14), its control, and the entropy cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for w, control in ((DSA, False), (DSA, True), (ENTROPY, False)):
        j = pbhelp.job(tied_root, w, control=control)
        j["device"] = "cuda"
        r = cell.run_rank(j)
        assert r["correct"] is not control, (w, control, r["checks"])
