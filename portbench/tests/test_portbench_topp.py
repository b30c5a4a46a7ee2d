"""The top-p sampler's row-sort cell and the all-equal-keys cell, run on
the CPU at test sizes, with faults planted under their timed paths, and
the readers of the rows metrics.

The row-sort cell runs in a copy of the benchmark whose configuration has
a vocabulary of 1000 and whose traffic makes 4 rows a call; the port's
row network runs its plain schedule (the CPU mirror of K1-K3). On the
CPU the profiler sees no kernels, so for the traced run each pass of the
network opens a range named as its kernel, and the slice takes those
ranges for the device's kernels, as a card's trace shows them.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import pytest
import torch

import pbhelp
import sortx_torch
from portbench import cell, spec, tracing
from sortx_torch.ops import bitonic as tb

# the modules, which the packages' functions of the same names shadow
sort_mod = importlib.import_module("sortx_torch.ops.sort")
rows_mod = importlib.import_module("sortx_torch.ops.rows")

ROWS_FAULTS = Path(__file__).resolve().parent / "rows_faults.py"
FAULTS = ["state_unchanged", "half_left_out", "answer_altered"]
TOPP = "topp_rows_f32.decode_256x129280"
EQUAL = "sort_u32.equal_2e27"
VOCAB, ROWS = 1000, 4


@pytest.fixture
def network(monkeypatch):
    """The port's network engines on CPU tensors, as a card runs them; the
    engine functions a planted fault patches come back after the test."""
    for mod, name in ((sort_mod, "sort_network"),
                      (sort_mod, "sort_kv_network"),
                      (rows_mod, "network_rows")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    old = sortx_torch.default_config()
    sortx_torch.set_default_config(sortx_torch.Config(engine="network"))
    yield
    sortx_torch.set_default_config(old)


def _topp_root(tmp, **traffic):
    """A copy of the benchmark at test sizes whose sampler cell sorts
    ``ROWS`` rows of ``VOCAB``."""
    root = pbhelp.small_root(tmp, **traffic)
    path = root / "portbench" / "configs" / "topp_rows_f32.json"
    config = json.loads(path.read_text())
    config["vocab_size"] = VOCAB
    path.write_text(json.dumps(config))
    path = root / "portbench" / "traffic" / "decode_256x129280.json"
    mix = json.loads(path.read_text())
    mix.update(keys_per_card=ROWS * VOCAB, rows=ROWS)
    path.write_text(json.dumps(mix))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _topp_root(tmp_path_factory.mktemp("topp"))


@pytest.fixture(scope="module")
def tied_root(tmp_path_factory):
    """Rows of 1000 probabilities hold hardly a tie at entropy 1.000 (rows
    of 129,280 hold about 880 a row): words of entropy 0.337 tie often."""
    return _topp_root(tmp_path_factory.mktemp("tied"),
                      distribution={"and_words": 4})


@pytest.fixture
def passes_as_kernels(monkeypatch):
    """Each pass of the network in a range named as its kernel, taken by
    the slice for a kernel on the device."""
    for name, (fn, plain) in list(tb.KERNELS.items()):
        def timed(x, *args, _fn=fn, _name=f"{name}_kernel", **kw):
            with torch.profiler.record_function(_name):
                return _fn(x, *args, **kw)
        monkeypatch.setitem(tb.KERNELS, name, (timed, plain))
    real = tracing.classify

    def classify(events):
        return [(n, "kernel" if n.startswith("bitonic_") else k, s, d)
                for n, k, s, d in real(events)]
    monkeypatch.setattr(tracing, "classify", classify)


@pytest.mark.parametrize("tied", [False, True])
def test_the_sampler_cell_is_correct_and_reports_its_metrics(
        root, tied_root, network, tied):
    r = pbhelp.run_cpu(tied_root if tied else root, TOPP)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"] == {"probs_mismatch": {"value": 0, "limit": 0},
                           "indices_mismatch": {"value": 0, "limit": 0}}
    assert set(r["metrics"]) == {"keys_per_s", "call_ms_p95", "setup_s"}


def test_the_sampler_control_breaks_only_the_order_of_ties(tied_root,
                                                          network):
    """The position stream carried but not compared: the probabilities
    stay right, the indices of tied probabilities do not."""
    r = pbhelp.run_cpu(tied_root, TOPP, control=True)
    assert r["correct"] is False
    assert r["checks"]["probs_mismatch"]["value"] == 0
    assert r["checks"]["indices_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_row_network_is_not_correct(root, network, fault):
    r = pbhelp.run_cpu(root, TOPP, hooks=[(str(ROWS_FAULTS), fault)])
    assert r["correct"] is False
    assert r["failed"] == min(r["attempted"], pbhelp.SMALL["checked_calls"])
    assert r["checks"]["probs_mismatch"]["value"] > 0


def test_the_traced_sampler_cell_reads_the_pass_plan(root, network,
                                                     passes_as_kernels,
                                                     monkeypatch):
    # a block of 2^8 at two streams, so rows of 2^10 take K1, and K3 and
    # K2 for each of the stages 9 and 10
    monkeypatch.setitem(tb.BLOCK_LOG, 2, 8)
    r = pbhelp.run_cpu(root, TOPP, trace=1)
    assert r["correct"] is True
    plan = tb.pass_plan(2, ROWS * 1024, 2, row_log=10)
    assert len(plan) == 5
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["rows_passes_per_call"] == len(plan)
    assert m["rows_engine_host_ms"] > 0
    assert m["rows_glue_dev_ms"] == 0.0     # no other operation on a card
    assert {"roofline_share", "device_idle_share"} <= set(m)


def test_the_sampler_inputs_come_from_the_seed(root):
    c = spec.load_cell(TOPP, root)
    op = c.module("ops", c.config["op"])
    state = op.setup(torch.device("cpu"), c.config, 1)
    words = torch.randint(-2**31, 2**31, (ROWS * VOCAB,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(3))
    (probs,) = op.inputs(state, words.view(torch.uint32))
    assert probs.shape == (ROWS, VOCAB) and probs.dtype == torch.float32
    assert torch.allclose(probs.sum(1), torch.ones(ROWS))
    assert torch.equal(op.inputs(state, words.view(torch.uint32))[0], probs)


def test_the_equal_keys_cell_is_correct(root, network):
    r = pbhelp.run_cpu(root, EQUAL)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"keys_per_s", "call_ms_p95", "setup_s"}


def test_an_altered_word_in_the_equal_keys_cell_is_not_correct(root,
                                                               network):
    """On all-equal keys every sort is the identity, so only a lost or
    altered word can show: one key's low bit, flipped where the sort
    produces it."""
    r = pbhelp.run_cpu(root, EQUAL,
                       hooks=[(str(pbhelp.FAULTS), "answer_altered")])
    assert r["correct"] is False
    assert r["failed"] == min(r["attempted"], pbhelp.SMALL["checked_calls"])


def _slice(device, host=()):
    return tracing.Slice(0, 100_000_000, list(device), list(host), 2)


def _reading(sl):
    return cell.Reading(sl, [], {}, 0, 1000, 12)


def _reader(name):
    return spec.load_module(pbhelp.REPO / "portbench" / "metrics" /
                            f"{name}.py")


def test_the_rows_readers_on_synthetic_slices():
    k = "kernel"
    dev = [(0, 1_000_000, k, "void bitonic_block_kernel<2, 2>(int*)"),
           (1_000_000, 1_500_000, k, "bitonic_global_kernel"),
           (2_000_000, 2_200_000, k, "bitonic_tail_kernel"),
           (3_000_000, 3_400_000, k, "void at::native::elementwise_kernel"),
           (4_000_000, 4_200_000, "gpu_memset", "Memset (Device)")]
    host = [(0, 50_000_000, "sortx_torch.api.sort_rows"),
            (1_000_000, 40_000_000, "sortx_torch.engine.rows"),
            (5_000_000, 25_000_000, "sortx_torch.driver.bitonic")]
    sl = _slice(dev, host)
    assert _reader("rows_passes_per_call").read(_reading(sl)) == 1.5
    assert _reader("rows_glue_dev_ms").read(_reading(sl)) == \
        pytest.approx(0.3)
    # engine.rows covers 39 ms, the driver 20 of them: 19 ms over 2 calls
    assert _reader("rows_engine_host_ms").read(_reading(sl)) == \
        pytest.approx(9.5)


@pytest.mark.parametrize("name", ["rows_passes_per_call", "rows_glue_dev_ms",
                                  "rows_engine_host_ms"])
def test_the_rows_readers_read_nothing_without_the_rows_engine(name):
    """A program without the rows engine's span and kernels (a 1-D radix
    sort, or no trace) gives no reading, and no reader raises."""
    radix = _slice([(0, 10, "kernel", "radix_onesweep_kernel")],
                   [(0, 20, "sortx_torch.engine.radix")])
    for sl in (None, _slice([]), radix):
        assert _reader(name).read(_reading(sl)) is None


@pytest.mark.cuda
def test_on_the_card_the_new_cells_run_correct_at_test_size(tied_root):
    """On a CUDA card (``-m cuda``): the sampler cell at test size, its
    control on tied probabilities, and the all-equal-keys cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for w, control in ((TOPP, False), (TOPP, True), (EQUAL, False)):
        j = pbhelp.job(tied_root, w, control=control)
        j["device"] = "cuda"
        r = cell.run_rank(j)
        assert r["correct"] is not control, (w, control, r["checks"])
