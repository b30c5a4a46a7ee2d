"""The reader of ``rows_radix_passes_per_call``: on synthetic slices, and
in a traced run of the sampler cell on the CPU at test size with the
port's rows radix engine (the plain versions of K11 and K12), each of
whose kernel calls opens a range named as its kernel, which the slice
takes for a kernel on the device, as a card's trace shows it.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json

import pytest
import torch

import pbhelp
import sortx_torch
from portbench import cell, spec, tracing
from sortx_torch.ops import radix_rows as rr

TOPP = "topp_rows_f32.decode_256x129280"
VOCAB, ROWS = 3000, 4
NAME = "rows_radix_passes_per_call"


def _reader():
    return spec.load_module(pbhelp.REPO / "portbench" / "metrics" /
                            f"{NAME}.py")


def _reading(sl):
    return cell.Reading(sl, [], {}, 0, 1000, 12)


def _slice(device, calls=2):
    return tracing.Slice(0, 100_000_000, list(device), [], calls)


def test_the_reader_counts_the_rows_radix_kernels_a_call():
    k = "kernel"
    call = [(0, 10, "gpu_memset", "Memset (Device)"),
            (10, 20, k, "void (anonymous namespace)::"
                        "radix_rows_histogram_kernel(unsigned int const*)"),
            *[(20 + i, 21 + i, k, "void (anonymous namespace)::"
                                  "radix_rows_onesweep_kernel<true>(int)")
              for i in range(4)]]
    assert _reader().read(_reading(_slice(call + call))) == 5.0


@pytest.mark.parametrize("device", [
    [],
    [(0, 10, "kernel", "bitonic_block_kernel"),
     (10, 20, "kernel", "void at::native::elementwise_kernel")],
    [(0, 10, "kernel", "radix_onesweep_kernel"),
     (10, 20, "kernel", "radix_histogram_kernel")],
], ids=["empty", "row network", "flat radix"])
def test_the_reader_reads_nothing_without_the_rows_radix_engine(device):
    """A program without K11 / K12 (the parent's row network, the flat
    radix engine, or no trace) gives no reading, and the reader does not
    raise."""
    assert _reader().read(_reading(None)) is None
    assert _reader().read(_reading(_slice(device))) is None


@pytest.fixture
def rows_radix(monkeypatch):
    """The rows radix engine on CPU tensors (rows of ``VOCAB`` are long
    enough for it), each kernel call in a range named as its kernel."""
    old = sortx_torch.default_config()
    sortx_torch.set_default_config(sortx_torch.Config(engine="radix"))
    for name in ("radix_rows_histogram", "radix_rows_onesweep"):
        def timed(*args, _fn=getattr(rr, name), _name=f"{name}_kernel",
                  **kw):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kw)
        monkeypatch.setattr(rr, name, timed)
    real = tracing.classify

    def classify(events):
        return [(n, "kernel" if n.startswith("radix_rows_") else k, s, d)
                for n, k, s, d in real(events)]
    monkeypatch.setattr(tracing, "classify", classify)
    yield
    sortx_torch.set_default_config(old)


def test_the_traced_sampler_cell_reads_five_rows_radix_passes(
        tmp_path, rows_radix):
    root = pbhelp.small_root(tmp_path)
    path = root / "portbench" / "configs" / "topp_rows_f32.json"
    config = json.loads(path.read_text())
    config["vocab_size"] = VOCAB
    path.write_text(json.dumps(config))
    path = root / "portbench" / "traffic" / "decode_256x129280.json"
    mix = json.loads(path.read_text())
    mix.update(keys_per_card=ROWS * VOCAB, rows=ROWS)
    path.write_text(json.dumps(mix))
    r = pbhelp.run_cpu(root, TOPP, trace=1)
    assert r["correct"] is True and r["failed"] == 0
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m[NAME] == 5
    # the row network's readers find none of its kernels
    assert "rows_passes_per_call" not in m and "rows_glue_dev_ms" not in m
    assert m["rows_engine_host_ms"] > 0
