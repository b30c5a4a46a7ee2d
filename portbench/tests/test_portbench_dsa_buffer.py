"""The reader of ``topk_rows_buffered_share`` (the indexer cell's share of
rows whose select finished on their candidate buffer), on synthetic
counts and on a port without the count.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import importlib
import json

import pytest

import pbhelp
from portbench import cell, spec

topk_mod = importlib.import_module("sortx_torch.ops.topk_rows")


def _read():
    reader = spec.load_module(pbhelp.REPO / "portbench" / "metrics" /
                              "topk_rows_buffered_share.py")
    return reader.read(cell.Reading(None, [], {}, 0, 1000, 4))


@pytest.mark.parametrize("counts, share", [((4096, 4096), 100.0),
                                           ((3, 4), 75.0), ((0, 7), 0.0)])
def test_the_reader_reads_the_ports_count(monkeypatch, counts, share):
    monkeypatch.setattr(topk_mod, "buffer_counts", lambda: counts)
    assert _read() == pytest.approx(share)


def test_no_rows_counted_reads_nothing(monkeypatch):
    monkeypatch.setattr(topk_mod, "buffer_counts", lambda: (0, 0))
    assert _read() is None


def test_a_port_without_the_count_reads_nothing(monkeypatch):
    monkeypatch.delattr(topk_mod, "buffer_counts")
    assert _read() is None


def test_the_benchmark_names_the_metric_for_the_indexer_cell():
    m = {e["name"]: e for e in json.loads(
        (pbhelp.REPO / "BENCHMARK.json").read_text())["per_layer"]}
    assert m["topk_rows_buffered_share"] == {
        "name": "topk_rows_buffered_share", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "kernels",
        "moves": "keys_per_s",
        "workloads": ["dsa_topk_f32.prefill_4096x131072"]}
