"""Helpers of the benchmark's CPU tests: a copy of the benchmark at test
sizes, and runs of its cells on the CPU with the port's own network
engine (the plain versions of the card's kernels)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import cell, ranks, spec  # noqa: E402

SMALL = {"keys_per_card": 4096, "checked_calls": 3, "trace_calls": 4,
         "step_calls": 2}
FAULTS = Path(__file__).resolve().parent / "faults.py"
SEED = 2**31 + 4242            # larger than 32 signed bits hold


def small_root(tmp: Path, **traffic) -> Path:
    """A copy of BENCHMARK.json and the benchmark's files under ``tmp``,
    every traffic mix cut to test sizes (``traffic`` overrides)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for path in (tmp / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        for key, value in {**SMALL, **traffic}.items():
            if key in mix or key == "keys_per_card":
                mix[key] = value
        path.write_text(json.dumps(mix))
    return tmp


def job(root: Path, workload: str, trace: int = 0, control: bool = False,
        seconds: float = 0.3, seed: int = SEED, hooks=()) -> dict:
    return {"workload": workload, "seed": seed, "seconds": seconds,
            "trace": trace, "control": control, "root": str(root),
            "device": "cpu", "start": cell.process_start_wall(),
            "hooks": [list(h) for h in hooks]}


def run_cpu(root: Path, workload: str, **kw) -> dict:
    """One run of a one-card cell in this process, on the CPU."""
    return cell.run_rank(job(root, workload, **kw))


def run_ranks(root: Path, workload: str, capfd, **kw) -> dict:
    """One run of a cell on several ranks (gloo, on the CPU), started as
    ``run.py`` starts them; returns rank 0's result."""
    j = job(root, workload, **kw)
    chips = spec.load_cell(workload, root).chips
    rc = ranks.spawn(str(REPO / "portbench" / "run.py"), j, chips, 240)
    cap = capfd.readouterr()
    assert rc == 0, cap.err[-3000:]
    return json.loads(cap.out.strip().splitlines()[-1])
