"""Finds a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration names its op. Every part is a file under this directory,
loaded by path, so a new cell, op or metric is a new file and a new
entry, and no file that is already here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent              # the checkout's root
BANNED = ("jax", "jaxlib", "flax", "sortx")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with what it names, read from ``root``."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list            # the end_to_end entries this cell reports
    per_layer: list             # the per_layer entries this cell reports
    root: Path

    @property
    def bench(self) -> Path:
        return self.root / HERE.name

    def module(self, kind: str, name: str) -> ModuleType:
        """``<kind>/<name>.py`` under the benchmark's directory."""
        return load_module(self.bench / kind / f"{name}.py")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; raises KeyError
    for a name it does not hold."""
    root = Path(root)
    bench = load_benchmark(root)
    (work,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if work is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    (conf,) = [c for c in bench["configs"] if c["name"] == work["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / HERE.name / "traffic" / f"{work['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(work["chips"]), config, traffic, e2e, layer, root)


def load_module(path: Path) -> ModuleType:
    """Import the file ``path`` as a module of its own (names such as
    ``device_idle_share.short`` hold dots, so not by import name)."""
    path = Path(path)
    key = "portbench_" + re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no benchmark file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules(modules) -> list:
    """The names in ``modules`` whose top-level name (before the first
    dot) is one of :data:`BANNED`, compared whole: ``sortx_torch`` is not
    ``sortx``."""
    return sorted(m for m in modules if m.split(".")[0] in BANNED)
