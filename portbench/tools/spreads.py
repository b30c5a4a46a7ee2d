"""The spread of each end-to-end metric over sets of runs, and the bound
it suggests.

    python3 portbench/tools/spreads.py <dir> [<dir> ...]

Each ``<dir>`` holds the standard output of runs, one file each, named
``<cell>.<seed>.t<trace>[.c][.<k>].out`` (``.c`` a control run, ``k`` the
run's place in its call). The untraced runs of one cell, in the order
they ran (by ``k``, else by file time), split in two halves, the two
sets; for each metric
this prints each set's median and spread (the quartiles of Python's
``statistics.quantiles(values, n=4)`` as a share of the median), the
wider spread, five times it (the bound the contract asks for, at least
1%), and every value, unrounded.
"""

from __future__ import annotations

import collections
import json
import re
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.stats import spread  # noqa: E402


NAME = re.compile(r"^(?P<cell>.+)\.(?P<seed>-?\d+)\.t(?P<trace>[01])"
                  r"(?P<control>\.c)?(?:\.(?P<k>\d+))?\.out$")


def results(dirs) -> dict:
    """cell -> [(seed, result)] of the untraced runs that are no control."""
    runs = []
    for path in (p for d in dirs for p in Path(d).glob("*.out")):
        m = NAME.match(path.name)
        if not m or m["trace"] != "0" or m["control"]:
            continue
        lines = path.read_text().strip().splitlines()
        if lines and lines[-1].startswith("{"):
            order = int(m["k"]) if m["k"] else path.stat().st_mtime
            runs.append((order, m["cell"], m["seed"], json.loads(lines[-1])))
    out = collections.defaultdict(list)
    for _, cell, seed, result in sorted(runs, key=lambda r: r[0]):
        out[cell].append((seed, result))
    return out


def main(dirs) -> None:
    for cell, runs in results(dirs).items():
        half = len(runs) // 2
        sets = [runs[:half], runs[half:2 * half]]
        print(f"{cell}: {len(runs)} runs, sets of {half}; correct "
              f"{sum(r['correct'] for _, r in runs)}/{len(runs)}")
        for name in runs[0][1]["metrics"]:
            vals = [[r["metrics"][name]["value"] for _, r in s] for s in sets]
            if half < 2:
                print(f"  {name}: {vals}")
                continue
            sp = [spread(v) for v in vals]
            med = [statistics.median(v) for v in vals]
            print(f"  {name}: medians {med}, spreads {sp}, wider "
                  f"{max(sp)!r} -> 5x {max(5 * max(sp), 0.01)!r}; second "
                  f"median vs first {med[1] / med[0] - 1!r}")
            print(f"    values {vals}")


if __name__ == "__main__":
    main(sys.argv[1:])
