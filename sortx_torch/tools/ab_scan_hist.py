"""Time the scan (K4) and the tile histogram (K5) on one NVIDIA GPU.

    python sortx_torch/tools/ab_scan_hist.py PHASE... [scan-only]

The script imports whatever ``sortx_torch`` is first on ``PYTHONPATH``
(and ``chip_smoke.py``'s timer and input generators from the checkout
it lies in), so two trees compare on one card in one shell command, in
turns:

    for t in old . . old; do PYTHONPATH=$t \\
        python sortx_torch/tools/ab_scan_hist.py kernels ops; done

A tree from before K5 took ``per_tile`` and ``prefix`` runs the rows it
can; ``scan-only`` leaves K5 out of ``kernels``. Whether the kernels are
right is not this script's business: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against their plain versions.
Phases, each printing one JSON object per line (``card`` is nvidia-smi's
name and power limit; times are medians of 9 CUDA-event timings in ms
after one warm-up, at n = 2^27 words; ``kernels`` times 10 calls in a
row per timing, so the host's work before a launch hides behind the
card's, ``ops`` one call as a caller would see it):

  ptxas    compile csrc/scan.cu and csrc/histogram.cu with -Xptxas -v:
           registers and spills of every kernel (fails on a spill), and
           the barriers, votes, matches and shared atomics in its SASS
  kernels  K4 on an aligned tensor and on a view shifted by one word,
           beside torch.cumsum(dtype=int32) and torch.clone; K5 per tile
           and whole, on uniform, all-equal, two-valued and 16-valued
           words and in a filtered round, beside torch.bincount
  sizes    K4, torch.cumsum and torch.clone at n = 2^20, 2^22, 2^24,
           2^26 (20 calls in a row per timing)
  ops      scan, histogram (8 bits), kth_value, median, the four K5
           launches of a kth_value alone, and scan_segments
"""

from __future__ import annotations

import inspect
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import sortx_torch
from sortx_torch.ops import _build
from sortx_torch.ops.radix_kernels import tile_histogram
from sortx_torch.ops.scan import tile_scan

# chip_smoke.py lies at the root of this script's checkout; the tree
# under test stays the sortx_torch imported above
sys.path.append(str(Path(__file__).resolve().parents[2]))
import chip_smoke  # noqa: E402

N = 1 << 27
TILE = 16384
HAS_FILTER = "prefix" in inspect.signature(tile_histogram).parameters


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def time_ms(run, calls: int = 1) -> dict:
    times = chip_smoke.time_ms(run, reps=9, calls=calls)
    return {"ms": statistics.median(times), "min": min(times),
            "max": max(times), "calls_per_timing": calls}


def ptxas(where: str, names=("scan.cu", "histogram.cu")) -> None:
    """Registers, spills and SASS counts of the kernels in the sources
    ``names`` of csrc/; raises on a spill."""
    nvcc = _build.nvcc_path()
    keys = ("BAR.SYNC", "VOTE", "MATCH", "SHFL", "ATOMS", "LDG.E.128",
            "STG.E.128")
    for src in _build.SOURCES:
        if src.name not in names:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            out = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                 "-o", f"{tmp}/k.o"],
                check=True, capture_output=True, text=True).stderr
            seconds = time.perf_counter() - t0
            sass = subprocess.run(
                [str(Path(nvcc).with_name("cuobjdump")), "-sass",
                 f"{tmp}/k.o"], check=True, capture_output=True,
                text=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = dict.fromkeys(("lines",) + keys, 0)
            elif fn and re.search(r"/\*[0-9a-f]{4}\*/", line):
                counts[fn]["lines"] += 1
                for key in keys:
                    counts[fn][key] += key in line
        rows, name = {}, None
        for line in out.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = m.group(1)
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
            if spill and name:
                stack = [int(g) for g in spill.groups()]
            regs = re.search(r"Used (\d+) registers", line)
            if regs and name:
                rows[name] = {"registers": int(regs.group(1)),
                              "stack_spill_stores_loads": stack,
                              "sass": counts.get(name)}
                name = None
        emit(phase="ptxas", card=where, source=src.name, seconds=seconds,
             kernels=rows)
        spilling = [k for k, v in rows.items()
                    if any(v["stack_spill_stores_loads"])]
        if spilling:
            raise RuntimeError(f"{src.name}: spills in {spilling}")


def scan_rows(where: str, phase: str, x, calls: int, **tags) -> None:
    """K4 beside the library's scan and a streaming read and write of
    the same bytes."""
    for kernel, run in (
            ("scan", lambda: tile_scan(x)),
            ("torch.cumsum int32->int32",
             lambda: torch.cumsum(x, 0, dtype=torch.int32)),
            ("torch.clone", lambda: x.clone())):
        emit(phase=phase, card=where, kernel=kernel, **tags,
             **time_ms(run, calls))


def kernels(where: str) -> None:
    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    buf = chip_smoke.words(rng, N + 1, dev)
    scan_rows(where, "kernels", buf[:N], 10, view="aligned")
    scan_rows(where, "kernels", buf[1:], 10, view="shifted by one word")
    del buf
    for kind in () if "scan-only" in sys.argv else (
            "uniform", "all-equal", "two-valued", "16-valued"):
        x = chip_smoke.skewed_words(rng, N, dev, kind)
        rounds = [("per tile", 24, {})]
        if HAS_FILTER:
            prefix = (chip_smoke.u64(x[N // 2].view(1)) >> 24).to(torch.int32)
            rounds += [("whole", 24, {"per_tile": False}),
                       ("whole, filtered round at shift 16", 16,
                        {"per_tile": False, "prefix": prefix})]
        for what, shift, kw in rounds:
            emit(phase="kernels", card=where, kernel="histogram", words=kind,
                 mode=what, **time_ms(lambda: tile_histogram(
                     x, shift, radix=256, tile_elems=TILE, **kw), 10))
        emit(phase="kernels", card=where, kernel="torch.bincount of the digit",
             words=kind, **time_ms(lambda: torch.bincount(
                 (x >> 24) & 0xFF, minlength=256), 10))
        del x


def sizes(where: str) -> None:
    """K4 below the headline size, where the data stays in the L2 cache
    and what is left is the chain of tiles and the host's work."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(3)
    for log_n in (20, 22, 24, 26):
        scan_rows(where, "sizes", chip_smoke.words(rng, 1 << log_n, dev), 20,
                  log_n=log_n)


def ops(where: str) -> None:
    dev = torch.device("cuda")
    keys = chip_smoke.words(np.random.RandomState(2), N, dev)
    u = keys.view(torch.uint32)
    off = torch.arange(0, N + 1, N // 8192, device=dev)
    kw = ({"per_tile": False,
           "prefix": torch.zeros(1, dtype=torch.int32, device=dev)}
          if HAS_FILTER else {})
    for what, run in (
            ("scan int32", lambda: sortx_torch.scan(keys)),
            ("histogram 8 bits at 24", lambda: sortx_torch.histogram(u, 8, 24)),
            ("kth_value u32", lambda: sortx_torch.kth_value(u, N // 3)),
            ("kth_value f32",
             lambda: sortx_torch.kth_value(keys.view(torch.float32), N // 3)),
            ("median u32", lambda: sortx_torch.median(u)),
            ("four K5 launches alone",
             lambda: [tile_histogram(keys, shift, radix=256, tile_elems=TILE,
                                     **kw) for shift in (24, 16, 8, 0)]),
            ("scan_segments, 8192 segments",
             lambda: sortx_torch.scan_segments(keys, off))):
        emit(phase="ops", card=where, what=f"{what} 2^27", **time_ms(run))


def main() -> None:
    where = chip_smoke.header()     # exits without a card; builds
    emit(phase="build", card=where,
         tree=str(Path(sortx_torch.__file__).parent))
    for phase in [a for a in sys.argv[1:] if a != "scan-only"] or ["kernels"]:
        {"ptxas": ptxas, "kernels": kernels, "sizes": sizes,
         "ops": ops}[phase](where)


if __name__ == "__main__":
    main()
