"""Time and check the bitonic block kernels (K1, K2) on one NVIDIA GPU.

    python sortx_torch/tools/ab_bitonic.py PHASE... [sets=1,1;3,2]

The script imports whatever ``sortx_torch`` is first on ``PYTHONPATH``,
so two trees compare on one card in one shell command, in turns:

    PYTHONPATH=old python sortx_torch/tools/ab_bitonic.py kernels ops
    PYTHONPATH=.   python sortx_torch/tools/ab_bitonic.py kernels ops
    PYTHONPATH=.   python sortx_torch/tools/ab_bitonic.py kernels ops
    PYTHONPATH=old python sortx_torch/tools/ab_bitonic.py kernels ops

Phases, each printing one JSON object per line (``card`` is nvidia-smi's
name and power limit; times are medians of 5 CUDA-event timings in ms
after one warm-up, of 15 in ``small`` and ``ops``, whose short calls
spike). ``sets=`` limits ``kernels``, ``blocks`` and ``small`` to the
(streams, keys) pairs given:

  ptxas    compile csrc/bitonic.cu with -Xptxas -v: registers, spills and
           build seconds of every K1 / K2 instantiation; fails unless
           each register-design kernel's SASS holds the barriers its
           schedule in ops/bitonic.py states (K2: one per change of
           layout; K1: those of one stage, inside its loop over stages)
  check    K1 (full, rows mode) and K2 (descending and ascending blocks,
           force_asc, s == L) against their plain versions, bit for bit,
           for every stream set at every block 2^1..2^15 that fits
  kernels  K1, K2 and K3 at n = 2^27, at the library's block size
  blocks   K1, K2 and the whole network at 2^27 at every block size the
           kernels take, in turns (default, others, others, default)
  small    the whole network at n = 2^16..2^24 at every block size
  ops      sort, stable sort_kv, hybrid sort, sort_rows, i64 sort, merge
           at 2^27, and sort / stable sort_kv at 2^18, 2^20, 2^22
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import unittest.mock
from pathlib import Path

import numpy as np
import torch

import sortx_torch
from sortx_torch.ops import _build
from sortx_torch.ops import bitonic as tb

N = 1 << 27
SETS = [(1, 1), (2, 2), (3, 2), (4, 2)]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def time_ms(run, setup=None, reps: int = 5) -> dict:
    """Median, least and most of reps CUDA-event timings of run(), each
    after an untimed setup(); one warm-up."""
    times = []
    for rep in range(reps + 1):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        if rep:
            times.append(start.elapsed_time(end))
    return {"ms": statistics.median(times), "min": min(times),
            "max": max(times)}


_KERNEL = (r"\w*?\d(bitonic_(?:block|tail|global)\w*?_kernel)"
           r"I((?:L[ib]\d+E)+)")


def _kernel_name(match) -> str:
    """bitonic_block_kernel<ns,nk,e> from a mangled name's match."""
    return match.group(1) + "<" + ",".join(
        re.findall(r"L[ib](\d+)E", match.group(2))) + ">"


def ptxas(where: str) -> None:
    src = next(s for s in _build.SOURCES if s.name == "bitonic.cu")
    nvcc = _build.nvcc_path()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
             f"{tmp}/bitonic.o"],
            check=True, capture_output=True, text=True).stderr
        seconds = time.perf_counter() - t0
        sass = subprocess.run(
            [str(Path(nvcc).with_name("cuobjdump")), "-sass",
             f"{tmp}/bitonic.o"], check=True, capture_output=True,
            text=True).stdout
    counts, fn = {}, None   # SASS lines, branches, shuffles, barriers
    for line in sass.splitlines():
        m = re.search("Function : " + _KERNEL, line)
        if m:
            fn = _kernel_name(m)
            counts[fn] = [0, 0, 0, 0]
        elif fn and re.search(r"/\*[0-9a-f]{4}\*/", line):
            counts[fn][0] += 1
            counts[fn][1] += " BRA " in line
            counts[fn][2] += "SHFL" in line
            counts[fn][3] += "BAR.SYNC" in line
    rows, name = [], None
    for line in out.splitlines():
        m = re.search("Function properties for " + _KERNEL, line)
        if m:
            name = _kernel_name(m)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                          line)
        if spill and name:
            stack = int(spill.group(1))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            rows.append((name, int(regs.group(1)), stack))
            name = None
    design = {k: v for k, v in counts.items()
              if "global" not in k and "layers" not in k}
    for name, (_, _, _, barriers) in design.items():
        ns, _, e = (int(a) for a in name[name.index("<") + 1:-1].split(","))
        top = tb.design_top(ns, e)
        if "tail" in name:
            want = sum(p.relayout for p in tb.tail_schedule(top, e))
        else:       # the stage loop is not unrolled: one stage's changes
            want = sum(p.relayout for p in tb.block_schedule(top, e)
                       if p.stage == top)
        if barriers != want:
            raise RuntimeError(f"{name}: {barriers} barriers in SASS, the "
                               f"schedule states {want}")
    emit(phase="ptxas", card=where, seconds=seconds, kernels=len(rows),
         spilling=[r for r in rows if r[2]],
         registers={r[0]: r[1] for r in rows if "global" not in r[0]},
         sass_lines_branches_shuffles_barriers=design)


def dup_words(gen, shape, dev) -> torch.Tensor:
    """Duplicate-heavy u32 words, so comparisons tie often."""
    return (torch.randint(0, 64, shape, device=dev, generator=gen,
                          dtype=torch.int64) * 0x1000193).to(torch.int32)


def check(where: str) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = 0
    for ns, nk in sorted(tb.STREAM_SETS):
        narrow = (ns, nk) in tb.NARROW_SETS
        for lb in range(1, 16):
            if 4 * ns << lb > tb.SMEM_MAX:
                continue
            n = 8 << lb
            buf = dup_words(gen, (ns, n + 4), dev)
            runs = [("block", (n, nk, lb)),
                    ("tail", (n, nk, lb, lb + 1)), ("tail", (n, nk, lb, lb + 3))]
            if narrow:
                runs += [("block", (n, nk, lb, r))
                         for r in sorted({lb, max(lb - 2, 1), 1})]
                runs += [("tail", (n, nk, lb, lb, True)),
                         ("tail", (n, nk, lb, lb + 2, True))]
            # offset 1: streams off the 16-byte grid
            for off in (0, 1) if lb in (3, 10, 12) else (0,):
                for kind, args in runs:
                    fn, plain = tb.KERNELS["bitonic_" + kind]
                    got = buf[:, off:off + n].clone() if off == 0 else \
                        buf.clone()[:, off:off + n]
                    want = buf[:, off:off + n].clone()
                    fn(got, *args)
                    plain(want, *args)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise RuntimeError(f"FAILED {kind} ns={ns} nk={nk} "
                                           f"args={args} offset={off}")
                    cases += 1
    emit(phase="check", card=where, cases=cases, ok=True)


def stream_set(ns: int, nk: int, dev, n: int = N) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(ns * 16 + nk)
    x = torch.randint(-2**31, 2**31, (ns, n), device=dev, generator=gen,
                      dtype=torch.int64).to(torch.int32)
    if nk == 2:
        x[1] = torch.arange(n, dtype=torch.int32, device=dev)
    return x


def network_ms(x, x0, nk: int, lb: int, reps: int) -> dict:
    """The whole network at block 2^lb, whatever BLOCK_LOG says (a tree
    from before BLOCK_LOG: at most its own block)."""
    with unittest.mock.patch.dict(getattr(tb, "BLOCK_LOG", {}),
                                  {x.shape[0]: lb}):
        return time_ms(lambda: tb.bitonic_sort_streams(x, nk, log_block=lb),
                       lambda: x.copy_(x0), reps)


def kernel_times(where: str, x0, nk: int, lb: int, tag: str) -> None:
    ns = x0.shape[0]
    x = x0.clone()
    log_n = N.bit_length() - 1
    restore = lambda: x.copy_(x0)   # noqa: E731
    row = {"phase": tag, "card": where, "ns": ns, "nk": nk, "L": lb}
    for name, args in (("bitonic_block", (N, nk, lb)),
                       ("bitonic_tail", (N, nk, lb, log_n)),
                       ("bitonic_global", (N, nk, log_n, log_n - 1,
                                           log_n - tb.f_max(ns)))):
        if tag == "blocks" and name == "bitonic_global":
            continue
        fn = tb.KERNELS[name][0]
        row[name] = time_ms(lambda: fn(x, *args), restore)
    if tag == "blocks":
        row["network"] = network_ms(x, x0, nk, lb, 5)
        plan = tb.pass_plan(ns, N, nk, log_block=lb)
        row["passes"] = {k: sum(name == k for name, _ in plan)
                         for k in tb.KERNELS}
    emit(**row)


def design_blocks(ns: int) -> list:
    """The blocks 2^11.. the register design takes for ns streams."""
    return [lb for lb in range(11, 16) if tb.elems_log(ns, lb)]


def kernels(where: str) -> None:
    dev = torch.device("cuda")
    for ns, nk in SETS:
        kernel_times(where, stream_set(ns, nk, dev), nk, tb.block_log(ns),
                     "kernels")


def blocks(where: str) -> None:
    dev = torch.device("cuda")
    for ns, nk in SETS:
        x0 = stream_set(ns, nk, dev)
        default = tb.block_log(ns)
        others = [lb for lb in design_blocks(ns) if lb != default]
        for lb in [default] + others + others[::-1] + [default]:
            kernel_times(where, x0, nk, lb, "blocks")
        del x0


def small(where: str) -> None:
    """Where the grid no longer fills the card: the network by block (a
    tree from before the register design: at its own block only)."""
    dev = torch.device("cuda")
    takes = getattr(tb, "elems_log", lambda ns, lb: lb == tb.block_log(ns))
    for ns, nk in SETS:
        for log_n in (16, 18, 20, 22, 24):
            x0 = stream_set(ns, nk, dev, 1 << log_n)
            x = x0.clone()
            sizes = [lb for lb in range(9, 16)
                     if takes(ns, lb) and lb <= log_n]
            # in turns: every size upwards, then downwards
            ms = [(lb, network_ms(x, x0, nk, lb, 15)["ms"])
                  for lb in sizes + sizes[::-1]]
            emit(phase="small", card=where, ns=ns, nk=nk, log_n=log_n,
                 default=min(tb.block_log(ns), log_n),
                 network_ms_by_block={
                     lb: [t for b, t in ms if b == lb] for lb in sizes})


def ops(where: str) -> None:
    dev = torch.device("cuda")
    rng = np.random.RandomState(2)
    keys = torch.from_numpy(rng.randint(0, 2**32, size=N, dtype=np.uint32)
                            .view(np.int32)).to(dev)
    u = keys.view(torch.uint32)
    values = torch.arange(N, dtype=torch.int32, device=dev)
    hybrid = sortx_torch.Config(engine="hybrid")
    k64 = (keys.to(torch.int64) << 20) ^ values
    half = N // 2
    a, b = (torch.sort(keys[i * half:(i + 1) * half] & 0xFFFFFF).values
            .view(torch.uint32) for i in range(2))
    rows = u.view(2048, 1 << 16)
    runs = [("sort u32 2^27", lambda: sortx_torch.sort(u)),
            ("sort_kv stable u32 2^27", lambda: sortx_torch.sort_kv(u, values)),
            ("sort hybrid u32 2^27",
             lambda: sortx_torch.sort(u, config=hybrid)),
            ("sort_rows 2048 x 2^16", lambda: sortx_torch.sort_rows(rows)),
            ("sort i64 2^27", lambda: sortx_torch.sort(k64)),
            ("merge 2 x 2^26", lambda: sortx_torch.merge(a, b)),
            ("torch.sort int32 2^27", lambda: torch.sort(keys))]
    for log_n in (18, 20, 22):
        n = 1 << log_n
        runs += [(f"sort u32 2^{log_n}",
                  lambda n=n: sortx_torch.sort(u[:n])),
                 (f"sort_kv stable u32 2^{log_n}",
                  lambda n=n: sortx_torch.sort_kv(u[:n], values[:n])),
                 (f"torch.sort int32 2^{log_n}",
                  lambda n=n: torch.sort(keys[:n]))]
    for what, run in runs:
        emit(phase="ops", card=where, what=what, reps=15,
             **time_ms(run, reps=15))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_bitonic: no CUDA device")
    where = card()
    phases = [a for a in sys.argv[1:] if not a.startswith("sets=")]
    for arg in set(sys.argv[1:]) - set(phases):
        SETS[:] = [tuple(int(v) for v in pair.split(","))
                   for pair in arg[5:].split(";")]
    phases = phases or ["check", "kernels"]
    t0 = time.perf_counter()
    _build.library()
    emit(phase="build", card=where, seconds=time.perf_counter() - t0,
         tree=str(Path(sortx_torch.__file__).parent))
    for phase in phases:
        {"ptxas": ptxas, "check": check, "kernels": kernels,
         "blocks": blocks, "small": small, "ops": ops}[phase](where)


if __name__ == "__main__":
    main()
