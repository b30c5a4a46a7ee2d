"""One rank's run of one cell: set-up, the window, the check, the result.

The loop is closed with one caller: issue a call, synchronise, issue
the next; a call's latency is the host clock from just before it is
issued until its synchronise returns. Calls rotate over a pool of
inputs made on the card from the seed. The window runs until its
seconds have passed (with several ranks, until rank 0 says so, so every
rank makes the same calls); in a traced run it ends with the traced
slice (``tracing.record``, a fixed count of calls) and, where the op has
step rows, a slice of calls with them on, so the untraced calls before
them run as in an untraced run.

A seeded reservoir keeps the outputs of ``checked_calls`` calls drawn
from the whole window. Once the window has closed and the peak memory
has been read, each kept output is held against the plain reference,
worked out again from inputs made anew from the seed.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import keygen, ranks, spec, tracing

BASELINE_KEYS_PER_S = 520e6     # bench.py's OCLRadixSort figure
REFERENCE_REPS = 5


def process_start_wall() -> float:
    """The wall-clock time at which this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        after_name = f.read().rsplit(")", 1)[1].split()
    started = int(after_name[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - started)


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader reads, on one rank."""

    slice: tracing.Slice | None
    enqueue_s: list            # issue to return, the window's untraced calls
    steps: dict                # the op's step rows: name -> [ms]
    step_calls: int
    keys_per_card: int
    bytes_per_key: int


@dataclasses.dataclass
class Window:
    """What an end-to-end metric's reader reads: every rank's window."""

    calls: int
    keys_per_card: int
    world: int
    window_s: list             # each rank's, first issue to last return
    latency_s: list            # rank 0's calls
    setup_s: float


class Reservoir:
    """Keeps ``k`` of the offered calls, drawn uniformly and from the
    seed alone, so every rank keeps the same calls."""

    def __init__(self, k: int, seed: int):
        self.k, self.kept = k, []
        self.rng = random.Random(keygen.stream_seed(seed, 1 << 40))

    def offer(self, i: int, j: int, outs) -> None:
        if len(self.kept) < self.k:
            self.kept.append((i, j, outs))
            return
        r = self.rng.randrange(i + 1)
        if r < self.k:
            self.kept[r] = (i, j, outs)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def _read_steps(path: str) -> dict:
    steps = collections.defaultdict(list)
    if os.path.exists(path):
        with open(path) as f:
            for row in f:
                name, ms = row.split(",")[:2]
                steps[name].append(float(ms))
    return dict(steps)


def _same_ints(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as the signed integer dtype of its width."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()])


def mismatches(outs, want, dev: torch.device) -> list:
    """Per output: the elements that differ from the reference's, bit
    for bit; an output of another type, shape or device differs in all."""
    outs = tuple(outs)
    wrong = []
    for k, w in enumerate(want):
        o = outs[k] if k < len(outs) else None
        if (not isinstance(o, torch.Tensor) or o.dtype != w.dtype
                or o.shape != w.shape or o.device != dev):
            wrong.append(int(w.numel()))
        else:
            wrong.append(int((_same_ints(o) != _same_ints(w)).sum()))
    return wrong


def _reference_ms(ref, args, n: int, dev: torch.device) -> float:
    """ms per call of the reference (``torch.sort``) on ``args``."""
    ref.expected(args, 0, n)
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(REFERENCE_REPS):
            ref.expected(args, 0, n)
        return (time.perf_counter() - t) * 1e3 / REFERENCE_REPS
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REFERENCE_REPS):
        ref.expected(args, 0, n)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REFERENCE_REPS


def run_window(call_one, pool: int, seconds: float, comm, reservoir,
               sync, trace_calls: int = 0, step_calls: int = 0,
               steps_on=None):
    """The window: returns (latencies, untraced enqueue times, the
    seconds of its untraced calls, the traced slice, the step rows)."""
    lat, enq = [], []
    t0 = time.perf_counter()
    i = 0

    def one(traced: bool) -> float:
        nonlocal i
        j = i % pool
        ta = time.perf_counter()
        outs = call_one(j)
        tb = time.perf_counter()
        sync()
        tc = time.perf_counter()
        lat.append(tc - ta)
        if not traced:
            enq.append(tb - ta)
        reservoir.offer(i, j, outs)
        i += 1
        return tc

    go = True
    while go:
        tc = one(False)
        go = comm.keep_going(tc - t0 < seconds)
    window_s = tc - t0
    sl, steps = None, {}
    if trace_calls:
        sl = tracing.record(lambda: one(True), trace_calls)
    if step_calls and steps_on is not None:
        with tempfile.TemporaryDirectory(prefix="portbench.steps.") as d:
            csv = os.path.join(d, "steps.csv")
            steps_on(csv, True)
            try:
                for _ in range(step_calls):
                    one(True)
            finally:
                steps_on(csv, False)
            steps = _read_steps(csv)
    return lat, enq, window_s, sl, steps


def _card_lines(world: int) -> list:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e}"]
    return out.strip().splitlines()[:world]


def _combine(how: str, values: list):
    values = [v for v in values if v is not None]
    if not values:
        return None
    if how == "max":
        return max(values)
    return sum(values) / len(values)


def run_rank(job: dict):
    """Run this process's rank of ``job``; returns the result's dict on
    rank 0 (None on the others), or raises.

    ``job``: workload, seed, seconds, trace, root, device ("cuda"; the
    tests give "cpu"), start (the wall time the run's first process
    started), and optionally control (run the op's control in place of
    its call) and hooks ([file, function] pairs called before set-up).
    """
    marks = [("python, torch and the harness imported", time.time())]
    root = Path(job["root"])
    cell = spec.load_cell(job["workload"], root)
    op = cell.module("ops", cell.config["op"])
    ref = cell.module("reference", cell.config["op"])
    marks.append(("port imported", time.time()))
    port = sys.modules.get("sortx_torch")
    if port is None or not Path(port.__file__).resolve().is_relative_to(
            spec.ROOT):
        raise RuntimeError(f"the port must be imported from {spec.ROOT}, "
                           f"got {getattr(port, '__file__', None)}")
    for path, fn in job.get("hooks", ()):
        getattr(spec.load_module(Path(path)), fn)()
    traffic, seed = cell.traffic, int(job["seed"])
    if job["device"] == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    sync = _sync(dev)
    state = op.setup(dev, cell.config, cell.chips)
    comm = ranks.Group(dev) if cell.chips > 1 else ranks.Solo()
    marks.append(("card and op set-up", time.time()))
    n = int(traffic["keys_per_card"])
    n_pool, keep = int(traffic["pool"]), int(traffic["checked_calls"])
    pool = [op.inputs(state, keygen.make_keys(traffic, seed, comm.rank, j,
                                              dev))
            for j in range(n_pool)]
    sync()
    marks.append(("inputs", time.time()))
    call = op.control if job.get("control") else op.call
    held = []                 # every input once; as many outputs held as
    for i in range(max(n_pool, keep + 1)):       # the window ever holds
        held.append(call(state, *pool[i % n_pool]))
        sync()
    del held
    marks.append(("warm-up", time.time()))
    comm.barrier()
    sync()
    marks.append(("ranks together", time.time()))
    setup_s = marks[-1][1] - float(job["start"])
    setup_parts = [(name, t - prev) for (name, t), prev in zip(
        marks, [float(job["start"])] + [t for _, t in marks])]

    trace = bool(int(job["trace"]))
    reservoir = Reservoir(keep, seed)
    lat, enq, window_s, sl, steps = run_window(
        lambda j: call(state, *pool[j]), n_pool, float(job["seconds"]),
        comm, reservoir, sync,
        trace_calls=int(traffic.get("trace_calls", 0)) if trace else 0,
        step_calls=int(traffic.get("step_calls", 0)) if trace else 0,
        steps_on=(lambda csv, on: op.step_rows(state, csv, on))
        if hasattr(op, "step_rows") else None)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    layer = {}
    if trace:
        reading = Reading(sl, enq, steps, int(traffic.get("step_calls", 0)),
                          n, int(op.BYTES_PER_KEY))
        for m in cell.per_layer:
            layer[m["name"]] = cell.module("metrics", m["name"]).read(reading)

    # The check, with the program's inputs and other outputs freed.
    kept = reservoir.kept
    del pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    names = ref.OUTPUTS
    wrong = [0] * len(names)
    bad_calls, args = [], None
    t = time.perf_counter()
    for i, j, outs in kept:
        glob = [keygen.make_keys(traffic, seed, r, j, dev)
                for r in range(comm.world)]
        args = op.inputs(state, torch.cat(glob) if len(glob) > 1
                         else glob[0])
        del glob
        want = ref.expected(args, comm.rank * n, (comm.rank + 1) * n)
        w = mismatches(outs, want, dev)
        wrong = [a + b for a, b in zip(wrong, w)]
        if any(w):
            bad_calls.append(i)
        del want, outs
    check_s = time.perf_counter() - t
    del kept, reservoir
    ref_ms = (_reference_ms(ref, args, n * comm.world, dev)
              if comm.rank == 0 and args is not None else None)
    del args

    # After the metric readers and the reference, this rank's last imports.
    found = spec.banned_modules(sys.modules)
    mine = {"window_s": window_s, "calls": len(lat), "peak": peak,
            "found": found, "wrong": wrong, "bad_calls": bad_calls,
            "layer": layer, "checked": min(keep, len(lat)),
            "busy_ns": tracing.busy_ns(sl) if sl else 0,
            "slice_ns": (sl.t1 - sl.t0) if sl else 0}
    every = comm.gather(mine)
    op.teardown(state)
    if comm.rank != 0:
        return None
    print("set-up: " + ", ".join(f"{name} {s!r} s"
                                 for name, s in setup_parts))
    return _result(cell, job, every, lat, setup_s, sl, check_s, ref_ms,
                   names, dev)


def refuse_banned() -> None:
    """Exit with code 1, before any result, where this process holds a
    module of jax or sortx."""
    found = spec.banned_modules(sys.modules)
    if found:
        raise SystemExit(f"portbench: modules of jax or sortx were loaded "
                         f"in the run: {found}")


def _result(cell, job, every, lat, setup_s, sl, check_s, ref_ms, names,
            dev) -> dict:
    """Rank 0's result from every rank's readings; prints the earlier
    lines on the way."""
    world = len(every)
    n = int(cell.traffic["keys_per_card"])
    found = sorted({m for e in every for m in e["found"]})
    if found:
        raise SystemExit(f"portbench: modules of jax or sortx were loaded "
                         f"in the run: {found}")
    calls = every[0]["calls"]
    for line in (_card_lines(world) if dev.type == "cuda" else ["cpu"]):
        print(f"card: {line}")
    win = Window(calls, n, world, [e["window_s"] for e in every], lat,
                 setup_s)
    print(f"window: {calls} calls of {n} keys a card on {world} card(s) in "
          f"{max(win.window_s)!r} s; set-up {setup_s!r} s; latency median "
          f"{sorted(lat)[len(lat) // 2] * 1e3!r} ms, mean "
          f"{sum(lat) / len(lat) * 1e3!r} ms")
    print(f"memory peak per card: {[e['peak'] for e in every]} bytes")
    if ref_ms is not None:
        print(f"reference (torch.sort, plain) of {n * world} keys on one "
              f"card: {ref_ms!r} ms, {n * world / ref_ms * 1e3!r} keys/s; "
              f"bench.py's baseline {BASELINE_KEYS_PER_S!r} keys/s")
    checked = sum(e["checked"] for e in every)
    print(f"checked {checked} kept outputs against the reference in "
          f"{check_s!r} s (rank 0)", flush=True)

    trace = bool(int(job["trace"]))
    metrics = {}
    if trace:
        for m in cell.per_layer:
            how = getattr(cell.module("metrics", m["name"]), "COMBINE",
                          "mean")
            v = _combine(how, [e["layer"].get(m["name"]) for e in every])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = cell.module("end_to_end", m["name"]).read(win)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    wrong = [sum(e["wrong"][k] for e in every) for k in range(len(names))]
    checks = {f"{name}_mismatch": {"value": w, "limit": 0}
              for name, w in zip(names, wrong)}
    bad = {i for e in every for i in e["bad_calls"]}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": world,
              "memory_peak_bytes": max(e["peak"] for e in every)}
    result = {"correct": checked > 0 and all(
                  c["value"] <= c["limit"] for c in checks.values()),
              "attempted": calls, "failed": len(bad), "metrics": metrics,
              "device": device}
    if trace:
        device["busy_s"] = sum(e["busy_ns"] for e in every) / world / 1e9
        device["window_s"] = sum(e["slice_ns"] for e in every) / world / 1e9
        if sl is not None:
            result["breakdown"] = {"device_ops": tracing.device_ops(sl),
                                   "idle_gaps": tracing.idle_gaps(sl)}
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result
    as the last line of standard output; no result, and exit code 1,
    where a module of jax or sortx was loaded at any point of the run
    (the end-to-end readers run after the ranks' own look)."""
    refuse_banned()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
