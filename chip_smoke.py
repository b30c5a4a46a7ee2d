"""Smoke run of the PyTorch port (sortx_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the kernels from sortx_torch/csrc/ (one nvcc per source, side
by side) and checks each kernel against its plain PyTorch version bit
for bit at the shapes its paths give it: every pass of the network's
pass plan, full and in rows mode, the histogram, and both run movers.
Then it drives each path through the public API at full size (n = 2^27
u32 keys, 512 MB per stream, or 2048 rows of 2^16):

  flagship   sort, sort_kv, scan and entry (the network engine)
  hybrid     sort and sort_kv under Config(engine="hybrid"), and a skewed
             input that takes its overflow branch
  rows       sort_rows and sort_kv_rows
  select     histogram, kth_value, median and top_k
  movers     apply_runs on a radix-style piece plan

Every result is checked against torch (torch.sort, torch.cumsum,
torch.bincount, torch.topk) or numpy on the same input. Each path runs
with the kernels' launch counters set to 0 just before it and read just
after, and fails if one of its kernels never launched. Then it times
each path beside its torch counterpart, and each kernel beside its
plain version, with CUDA events. Every check raises on failure: the
exit code is 0 only if all passed. The last line is a JSON object
naming the device. Without a CUDA device it exits non-zero before
printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import sortx_torch
from sortx_torch.ops import _build
from sortx_torch.ops import bitonic as tb
from sortx_torch.ops import sort_hybrid as hy
from sortx_torch.ops.radix_kernels import histogram_plain, tile_histogram
from sortx_torch.ops.scan import scan_plain, tile_scan
from sortx_torch.ops.shuffle import (apply_runs, apply_runs_plain,
                                     build_piece_plan, move_runs,
                                     move_runs_plain)

N = 1 << 27            # the reference's headline size
RAGGED = (1 << 26) + 13
SEED = 0

KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "bitonic_block": ("sortx_torch/csrc/bitonic.cu",
                      "sortx/ops/bitonic.py:304"),
    "bitonic_tail": ("sortx_torch/csrc/bitonic.cu",
                     "sortx/ops/bitonic.py:401"),
    "bitonic_global": ("sortx_torch/csrc/bitonic.cu",
                       "sortx/ops/bitonic.py:437"),
    "scan": ("sortx_torch/csrc/scan.cu", "sortx/ops/scan.py:96"),
    "histogram": ("sortx_torch/csrc/histogram.cu",
                  "sortx/ops/radix_kernels.py:78"),
    "run_mover": ("sortx_torch/csrc/shuffle.cu", "sortx/ops/shuffle.py:277"),
    "piece_mover": ("sortx_torch/csrc/shuffle.cu",
                    "sortx/ops/shuffle.py:107"),
}
NETWORK = ("bitonic_block", "bitonic_tail", "bitonic_global")
ROWS = (2048, 1 << 16)      # bench.py's sort_rows shape
RAGGED_ROWS = (2048, 50_000)
HYBRID = sortx_torch.Config(engine="hybrid")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED {what}")
    print(f"ok   {what}", flush=True)


def u64(x: torch.Tensor) -> torch.Tensor:
    """Unsigned values of 32-bit words, as int64."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((u64(a) - u64(b)).abs().max())


def time_ms(run, setup=None, reps: int = 5) -> list:
    """CUDA-event times (ms) of reps calls of run() after one warm-up;
    setup() (not timed) restores the inputs of an in-place run before
    each call."""
    if setup:
        setup()
    run()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def words(rng, n: int, dev) -> torch.Tensor:
    """n random u32 words (as int32) on the card."""
    return torch.from_numpy(rng.randint(0, 2**32, size=n, dtype=np.uint32)
                            .view(np.int32)).to(dev)


def header() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this run needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc: "
          f"{nvcc.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s: "
          f"{[s.name for s in _build.SOURCES]}", flush=True)
    return card


def stream_set(rng, dev, ns: int, nk: int, n: int, nv: int) -> torch.Tensor:
    """An (ns, n) buffer shaped like the network's stream set with ns
    streams and nk keys, padded with 0xFFFFFFFF from nv: (key), (key,
    value) with duplicate-heavy keys, or (key, idx, value)."""
    x = torch.full((ns, n), -1, dtype=torch.int32, device=dev)
    for t in range(ns):
        x[t, :nv] = words(rng, nv, dev)
    if ns == 2:
        x[0, :nv] &= 0xFFFF
    if nk == 2:
        x[1, :nv] = torch.randperm(nv, device=dev, dtype=torch.int32)
    return x


def walk_plan(x: torch.Tensor, nk: int, nv: int, err: dict,
              row_log: int | None = None) -> int:
    """Run the network's pass plan on x (in rows mode with row_log), each
    pass through its kernel and, on a copy of the same input, through its
    plain version; the two must agree bit for bit. Returns the number of
    passes."""
    plan = tb.pass_plan(*x.shape, nk, nv, row_log=row_log)
    for name, args in plan:
        fn, plain = tb.KERNELS[name]
        want = x.clone()
        plain(want, *args)
        fn(x, *args)
        torch.cuda.synchronize()
        err[name] = max(err[name], max_abs_err(x, want))
        if not torch.equal(x, want):
            raise RuntimeError(f"chip_smoke: FAILED {name} ns={x.shape[0]} "
                               f"nk={nk} n={x.shape[1]} n_valid={nv} "
                               f"row_log={row_log} args={args} == plain")
        del want
    return len(plan)


def kernel_checks(dev) -> dict:
    """Phase 2: each kernel against its plain version, bit for bit, on
    every pass the main path launches, at its stream sets and sizes."""
    rng = np.random.RandomState(SEED)
    err = dict.fromkeys(KERNELS, 0)
    for ns, nk, n, nv, what in (
            (1, 1, 1 << 20, 1 << 20, "keys-only"),
            (3, 2, 1 << 20, 1 << 20, "stable KV"),
            (1, 1, N, N, "keys-only sort"),
            (2, 1, N, N, "unstable KV / packed sort_bits=4"),
            (3, 2, N, N, "stable KV"),
            (2, 2, N, N, "top_k k=1024 with indices: sort_u64"),
            (2, 2, N >> 4, N >> 4,
             "top_k k=64 with indices: sort_u64 of the candidates"),
            (1, 1, N, RAGGED, "ragged keys-only sort"),
            (3, 2, N, RAGGED, "ragged stable KV")):
        x = stream_set(rng, dev, ns, nk, n, nv)
        keys = torch.sort(u64(x[0])).values
        passes = walk_plan(x, nk, nv, err)
        check(torch.equal(u64(x[0]), keys),
              f"{what}: ns={ns} nk={nk} n={n} n_valid={nv}, all {passes} "
              "passes == plain, and the keys sorted")
        del x, keys
    for size in (N, 1 << 20, (1 << 20) + 13):
        # magnitudes near 2^31, so the running sum wraps
        x = torch.from_numpy(rng.randint(2**30, 2**31, size=size).astype(
            np.int32)).to(dev)
        x[::3] = -x[::3]
        for inclusive in (False, True):
            out, total = tile_scan(x, inclusive=inclusive)
            pout, ptotal = scan_plain(x, inclusive)
            torch.cuda.synchronize()
            err["scan"] = max(err["scan"], max_abs_err(out, pout),
                              max_abs_err(total.view(1), ptotal.view(1)))
            check(torch.equal(out, pout) and torch.equal(total, ptotal),
                  f"scan n={size} inclusive={inclusive} == plain")
    rows_walks(rng, dev, err)
    histogram_checks(rng, dev, err)
    mover_checks(dev, err)
    return err


def rows_walks(rng, dev, err: dict) -> None:
    """K1-K3 in rows mode: the pass plans of sort_rows / sort_kv_rows
    (2048 x 2^16), top_k's tournament rows (2^17 x 1024, keys alone and
    with indices) and the hybrid's
    phases at 2^27 (A: 64 tiles of 2^21; B: 564 buckets of 2^18), each
    pass against its plain version; then every row must be sorted."""
    # n = 2^27 keys, or the hybrid's phase shapes for it
    S, L, B, cap, _, _ = hy._params(N, HYBRID)
    log_l, log_cap = L.bit_length() - 1, cap.bit_length() - 1
    log_row = ROWS[1].bit_length() - 1
    for ns, nk, n, row_log, what in (
            (1, 1, N, log_row, "sort_rows"),
            (3, 2, N, log_row, "sort_kv_rows"),
            (1, 1, N, 10, "top_k rows of 1024"),
            (3, 2, N, 10, "top_k tournament with indices, rows of 1024"),
            (1, 1, S * L, log_l, f"hybrid phase A keys, {S} x {L}"),
            (3, 2, S * L, log_l, "hybrid phase A stable KV"),
            (1, 1, B * cap, log_cap, f"hybrid phase B keys, {B} x {cap}"),
            (3, 2, B * cap, log_cap, "hybrid phase B stable KV"),
            (4, 2, N >> 3, log_row, "4 streams (partial-bit KV phases)")):
        x = stream_set(rng, dev, ns, nk, n, n)
        passes = walk_plan(x, nk, n, err, row_log)
        rows = ordered(x[0]).view(-1, 1 << row_log)
        check(bool((rows[:, 1:] >= rows[:, :-1]).all()),
              f"rows mode, {what}: ns={ns} nk={nk} n={n} row_log={row_log}, "
              f"all {passes} passes == plain, and every row sorted")
        del x, rows


def histogram_checks(rng, dev, err: dict) -> None:
    """K5 against its plain version at 2^27 and at a ragged n, for the
    digits 8 bits at 24 and 4 bits at 30, on uniform and skewed words."""
    for n in (N, N - 12345):
        x = words(rng, n, dev)
        for skew in (False, True):
            if skew:    # kth_value's later rounds: most words in bucket 0
                x[: n - 1000] = 0
            for bits, shift in ((8, 24), (4, 30)):
                got = tile_histogram(x, shift, radix=1 << bits,
                                     tile_elems=16384)
                want = histogram_plain(x, shift, 1 << bits, 16384)
                torch.cuda.synchronize()
                err["histogram"] = max(err["histogram"],
                                       max_abs_err(got, want))
                check(torch.equal(got, want),
                      f"histogram n={n} bits={bits} shift={shift} "
                      f"skewed={skew} == plain")
        del x


def hybrid_tables(rng, dev, ns: int):
    """The hybrid's own state at 2^27 after phase A: the sorted tiles of
    its keys-only stream set (ns = 1), its stable KV set (ns = 2: key,
    value) or its partial-bit KV set (ns = 3: masked key, key, value),
    and the partition's run table."""
    S, L, B, cap, chunk, alpha = hy._params(N, HYBRID)
    keys = words(rng, N, dev)
    streams = {1: [keys], 2: [keys, words(rng, N, dev)],
               3: [keys & 0xFFFFFF, keys, words(rng, N, dev)]}[ns]
    tiles = hy._phase_rows([s.view(S, L) for s in streams], HYBRID)
    return tiles, hy._partition(tiles[0], B, cap, alpha), (B, cap, chunk)


def mover_checks(dev, err: dict) -> None:
    """K6 on the hybrid's partition and compaction tables at 2^27, with
    one, two and three streams (keys; stable KV; partial-bit KV); K7 on
    a radix-16 piece plan at 2^27."""
    rng = np.random.RandomState(SEED + 3)
    for ns in (1, 2, 3):
        tiles, (rs, rd, rl, tot), (B, cap, chunk) = hybrid_tables(
            rng, dev, ns)
        fills = (-1,) + (0,) * (ns - 1)
        flat = tuple(t.reshape(-1) for t in tiles)
        moved = move_runs(flat, rs, rd, rl, B * cap, fills=fills,
                          chunk=chunk)
        want = move_runs_plain(flat, rs, rd, rl, B * cap, fills)
        bucket_start = torch.cumsum(tot, 0, dtype=torch.int32) - tot
        starts = torch.arange(B, dtype=torch.int32, device=dev) * cap
        out = move_runs(moved, starts, bucket_start, tot, N, fills=fills,
                        chunk=chunk)
        out_want = move_runs_plain(moved, starts, bucket_start, tot, N,
                                   fills)
        torch.cuda.synchronize()
        for got, ref in zip(moved + out, want + out_want):
            err["run_mover"] = max(err["run_mover"], max_abs_err(got, ref))
        check(all(torch.equal(a, b) for a, b in zip(moved + out,
                                                    want + out_want)),
              f"run_mover: the hybrid's partition ({rs.shape[0]} runs into "
              f"{B} x {cap}) and compaction ({B} runs) at n={N}, {ns} "
              "stream(s), == plain")
        del tiles, flat, moved, want, out, out_want
    src, plan, runs = radix_plan(rng, dev)
    got = apply_runs(src, plan, N)
    want = apply_runs_plain(src, plan, N)
    torch.cuda.synchronize()
    err["piece_mover"] = max_abs_err(got, want)
    check(torch.equal(got, want),
          f"piece_mover: {len(plan['piece_src'])} pieces of a radix-16 plan "
          f"at n={N} == plain")


def radix_plan(rng, dev, tiles: int = 256, radix: int = 16):
    """One radix pass's shuffle at 2^27: each tile grouped by its digit
    (stable), and the runs that concatenate the groups digit-major.
    Returns (src, piece plan, (starts, dsts, lens))."""
    keys = words(rng, N, dev)
    tile = N // tiles
    digit = (keys & (radix - 1)).to(torch.int64)
    tid = torch.arange(N, device=dev) // tile
    src = keys[torch.sort(tid * radix + digit, stable=True).indices]
    counts = torch.bincount(tid * radix + digit, minlength=tiles * radix
                            ).view(tiles, radix).cpu().numpy()
    local_off = np.cumsum(counts, axis=1) - counts
    tile_prefix = np.cumsum(counts, axis=0) - counts
    col_prefix = np.cumsum(counts.sum(0)) - counts.sum(0)
    starts = (np.arange(tiles)[:, None] * tile + local_off).T.reshape(-1)
    dsts = (col_prefix[:, None] + tile_prefix.T).reshape(-1)
    lens = counts.T.reshape(-1)
    return src, build_piece_plan(starts, dsts, lens, N), (starts, dsts, lens)


def ordered(x: torch.Tensor) -> torch.Tensor:
    """int32 words whose signed order is the unsigned order of x."""
    return x.view(torch.int32) ^ -(1 << 31)


def main_path(dev) -> dict:
    """Phase 3: the flagship path at 2^27 through the public API."""
    rng = np.random.RandomState(SEED + 1)
    keys = words(rng, N, dev).view(torch.uint32)
    k64 = u64(keys)
    ref = torch.sort(k64, stable=True)

    _build.launches.clear()
    out = sortx_torch.sort(keys)
    check(torch.equal(u64(out), ref.values), f"sort u32 n={N} == torch.sort")
    del out
    values = torch.arange(N, dtype=torch.int32, device=dev)
    ks, vs = sortx_torch.sort_kv(keys, values)
    check(torch.equal(u64(ks), ref.values)
          and torch.equal(vs, values[ref.indices]),
          f"stable sort_kv n={N} == torch.sort(stable=True) + gather")
    del ks, vs
    uvals = words(rng, N, dev)
    ks, vs = sortx_torch.sort_kv(keys, uvals, stable=False)

    def pairs(k, v):
        return torch.sort((k.view(torch.int32).to(torch.int64) << 32)
                          | (v.to(torch.int64) & 0xFFFFFFFF)).values
    check(torch.equal(u64(ks), ref.values)
          and torch.equal(pairs(ks, vs), pairs(keys, uvals)),
          f"unstable sort_kv n={N}: keys == torch.sort, (key, value) "
          "multiset kept")
    del ks, vs, uvals

    rk, rv = keys[:RAGGED], values[:RAGGED]
    rref = torch.sort(k64[:RAGGED], stable=True)
    check(torch.equal(u64(sortx_torch.sort(rk)), rref.values),
          f"sort u32 n={RAGGED} == torch.sort")
    ks, vs = sortx_torch.sort_kv(rk, rv)
    check(torch.equal(u64(ks), rref.values)
          and torch.equal(vs, rv[rref.indices]),
          f"stable sort_kv n={RAGGED} == torch.sort(stable=True) + gather")
    del ks, vs, rref

    p4 = torch.sort(k64 & 0xF, stable=True).indices
    check(torch.equal(sortx_torch.sort(keys, 4).view(torch.int32),
                      keys.view(torch.int32)[p4]),
          f"sort u32 sort_bits=4 (packed) n={N} == stable torch.sort of "
          "the low bits")
    del p4
    ki = keys.view(torch.int32)
    check(torch.equal(sortx_torch.sort(ki), torch.sort(ki).values),
          f"sort i32 n={N} == torch.sort")
    kf = torch.from_numpy(rng.randn(N).astype(np.float32)).to(dev)
    check(torch.equal(sortx_torch.sort(kf), torch.sort(kf).values),
          f"sort f32 n={N} == torch.sort")
    del kf
    check(torch.equal(u64(sortx_torch.sort(keys, descending=True)),
                      ref.values.flip(0)),
          f"sort u32 descending n={N} == torch.sort reversed")

    ks, vs, s, total = sortx_torch.entry(keys, values)
    ps, ptotal = scan_plain(ks.view(torch.int32))
    check(torch.equal(u64(ks), ref.values)
          and torch.equal(vs, values[ref.indices])
          and torch.equal(s, ps)
          and int(total) & 0xFFFFFFFF == int(k64.sum()) & 0xFFFFFFFF,
          f"entry(): sort_kv then scan n={N}, total == sum of keys mod 2^32")
    return read_launches("flagship", NETWORK + ("scan",))


def read_launches(path: str, kernels) -> dict:
    """The launch counts of the path just run; each of its kernels must
    have launched."""
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    print(f"launches on the {path} path: {counts}")
    check(all(counts.get(k, 0) > 0 for k in kernels),
          f"the {path} path launched {', '.join(kernels)}")
    return counts


def hybrid_path(dev) -> dict:
    """Phase 4: sort and stable sort_kv at 2^27 under engine="hybrid",
    on uniform keys (the engine branch), and keys drawn from
    {3, 0xFFFFFFFF} (a bucket overflows: the network sorts)."""
    rng = np.random.RandomState(SEED + 4)
    keys = words(rng, N, dev).view(torch.uint32)
    values = torch.arange(N, dtype=torch.int32, device=dev)
    ref = torch.sort(u64(keys), stable=True)
    _build.launches.clear()
    out = sortx_torch.sort(keys, config=HYBRID)
    check(hy.last_dispatch == "hybrid"
          and torch.equal(u64(out), ref.values),
          f"hybrid sort u32 n={N}: the engine branch ran, == torch.sort")
    del out
    ks, vs = sortx_torch.sort_kv(keys, values, config=HYBRID)
    check(hy.last_dispatch == "hybrid" and torch.equal(u64(ks), ref.values)
          and torch.equal(vs, values[ref.indices]),
          f"hybrid stable sort_kv n={N}: the engine branch ran, == "
          "torch.sort(stable=True) + gather")
    counts = read_launches("hybrid", NETWORK + ("run_mover",))
    del ks, vs, ref
    two = torch.tensor([3, -1], dtype=torch.int32, device=dev)[
        torch.randint(0, 2, (N,), device=dev)]
    out = sortx_torch.sort(two.view(torch.uint32), config=HYBRID)
    check(hy.last_dispatch == "hybrid-overflow"
          and torch.equal(u64(out), torch.sort(u64(two)).values),
          f"hybrid sort of {N} keys from {{3, 0xFFFFFFFF}}: the overflow "
          "branch ran, == torch.sort")
    return counts


def rows_path(dev) -> dict:
    """Phase 5: sort_rows and sort_kv_rows on 2048 x 2^16 (and a ragged
    2048 x 50000) against torch.sort(dim=1, stable=True)."""
    rng = np.random.RandomState(SEED + 5)
    _build.launches.clear()
    for B, L in (ROWS, RAGGED_ROWS):
        keys = words(rng, B * L, dev).view(B, L)
        keys[:, ::7] &= 0xFF          # ties, so stability shows
        values = torch.arange(B * L, dtype=torch.int32, device=dev).view(B, L)
        ref = torch.sort(u64(keys), dim=1, stable=True)
        out = sortx_torch.sort_rows(keys.view(torch.uint32))
        check(torch.equal(u64(out), ref.values),
              f"sort_rows {B} x {L} == torch.sort(dim=1)")
        ks, vs = sortx_torch.sort_kv_rows(keys.view(torch.uint32), values)
        check(torch.equal(u64(ks), ref.values)
              and torch.equal(vs, values.gather(1, ref.indices)),
              f"sort_kv_rows {B} x {L} == torch.sort(dim=1, stable=True) "
              "+ gather")
        del keys, values, ref, out, ks, vs
    return read_launches("rows", NETWORK)


def select_path(dev) -> dict:
    """Phase 6: histogram, kth_value, median and top_k at 2^27."""
    rng = np.random.RandomState(SEED + 6)
    keys = words(rng, N, dev).view(torch.uint32)
    k64 = u64(keys)
    _build.launches.clear()
    hist = sortx_torch.histogram(keys, 8, 24)
    check(torch.equal(hist.to(torch.int64),
                      torch.bincount(k64 >> 24, minlength=256)),
          f"histogram 8 bits at 24, n={N} == torch.bincount")
    srt = torch.sort(k64).values
    for k in (0, 12345, N // 3, N - 1):
        check(int(u64(sortx_torch.kth_value(keys, k))) == int(srt[k]),
              f"kth_value k={k} n={N} == torch.sort(...)[k]")
    check(int(u64(sortx_torch.median(keys))) == int(srt[(N - 1) // 2]),
          f"median n={N} == torch.sort(...)[(n-1)//2]")
    del srt
    ki = keys.view(torch.int32)
    for k in (64, 1024):
        vals = sortx_torch.top_k(ki, k)
        check(torch.equal(vals, torch.topk(ki, k).values),
              f"top_k k={k} n={N} values == torch.topk")
    dup = (ki & 0xFFF) - 2048             # duplicate-heavy, signed
    first = torch.sort(-dup.to(torch.int64), stable=True).indices
    for k in (64, 1024):
        vals, idx = sortx_torch.top_k(dup, k, return_indices=True)
        check(torch.equal(idx.to(torch.int64), first[:k])
              and torch.equal(vals, dup[first[:k]]),
              f"top_k k={k} n={N} duplicate-heavy, with indices == the "
              "first k of a stable torch.sort of the complemented keys")
    return read_launches("select", NETWORK + ("histogram",))


def movers_path(dev) -> dict:
    """Phase 7: apply_runs on a radix-16 piece plan at 2^27 against the
    numpy run loop."""
    rng = np.random.RandomState(SEED + 7)
    src, plan, runs = radix_plan(rng, dev)
    _build.launches.clear()
    out = apply_runs(src, plan, N)
    counts = read_launches("movers", ("piece_mover",))
    host = src.cpu().numpy()
    want = np.empty_like(host)
    for s, d, ln in zip(*runs):
        want[d:d + ln] = host[s:s + ln]
    check(np.array_equal(out.cpu().numpy(), want),
          f"apply_runs n={N}, {len(runs[0])} runs == the numpy run loop")
    return counts


def time_line(card: str, what: str, times, per=None) -> float:
    """Print the median of times (ms), its rate and its range."""
    ms = statistics.median(times)
    rate = f" = {per / (ms / 1e3):.6g}/s" if per else ""
    print(f"time {what}: {ms!r} ms{rate} (min {min(times)!r}, max "
          f"{max(times)!r}, {len(times)} runs) [{card}]", flush=True)
    return ms


def timings(dev, card: str, err: dict) -> dict:
    """Phase 8: CUDA-event medians of the flagship path and of K1-K4;
    each kernel's timed output is held against its plain version's."""
    torch.cuda.empty_cache()    # drop the earlier phases' cached blocks
    rng = np.random.RandomState(SEED + 2)
    keys = words(rng, N, dev)
    u = keys.view(torch.uint32)
    values = torch.arange(N, dtype=torch.int32, device=dev)

    def line(what, times, per=None):
        return time_line(card, what, times, per)

    line(f"sortx_torch.sort u32 n={N} keys",
         time_ms(lambda: sortx_torch.sort(u)), N)
    line(f"torch.sort int32 n={N} keys", time_ms(lambda: torch.sort(keys)), N)
    line(f"sortx_torch.sort_kv stable u32 n={N} keys",
         time_ms(lambda: sortx_torch.sort_kv(u, values)), N)
    line(f"sortx_torch.sort_kv unstable u32 n={N} keys",
         time_ms(lambda: sortx_torch.sort_kv(u, values, stable=False)), N)
    line(f"torch.sort(stable=True) + gather int32 n={N} keys",
         time_ms(lambda: values[torch.sort(keys, stable=True).indices]), N)
    line(f"sortx_torch.scan int32 n={N} elements",
         time_ms(lambda: sortx_torch.scan(keys)), N)
    line(f"torch.cumsum int32->int64 n={N} elements",
         time_ms(lambda: torch.cumsum(keys, 0)), N)

    ms = {}
    log_n = N.bit_length() - 1
    for ns, nk in ((1, 1), (3, 2)):
        x0 = torch.stack([keys] + [values] * (ns - 1))
        x = x0.clone()
        lb = tb.block_log(ns)
        restore = lambda: x.copy_(x0)   # noqa: E731
        for name, args in (
                ("bitonic_block", (N, nk, lb)),
                ("bitonic_tail", (N, nk, lb, log_n)),
                ("bitonic_global",
                 (N, nk, log_n, log_n - 1, log_n - tb.F_MAX))):
            fn, plain = tb.KERNELS[name]
            k_ms = time_ms(lambda: fn(x, *args), restore)
            got = x.clone()       # the kernel's output of the last run
            p_ms = time_ms(lambda: plain(x, *args), restore, reps=3)
            torch.cuda.synchronize()
            err[name] = max(err[name], max_abs_err(got, x))
            check(torch.equal(got, x), f"{name} ns={ns} nk={nk} n={N} "
                  f"args={args[2:]}: timed kernel output == plain")
            del got
            what = f"{name} ns={ns} nk={nk} n={N} args={args[2:]}"
            k_ms = line(f"{what} kernel", k_ms)
            p_ms = line(f"{what} plain", p_ms)
            if ns == 1:       # the keys-only sort's shapes
                ms[name] = (k_ms, p_ms)
        del x, x0
    k_ms = time_ms(lambda: tile_scan(keys))
    p_ms = time_ms(lambda: scan_plain(keys))
    ms["scan"] = (line(f"scan kernel n={N}", k_ms, N),
                  line(f"scan plain n={N}", p_ms, N))
    return ms


def timed_kernel(card: str, what: str, run, plain, err: dict, name: str,
                 setup=None):
    """Time a kernel's wrapper and its plain version on the same inputs
    (setup, untimed, restores them for an in-place run), and hold the
    timed outputs equal. Returns (kernel ms, plain ms)."""
    k_ms = time_ms(run, setup)
    got = [g.clone() for g in _outputs(setup, run)]
    p_ms = time_ms(plain, setup, reps=3)
    want = _outputs(setup, plain)
    torch.cuda.synchronize()
    err[name] = max(err[name], max(max_abs_err(g, w)
                                   for g, w in zip(got, want)))
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{what}: timed kernel output == plain")
    return (time_line(card, f"{what} kernel", k_ms),
            time_line(card, f"{what} plain", p_ms))


def _outputs(setup, run) -> tuple:
    """run()'s output (after setup()) as a tuple of tensors."""
    if setup is not None:
        setup()
    out = run()
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def slice2_timings(dev, card: str, err: dict) -> dict:
    """Phase 9: CUDA-event medians of the hybrid, rows, select and mover
    paths beside their torch counterparts; the new kernels and the rows
    mode of K1-K3 beside their plain versions; and where the hybrid's
    time goes."""
    torch.cuda.empty_cache()
    rng = np.random.RandomState(SEED + 9)
    keys = words(rng, N, dev)
    u = keys.view(torch.uint32)
    values = torch.arange(N, dtype=torch.int32, device=dev)
    ms = {}

    def line(what, times, per=None):
        return time_line(card, what, times, per)

    line(f"sortx_torch.sort hybrid u32 n={N} keys",
         time_ms(lambda: sortx_torch.sort(u, config=HYBRID)), N)
    line(f"sortx_torch.sort_kv hybrid stable u32 n={N} keys",
         time_ms(lambda: sortx_torch.sort_kv(u, values, config=HYBRID)), N)
    hybrid_breakdown(card, "keys", lambda: sortx_torch.sort(u, config=HYBRID))
    hybrid_breakdown(card, "stable KV",
                     lambda: sortx_torch.sort_kv(u, values, config=HYBRID))

    rk, rv = keys.view(ROWS), values.view(ROWS)
    shape = f"{ROWS[0]} x {ROWS[1]}"
    line(f"sortx_torch.sort_rows u32 {shape}",
         time_ms(lambda: sortx_torch.sort_rows(rk.view(torch.uint32))), N)
    line(f"torch.sort(dim=1) int32 {shape}",
         time_ms(lambda: torch.sort(rk, dim=1)), N)
    line(f"sortx_torch.sort_kv_rows u32 {shape}",
         time_ms(lambda: sortx_torch.sort_kv_rows(rk.view(torch.uint32),
                                                  rv)), N)
    line(f"torch.sort(dim=1, stable=True) + gather int32 {shape}",
         time_ms(lambda: rv.gather(1, torch.sort(rk, dim=1, stable=True)
                                   .indices)), N)

    line(f"sortx_torch.histogram 8 bits n={N}",
         time_ms(lambda: sortx_torch.histogram(u, 8, 24)), N)
    line(f"torch.bincount of the 8-bit digit n={N}",
         time_ms(lambda: torch.bincount((keys >> 24) & 0xFF,
                                        minlength=256)), N)
    k64 = u64(keys)
    line(f"sortx_torch.kth_value n={N}",
         time_ms(lambda: sortx_torch.kth_value(u, N // 3)), N)
    line(f"torch.kthvalue int64 n={N}",
         time_ms(lambda: torch.kthvalue(k64, N // 3 + 1)), N)
    del k64
    for k in (64, 1024):
        line(f"sortx_torch.top_k k={k} i32 n={N}",
             time_ms(lambda: sortx_torch.top_k(keys, k)), N)
        line(f"sortx_torch.top_k k={k} with indices i32 n={N}",
             time_ms(lambda: sortx_torch.top_k(keys, k,
                                               return_indices=True)), N)
        line(f"torch.topk k={k} int32 n={N}",
             time_ms(lambda: torch.topk(keys, k)), N)

    ms["histogram"] = timed_kernel(
        card, f"histogram n={N} bits=8 shift=24",
        lambda: tile_histogram(keys, 24, radix=256, tile_elems=16384),
        lambda: histogram_plain(keys, 24, 256, 16384), err, "histogram")
    tiles, (rs, rd, rl, _), (B, cap, chunk) = hybrid_tables(rng, dev, 1)
    flat = (tiles[0].reshape(-1),)
    ms["run_mover"] = timed_kernel(
        card, f"run_mover: the hybrid's partition n={N}, 1 stream, "
        f"{rs.shape[0]} runs into {B} x {cap}",
        lambda: move_runs(flat, rs, rd, rl, B * cap, fills=(-1,),
                          chunk=chunk),
        lambda: move_runs_plain(flat, rs, rd, rl, B * cap, (-1,)), err,
        "run_mover")
    del tiles, flat
    src, plan, _ = radix_plan(rng, dev)
    ms["piece_mover"] = timed_kernel(
        card, f"piece_mover: radix-16 plan n={N}, "
        f"{len(plan['piece_src'])} pieces",
        lambda: apply_runs(src, plan, N), lambda: apply_runs_plain(src, plan,
                                                                   N),
        err, "piece_mover")
    del src

    # rows mode of K1-K3 at the sort_rows and top_k shapes, 1 stream
    x0 = keys.view(1, N)
    x = x0.clone()
    lb = tb.block_log(1)
    restore = lambda: x.copy_(x0)   # noqa: E731
    for name, args in (("bitonic_block", (N, 1, lb, 10)),
                       ("bitonic_tail", (N, 1, lb, 16, True)),
                       ("bitonic_global", (N, 1, 16, 15, 13, True))):
        fn, plain = tb.KERNELS[name]
        timed_kernel(card, f"{name} rows mode n={N} args={args[2:]}",
                     lambda: fn(x, *args), lambda: plain(x, *args) or x,
                     err, name, setup=restore)
    return ms


def hybrid_breakdown(card: str, what: str, run, reps: int = 3) -> None:
    """Time each step of the hybrid engine (ops/sort_hybrid.py
    ``_engine``) inside the real call run(): CUDA events around each
    step, through ``sort_hybrid.step_hook``; one warm-up, then reps."""
    steps = collections.defaultdict(list)
    events = []

    @contextlib.contextmanager
    def hook(name):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        events.append((name, start, end))

    hy.step_hook = hook
    try:
        for rep in range(reps + 1):
            events.clear()
            run()
            torch.cuda.synchronize()
            for name, start, end in events if rep else ():
                steps[name].append(start.elapsed_time(end))
    finally:
        hy.step_hook = None
    check(hy.last_dispatch == "hybrid" and len(steps) == 6,
          f"hybrid {what} n={N}: the engine branch ran all six steps")
    total = sum(time_line(card, f"hybrid {what} n={N} step: {name}", times)
                for name, times in steps.items())
    print(f"time hybrid {what} n={N} steps: sum of medians {total!r} ms "
          f"[{card}]")


def main() -> None:
    t0 = time.perf_counter()
    card = header()
    dev = torch.device("cuda", 0)
    err = kernel_checks(dev)
    # each kernel's launches are read from the path it belongs to
    counts = main_path(dev)
    ms = timings(dev, card, err)    # before the other paths' allocations
    counts["run_mover"] = hybrid_path(dev)["run_mover"]
    rows_path(dev)
    counts["histogram"] = select_path(dev)["histogram"]
    counts["piece_mover"] = movers_path(dev)["piece_mover"]
    ms.update(slice2_timings(dev, card, err))
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": err[name], "ms": ms[name][0],
                "plain_ms": ms[name][1]}
               for name, (src, replaces) in KERNELS.items()]
    print(f"chip_smoke took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
