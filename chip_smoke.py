"""Smoke run of the PyTorch port (sortx_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the kernels from sortx_torch/csrc/, checks each kernel against
its plain PyTorch version bit for bit on every pass of the network's
pass plan at the main path's stream sets and sizes, drives the flagship
path (sort, sort_kv, scan and entry at n = 2^27 u32 keys, 512 MB per
stream) through the public API, checks every result against torch.sort / torch.cumsum
on the same tensors, shows through the kernels' launch counters that
the path ran on them, and times the path and each kernel with CUDA
events. Every check raises on failure: the exit code is 0 only if all
passed. The last line is a JSON object naming the device. Without a
CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

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
from sortx_torch.ops.scan import scan_plain, tile_scan

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
}


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


def walk_plan(x: torch.Tensor, nk: int, nv: int, err: dict) -> int:
    """Run the network's pass plan on x, each pass through its kernel and,
    on a copy of the same input, through its plain version; the two must
    agree bit for bit. Returns the number of passes."""
    plan = tb.pass_plan(*x.shape, nk, nv)
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
                               f"args={args} == plain")
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
    return err


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
    torch.cuda.synchronize()
    counts = {name: _build.launches[name] for name in KERNELS}
    print(f"launches on the main path: {counts}")
    check(all(c > 0 for c in counts.values()),
          "every kernel launched on the main path")
    return counts


def timings(dev, card: str, err: dict) -> dict:
    """Phase 4: CUDA-event medians of the path and of each kernel; each
    kernel's timed output is held against its plain version's."""
    torch.cuda.empty_cache()    # drop the earlier phases' cached blocks
    rng = np.random.RandomState(SEED + 2)
    keys = words(rng, N, dev)
    u = keys.view(torch.uint32)
    values = torch.arange(N, dtype=torch.int32, device=dev)

    def line(what, times, per=None):
        """Print the median of times (ms), its rate and its range."""
        ms = statistics.median(times)
        rate = f" = {per / (ms / 1e3):.6g}/s" if per else ""
        print(f"time {what}: {ms!r} ms{rate} (min {min(times)!r}, max "
              f"{max(times)!r}, {len(times)} runs) [{card}]", flush=True)
        return ms

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


def main() -> None:
    card = header()
    dev = torch.device("cuda", 0)
    err = kernel_checks(dev)
    counts = main_path(dev)
    ms = timings(dev, card, err)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": err[name], "ms": ms[name][0],
                "plain_ms": ms[name][1]}
               for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
