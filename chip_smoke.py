"""Smoke run of the PyTorch port (sortx_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the kernels from sortx_torch/csrc/ (one nvcc per source, side
by side) and checks each kernel against its plain PyTorch version bit
for bit at the shapes its paths give it: every pass of the network's
pass plan, full and in rows mode, at the wide stream sets (up to 8
streams) and in the merge stage, the scan (sizes around a tile's edges,
wrapping and all-ones words, a shifted view, 20 repeats, under two
configs' tiles), the
histogram (uniform, all-equal and two-valued words, every digit width,
per tile and whole, with and without the prefix filter), both run
movers, and the radix engine's K9 and every K10 pass (2^20, 2^27 and
2^26 + 13, keys-only and with values, full and partial sort_bits,
uniform, 16-valued and all-equal words), and the rows' radix engine's
K11 and every K12 pass (the top-p sampler's 256 x 129,280 float32
probabilities with positions, rows of one to 300 keys-only and with
values, each order map);
K1 and K2 also at the block sizes no plan reaches (the smallest the
wrappers take, the ends of the register design's range, a buffer off
the 16-byte grid). Then it drives each path through the public API at full size (n = 2^27
u32 keys, 512 MB per stream, or 2048 rows of 2^16):

  flagship   sort, sort_kv, scan and entry (the radix engine; unstable
             sort_kv on the network)
  hybrid     sort and sort_kv under Config(engine="hybrid"), and a skewed
             input that takes its overflow branch
  rows       sort_rows and sort_kv_rows (the rows' radix engine, K11
             and four K12 passes; the sampler's 256 x 129,280 float32
             probabilities descending with indices too), then the same
             calls under Config(engine="network") on the row network
  top_k_rows K13, K14 and K15 against their plain versions (rows that
             finish on their buffer and rows that read themselves
             again), then top_k_rows at DeepSeek-V3.2's indexer shape
             (4096 causal rows of 126,977 to 131,072 float32 scores, k =
             2048) against the benchmark's plain reference, with the
             times of each kernel, the call, torch.topk and the
             sort_rows route
  select     histogram, kth_value, median and top_k
  movers     apply_runs on two radix-style piece plans: a radix-16 pass
             (256 tiles x 16 digits) from its numpy plan, and an 8-bit
             pass (4096 tiles x 256 digits, about 65 pieces a chunk)
             with its plan on the card
  companions 64-bit sort / sort_kv, argsort, lexsort, sort_kv of u64 keys,
             merge / merge_kv, unique, run_length_encode, reduce_by_key,
             sum_by_key, partition, sort_segments, sort_kv_segments,
             scan_segments and scan_by_key
  runtime    ParallelPrimitives(allocate_device()) on Buffers of 2^27
             (radix_sort, radix_sort_kv of 2^26 + 13, scan with a u32
             total, check_leaks); sort_large of 2^29 host keys (2^28 if
             the host's memory is short), sort_kv_large of 2^28 + 13 f32
             keys with i32 values, sort_large(sort_bits=16,
             descending=True) at 2^28, each with the time of its steps
             (key transform, copies, device sorts, host merge); and one
             flagship entry traced by runtime.profiler, for the share of
             the traced window in which the card ran a kernel
  graph      every op of the capture list (sort over its key types,
             sort_bits, descending and ragged n; sort_kv stable and
             unstable with 32- and 64-bit values; scan; entry; argsort;
             lexsort; merge / merge_kv; sort_segments; scan_segments;
             kth_value with a rank tensor; median; top_k; unique;
             histogram; sort_rows / sort_kv_rows, also under
             engine="network") captured once into a
             CUDA graph after an eager warm-up and an eager call under
             set_sync_debug_mode("error"), then replayed on random,
             nondecreasing, nonincreasing and all-equal inputs copied
             into its static input (kth_value also on a new rank), each
             replay bit for bit the eager call on the same input; the
             main path (sort, sort_kv, scan, entry) at 2^27 and 2^26 +
             13, each eager call also held against the host engine, the
             rest at 2^22; the hybrid refusing capture; eager calls
             against replays from 2^16 to 2^27; and the traced idle
             share of a replayed entry and of a replayed sort of
             nondecreasing keys. Launch counts come from eager runs: a
             launch under capture counts once, a replay not at all
  dist       the distributed layer (sortx_torch.parallel): at world size
             1 on NCCL, dist_sort and stable dist_sort_kv at 2^27,
             dist_sort_padded at 2^26 + 13 and dist_scan, each bit for
             bit the single-card op on the same tensor; then 2 and 4
             processes sharing the card over gloo (spawned after the
             kernels are built, so they only load them), 2^26 keys in
             all and a ragged 2^26 + 13: dist_sort under "auto" (the
             radix engine and the re-sort), stable dist_sort_kv with
             int32 values (radix) and with int64 values (the tree), and
             dist_scan; the int32
             dist_sort_kv and the ragged dist_sort also under
             engine="network" (the tree); the gathered
             shards held against the single-card op of the whole input,
             every rank's launches (K9 / K10 and no network pass on the
             radix engine, K1-K3 on the network) and the branches it
             took (its witnesses and
             the launcher's step rows), the time of the whole call and
             of each step (not a scaling figure: the ranks share one
             card)
  dist cards where two or more cards are visible (else one "skipped"
             line): D = min(cards, 4) spawned ranks, one a card, each
             started as torchrun starts one and calling init_multihost()
             with no arguments (NCCL, on card LOCAL_RANK); at 2^27 keys a
             rank dist_sort under "auto" (the radix engine, the re-sort),
             stable dist_sort_kv with int32 (radix) and int64 values (the
             tree), dist_sort_padded and dist_sort_kv_padded of D * 2^27
             + 13 keys and dist_scan with its total; at 2^22 a rank
             presorted keys that take the tree's skew re-sort on the
             network, all-equal keys, descending, sort_bits=12, n < D and
             n = 0. Each case that runs the radix engine under "auto"
             (but the plain dist_sort and scan) runs again under
             engine="network" ("<case> network": the network's local
             sort, its merge tree, its position lane).
             Each rank makes the whole global array from the seed on its
             own card, runs the single-card op on it and holds its shard
             bit for bit against its slice; the parent checks every
             rank's backend, card, outputs' card, launches, witnesses and
             steps, and prints the times of the whole call, of each step
             and of the single-card op on the whole array and on one
             rank's shard

Every result is checked against torch (torch.sort, torch.cumsum,
torch.bincount, torch.topk, torch.unique) or numpy on the same input. Each path runs
with the kernels' launch counters set to 0 just before it and read just
after, and fails if one of its kernels never launched. Then it times
each path beside its torch counterpart, and each kernel beside its
plain version, its bound (the larger of its bytes over the card's memory
rate and its operations over the card's integer rate) and, where one
PyTorch call computes the same function, that call, with CUDA events
(K4-K7 and the library calls over 10 calls in a row). Every check
raises on failure: the exit code is 0 only if all passed. The last line is a JSON object
naming the device. Without a CUDA device it exits non-zero before
printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

import sortx_torch
from portbench import spec
from sortx_torch.ops import _build
from sortx_torch.ops import bitonic as tb
from sortx_torch.ops import radix as rx
from sortx_torch.ops import radix_rows as rr
from sortx_torch.ops import sort_hybrid as hy
from sortx_torch.ops import topk_rows as tk
from sortx_torch.ops.radix_kernels import histogram_plain, tile_histogram
from sortx_torch.ops.scan import scan_plain, tile_scan
from sortx_torch.ops.shuffle import (apply_runs, apply_runs_plain,
                                     build_piece_plan, move_runs,
                                     move_runs_plain)
# the signed view of a tensor's width, which (unlike uint32 and uint64 on
# the card) gathers
from sortx_torch.utils.words import int_view as iv

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
    # K8 replaces no Pallas kernel: it is the jnp.flip branch of the
    # reference's lax.cond for a nonincreasing keys-only input
    "reverse": ("sortx_torch/csrc/bitonic.cu",
                "sortx/ops/sort_pallas.py:349"),
    # K9 and K10 replace no Pallas kernel: the radix engine sorts where
    # the reference ran the network (its own algorithm, OCLRadixSort's)
    "radix_histogram": ("sortx_torch/csrc/radix.cu", "none"),
    "radix_onesweep": ("sortx_torch/csrc/radix.cu", "none"),
    # K11 and K12 replace no Pallas kernel either: the rows' radix engine
    # sorts long rows where the reference ran the network in rows mode
    "radix_rows_histogram": ("sortx_torch/csrc/radix_rows.cu", "none"),
    "radix_rows_onesweep": ("sortx_torch/csrc/radix_rows.cu", "none"),
    # K13-K15 replace no Pallas kernel: sortx has no per-row top-k
    "topk_rows_histogram": ("sortx_torch/csrc/topk_rows.cu", "none"),
    "topk_rows_gather": ("sortx_torch/csrc/topk_rows.cu", "none"),
    "topk_rows_buffer_select": ("sortx_torch/csrc/topk_rows.cu", "none"),
}
NETWORK = ("bitonic_block", "bitonic_tail", "bitonic_global")
RADIX = ("radix_histogram", "radix_onesweep")
ROWS_RADIX = ("radix_rows_histogram", "radix_rows_onesweep")
TOPK_ROWS = ("topk_rows_histogram", "topk_rows_gather",
             "topk_rows_buffer_select")
# DeepSeek-V3.2's indexer: the last 4096-token prefill chunk of a 128k
# prompt, the top 2048 of each query's causal row of float32 scores
INDEXER = (4096, 131_072, 2048)
SAMPLER = (256, 129_280)    # the top-p sampler's rows: DeepSeek-V3's vocab
# the plain reference of the benchmark's sampler cell
TOPP_REF = spec.load_module(Path(__file__).resolve().parent / "portbench" /
                            "reference" / "topp_rows.py")
# the plain reference of the benchmark's indexer cell
DSA_REF = spec.load_module(Path(__file__).resolve().parent / "portbench" /
                           "reference" / "dsa_topk.py")
# The card's peaks the bounds divide by (H100 SXM, NVIDIA's data sheet):
# device memory 3.35 TB/s; integer compare, min, max, add and select
# run outside the tensor cores on 64 INT32 lanes per SM, one operation
# a clock, against the 128 lanes at 2 operations (a fused multiply-add)
# that the sheet's 67 TFLOP/s of float32 counts: a quarter of it.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
ROWS = (2048, 1 << 16)      # bench.py's sort_rows shape
RAGGED_ROWS = (2048, 50_000)
HYBRID = sortx_torch.Config(engine="hybrid")
NET = sortx_torch.Config(engine="network")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED {what}")
    print(f"ok   {what}", flush=True)


def u64(x: torch.Tensor) -> torch.Tensor:
    """Unsigned values of 32-bit words, as int64."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((u64(a) - u64(b)).abs().max())


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time (ms) the card could take to move n_bytes through
    device memory and do n_ops integer operations, and which sets it."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def network_bound(ns: int, n: int, layers: int) -> dict:
    """A network pass over ns streams of n words: each word read and
    written once; per layer n / 2 compare-exchanges of at least 2
    operations (keys-only: a min and a max)."""
    return bound(2 * 4 * ns * n, layers * (n // 2) * 2)


def time_ms(run, setup=None, reps: int = 5, calls: int = 1) -> list:
    """CUDA-event times (ms) of reps calls of run() after one warm-up;
    setup() (not timed) restores the inputs of an in-place run before
    each call. With calls > 1 each time is that of `calls` calls in a
    row, divided by them: the host's work before a launch (during which
    the card idles when a call is timed alone) then hides behind the
    card's, which matters for a kernel of a few tenths of a ms."""
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
        for _ in range(calls):
            run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


ROW = 10    # calls in a row per timing of K4-K7 and the library calls


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
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], check=True,
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
              row_log: int | None = None, plan=None) -> int:
    """Run the network's pass plan on x (in rows mode with row_log; or
    the given plan, such as the merge stage's), each pass through its
    kernel and, on a copy of the same input, through its plain version;
    the two must agree bit for bit. Returns the number of passes."""
    plan = plan or tb.pass_plan(*x.shape, nk, nv, row_log=row_log)
    for name, args in plan:
        fn, plain = tb.KERNELS[name]
        want = x.clone()
        plain(want, *args)
        fn(x, *args)
        torch.cuda.synchronize()
        if not torch.equal(x, want):    # equal: the error stays 0
            err[name] = max(err[name], max_abs_err(x, want))
            raise RuntimeError(f"chip_smoke: FAILED {name} ns={x.shape[0]} "
                               f"nk={nk} n={x.shape[1]} n_valid={nv} "
                               f"row_log={row_log} args={args} == plain "
                               f"(max abs err {err[name]})")
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
    reverse_checks(rng, dev, err)
    scan_checks(rng, dev, err)
    rows_walks(rng, dev, err)
    histogram_checks(rng, dev, err)
    mover_checks(dev, err)
    radix_checks(rng, dev, err)
    radix_rows_checks(dev, err)
    topk_rows_checks(dev, err)
    return err


def radix_checks(rng, dev, err: dict) -> None:
    """K9 and each K10 pass against their plain versions at 2^20, 2^27
    and 2^26 + 13, keys-only and with values, at full and partial
    sort_bits (the last digit narrower), on uniform and tie-heavy keys;
    the kernels' passes must also sort."""
    for n, bits, kind, kv in ((1 << 20, 32, "uniform", True),
                              (N, 32, "uniform", False),
                              (N, 32, "uniform", True),
                              (RAGGED, 32, "uniform", True),
                              (RAGGED, 20, "16-valued", False),
                              (1 << 20, 9, "all-equal", True)):
        keys = skewed_words(rng, n, dev, kind)
        vals = torch.arange(n, dtype=torch.int32, device=dev) if kv else None
        what = f"n={n} sort_bits={bits} {kind}{' with values' if kv else ''}"
        got = rx.radix_histogram(keys, bits)
        want = rx.offsets_plain(keys, bits)
        err["radix_histogram"] = max(err["radix_histogram"],
                                     max_abs_err(got, want))
        check(torch.equal(got, want), f"radix_histogram {what} == plain")
        src, vsrc = keys, vals
        for p in range(rx.radix_passes(bits)):
            db = min(8, bits - 8 * p)
            out, vout = rx.onesweep_plain(src, 8 * p, db, want[p], vsrc)
            kout = torch.empty_like(src)
            vk = None if vals is None else torch.empty_like(vals)
            region = torch.zeros(rx.scratch_words(n, 1), dtype=torch.int32,
                                 device=dev)
            rx.radix_onesweep(src, kout, want[p].contiguous(), 8 * p, db,
                              region=region, values=vsrc, values_out=vk)
            torch.cuda.synchronize()
            ok = torch.equal(kout, out) and (vk is None
                                             or torch.equal(vk, vout))
            if not ok:
                err["radix_onesweep"] = max(err["radix_onesweep"],
                                            max_abs_err(kout, out))
            check(ok, f"radix_onesweep pass {p} {what} == plain")
            src, vsrc = kout, vk
            del out, vout, region
        order = torch.sort(u64(keys) & ((1 << bits) - 1), stable=True).indices
        check(torch.equal(src, keys[order]) and (
            vals is None or torch.equal(vsrc, vals[order])),
            f"radix passes {what} == stable torch.sort of the low bits")
        del keys, vals, src, vsrc, order


def sampler_probs(dev, seed: int) -> torch.Tensor:
    """The top-p sampler cell's float32 probabilities, a row of the
    vocabulary a sequence (the benchmark's plain reference makes them)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randint(-2**31, 2**31, (SAMPLER[0] * SAMPLER[1],),
                      dtype=torch.int32, generator=gen, device=dev)
    return TOPP_REF.probabilities(w, SAMPLER[1])


def radix_rows_checks(dev, err: dict) -> None:
    """K11 and each K12 pass against their plain versions: the sampler's
    probabilities descending with positions, and tie-heavy rows (the low
    20 bits cleared) of one to 300 keys-only and with values under each
    order map; the last pass must equal a stable torch.sort of the mapped
    words."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    for shape, kind, desc, pairs in ((SAMPLER, "f32", True, "positions"),
                                     ((1, 1_000_003), "u32", False, "keys"),
                                     ((300, 9000), "i32", True, "values"),
                                     ((5, 6145), "f32", False, "positions")):
        if shape == SAMPLER:
            keys = sampler_probs(dev, SEED + 12).view(torch.int32)
        else:
            keys = cwords(gen, shape[0] * shape[1], dev).view(shape) \
                & (-1 << 20)
        R, L = shape
        vals = (torch.arange(R * L, dtype=torch.int32, device=dev).view(R, L)
                if pairs == "values" else None)
        what = f"{R} x {L} {kind}{' descending' if desc else ''} {pairs}"
        got = rr.radix_rows_histogram(keys, kind, desc)
        want = rr.offsets_rows_plain(keys, kind, desc)
        err["radix_rows_histogram"] = max(err["radix_rows_histogram"],
                                          max_abs_err(got, want))
        check(torch.equal(got, want), f"radix_rows_histogram {what} == plain")
        withv = pairs != "keys"
        region = rr._region(R, L, withv)
        src, vsrc = keys, vals
        for p in range(rr.PASSES):
            reg = torch.zeros(region, dtype=torch.int32, device=dev)
            kout = torch.empty_like(src)
            vout = torch.empty_like(src) if withv else None
            rr.radix_rows_onesweep(src, kout, want, p, kind, desc, region=reg,
                                   values=vsrc, values_out=vout)
            pk, pv = rr.onesweep_rows_plain(
                src, p, want[:, p], kind, desc, vsrc,
                positions=pairs == "positions" and p == 0)
            torch.cuda.synchronize()
            ok = torch.equal(kout, pk) and (not withv or torch.equal(vout, pv))
            if not ok:
                err["radix_rows_onesweep"] = max(err["radix_rows_onesweep"],
                                                 max_abs_err(kout, pk))
            check(ok, f"radix_rows_onesweep pass {p} {what} == plain")
            src, vsrc = kout, vout
            del pk, pv, reg
        order = torch.sort(u64(rr.encode_plain(keys, kind, desc)), dim=1,
                           stable=True).indices
        check(torch.equal(src, keys.gather(1, order)) and (
            pairs != "positions" or torch.equal(vsrc.long(), order)),
            f"radix rows passes {what} == stable torch.sort of the mapped "
            "words")
        del keys, vals, src, vsrc, order, got, want


def order_flag(value: int, dev) -> torch.Tensor:
    """A 0-d int32 order flag (utils.words.order_flags) on the card."""
    return torch.full((), value, dtype=torch.int32, device=dev)


def reverse_checks(rng, dev, err: dict) -> None:
    """K8 against its plain version at the main path's sizes, under each
    order flag: it reverses only a nonincreasing input."""
    for n in (N, RAGGED, 3):
        src = words(rng, n, dev)
        for flag in range(4):
            out = words(rng, n, dev)
            want = out.clone()
            tb.reverse_plain(src, want, order_flag(flag, dev))
            tb.reverse_ordered(src, out, order_flag(flag, dev))
            torch.cuda.synchronize()
            err["reverse"] = max(err["reverse"], max_abs_err(out, want))
            check(torch.equal(out, want) and torch.equal(
                      out, src.flip(0)) == (flag == 2),
                  f"reverse n={n} flags={flag} == plain (reversed only "
                  "where the flags say nonincreasing alone)")
        del src, out, want


def scan_checks(rng, dev, err: dict) -> None:
    """K4 against its plain version: n from 1 to 2^27 around the tile's
    edges, exclusive and inclusive, under the tile of the port's default
    config and of the reference's (2^18: the kernel keeps its own tile,
    and every tile a config accepts must run); words near 2^31
    in magnitude (the running sum wraps), all-ones words (it wraps every
    step) and a view shifted by one word; and 20 scans of one input,
    which must give the same bits each time (a race in the look-back
    would show here)."""
    # magnitudes near 2^31, so the running sum wraps
    big = torch.from_numpy(rng.randint(2**30, 2**31, size=N + 1).astype(
        np.int32)).to(dev)
    big[::3] = -big[::3]
    ones = torch.full((N,), -1, dtype=torch.int32, device=dev)

    def same(x, inclusive, tile):
        out, total = tile_scan(x, inclusive=inclusive, tile_elems=tile)
        pout, ptotal = scan_plain(x, inclusive)
        torch.cuda.synchronize()
        err["scan"] = max(err["scan"], max_abs_err(out, pout),
                          max_abs_err(total.view(1), ptotal.view(1)))
        return torch.equal(out, pout) and torch.equal(total, ptotal)

    for tile in (sortx_torch.Config.scan_tile_elems, 1 << 18):
        for n in (1, 31, 1023, 8191, 8192, 8193, (1 << 20) + 7,
                  (1 << 20) + 13, N):
            for what, x in (("words near 2^31", big[:n]),
                            ("a view shifted by one word", big[1:n + 1]),
                            ("all-ones words", ones[:n])):
                check(same(x, False, tile) and same(x, True, tile),
                      f"scan n={n} scan_tile_elems={tile} {what}, "
                      "exclusive and inclusive == plain")
        first = tile_scan(big[:N], tile_elems=tile)
        repeats = True
        for _ in range(20):
            out, total = tile_scan(big[:N], tile_elems=tile)
            repeats &= (torch.equal(first[0], out)
                        and torch.equal(first[1], total))
        check(repeats, f"scan n={N} scan_tile_elems={tile}: 20 more scans of "
              "one input give the same bits and total")
        del first, out


def rows_walks(rng, dev, err: dict) -> None:
    """K1-K3 in rows mode: the pass plans of sort_rows / sort_kv_rows
    (2048 x 2^16), top_k's tournament rows (2^17 x 1024, keys alone and
    with indices, the latter as sort_rows with indices runs them: two
    streams, both compared), the top-p sampler's sort_rows with indices
    (256 x 2^17: K1 at the block, then K3 and K2 with the row's last stage
    forced ascending) and the hybrid's phases at 2^27 (A: 64 tiles of
    2^21; B: 564 buckets of 2^18), each pass against its plain version;
    then every row must be sorted."""
    # n = 2^27 keys, or the hybrid's phase shapes for it
    S, L, B, cap, _, _ = hy._params(N, HYBRID)
    log_l, log_cap = L.bit_length() - 1, cap.bit_length() - 1
    log_row = ROWS[1].bit_length() - 1
    for ns, nk, n, row_log, what in (
            (1, 1, N, log_row, "sort_rows"),
            (3, 2, N, log_row, "sort_kv_rows"),
            (1, 1, N, 10, "top_k rows of 1024"),
            (2, 2, N, 10, "top_k tournament with indices, rows of 1024"),
            (2, 2, 256 << 17, 17,
             "sort_rows with indices: the sampler's 256 x 2^17"),
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


def skewed_words(rng, n: int, dev, kind: str) -> torch.Tensor:
    """n u32 words (as int32): uniform, all equal, or drawn from 2 or 16
    values that differ in every byte."""
    if kind == "uniform":
        return words(rng, n, dev)
    if kind == "all-equal":
        return torch.full((n,), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    values = {"two-valued": 2, "16-valued": 16}[kind]
    pick = torch.randint(0, values, (n,), device=dev, dtype=torch.int32)
    return pick * 0x11111111 + 0x01020304


def histogram_checks(rng, dev, err: dict) -> None:
    """K5 against its plain version on uniform, all-equal and two-valued
    words. At 2^27: 8 bits at 24 and 4 bits at 30, per tile and whole,
    and each of kth_value's four rounds with the prefix of the middle
    word; and at a ragged 2^27 - 12345, without and with a prefix. At a
    ragged 2^22 - 12345, on the tensor and on a view shifted
    by one word: every digit width 1..8 at shifts 0, 7, 24 and 32 - bits,
    with and without a prefix."""
    def same(x, shift, bits, tile=16384, **kw):
        got = tile_histogram(x, shift, radix=1 << bits, tile_elems=tile, **kw)
        want = histogram_plain(x, shift, 1 << bits, tile, kw.get("prefix"))
        if not kw.get("per_tile", True):
            want = want.sum(0, dtype=torch.int32)
        torch.cuda.synchronize()
        err["histogram"] = max(err["histogram"], max_abs_err(got, want))
        return torch.equal(got, want)

    def above(x, hi_shift):     # the bits of x's middle word above a digit
        mid = u64(x[x.shape[0] // 2].view(1))
        return (mid >> min(hi_shift, 31)).to(torch.int32)

    for kind in ("uniform", "all-equal", "two-valued"):
        x = skewed_words(rng, N, dev, kind)
        check(all(same(x, shift, bits, per_tile=per_tile)
                  for bits, shift in ((8, 24), (4, 30))
                  for per_tile in (True, False)),
              f"histogram n={N} {kind} words, 8 bits at 24 and 4 bits at 30, "
              "per tile and whole == plain")
        check(all(same(x, shift, 8, per_tile=per_tile,
                       prefix=above(x, shift + 8))
                  for shift in (24, 16, 8, 0) for per_tile in (True, False)),
              f"histogram n={N} {kind} words, kth_value's four rounds with "
              "the prefix of the middle word, per tile and whole == plain")
        y = x[:N - 12345]
        check(same(y, 24, 8) and same(y, 16, 8, per_tile=False,
                                      prefix=above(y, 24)),
              f"histogram ragged n={N - 12345} {kind} words, 8 bits at 24 per "
              "tile, and at 16 whole with the prefix of the middle word == "
              "plain")
        n = (1 << 22) - 12345
        for view, y in (("", x[:n]), (" shifted by one word", x[1:n + 1])):
            count = 0
            for bits in range(1, 9):
                for shift in sorted({0, 7, 24, 32 - bits}):
                    ok = (same(y, shift, bits)
                          and same(y, shift, bits, per_tile=False)
                          and same(y, shift, bits,
                                   prefix=above(y, shift + bits))
                          and same(y, shift, bits, tile=1000, per_tile=False,
                                   prefix=above(y, shift + bits)))
                    if not ok:
                        raise RuntimeError(
                            f"chip_smoke: FAILED histogram {kind} n={n}"
                            f"{view} bits={bits} shift={shift} == plain")
                    count += 4
            check(True, f"histogram n={n}{view} {kind} words, bits 1..8 at "
                  f"shifts 0, 7, 24 and 32 - bits, with and without a "
                  f"prefix: all {count} launches == plain")
        del x, y


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
    the radix-16 and the 8-bit piece plans at 2^27, each with its plan
    on the card."""
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
    for name, (tiles, radix) in PIECE_PLANS.items():
        src, plan, _ = radix_plan(rng, dev, tiles, radix)
        got = apply_runs(src, plan_on_card(plan, dev), N)
        want = apply_runs_plain(src, plan, N)
        torch.cuda.synchronize()
        err["piece_mover"] = max(err["piece_mover"], max_abs_err(got, want))
        check(torch.equal(got, want),
              f"piece_mover: {len(plan['piece_src'])} pieces of the {name} "
              f"plan at n={N}, plan on the card, == plain")
        del src, got, want


# K7's two plans, (tiles, digits): one radix-16 pass (1.25 pieces a
# chunk) and one 8-bit pass (2^20 runs of 128 words, 65 pieces a chunk)
PIECE_PLANS = {"radix-16": (256, 16), "8-bit": (4096, 256)}


def plan_on_card(plan: dict, dev) -> dict:
    """A numpy piece plan as int32 tensors on the card."""
    return {k: torch.from_numpy(v).to(dev) for k, v in plan.items()}


def piece_mover_bound(plan: dict) -> dict:
    """K7 reads each output word's source and writes it once, and reads
    12 bytes a piece and 8 a chunk of plan."""
    return bound(2 * 4 * N + 3 * 4 * len(plan["piece_src"])
                 + 2 * 4 * len(plan["chunk_first"]), 0)


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
    # sort and stable sort_kv run the radix engine; unstable sort_kv the
    # network (K8 runs only on an ordered keys-only network sort now)
    return read_launches("flagship", RADIX + NETWORK + ("scan",))


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


def indexer_scores(dev, seed: int, rows: int = INDEXER[0]):
    """The indexer cell's causal rows of float32 scores (+inf past each
    row's length) and their lengths, from seeded words."""
    context = INDEXER[1]
    n = int(DSA_REF.row_lengths(rows, context).sum())
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, generator=gen,
                      device=dev)
    return DSA_REF.causal_scores(w, rows, context)


def topk_rows_checks(dev, err: dict) -> None:
    """K13, K14 and K15 against their plain versions: the indexer's first
    256 rows, tied u32 rows, rows whose keys share one 24-bit bucket,
    three-valued and all-equal rows (their buckets outgrow the buffer, so
    K15 reads the rows again), with lengths of L, 0, 1, k and random;
    K14's winners and buffer and K15's kept slots compared in each row's
    index order (they come in the order the warps take them)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    k = INDEXER[2]
    for what in ("indexer", "tied u32", "crowded bucket", "three values",
                 "all equal"):
        if what == "indexer":
            scores, lengths = indexer_scores(dev, SEED + 22, rows=256)
            keys = scores.view(torch.int32)
            kind = "f32"
        else:
            R, L = 300, 20_000
            keys = {"tied u32": lambda: cwords(gen, R * L, dev).view(R, L)
                    & -(1 << 24),
                    "crowded bucket": lambda: (0x3F800000 + torch.randint(
                        0, 4, (R, L), generator=gen, device=dev,
                        dtype=torch.int32)),
                    "three values": lambda: 0x3F800000 + (1 << 23) * (
                        torch.randint(0, 3, (R, L), generator=gen,
                                      device=dev, dtype=torch.int32)),
                    "all equal": lambda: torch.full(
                        (R, L), 77, dtype=torch.int32, device=dev)}[what]()
            kind = "u32" if what == "tied u32" else "f32"
            lengths = torch.randint(0, L + 1, (R,), generator=gen,
                                    device=dev, dtype=torch.int32)
            lengths[:4] = torch.tensor([L, 0, 1, k], dtype=torch.int32)
        R, L = keys.shape
        s_k = torch.empty(tk.scratch_words(R, L), dtype=torch.int32,
                          device=dev)
        s_p = torch.empty_like(s_k)
        got = tk.topk_rows_histogram(keys, lengths, kind, k, s_k)
        want = tk.histogram_plain(keys, lengths, kind, k, s_p)
        torch.cuda.synchronize()
        err["topk_rows_histogram"] = max(err["topk_rows_histogram"],
                                         max_abs_err(got, want))
        check(torch.equal(got, want),
              f"topk_rows_histogram {what} {R} x {L} == plain")
        outs = [torch.zeros((3, R, k), dtype=torch.int32, device=dev)
                for _ in range(2)]
        tk.topk_rows_gather(keys, lengths, kind, k, s_k, *outs[0])
        tk.gather_plain(keys, lengths, kind, k, s_p, *outs[1])
        taken = tk.row_taken(s_p, R, L)
        same = torch.equal(tk.row_taken(s_k, R, L), taken)
        for r in range(R):
            wins, kept = int(taken[r, 0]), int(taken[r, 1])
            same &= torch.equal(*(by_index(o[:, r:r + 1, :wins])
                                  for o in outs))
            same &= torch.equal(*(by_index(torch.stack(tk.row_buffer(
                s, R, L))[[0, 1, 0], r:r + 1, :kept]) for s in (s_k, s_p)))
        check(same, f"topk_rows_gather {what} {R} x {L} == plain (counters; "
              "winners and buffers in index order)")
        tk.topk_rows_buffer_select(keys, lengths, kind, k, -1, s_k, *outs[0])
        tk.buffer_select_plain(keys, lengths, kind, k, -1, s_p, *outs[1])
        got, want = (by_index(o) for o in outs)
        err["topk_rows_buffer_select"] = max(
            err["topk_rows_buffer_select"], max_abs_err(got, want))
        buffered = int((tk.row_state(s_p, R, L)[2]
                        <= tk.buffer_cap(L)).sum())
        check(torch.equal(got, want) and torch.equal(
            tk.row_state(s_k, R, L), tk.row_state(s_p, R, L)),
              f"topk_rows_buffer_select {what} {R} x {L} == plain ({buffered}"
              f" of {R} rows on their buffer; each row's kept slots in index "
              "order, the row state)")
        del keys, lengths, s_k, s_p, outs, got, want


def by_index(out: torch.Tensor) -> torch.Tensor:
    """K14's three [R, k] output streams with each row's slots in index
    order (its winners come in the order its CTAs take them)."""
    order = torch.sort(out[1], dim=1).indices
    return torch.stack([t.gather(1, order) for t in out])


def topk_rows_path(dev) -> dict:
    """Phase 5b: top_k_rows at the indexer cell's shape (4096 causal rows
    of 126,977 to 131,072 float32 scores, k = 2048) under "auto" (K13,
    K14, K15 with every row on its buffer, and the row network) against
    the plain reference. Returns the call's launch counts."""
    scores, lengths = indexer_scores(dev, SEED + 23)
    k = INDEXER[2]
    _build.launches.clear()
    before = tk.buffer_counts(dev)
    got = sortx_torch.top_k_rows(scores, k, lengths=lengths)
    counts = {name: c for name, c in read_launches(
        "top_k_rows (auto)", TOPK_ROWS).items() if name in TOPK_ROWS}
    after = tk.buffer_counts(dev)
    want = DSA_REF.top_k_rows(scores, lengths, k)
    check(same_tree(got, want), f"top_k_rows {INDEXER[0]} x {INDEXER[1]} "
          f"k={k}, auto == the indexer cell's plain reference")
    check(counts == dict.fromkeys(TOPK_ROWS, 1),
          f"top_k_rows launched one K13, K14 and K15: {counts}")
    check(after[0] - before[0] == after[1] - before[1] == INDEXER[0],
          f"top_k_rows: every row finished on its buffer ({before} -> "
          f"{after})")
    del scores, lengths, got, want
    return counts


def rows_path(dev) -> dict:
    """Phase 5: sort_rows (also with indices) and sort_kv_rows on
    2048 x 2^16 (and a ragged 2048 x 50000) against torch.sort(dim=1,
    stable=True), and the top-p sampler's sort_rows of 256 x 129,280
    float32 probabilities, descending with indices, against the plain
    reference: under "auto" on the rows' radix engine (no bitonic kernel
    launched), then again under engine="network" on the row network
    (no radix rows kernel launched). Returns the "auto" calls' launch
    counts."""
    counts = {}
    for engine, cfg, ran, not_ran in (
            ("auto", None, ROWS_RADIX, NETWORK),
            ("network", sortx_torch.Config(engine="network"), NETWORK,
             ROWS_RADIX)):
        rng = np.random.RandomState(SEED + 5)
        _build.launches.clear()
        probs = sampler_probs(dev, SEED + 5)
        want_p, want_i = TOPP_REF.sort_probs(probs)
        got_p, got_i = sortx_torch.sort_rows(probs, descending=True,
                                             return_indices=True, config=cfg)
        check(torch.equal(got_p.view(torch.int32), want_p.view(torch.int32))
              and torch.equal(got_i, want_i),
              f"sort_rows {SAMPLER[0]} x {SAMPLER[1]} float32 descending "
              f"with indices, {engine} == the sampler cell's plain reference")
        del probs, want_p, want_i, got_p, got_i
        for B, L in (ROWS, RAGGED_ROWS):
            keys = words(rng, B * L, dev).view(B, L)
            keys[:, ::7] &= 0xFF          # ties, so stability shows
            values = torch.arange(B * L, dtype=torch.int32,
                                  device=dev).view(B, L)
            ref = torch.sort(u64(keys), dim=1, stable=True)
            out = sortx_torch.sort_rows(keys.view(torch.uint32), config=cfg)
            check(torch.equal(u64(out), ref.values),
                  f"sort_rows {B} x {L}, {engine} == torch.sort(dim=1)")
            out, idx = sortx_torch.sort_rows(keys.view(torch.uint32),
                                             return_indices=True, config=cfg)
            check(torch.equal(u64(out), ref.values)
                  and torch.equal(idx, ref.indices.to(torch.int32)),
                  f"sort_rows {B} x {L} with indices, {engine} == "
                  "torch.sort(dim=1, stable=True)")
            del idx
            ks, vs = sortx_torch.sort_kv_rows(keys.view(torch.uint32), values,
                                              config=cfg)
            check(torch.equal(u64(ks), ref.values)
                  and torch.equal(vs, values.gather(1, ref.indices)),
                  f"sort_kv_rows {B} x {L}, {engine} == torch.sort(dim=1, "
                  "stable=True) + gather")
            del keys, values, ref, out, ks, vs
        got = read_launches(f"rows ({engine})", ran)
        check(not any(got.get(k, 0) for k in not_ran),
              f"the rows ({engine}) path launched none of "
              f"{', '.join(not_ran)}")
        if cfg is None:
            counts = got
    return counts


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
    """Phase 7: apply_runs at 2^27 on the radix-16 plan from numpy (held
    against the numpy run loop and the plain version) and on the 8-bit
    plan on the card (against the plain version)."""
    rng = np.random.RandomState(SEED + 7)
    src, plan, runs = radix_plan(rng, dev)
    src8, plan8, runs8 = radix_plan(rng, dev, *PIECE_PLANS["8-bit"])
    card8 = plan_on_card(plan8, dev)
    torch.cuda.synchronize()
    _build.launches.clear()
    out = apply_runs(src, plan, N)
    out8 = apply_runs(src8, card8, N)
    counts = read_launches("movers", ("piece_mover",))
    host = src.cpu().numpy()
    want = np.empty_like(host)
    for s, d, ln in zip(*runs):
        want[d:d + ln] = host[s:s + ln]
    check(np.array_equal(out.cpu().numpy(), want)
          and torch.equal(out, apply_runs_plain(src, plan, N)),
          f"apply_runs n={N}, radix-16 plan ({len(runs[0])} runs) == the "
          "numpy run loop and plain")
    check(torch.equal(out8, apply_runs_plain(src8, plan8, N)),
          f"apply_runs n={N}, 8-bit plan on the card ({len(runs8[0])} runs, "
          f"{len(plan8['piece_src'])} pieces) == plain")
    return counts


# --- the companions: 64-bit sorts, argsort, lexsort, merge, keyed and
# segmented ops ----------------------------------------------------------

SIGN64 = -(1 << 63)
WALK = 1 << 22         # every wide stream set's ragged walk
N24 = 1 << 24          # lexsort of 7 columns, the wide kernels' timings
WIDE_SETS = sorted(tb.STREAM_SETS - tb.NARROW_SETS)


def cwords(gen, n: int, dev) -> torch.Tensor:
    """n random u32 words (as int32), drawn on the card."""
    return torch.randint(0, 2**32, (n,), device=dev, generator=gen,
                         dtype=torch.int64).to(torch.int32)


def image64(t: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the order sortx gives 64-bit keys:
    u64 unsigned, i64 signed, f64 total (NaNs at the ends by sign)."""
    b = t.view(torch.int64)
    if t.dtype == torch.uint64:
        return b ^ SIGN64
    if t.dtype == torch.int64:
        return b
    return b ^ ((b >> 63) & ~SIGN64)


def keys64(gen, dev, dtype, n: int) -> torch.Tensor:
    """Duplicate-heavy 64-bit keys: few distinct hi words, so lo decides;
    f64 also with signed zeros, infinities and NaNs of both signs."""
    if dtype == torch.float64:
        f = torch.round(torch.randn(n, device=dev, generator=gen,
                                    dtype=torch.float64) * 1000) / 8
        pick = torch.randint(0, n, (6, 1000), device=dev, generator=gen)
        for row, v in zip(pick, (-0.0, 0.0, float("inf"), float("-inf"),
                                 float("nan"), -float("nan"))):
            f[row] = v
        return f
    hi = cwords(gen, n, dev).to(torch.int64) & 0xFFF
    lo = cwords(gen, n, dev).to(torch.int64) & 0x3FF
    k = (hi << 52) | (hi << 20) | lo
    return k.view(torch.uint64) if dtype == torch.uint64 else k


def stable_order(*images) -> torch.Tensor:
    """The stable sorting permutation by int64 images, images[0] the most
    significant: chained stable torch.sort passes, least significant
    first."""
    perm = torch.sort(images[-1], stable=True).indices
    for img in reversed(images[:-1]):
        perm = perm[torch.sort(img[perm], stable=True).indices]
    return perm


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(iv(a), iv(b))


def lex_sorted(x: torch.Tensor, nk: int) -> bool:
    """Are the columns of x nondecreasing on its first nk rows, unsigned
    and lexicographic?"""
    a, b = ordered(x[:nk, :-1]), ordered(x[:nk, 1:])
    le = torch.zeros(a.shape[1], dtype=torch.bool, device=x.device)
    eq = torch.ones_like(le)
    for t in range(nk):
        le |= eq & (a[t] < b[t])
        eq &= a[t] == b[t]
    return bool((le | eq).all())


def wide_set(gen, dev, ns: int, nk: int, n: int, nv: int) -> torch.Tensor:
    """An (ns, n) buffer shaped like a wide stream set, padded with
    0xFFFFFFFF from nv: key words with few values (so ties reach the
    later keys), a tie-free last key (the idx stream), then payloads."""
    x = torch.full((ns, n), -1, dtype=torch.int32, device=dev)
    for t in range(ns):
        x[t, :nv] = cwords(gen, nv, dev)
        if t < nk - 1:
            x[t, :nv] &= 3
    x[nk - 1, :nv] = torch.randperm(nv, device=dev, generator=gen,
                                    dtype=torch.int32)
    return x


def merge_set(gen, dev, ns: int, n: int, na: int, nb: int) -> torch.Tensor:
    """The merge's buffer: [a, pads, reverse(b)] of two sorted runs of
    duplicate-heavy keys; with 3 streams also the idx stream (pads
    0xFFFFFFFF) and a payload (pads 0), as merge_kv builds them."""
    x = torch.zeros((ns, n), dtype=torch.int32, device=dev)
    srt = lambda m: torch.sort(cwords(gen, m, dev) & 0xFFFFF).values  # noqa: E731
    x[0, :na], x[0, na:n - nb], x[0, n - nb:] = srt(na), -1, srt(nb).flip(0)
    if ns == 3:
        x[1, :na] = torch.arange(na, dtype=torch.int32, device=dev)
        x[1, na:n - nb] = -1
        x[1, n - nb:] = torch.arange(na, na + nb, dtype=torch.int32,
                                     device=dev).flip(0)
        x[2, :na], x[2, n - nb:] = cwords(gen, na, dev), cwords(gen, nb, dev)
    return x


def companion_walks(dev, err: dict) -> None:
    """K1-K3 at each wide stream set at 2^22 (ragged), and at the sizes
    the companions path gives them: (3,3) at 2^27 (argsort f64) and on a
    2^27 buffer with 2^26 + 13 valid (unstable sort_kv, int64 values),
    (4,3) at 2^27 (stable sort_kv of u64 keys, sort_kv_segments), (4,2)
    at 2^27 (stable sort_kv, int64 values), (5,5) at 2^27 (lexsort of 3
    columns), (8,8) at 2^24 (lexsort of 7); and the merge stage (2^27,
    and 2^12, where K2 takes s == L). Every pass against its plain
    version; then the keys must be sorted."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    walks = [(ns, nk, WALK, WALK - 12345) for ns, nk in WIDE_SETS] + [
        (3, 3, N, N), (3, 3, N, RAGGED), (4, 3, N, N), (4, 2, N, N),
        (5, 5, N, N), (8, 8, N24, N24)]
    for ns, nk, n, nv in walks:
        x = wide_set(gen, dev, ns, nk, n, nv)
        passes = walk_plan(x, nk, nv, err)
        check(lex_sorted(x, nk),
              f"stream set ns={ns} nk={nk} n={n} n_valid={nv}: all "
              f"{passes} passes == plain, and the key columns sorted")
        del x
    for ns, nk, n in ((1, 1, N), (3, 2, N), (1, 1, 1 << 12),
                      (3, 2, 1 << 12)):
        na = n // 2 + 5
        x = merge_set(gen, dev, ns, n, na, n - na - 1000)
        plan = tb.merge_plan(ns, n, nk)
        walk_plan(x, nk, n, err, plan=plan)
        check(lex_sorted(x, nk),
              f"merge stage ns={ns} nk={nk} n={n}: all {len(plan)} passes "
              f"({[name for name, _ in plan].count('bitonic_global')} K3, "
              f"K2 at s={plan[-1][1][3]}, L={plan[-1][1][2]}) == plain, "
              "and the keys sorted")
        del x


def design_walks(dev, err: dict) -> None:
    """K1 and K2, one launch each against the plain version, at the
    blocks no path's plan reaches: per stream set the smallest block the
    wrappers take (2^1) and the one below the register design's range
    (both run the per-layer kernels), the ends of that range (and 2^14
    at one stream), and a 2^10 block of a buffer off the 16-byte grid;
    K2 in descending and ascending blocks; the narrow sets also in rows
    mode and K2 at s == L."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    for ns, nk in sorted(tb.STREAM_SETS):
        design = [lb for lb in range(1, tb.LOG_BLOCK_MAX + 1)
                  if tb.elems_log(ns, lb)]
        sizes = sorted({1, design[0] - 1, design[0], design[-1]}
                       | ({14} if ns == 1 else set()))
        count = 0
        for lb, off in [(lb, 0) for lb in sizes] + [(10, 1)]:
            n = 8 << lb
            buf = wide_set(gen, dev, ns, nk, n + 4, n + 4)
            buf[:nk - 1] &= 1       # many ties on the leading keys
            if nk == 1:
                buf[0] &= 0xFF      # and on a lone key: a tie must not move
            runs = [("bitonic_block", (n, nk, lb)),
                    ("bitonic_tail", (n, nk, lb, lb + 1))]
            if (ns, nk) in tb.NARROW_SETS:
                runs += [("bitonic_block", (n, nk, lb, r))
                         for r in sorted({lb, max(lb - 2, 1)})]
                runs += [("bitonic_tail", (n, nk, lb, lb, True))]
            for name, args in runs:
                fn, plain = tb.KERNELS[name]
                x = buf.clone()[:, off:off + n]
                want = x.clone()
                fn(x, *args)
                plain(want, *args)
                torch.cuda.synchronize()
                err[name] = max(err[name], max_abs_err(x, want))
                if not torch.equal(x, want):
                    raise RuntimeError(
                        f"chip_smoke: FAILED {name} ns={ns} nk={nk} "
                        f"args={args} word offset {off} == plain")
                count += 1
        check(True, f"K1 / K2 ns={ns} nk={nk} at blocks 2^{sizes} and off "
              f"the 16-byte grid (design e={tb.elems_log(ns, design[-1])} "
              f"from 2^{design[0]}): all {count} launches == plain")


def segments(gen, dev, n: int, count: int = 10_000) -> torch.Tensor:
    """count + 1 ragged int64 offsets over n, every 97th segment empty."""
    cuts = torch.sort(torch.randint(0, n + 1, (count - 1,), device=dev,
                                    generator=gen)).values
    cuts[1::97] = cuts[0::97][:cuts[1::97].shape[0]]
    zero, end = cuts.new_zeros(1), cuts.new_full((1,), n)
    return torch.cat([zero, cuts, end])


def companion_inputs(dev) -> types.SimpleNamespace:
    """Every companion op's input, made once on the card from the seed
    (n = 2^27 unless stated): companions_path checks the ops on these
    tensors and companion_timings times the same calls on them."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    c = types.SimpleNamespace()
    c.k64 = {dt: keys64(gen, dev, dt, N)
             for dt in (torch.uint64, torch.int64, torch.float64)}
    c.keys = cwords(gen, N, dev).view(torch.uint32)
    kw = c.keys.view(torch.int32)
    c.kk = (kw & 0xFFFF).view(torch.uint32)     # duplicate-heavy
    c.runs = (kw >> 30).view(torch.uint32)      # 4 values, long runs
    c.v = cwords(gen, N, dev)                   # u32 values
    c.mask = (c.v & 1).bool()
    c.v64 = cwords(gen, N, dev).to(torch.int64) * 4_000_000_011
    # lexsort: (u32, i32, f64) -> (5, 5); 7 x u32 at 2^24 -> (8, 8)
    c.cols = [(cwords(gen, N, dev) & 3).view(torch.uint32),
              cwords(gen, N, dev) % 5,
              torch.round(torch.randn(N, device=dev, generator=gen,
                                      dtype=torch.float64) * 8)]
    c.cols7 = [(cwords(gen, N24, dev) & 1).view(torch.uint32)
               for _ in range(7)]
    # merge: two sorted runs of 2^26 24-bit keys
    half = N // 2
    c.a, c.b = (torch.sort(kw[i * half:(i + 1) * half] & 0xFFFFFF).values
                .view(torch.uint32) for i in range(2))
    c.va = torch.arange(half, dtype=torch.int32, device=dev)
    c.off = segments(gen, dev, N)
    c.seg = torch.repeat_interleave(
        torch.arange(c.off.shape[0] - 1, device=dev), c.off.diff())
    return c


def companions_path(dev, c) -> dict:
    """Phase 10: the companion ops through the public API, on the inputs
    of companion_inputs, each against an independent torch computation."""
    _build.launches.clear()

    # 64-bit keys: (hi, lo) at (2, 2); argsort f64 (hi, lo, idx) at (3, 3)
    for dt, k in c.k64.items():
        order = stable_order(image64(k))
        check(same_bits(sortx_torch.sort(k), iv(k)[order]),
              f"sort {dt} n={N} == stable torch.sort of the int64 image")
        if dt == torch.float64:
            check(torch.equal(sortx_torch.argsort(k).long(), order),
                  f"argsort f64 n={N} == torch.sort(stable=True).indices")
    # stable sort_kv of u64 keys, u32 values: (hi, lo, idx, v) at (4, 3)
    k = c.k64[torch.uint64]
    order = stable_order(image64(k))
    ks, vs = sortx_torch.sort_kv(k, c.keys)
    check(same_bits(ks, iv(k)[order]) and same_bits(vs, iv(c.keys)[order]),
          f"stable sort_kv u64 keys, u32 values n={N} (4,3) == stable "
          "torch.sort + gather")
    del ks, vs, k, order

    # 64-bit values: stable (key, idx, hi, lo) at (4, 2); unstable at
    # ragged n (key, hi, lo) at (3, 3), which orders by (key, value)
    order = stable_order(u64(c.kk))
    ks, vs = sortx_torch.sort_kv(c.kk, c.v64)
    check(same_bits(ks, iv(c.kk)[order]) and same_bits(vs, c.v64[order]),
          f"stable sort_kv u32 keys, int64 values n={N} (4,2) == stable "
          "torch.sort + gather")
    rk, rv = c.kk[:RAGGED], c.v64[:RAGGED]
    order = stable_order(u64(rk), rv ^ SIGN64)
    ks, vs = sortx_torch.sort_kv(rk, rv, stable=False)
    check(same_bits(ks, iv(rk)[order]) and same_bits(vs, rv[order]),
          f"unstable sort_kv u32 keys, int64 values n={RAGGED} (3,3) == "
          "torch.sort by (key, value)")
    del ks, vs, rk, rv, order

    check(torch.equal(sortx_torch.argsort(c.kk).long(),
                      torch.sort(u64(c.kk), stable=True).indices),
          f"argsort u32 n={N} == torch.sort(stable=True).indices")

    want = stable_order(image64(c.cols[2]), c.cols[1].to(torch.int64),
                        u64(c.cols[0]))
    check(torch.equal(sortx_torch.lexsort(c.cols).long(), want),
          f"lexsort (u32, i32, f64) n={N} (5,5) == chained stable "
          "torch.sort passes")
    want = stable_order(*[u64(col) for col in reversed(c.cols7)])
    check(torch.equal(sortx_torch.lexsort(c.cols7).long(), want),
          f"lexsort 7 x u32 n={N24} (8,8) == chained stable torch.sort "
          "passes")
    del want

    half = N // 2
    cat = torch.cat([iv(c.a), iv(c.b)])
    order = torch.sort(u64(cat), stable=True).indices
    check(same_bits(sortx_torch.merge(c.a, c.b), cat[order]),
          f"merge of two sorted runs of {half} == torch.sort of the "
          "concatenation")
    mk, mv = sortx_torch.merge_kv(c.a, c.va, c.b, c.va + half)
    check(same_bits(mk, cat[order]) and torch.equal(mv.long(), order),
          f"merge_kv of two sorted runs of {half} == stable torch.sort of "
          "the concatenation (a first on ties)")
    del cat, mk, mv, order

    keyed_checks(c)
    segmented_checks(c)
    return read_launches("companions", NETWORK + ("scan",))


def keyed_checks(c) -> None:
    """unique, run_length_encode, reduce_by_key, sum_by_key, partition on
    duplicate-heavy keys at 2^27, against torch.unique, int64 sums and
    boolean indexing."""
    vals, counts = torch.unique(u64(c.kk), return_counts=True)
    m = vals.shape[0]
    uv, uc, un = sortx_torch.unique(c.kk, 1 << 17)
    check(int(un) == m and torch.equal(u64(uv[:m]), vals)
          and torch.equal(uc[:m].long(), counts)
          and bool((uv[m:].view(torch.int32) == uv[m - 1].view(torch.int32)
                    ).all()) and not bool(uc[m:].any()),
          f"unique n={N}: {m} values == torch.unique(return_counts=True), "
          "fill rules kept")
    rvals, rcounts = torch.unique_consecutive(u64(c.runs), return_counts=True)
    size = 1 << 20
    rv, rc, rn = sortx_torch.run_length_encode(c.runs, size)
    n_runs = min(int(rn), size)
    check(int(rn) == rvals.shape[0]
          and torch.equal(u64(rv[:n_runs]), rvals[:n_runs])
          and torch.equal(rc[:n_runs].long(), rcounts[:n_runs]),
          f"run_length_encode n={N}: {int(rn)} runs, first {n_runs} == "
          "torch.unique_consecutive")
    run_id = torch.repeat_interleave(
        torch.arange(rcounts.shape[0], device=c.v.device), rcounts)
    sums = torch.zeros(rcounts.shape[0], dtype=torch.int64,
                       device=c.v.device)
    sums.index_add_(0, run_id, c.v.to(torch.int64))
    bk, bs, bn = sortx_torch.reduce_by_key(c.runs, c.v, size)
    check(int(bn) == rvals.shape[0]
          and torch.equal(u64(bk[:n_runs]), rvals[:n_runs])
          and torch.equal(u64(bs[:n_runs]), sums[:n_runs] & 0xFFFFFFFF),
          f"reduce_by_key n={N}: first {n_runs} run sums == int64 "
          "index_add mod 2^32")
    del run_id, sums, rvals, rcounts
    inv = torch.unique(u64(c.kk), return_inverse=True)[1]
    sums = torch.zeros(m, dtype=torch.int64, device=c.v.device)
    sums.index_add_(0, inv, c.v.to(torch.int64))
    sk, ss, sn = sortx_torch.sum_by_key(c.kk, c.v, 1 << 17)
    check(int(sn) == m and torch.equal(u64(sk[:m]), vals)
          and torch.equal(u64(ss[:m]), sums & 0xFFFFFFFF),
          f"sum_by_key n={N}: {m} key sums == torch.unique + int64 "
          "index_add mod 2^32")
    del inv, sums
    out, nt = sortx_torch.partition(c.keys, c.mask)
    kw = c.keys.view(torch.int32)
    check(int(nt) == int(c.mask.sum())
          and torch.equal(out.view(torch.int32),
                          torch.cat([kw[c.mask], kw[~c.mask]])),
          f"partition n={N} == boolean indexing, selected first")


def segmented_checks(c) -> None:
    """sort_segments, sort_kv_segments, scan_segments and scan_by_key on
    10^4 ragged segments at 2^27, against stable sorts of the (segment,
    key) int64 image and int64 cumsums minus each segment's start."""
    off, seg = c.off, c.seg
    order = torch.sort((seg << 32) | u64(c.kk), stable=True).indices
    check(same_bits(sortx_torch.sort_segments(c.kk, off), iv(c.kk)[order]),
          f"sort_segments n={N}, {off.shape[0] - 1} segments == stable "
          "torch.sort of the (segment, key) image")
    ks, vs = sortx_torch.sort_kv_segments(c.kk, c.v, off)
    check(same_bits(ks, iv(c.kk)[order]) and same_bits(vs, c.v[order]),
          f"sort_kv_segments n={N} == stable torch.sort + gather")
    del order, ks, vs
    x64 = c.v.to(torch.int64)
    incl = torch.cumsum(x64, 0)
    excl = incl - x64
    for inclusive in (False, True):
        want = excl - excl[off[seg]] + (x64 if inclusive else 0)
        got, totals = sortx_torch.scan_segments(c.v, off, with_totals=True,
                                                inclusive=inclusive)
        ext = torch.cat([incl.new_zeros(1), incl])
        check(torch.equal(u64(got), want & 0xFFFFFFFF)
              and torch.equal(u64(totals),
                              (ext[off[1:]] - ext[off[:-1]]) & 0xFFFFFFFF),
              f"scan_segments n={N} inclusive={inclusive} with totals == "
              "int64 cumsum minus the segment start")
    counts = torch.unique_consecutive(u64(c.runs), return_counts=True)[1]
    start = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    check(torch.equal(u64(sortx_torch.scan_by_key(c.runs, c.v)),
                      (excl - excl[start]) & 0xFFFFFFFF),
          f"scan_by_key n={N}, {counts.shape[0]} runs == int64 cumsum "
          "minus the run start")


def timed_pair(card: str, ours: str, run, theirs: str, torch_run, same,
               per: int = N) -> None:
    """Time a companion op (run) beside the torch computation of the same
    result (torch_run) on the same tensors, and hold the outputs of the
    last timed calls equal with same(ours, theirs)."""
    out = {}

    def timed(key, fn):
        def call():
            out[key] = fn()
        return time_ms(call)
    time_line(card, f"sortx_torch.{ours}", timed("ours", run), per)
    time_line(card, theirs, timed("theirs", torch_run), per)
    torch.cuda.synchronize()
    check(same(out["ours"], out["theirs"]),
          f"timed sortx_torch.{ours} == {theirs}")


def companion_timings(dev, card: str, err: dict, c) -> None:
    """Phase 11: CUDA-event medians of each companion op beside the torch
    computation of its result, on the tensors companions_path checked,
    each timed output held against the torch one; then K1-K3 at the
    widest stream sets beside their plain versions."""
    torch.cuda.empty_cache()

    def values(g, w):       # for the ops that return (keys, values)
        return torch.equal(iv(g[1]), w)

    for dt, k in c.k64.items():
        img = image64(k)
        timed_pair(card, f"sort {dt} n={N}", lambda: sortx_torch.sort(k),
                   f"torch.sort of the int64 image ({dt}) n={N}",
                   lambda: torch.sort(img).values,
                   lambda g, w: torch.equal(image64(g), w))
        if dt == torch.float64:
            timed_pair(card, f"argsort f64 n={N}",
                       lambda: sortx_torch.argsort(k),
                       f"torch.sort(stable=True).indices, int64 image n={N}",
                       lambda: torch.sort(img, stable=True).indices,
                       lambda g, w: torch.equal(g.long(), w))
        del img
    k = c.k64[torch.uint64]
    img = image64(k)
    kw = c.keys.view(torch.int32)
    timed_pair(card, f"sort_kv u64 keys, u32 values stable n={N}",
               lambda: sortx_torch.sort_kv(k, c.keys),
               f"torch.sort(stable=True) of the int64 image + gather n={N}",
               lambda: kw[torch.sort(img, stable=True).indices],
               values)
    del img
    kk = c.kk.view(torch.int32)     # 16-bit: signed order == unsigned
    timed_pair(card, f"sort_kv u32 keys, int64 values stable n={N}",
               lambda: sortx_torch.sort_kv(c.kk, c.v64),
               f"torch.sort(stable=True) + gather of int64 values n={N}",
               lambda: c.v64[torch.sort(kk, stable=True).indices],
               values)
    rk, rv, rkl = c.kk[:RAGGED], c.v64[:RAGGED], kk[:RAGGED].to(torch.int64)
    timed_pair(card, f"sort_kv u32 keys, int64 values unstable n={RAGGED}",
               lambda: sortx_torch.sort_kv(rk, rv, stable=False),
               f"chained stable torch.sort by (key, value) + gather "
               f"n={RAGGED}",
               lambda: rv[stable_order(rkl, rv ^ SIGN64)],
               values, RAGGED)
    del rkl
    timed_pair(card, f"argsort u32 n={N}", lambda: sortx_torch.argsort(c.kk),
               f"torch.sort(stable=True).indices int32 n={N}",
               lambda: torch.sort(kk, stable=True).indices,
               lambda g, w: torch.equal(g.long(), w))
    imgs = [image64(c.cols[2]), c.cols[1].to(torch.int64), u64(c.cols[0])]
    timed_pair(card, f"lexsort (u32, i32, f64) n={N}",
               lambda: sortx_torch.lexsort(c.cols),
               f"chained stable torch.sort, 3 int64 images n={N}",
               lambda: stable_order(*imgs),
               lambda g, w: torch.equal(g.long(), w))
    imgs = [u64(col) for col in reversed(c.cols7)]
    timed_pair(card, f"lexsort 7 x u32 n={N24}",
               lambda: sortx_torch.lexsort(c.cols7),
               f"chained stable torch.sort, 7 int64 images n={N24}",
               lambda: stable_order(*imgs),
               lambda g, w: torch.equal(g.long(), w), N24)
    del imgs

    half = N // 2
    ia, ib = iv(c.a), iv(c.b)       # 24-bit: signed order == unsigned
    timed_pair(card, f"merge 2 x {half}",
               lambda: sortx_torch.merge(c.a, c.b),
               f"torch.sort of the concatenation int32 n={N}",
               lambda: torch.sort(torch.cat([ia, ib])).values,
               lambda g, w: torch.equal(iv(g), w))
    vb = c.va + half
    timed_pair(card, f"merge_kv 2 x {half}",
               lambda: sortx_torch.merge_kv(c.a, c.va, c.b, vb),
               "torch.sort(stable=True) + gather of the concatenation "
               f"n={N}",
               lambda: torch.cat([c.va, vb])[
                   torch.sort(torch.cat([ia, ib]), stable=True).indices],
               values)
    del vb

    keyed_timings(card, c)
    segmented_timings(card, c)

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    for ns, nk, n in ((5, 5, N24), (8, 8, N24)):
        x0 = wide_set(gen, dev, ns, nk, n, n)
        x = x0.clone()
        lb, s = tb.block_log(ns), n.bit_length() - 1
        restore = lambda: x.copy_(x0)   # noqa: E731
        for name, args in (
                ("bitonic_block", (n, nk, lb)),
                ("bitonic_tail", (n, nk, lb, s)),
                ("bitonic_global", (n, nk, s, s - 1, s - tb.f_max(ns)))):
            fn, plain = tb.KERNELS[name]
            timed_kernel(card, f"{name} ns={ns} nk={nk} n={n} "
                         f"args={args[2:]}", lambda: fn(x, *args),
                         lambda: plain(x, *args) or x, err, name,
                         setup=restore)
        del x, x0


def keyed_timings(card: str, c) -> None:
    """The keyed ops beside torch.unique / unique_consecutive with int64
    sums, and boolean indexing."""
    kk, runs, v64 = iv(c.kk), iv(c.runs), c.v.to(torch.int64)
    size = 1 << 20

    # counts and sums alike compare as u32 words against int64 mod 2^32
    def first_runs(g, w):
        n_runs = min(int(g[2]), size)
        return (int(g[2]) == w[0].shape[0]
                and torch.equal(iv(g[0][:n_runs]), w[0][:n_runs])
                and torch.equal(u64(g[1][:n_runs]),
                                w[1][:n_runs] & 0xFFFFFFFF))

    def run_sums():
        vals, counts = torch.unique_consecutive(runs, return_counts=True)
        incl = torch.cumsum(v64, 0)
        ends = incl[torch.cumsum(counts, 0) - 1]
        return vals, ends - torch.cat([ends.new_zeros(1), ends[:-1]])

    def key_sums():
        vals, inv = torch.unique(kk, return_inverse=True)
        sums = torch.zeros(vals.shape[0], dtype=torch.int64, device=kk.device)
        return vals, sums.index_add_(0, inv, v64)

    def all_keys(g, w):
        m = w[0].shape[0]
        return (int(g[2]) == m and torch.equal(iv(g[0][:m]), w[0])
                and torch.equal(u64(g[1][:m]), w[1] & 0xFFFFFFFF))

    timed_pair(card, f"unique n={N}", lambda: sortx_torch.unique(c.kk, 1 << 17),
               f"torch.unique(return_counts=True) int32 n={N}",
               lambda: torch.unique(kk, return_counts=True), all_keys)
    timed_pair(card, f"run_length_encode n={N}",
               lambda: sortx_torch.run_length_encode(c.runs, size),
               f"torch.unique_consecutive(return_counts=True) int32 n={N}",
               lambda: torch.unique_consecutive(runs, return_counts=True),
               first_runs)
    timed_pair(card, f"reduce_by_key n={N}",
               lambda: sortx_torch.reduce_by_key(c.runs, c.v, size),
               f"torch.unique_consecutive + int64 cumsum at the run ends "
               f"n={N}", run_sums, first_runs)
    timed_pair(card, f"sum_by_key n={N}",
               lambda: sortx_torch.sum_by_key(c.kk, c.v, 1 << 17),
               f"torch.unique(return_inverse=True) + int64 index_add n={N}",
               key_sums, all_keys)
    kw = c.keys.view(torch.int32)
    timed_pair(card, f"partition n={N}",
               lambda: sortx_torch.partition(c.keys, c.mask),
               f"torch.cat(x[mask], x[~mask]) int32 n={N}",
               lambda: torch.cat([kw[c.mask], kw[~c.mask]]),
               lambda g, w: torch.equal(iv(g[0]), w))


def segmented_timings(card: str, c) -> None:
    """The segmented ops beside a torch.sort of the (segment, key) int64
    image and int64 cumsums minus each segment's or run's start."""
    off, seg = c.off, c.seg
    img = (seg << 32) | u64(c.kk)
    v64 = c.v.to(torch.int64)
    timed_pair(card, f"sort_segments n={N}, 10^4 segments",
               lambda: sortx_torch.sort_segments(c.kk, off),
               f"torch.sort of the (segment, key) int64 image n={N}",
               lambda: torch.sort(img).values,
               lambda g, w: torch.equal((seg << 32) | u64(g), w))
    timed_pair(card, f"sort_kv_segments n={N}",
               lambda: sortx_torch.sort_kv_segments(c.kk, c.v, off),
               f"torch.sort(stable=True) of the (segment, key) image + "
               f"gather n={N}",
               lambda: c.v[torch.sort(img, stable=True).indices],
               lambda g, w: torch.equal(iv(g[1]), w))
    del img

    def minus_start(start):
        def run():
            excl = torch.cumsum(v64, 0) - v64
            return excl - excl[start()]
        return run

    def runs_start():
        counts = torch.unique_consecutive(iv(c.runs), return_counts=True)[1]
        return torch.repeat_interleave(torch.cumsum(counts, 0) - counts,
                                       counts)

    def wrapped(g, w):
        return torch.equal(u64(g), w & 0xFFFFFFFF)
    timed_pair(card, f"scan_segments n={N}, 10^4 segments",
               lambda: sortx_torch.scan_segments(c.v, off),
               f"int64 torch.cumsum minus the segment start n={N}",
               minus_start(lambda: off[seg]), wrapped)
    timed_pair(card, f"scan_by_key n={N}",
               lambda: sortx_torch.scan_by_key(c.runs, c.v),
               f"int64 torch.cumsum minus the run start "
               f"(unique_consecutive) n={N}", minus_start(runs_start), wrapped)


def time_line(card: str, what: str, times, per=None) -> float:
    """Print the median of times (ms), its rate and its range."""
    ms = statistics.median(times)
    rate = f" = {per / (ms / 1e3):.6g}/s" if per else ""
    print(f"time {what}: {ms!r} ms{rate} (min {min(times)!r}, max "
          f"{max(times)!r}, {len(times)} runs) [{card}]", flush=True)
    return ms


def timings(dev, card: str, err: dict):
    """Phase 8: CUDA-event medians of the flagship path and of K1-K4;
    each kernel's timed output is held against its plain version's.
    Returns (kernel -> (ms, plain ms), kernel -> bound and library ms)."""
    torch.cuda.empty_cache()    # drop the earlier phases' cached blocks
    rng = np.random.RandomState(SEED + 2)
    keys = words(rng, N, dev)
    u = keys.view(torch.uint32)
    values = torch.arange(N, dtype=torch.int32, device=dev)

    def line(what, times, per=None):
        return time_line(card, what, times, per)

    net = sortx_torch.Config(engine="network")
    line(f"sortx_torch.sort u32 n={N} keys",
         time_ms(lambda: sortx_torch.sort(u)), N)
    line(f"sortx_torch.sort u32 n={N} keys, network engine",
         time_ms(lambda: sortx_torch.sort(u, config=net)), N)
    torch_sort = line(f"torch.sort int32 n={N} keys",
                      time_ms(lambda: torch.sort(keys)), N)
    line(f"sortx_torch.sort_kv stable u32 n={N} keys",
         time_ms(lambda: sortx_torch.sort_kv(u, values)), N)
    line(f"sortx_torch.sort_kv stable u32 n={N} keys, network engine",
         time_ms(lambda: sortx_torch.sort_kv(u, values, config=net)), N)
    line(f"sortx_torch.sort_kv unstable u32 n={N} keys",
         time_ms(lambda: sortx_torch.sort_kv(u, values, stable=False)), N)
    line(f"torch.sort(stable=True) + gather int32 n={N} keys",
         time_ms(lambda: values[torch.sort(keys, stable=True).indices]), N)
    line(f"sortx_torch.scan int32 n={N} elements",
         time_ms(lambda: sortx_torch.scan(keys)), N)
    line(f"torch.cumsum int32->int64 n={N} elements",
         time_ms(lambda: torch.cumsum(keys, 0)), N)

    ms, extra = {}, {}
    log_n = N.bit_length() - 1
    for ns, nk in ((1, 1), (2, 2), (3, 2)):
        x0 = torch.stack([keys] + [values] * (ns - 1))
        x = x0.clone()
        lb = tb.block_log(ns)
        restore = lambda: x.copy_(x0)   # noqa: E731
        for name, args, layers in (
                ("bitonic_block", (N, nk, lb), lb * (lb + 1) // 2),
                ("bitonic_tail", (N, nk, lb, log_n), lb),
                ("bitonic_global",
                 (N, nk, log_n, log_n - 1, log_n - tb.f_max(ns)),
                 tb.f_max(ns))):
            fn, plain = tb.KERNELS[name]
            k_ms = time_ms(lambda: fn(x, *args), restore)
            got = x.clone()       # the kernel's output of the last run
            p_ms = time_ms(lambda: plain(x, *args), restore, reps=1)
            torch.cuda.synchronize()
            err[name] = max(err[name], max_abs_err(got, x))
            check(torch.equal(got, x), f"{name} ns={ns} nk={nk} n={N} "
                  f"args={args[2:]}: timed kernel output == plain")
            del got
            what = f"{name} ns={ns} nk={nk} n={N} args={args[2:]}"
            k_ms = line(f"{what} kernel", k_ms)
            p_ms = line(f"{what} plain", p_ms)
            b = network_bound(ns, N, layers)
            print(f"bound {what}: {b['bound_ms']!r} ms by {b['bound_by']}")
            if ns == 1:       # the keys-only sort's shapes
                ms[name] = (k_ms, p_ms)
                extra[name] = dict(b, library_ms=None)
        del x, x0
    block_size_ab(card, keys, values)
    # one PyTorch call for K1's function: the same 2^L blocks, each
    # sorted ascending (K1 sorts every other block descending)
    lb = tb.block_log(1)
    extra["bitonic_block"]["library_ms"] = line(
        f"torch.sort(dim=1) int32 {N >> lb} x 2^{lb} (K1's blocks)",
        time_ms(lambda: torch.sort(keys.view(-1, 1 << lb), dim=1)), N)
    # K4 and the library call beside it, each ROW calls in a row
    k_ms = time_ms(lambda: tile_scan(keys), calls=ROW)
    p_ms = time_ms(lambda: scan_plain(keys))
    ms["scan"] = (line(f"scan kernel n={N}, {ROW} calls in a row", k_ms, N),
                  line(f"scan plain n={N}", p_ms, N))
    # K4 reads n words and writes n words (and one total); one add each
    extra["scan"] = dict(bound(2 * 4 * N, N), library_ms=line(
        f"torch.cumsum int32->int32 n={N} elements, {ROW} calls in a row",
        time_ms(lambda: torch.cumsum(keys, 0, dtype=torch.int32),
                calls=ROW), N))
    print(f"bound scan n={N}: {extra['scan']['bound_ms']!r} ms by "
          f"{extra['scan']['bound_by']}")
    print(f"scan kernel / torch.cumsum(dtype=int32) of the same tensor: "
          f"{ms['scan'][0] / extra['scan']['library_ms']:.3f}")
    shifted = torch.cat([keys[:1], keys])[1:]
    line(f"scan kernel n={N}, a view shifted by one word, {ROW} calls in a "
         "row", time_ms(lambda: tile_scan(shifted), calls=ROW), N)
    # K8 on a nonincreasing input (it reverses), and skipped
    out = torch.empty_like(keys)
    down, up = order_flag(2, dev), order_flag(1, dev)
    k_ms = time_ms(lambda: tb.reverse_ordered(keys, out, down), calls=ROW)
    check(torch.equal(out, keys.flip(0)), f"reverse n={N}: timed kernel "
          "output == the input reversed")
    p_ms = time_ms(lambda: tb.reverse_plain(keys, out, down))
    ms["reverse"] = (line(f"reverse kernel n={N}, {ROW} calls in a row",
                          k_ms, N), line(f"reverse plain n={N}", p_ms, N))
    line(f"reverse kernel n={N} on nondecreasing flags (every CTA returns "
         f"at once), {ROW} calls in a row",
         time_ms(lambda: tb.reverse_ordered(keys, out, up), calls=ROW))
    # K8 reads n words and writes n words; no arithmetic to speak of
    extra["reverse"] = dict(bound(2 * 4 * N, 0), library_ms=line(
        f"torch.flip int32 n={N}, {ROW} calls in a row",
        time_ms(lambda: torch.flip(keys, (0,)), calls=ROW), N))
    print(f"bound reverse n={N}: {extra['reverse']['bound_ms']!r} ms by "
          f"{extra['reverse']['bound_by']}")
    del out
    radix_timings(card, keys, values, err, torch_sort, ms, extra)
    del keys, values
    radix_rows_timings(dev, card, err, ms, extra)
    topk_rows_timings(dev, card, err, ms, extra)
    return ms, extra


def topk_rows_timings(dev, card: str, err: dict, ms: dict,
                      extra: dict) -> None:
    """K13, K14 and K15 at the indexer cell's shape (4096 causal rows of
    126,977 to 131,072 float32 scores, k = 2048): each from the state the
    kernels before it left (restored before each call, untimed) beside
    its plain version and its bound by bytes; the bucket sizes K13
    counted; the whole top_k_rows call; torch.topk(dim=1) of the same
    rows masked with -inf (the one PyTorch call that selects them; the
    port never calls it) and the sort_rows route (sort every row, keep
    the first k)."""
    torch.cuda.empty_cache()
    scores, lengths = indexer_scores(dev, SEED + 24)
    rows, context, k = INDEXER
    n = int(lengths.sum())
    keys = scores.view(torch.int32)
    line = functools.partial(time_line, card)
    line(f"sortx_torch.top_k_rows f32 {rows} x {context} k={k} with lengths",
         time_ms(lambda: sortx_torch.top_k_rows(scores, k, lengths=lengths)),
         n)
    masked = scores.masked_fill(
        torch.arange(context, device=dev) >= lengths[:, None], float("-inf"))
    library = line(f"torch.topk(k={k}, dim=1) f32 {rows} x {context} "
                   "masked with -inf", time_ms(
                       lambda: torch.topk(masked, k, dim=1)), n)

    def sort_route():
        s, i = sortx_torch.sort_rows(masked, descending=True,
                                     return_indices=True)
        return s[:, :k].contiguous(), i[:, :k].contiguous()
    line(f"sortx_torch.sort_rows route f32 {rows} x {context}: every row "
         "sorted with indices, the first k kept", time_ms(sort_route, reps=3),
         n)
    del masked
    scratch = torch.empty(tk.scratch_words(rows, context), dtype=torch.int32,
                          device=dev)
    plain_scratch = torch.empty_like(scratch)
    # the slots a kernel leaves alone hold -1 on both sides
    out = torch.full((3, rows, k), -1, dtype=torch.int32, device=dev)
    plain_out = torch.full_like(out, -1)
    what = f"{rows} x {context} k={k}"

    def k13():
        return tk.topk_rows_histogram(keys, lengths, "f32", k, scratch)

    def k13_plain():
        return tk.histogram_plain(keys, lengths, "f32", k, plain_scratch)
    ms["topk_rows_histogram"] = timed_kernel(
        card, f"topk_rows_histogram {what}", k13, k13_plain, err,
        "topk_rows_histogram")
    # K13 reads each valid key once; the row state it writes is a few
    # words a row
    extra["topk_rows_histogram"] = dict(bound(4 * n, 0), library_ms=library)
    size = tk.row_state(plain_scratch, rows, context)[2].to(torch.float64)
    print(f"topk_rows buckets {what}: keys a row mean {size.mean().item()!r}"
          f", min {int(size.min())}, max {int(size.max())}, buffer "
          f"{tk.buffer_cap(context)}")

    def restore(saved, outs=None):
        def setup():
            scratch.copy_(saved[0])
            plain_scratch.copy_(saved[1])
            if outs is not None:
                out.copy_(outs[0])
                plain_out.copy_(outs[1])
        return setup

    def timed(name, run, plain, setup, state=False):
        """(kernel ms, plain ms) of a kernel whose slots land in the order
        its warps take them: its outputs held equal in index order."""
        k_ms = time_ms(run, setup)
        p_ms = time_ms(plain, setup, reps=1)
        setup()
        run()
        plain()
        got, want = by_index(out), by_index(plain_out)
        err[name] = max(err[name], max_abs_err(got, want))
        same = torch.equal(got, want) and torch.equal(
            tk.row_taken(scratch, rows, context),
            tk.row_taken(plain_scratch, rows, context))
        if state:
            same &= torch.equal(tk.row_state(scratch, rows, context),
                                tk.row_state(plain_scratch, rows, context))
        check(same, f"{name} {what}: timed kernel output == plain (each "
              "row's slots in index order)")
        return (time_line(card, f"{name} {what} kernel", k_ms),
                time_line(card, f"{name} {what} plain", p_ms))
    after13 = (scratch.clone(), plain_scratch.clone())
    ms["topk_rows_gather"] = timed(
        "topk_rows_gather",
        lambda: tk.topk_rows_gather(keys, lengths, "f32", k, scratch, *out),
        lambda: tk.gather_plain(keys, lengths, "f32", k, plain_scratch,
                                *plain_out), restore(after13))
    taken = tk.row_taken(plain_scratch, rows, context).to(torch.int64)
    wins, buffered = int(taken[:, 0].sum()), int(taken[:, 1].sum())
    print(f"topk_rows_gather {what}: winners above the bucket a row "
          f"{wins / rows!r}, buffered keys a row {buffered / rows!r}")
    # K14 reads each valid key once and writes each winner's mapped word,
    # index and own word and each buffered key's word and index
    extra["topk_rows_gather"] = dict(bound(4 * n + 12 * wins + 8 * buffered,
                                           0), library_ms=library)
    after14 = (scratch.clone(), plain_scratch.clone())
    outs14 = (out.clone(), plain_out.clone())
    ms["topk_rows_buffer_select"] = timed(
        "topk_rows_buffer_select",
        lambda: tk.topk_rows_buffer_select(keys, lengths, "f32", k, -1,
                                           scratch, *out),
        lambda: tk.buffer_select_plain(keys, lengths, "f32", k, -1,
                                       plain_scratch, *plain_out),
        restore(after14, outs14), state=True)
    # K15 reads each buffered key's word and index once and writes the
    # rest of each row's k slots
    extra["topk_rows_buffer_select"] = dict(
        bound(8 * buffered + 12 * (rows * k - wins), 0), library_ms=library)
    for name in TOPK_ROWS:
        print(f"bound {name} {rows} x {context}: "
              f"{extra[name]['bound_ms']!r} ms by {extra[name]['bound_by']}")
    del scores, lengths, keys, scratch, plain_scratch, out, plain_out
    del after13, after14, outs14


def radix_timings(card: str, keys, values, err: dict, torch_sort: float,
                  ms: dict, extra: dict) -> None:
    """K9, and K10's first pass keys-only and with values, at 2^27, each
    over ROW calls in a row beside its plain version, its bound by bytes
    and torch.sort of the same keys (the one PyTorch call that sorts
    them; the port never calls it). Each K10 call takes a zeroed region
    of its own, zeroed untimed before each timing."""
    scratch = torch.empty(rx.scratch_words(N, 4), dtype=torch.int32,
                          device=keys.device)
    what = f"radix_histogram n={N} sort_bits=32"
    ms["radix_histogram"] = timed_kernel(
        card, what, lambda: rx.radix_histogram(keys, 32, scratch),
        lambda: rx.offsets_plain(keys, 32), err, "radix_histogram",
        calls=ROW)
    # K9 reads each key once; a shift, a mask and an add a digit
    extra["radix_histogram"] = dict(bound(4 * N, 3 * 4 * N),
                                    library_ms=torch_sort)
    offsets = rx.offsets_plain(keys, 32)[0].contiguous()
    regions = torch.empty(ROW, rx.scratch_words(N, 1), dtype=torch.int32,
                          device=keys.device)
    out, vout = torch.empty_like(keys), torch.empty_like(values)
    turn = [0]

    def zero():
        regions.zero_()
        turn[0] = 0

    def one_pass(vals):
        def run():
            rx.radix_onesweep(keys, out, offsets, 0, 8,
                              region=regions[turn[0] % ROW], values=vals,
                              values_out=None if vals is None else vout)
            turn[0] += 1
            return (out,) if vals is None else (out, vout)
        return run

    for vals, bytes_per_key in ((None, 8), (values, 16)):
        what = (f"radix_onesweep n={N} digit 0 "
                f"{'keys-only' if vals is None else 'with values'}")
        k_p = timed_kernel(card, what, one_pass(vals), lambda: [
            t for t in rx.onesweep_plain(keys, 0, 8, offsets, vals)
            if t is not None], err, "radix_onesweep", zero, calls=ROW)
        # a pass reads and writes each key (and value) once; its
        # operations (a match, a shift, a few adds a word) are below that
        b = bound(bytes_per_key * N, 0)
        print(f"bound {what}: {b['bound_ms']!r} ms by {b['bound_by']}")
        if vals is None:
            ms["radix_onesweep"] = k_p
            extra["radix_onesweep"] = dict(b, library_ms=torch_sort)
    del scratch, regions, out, vout
    # the radix engine's time depends on the keys (the network's does
    # not): tie-heavy keys crowd K9's and K10's shared counters
    net = sortx_torch.Config(engine="network")
    gen = torch.Generator(device=keys.device).manual_seed(SEED + 40)
    tied = cwords(gen, N, keys.device)
    for _ in range(4):
        tied &= cwords(gen, N, keys.device)
    for kind, k in (("entropy 0.201 (AND of 5 words)", tied),
                    ("all-equal", torch.full_like(keys, 0x5A5A5A5A))):
        u = k.view(torch.uint32)
        for what, cfg in (("radix", None), ("network", net)):
            time_line(card, f"sortx_torch.sort u32 n={N} {kind} keys, {what} "
                      "engine", time_ms(lambda: sortx_torch.sort(u, config=cfg),
                                        reps=3), N)
    del tied


def radix_rows_timings(dev, card: str, err: dict, ms: dict,
                       extra: dict) -> None:
    """K11 and K12 at the top-p sampler's shape (256 x 129,280 float32
    probabilities, descending): K11, K12's first pass (positions made in
    registers) and a later pass (a value word in and out), each over ROW
    calls in a row beside its plain version and its bound by bytes; the
    whole sort_rows with indices beside the row network's; and torch.sort
    of the same rows with indices (the one PyTorch call that sorts them;
    the port never calls it)."""
    probs = sampler_probs(dev, SEED + 13)
    keys = probs.view(torch.int32)
    R, L = SAMPLER
    n = R * L
    scratch = torch.empty(rr.scratch_words(R, L, True), dtype=torch.int32,
                          device=dev)
    net = sortx_torch.Config(engine="network")
    line = functools.partial(time_line, card)
    line(f"sortx_torch.sort_rows f32 {R} x {L} descending with indices",
         time_ms(lambda: sortx_torch.sort_rows(
             probs, descending=True, return_indices=True)), n)
    line(f"sortx_torch.sort_rows f32 {R} x {L} descending with indices, "
         "row network", time_ms(lambda: sortx_torch.sort_rows(
             probs, descending=True, return_indices=True, config=net)), n)
    library = line(f"torch.sort(dim=1, descending=True, stable=True) f32 "
                   f"{R} x {L}", time_ms(lambda: torch.sort(
                       probs, dim=1, descending=True, stable=True)), n)
    what = f"radix_rows_histogram {R} x {L} f32 descending"
    ms["radix_rows_histogram"] = timed_kernel(
        card, what, lambda: rr.radix_rows_histogram(keys, "f32", True,
                                                    scratch),
        lambda: rr.offsets_rows_plain(keys, "f32", True), err,
        "radix_rows_histogram", calls=ROW)
    # K11 reads each key once; the order map, then a shift, a mask and an
    # add a digit
    extra["radix_rows_histogram"] = dict(bound(4 * n, 3 * 5 * n),
                                         library_ms=library)
    offsets = rr.offsets_rows_plain(keys, "f32", True)
    regions = torch.empty(ROW, rr._region(R, L, True), dtype=torch.int32,
                          device=dev)
    k1, v1 = rr.onesweep_rows_plain(keys, 0, offsets[:, 0], "f32", True,
                                    positions=True)
    out, vout = torch.empty_like(keys), torch.empty_like(keys)
    turn = [0]

    def zero():
        regions.zero_()
        turn[0] = 0

    def one_pass(p, src, vals):
        def run():
            rr.radix_rows_onesweep(src, out, offsets, p, "f32", True,
                                   region=regions[turn[0] % ROW],
                                   values=vals, values_out=vout)
            turn[0] += 1
            return out, vout
        return run

    for p, src, vals, bytes_per_key in ((0, keys, None, 12), (1, k1, v1, 16)):
        what = (f"radix_rows_onesweep {R} x {L} pass {p} "
                f"{'positions made' if vals is None else 'with values'}")
        k_p = timed_kernel(
            card, what, one_pass(p, src, vals), lambda: rr.onesweep_rows_plain(
                src, p, offsets[:, p], "f32", True, vals,
                positions=vals is None), err, "radix_rows_onesweep", zero,
            calls=ROW)
        # a pass reads each key (and value) once and writes each key and
        # value once; its operations (a match, a shift, a few adds a word)
        # are below that
        b = bound(bytes_per_key * n, 0)
        print(f"bound {what}: {b['bound_ms']!r} ms by {b['bound_by']}")
        if vals is not None:
            ms["radix_rows_onesweep"] = k_p
            extra["radix_rows_onesweep"] = dict(b, library_ms=library)
    del probs, keys, scratch, regions, out, vout, k1, v1, offsets


# The blocks (log2) K1 and K2 had at 1 and 4 streams before they kept
# their elements in registers; ops/bitonic.py BLOCK_LOG has today's.
OLD_BLOCK_LOG = {1: 13, 4: 12}


def block_size_ab(card: str, keys, values) -> None:
    """K1, K2 and the whole network at 2^27 at the old and the new block
    size of the stream counts whose block changed, in turns (old, new,
    new, old)."""
    for ns, old in OLD_BLOCK_LOG.items():
        nk = min(ns, 2)
        x0 = torch.stack(([keys, values] * 2)[:ns])
        x = x0.clone()
        restore = lambda: x.copy_(x0)   # noqa: E731
        log_n = N.bit_length() - 1
        for lb in (old, tb.block_log(ns), tb.block_log(ns), old):
            what = f"ns={ns} nk={nk} n={N} block 2^{lb}"
            time_line(card, f"bitonic_block {what}", time_ms(
                lambda: tb.bitonic_block(x, N, nk, lb), restore, reps=3))
            time_line(card, f"bitonic_tail {what}", time_ms(
                lambda: tb.bitonic_tail(x, N, nk, lb, log_n), restore,
                reps=3))
            plan = [name for name, _ in tb.pass_plan(ns, N, nk, log_block=lb)]
            time_line(card, f"network {what} ({plan.count('bitonic_tail')} "
                      f"K2 + {plan.count('bitonic_global')} K3 passes)",
                      time_ms(lambda: tb.bitonic_sort_streams(
                          x, nk, log_block=lb), restore, reps=3))
        del x, x0


def timed_kernel(card: str, what: str, run, plain, err: dict, name: str,
                 setup=None, calls: int = 1):
    """Time a kernel's wrapper (over ``calls`` calls in a row) and its
    plain version on the same inputs (setup, untimed, restores them for
    an in-place run), and hold the timed outputs equal. Returns (kernel
    ms, plain ms)."""
    k_ms = time_ms(run, setup, calls=calls)
    got = [g.clone() for g in _outputs(setup, run)]
    p_ms = time_ms(plain, setup, reps=1)
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


def slice2_timings(dev, card: str, err: dict):
    """Phase 9: CUDA-event medians of the hybrid, rows, select and mover
    paths beside their torch counterparts; the new kernels and the rows
    mode of K1-K3 beside their plain versions; and where the hybrid's
    time goes."""
    torch.cuda.empty_cache()
    rng = np.random.RandomState(SEED + 9)
    keys = words(rng, N, dev)
    u = keys.view(torch.uint32)
    values = torch.arange(N, dtype=torch.int32, device=dev)
    ms, extra = {}, {}

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
    bincount_ms = line(f"torch.bincount of the 8-bit digit n={N}, {ROW} "
                       "calls in a row",
                       time_ms(lambda: torch.bincount((keys >> 24) & 0xFF,
                                                      minlength=256),
                               calls=ROW), N)
    k64 = u64(keys)
    line(f"sortx_torch.kth_value n={N}",
         time_ms(lambda: sortx_torch.kth_value(u, N // 3)), N)
    line(f"torch.kthvalue int64 n={N}",       # 1.9 s a call: one rep
         time_ms(lambda: torch.kthvalue(k64, N // 3 + 1), reps=1), N)
    del k64
    line(f"sortx_torch.kth_value f32 n={N}",
         time_ms(lambda: sortx_torch.kth_value(keys.view(torch.float32),
                                               N // 3)), N)
    line(f"sortx_torch.median n={N}",
         time_ms(lambda: sortx_torch.median(u)), N)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    line(f"the four K5 launches of a kth_value alone n={N}",
         time_ms(lambda: [tile_histogram(keys, shift, radix=256,
                                         tile_elems=16384, per_tile=False,
                                         prefix=zero)
                          for shift in (24, 16, 8, 0)]), N)
    for k in (64, 1024):
        line(f"sortx_torch.top_k k={k} i32 n={N}",
             time_ms(lambda: sortx_torch.top_k(keys, k)), N)
        line(f"sortx_torch.top_k k={k} with indices i32 n={N}",
             time_ms(lambda: sortx_torch.top_k(keys, k,
                                               return_indices=True)), N)
        line(f"torch.topk k={k} int32 n={N}",
             time_ms(lambda: torch.topk(keys, k)), N)

    # K5 per tile (the TPU kernel's function) on uniform words, ROW calls
    # in a row, held against its plain version
    k_ms = time_ms(lambda: tile_histogram(keys, 24, radix=256,
                                          tile_elems=16384), calls=ROW)
    got = tile_histogram(keys, 24, radix=256, tile_elems=16384)
    p_ms = time_ms(lambda: histogram_plain(keys, 24, 256, 16384), reps=1)
    torch.cuda.synchronize()
    want = histogram_plain(keys, 24, 256, 16384)
    err["histogram"] = max(err["histogram"], max_abs_err(got, want))
    check(torch.equal(got, want),
          f"histogram n={N} bits=8 shift=24: timed kernel output == plain")
    what = f"histogram n={N} bits=8 shift=24"
    ms["histogram"] = (line(f"{what} kernel, uniform words, {ROW} calls in a "
                            "row", k_ms, N), line(f"{what} plain", p_ms, N))
    # K5 reads n words and writes 256 counts per 16384-word tile; a
    # shift, a mask and an add per word
    extra["histogram"] = dict(bound(4 * N + 4 * 256 * (N // 16384), 3 * N),
                              library_ms=bincount_ms)
    print(f"bound {what}: {extra['histogram']['bound_ms']!r} ms by "
          f"{extra['histogram']['bound_by']}")
    uniform_ms = ms["histogram"][0]
    for kind in ("all-equal", "two-valued"):
        x = skewed_words(rng, N, dev, kind)
        kind_ms = line(f"{what} kernel, {kind} words, {ROW} calls in a row",
                       time_ms(lambda: tile_histogram(
                           x, 24, radix=256, tile_elems=16384), calls=ROW), N)
        line(f"torch.bincount of the 8-bit digit, {kind} words n={N}",
             time_ms(lambda: torch.bincount((x >> 24) & 0xFF, minlength=256),
                     reps=2), N)
        if kind == "all-equal":
            check(kind_ms <= 2 * uniform_ms, "histogram of all-equal words "
                  "takes at most twice the time of uniform words")
        del x
    line(f"{what} kernel, whole (per_tile=False), uniform words, {ROW} calls "
         "in a row", time_ms(lambda: tile_histogram(
             keys, 24, radix=256, tile_elems=16384, per_tile=False),
             calls=ROW), N)
    del got, want
    tiles, (rs, rd, rl, _), (B, cap, chunk) = hybrid_tables(rng, dev, 1)
    flat = (tiles[0].reshape(-1),)
    ms["run_mover"] = timed_kernel(
        card, f"run_mover: the hybrid's partition n={N}, 1 stream, "
        f"{rs.shape[0]} runs into {B} x {cap}, {ROW} calls in a row",
        lambda: move_runs(flat, rs, rd, rl, B * cap, fills=(-1,),
                          chunk=chunk),
        lambda: move_runs_plain(flat, rs, rd, rl, B * cap, (-1,)), err,
        "run_mover", calls=ROW)
    # K6 reads the words its runs hold and its three run tables, and
    # writes the whole B x cap destination, fills included. One PyTorch
    # call computes the same: torch.cat of the runs and of the fill gaps
    # between them (views of one filled tensor), in destination order.
    views, at, fill = [], 0, torch.full((B * cap,), -1, dtype=torch.int32,
                                         device=dev)
    for s0, d0, ln in sorted(zip(rs.tolist(), rd.tolist(), rl.tolist()),
                             key=lambda r: r[1]):
        views += [fill[:d0 - at], flat[0][s0:s0 + ln]]
        at = d0 + ln
    views.append(fill[:B * cap - at])
    check(torch.equal(torch.cat(views), move_runs(
        flat, rs, rd, rl, B * cap, fills=(-1,), chunk=chunk)[0]),
          "torch.cat of the hybrid partition's runs and fill gaps == "
          "move_runs")
    extra["run_mover"] = dict(
        bound(4 * (int(rl.sum()) + B * cap) + 3 * 4 * rs.shape[0], 0),
        library_ms=line(f"torch.cat of the {rs.shape[0]} runs and their "
                        f"fill gaps (the hybrid's partition) n={N}, {ROW} "
                        "calls in a row",
                        time_ms(lambda: torch.cat(views), calls=ROW), N))
    del tiles, flat, views, fill
    # K7 with its plan on the card (the kernels line: the radix-16 plan),
    # the whole call from the numpy plan, and the yardsticks: torch.cat
    # of the radix-16 plan's runs in destination order (K7's function
    # where the runs tile the output) and a plain device copy
    for name, (tiles, radix) in PIECE_PLANS.items():
        src, plan, runs = radix_plan(rng, dev, tiles, radix)
        card_plan = plan_on_card(plan, dev)
        what = (f"piece_mover: {name} plan n={N}, {len(plan['piece_src'])} "
                f"pieces, plan on the card, {ROW} calls in a row")
        k_p = timed_kernel(card, what,
                           lambda: apply_runs(src, card_plan, N),
                           lambda: apply_runs_plain(src, plan, N),
                           err, "piece_mover", calls=ROW)
        b = piece_mover_bound(plan)
        print(f"bound {what}: {b['bound_ms']!r} ms by {b['bound_by']}; "
              f"share {b['bound_ms'] / k_p[0]!r}")
        line(f"apply_runs: {name} plan n={N}, from the numpy plan (one "
             f"upload a call), {ROW} calls in a row",
             time_ms(lambda: apply_runs(src, plan, N), calls=ROW), N)
        if name == "radix-16":
            ms["piece_mover"] = k_p
            order = np.argsort(runs[1], kind="stable")
            views = [src[int(s):int(s) + int(ln)]
                     for s, ln in zip(runs[0][order], runs[2][order])]
            check(torch.equal(torch.cat(views), apply_runs(src, card_plan,
                                                           N)),
                  "torch.cat of the radix-16 plan's runs == apply_runs")
            extra["piece_mover"] = dict(b, library_ms=line(
                f"torch.cat of the {len(views)} runs of the radix-16 plan "
                f"n={N}, {ROW} calls in a row",
                time_ms(lambda: torch.cat(views), calls=ROW), N))
            out = torch.empty_like(src)
            line(f"out.copy_(src) n={N} (the card's practical copy rate), "
                 f"{ROW} calls in a row",
                 time_ms(lambda: out.copy_(src), calls=ROW), N)
            del views, out
        del src, plan, card_plan

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
    return ms, extra


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


# --- the runtime layer, the facade and the out-of-core sorts ------------

LARGE = 1 << 29        # sort_large's keys: 4 chunks of the default 2^27
CHUNK = 1 << 27        # sort_large's default chunk_elems


def host_gib_available() -> float:
    """MemAvailable of /proc/meminfo, in GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def radix_image(t: torch.Tensor) -> torch.Tensor:
    """int64 whose order is the order sortx gives u32 / i32 / f32 keys
    (the u32 radix image: f32 negatives all bits flipped, the rest the
    sign bit)."""
    b = t.view(torch.int32)
    if t.dtype == torch.float32:
        b = b ^ ((b >> 31) | -(1 << 31))
    elif t.dtype == torch.int32:
        b = b ^ -(1 << 31)
    return b.to(torch.int64) & 0xFFFFFFFF


def check_chunk_launches(what: str, n: int, chunk: int,
                         sort_bits: int) -> None:
    """The launches of the run just made are its chunks' radix sorts: one
    K9 and ceil(sort_bits / 8) K10 passes a chunk, and no network."""
    torch.cuda.synchronize()
    chunks = len(range(0, n, chunk))
    got = {k: c for k, c in _build.launches.items() if k in RADIX + NETWORK}
    print(f"launches of {what}: {got}; {chunks} chunks")
    check(got == {"radix_histogram": chunks, "radix_onesweep":
                  chunks * rx.radix_passes(sort_bits)},
          f"{what}: the launches are those of its {chunks} chunks' radix "
          "sorts")


def facade_checks(dev, card: str) -> dict:
    """ParallelPrimitives on Buffers of 2^27: radix_sort, radix_sort_kv
    of n = 2^26 + 13 (the tails untouched), scan into a u32 buffer with
    the total, each held bit for bit against torch; then the facade
    beside the bare op on the same tensor."""
    from sortx_torch.runtime import Buffer, allocate_device

    device = allocate_device()
    check(device.torch_device == dev and device.n_cores
          == torch.cuda.get_device_properties(dev).multi_processor_count,
          f"allocate_device(): {device!r}, {device.n_cores} SMs, "
          f"{device.hbm_bytes} bytes")
    pp = sortx_torch.ParallelPrimitives(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    keys = cwords(gen, N, dev)
    k64 = u64(keys)
    _build.launches.clear()

    kb = Buffer(device, torch.uint32, N)
    kb.array.view(torch.int32).copy_(keys)
    pp.radix_sort(kb)
    check(torch.equal(u64(kb.array), torch.sort(k64).values),
          f"ParallelPrimitives.radix_sort n={N} == torch.sort")

    n = RAGGED
    host_vals = np.arange(N, dtype=np.uint32)
    kb.array.view(torch.int32).copy_(keys)
    vb = Buffer(device, np.uint32, N)
    sync = vb.write(host_vals, blocking=False)
    sync.wait()
    check(sync.is_complete, f"Buffer.write of {N} words, non-blocking: "
          "its SyncObject completed")
    pp.radix_sort_kv(kb, vb, n)
    ref = torch.sort(k64[:n], stable=True)
    vals = torch.from_numpy(host_vals.view(np.int32)).to(dev)
    check(torch.equal(u64(kb.array[:n]), ref.values)
          and torch.equal(vb.array[:n].view(torch.int32),
                          vals[:n][ref.indices])
          and torch.equal(kb.array[n:].view(torch.int32), keys[n:])
          and torch.equal(vb.array[n:].view(torch.int32), vals[n:]),
          f"ParallelPrimitives.radix_sort_kv n={n} in buffers of {N} == "
          "torch.sort(stable=True) + gather, tails untouched")
    del ref, vals

    src, dst = Buffer(device, torch.int32, N), Buffer(device, np.uint32, N)
    src.array.copy_(keys)
    total = pp.scan(dst, src, with_total=True)
    want, _ = scan_plain(keys)
    check(torch.equal(dst.array.view(torch.int32), want)
          and total.dtype == torch.uint32 and total.dim() == 0
          and int(total.view(torch.int32)) & 0xFFFFFFFF
          == int(k64.sum()) & 0xFFFFFFFF,
          f"ParallelPrimitives.scan(dst u32, src, with_total=True) n={N} "
          "== torch.cumsum, total a 0-d uint32 == sum mod 2^32")
    del want
    counts = read_launches("facade", RADIX + ("scan",))

    restore = lambda: kb.array.view(torch.int32).copy_(keys)  # noqa: E731
    time_line(card, f"ParallelPrimitives.radix_sort u32 n={N} (Buffer)",
              time_ms(lambda: pp.radix_sort(kb), restore), N)
    time_line(card, f"sortx_torch.sort u32 n={N} (the same tensor)",
              time_ms(lambda: sortx_torch.sort(kb.array), restore), N)
    time_line(card, f"ParallelPrimitives.scan n={N} (Buffers)",
              time_ms(lambda: pp.scan(dst, src, with_total=True)), N)
    time_line(card, f"sortx_torch.scan n={N} (the same tensor)",
              time_ms(lambda: sortx_torch.scan(src.array, with_total=True)),
              N)
    for b in (kb, vb, src, dst):
        b.destroy()
    device.check_leaks()
    check(True, "check_leaks(): every Buffer released")
    return counts


def large_split(dev, card: str, what: str, keys: np.ndarray, chunk: int,
                sort_bits: int = 32, descending: bool = False,
                values: np.ndarray | None = None) -> None:
    """sort_large's (or, with values, sort_kv_large's) steps on its own
    data, each timed alone: the key transform on the host, the copies to
    the card, the device sorts of the chunks, the copies back, the host
    merge and the transform back."""
    from sortx_torch.ops import out_of_core as oc
    from sortx_torch.runtime import Stopwatch, native

    omask = np.uint32((1 << sort_bits) - 1)
    off = oc.chunk_offsets(keys.shape[0], chunk)
    bounds = list(zip(off[:-1].tolist(), off[1:].tolist()))
    sw = Stopwatch()
    sw.start()
    ku, undo = oc._np_to_radix_u32(keys)
    if descending:
        ku = ku ^ omask
    sw.split()
    streams = (ku,) if values is None else (ku, values.view(np.uint32))
    on_card = [[oc.to_card(s[lo:hi], dev) for s in streams]
               for lo, hi in bounds]
    sw.split(on_card)
    if values is None:
        done = [(sortx_torch.sort(k, sort_bits),) for (k,) in on_card]
    else:
        done = [sortx_torch.sort_kv(k, v) for k, v in on_card]
    sw.split(done)
    runs = [np.empty_like(s) for s in streams]
    for (lo, hi), outs in zip(bounds, done):
        for r, t in zip(runs, outs):
            oc.from_card(t, r[lo:hi])
    sw.split()
    del on_card, done
    if sort_bits < 32:
        _, out = native.host_merge(runs[0] & omask, off, values=runs[0])
    else:
        out = native.host_merge(runs[0], off, *runs[1:])
        out = out if values is None else out[0]
    sw.split()
    if descending:
        out = out ^ omask
    undo(out)
    sw.stop()
    m = keys.shape[0]
    parts = sw.split_times_ms()
    for part, ms in zip(("key transform (host)", "copies to the card",
                         "device sorts", "copies back", "host merge",
                         "transform back (host)"), parts):
        print(f"time {what} part: {part}: {ms!r} ms = "
              f"{m / (ms / 1e3):.6g}/s [{card}]", flush=True)
    print(f"time {what} parts: sum {sum(parts)!r} ms [{card}]", flush=True)


def out_of_core_checks(dev, card: str) -> None:
    """sort_large of 2^29 host u32 keys (4 chunks; 2^28 if the host's
    free memory cannot hold 2^29 keys four times over), sort_kv_large of
    2^28 + 13 f32 keys with i32 values (3 chunks, the last ragged), and
    sort_large(sort_bits=16, descending=True) at 2^28, each held bit for
    bit against a stable torch.sort of the radix image on the card, with
    its launches and the time of its parts."""
    from sortx_torch.runtime import Stopwatch

    gib = host_gib_available()
    big = LARGE if gib >= 4 * LARGE * 4 / 2**30 else LARGE // 2
    print(f"host memory available: {gib:.1f} GiB; sort_large runs at "
          f"n={big}" + ("" if big == LARGE else
                        f" (not {LARGE}: too little host memory)"))
    chunk = CHUNK
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)

    def timed(what, fn, m):
        torch.cuda.synchronize()
        _build.launches.clear()
        sw = Stopwatch()
        sw.start()
        out = fn()
        sw.stop()
        print(f"time {what} total: {sw.get_ms()!r} ms = "
              f"{m / (sw.get_ms() / 1e3):.6g}/s [{card}]", flush=True)
        return out

    card_keys = cwords(gen, big, dev)
    host = card_keys.cpu().numpy().view(np.uint32)
    what = f"sort_large u32 n={big}"
    out = timed(what, lambda: sortx_torch.sort_large(
        host, chunk_elems=chunk, device=dev), big)
    check_chunk_launches(what, big, chunk, 32)
    want = torch.sort(radix_image(card_keys.view(torch.uint32))).values
    check(torch.equal(u64(torch.from_numpy(out.view(np.int32)).to(dev)),
                      want), f"{what} == torch.sort on the card")
    del out, want, card_keys
    large_split(dev, card, what, host, chunk)
    del host

    n = LARGE // 2 + 13
    fk = torch.randn(n, device=dev, generator=gen)
    fk[::1001] = -0.0
    kf, vi = fk.cpu().numpy(), np.arange(n, dtype=np.int32)
    what = f"sort_kv_large f32 keys, i32 values n={n}"
    ks, vs = timed(what, lambda: sortx_torch.sort_kv_large(
        kf, vi, chunk_elems=chunk, device=dev), n)
    check_chunk_launches(what, n, chunk, 32)
    order = torch.sort(radix_image(fk), stable=True).indices
    check(torch.equal(torch.from_numpy(ks.view(np.int32)).to(dev),
                      fk.view(torch.int32)[order])
          and torch.equal(torch.from_numpy(vs).to(dev),
                          order.to(torch.int32)),
          f"{what} == torch.sort(stable=True) of the radix image")
    del fk, ks, vs, order
    large_split(dev, card, what, kf, chunk, values=vi)
    del kf, vi

    n = LARGE // 2
    card_keys = cwords(gen, n, dev)
    host = card_keys.cpu().numpy().view(np.uint32)
    what = f"sort_large u32 sort_bits=16 descending n={n}"
    out = timed(what, lambda: sortx_torch.sort_large(
        host, 16, descending=True, chunk_elems=chunk, device=dev), n)
    check_chunk_launches(what, n, chunk, 16)
    order = torch.sort((~card_keys) & 0xFFFF, stable=True).indices
    check(torch.equal(torch.from_numpy(out.view(np.int32)).to(dev),
                      card_keys[order]),
          f"{what} == torch.sort(stable=True) of the complemented low "
          "16 bits")
    del out, order, card_keys
    large_split(dev, card, what, host, chunk, 16, descending=True)


def idle_share(dev, card: str) -> None:
    """One flagship entry (stable sort_kv, then scan) at 2^27 under
    runtime.profiler.trace: the share of the traced window in which a
    CUDA kernel ran (the union of the kernel intervals)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    keys = cwords(gen, N, dev).view(torch.uint32)
    values = torch.arange(N, dtype=torch.int32, device=dev)
    sortx_torch.entry(keys, values)          # warm
    torch.cuda.synchronize()
    traced_idle_share(card, f"entry n={N}",
                      lambda: sortx_torch.entry(keys, values))


def traced_idle_share(card: str, what: str, run) -> None:
    """run() under runtime.profiler.trace, once to warm the profiler and
    once annotated as ``what``: print the share of the annotated window
    in which the card ran a kernel (the union of the kernel intervals)
    and in which it ran a kernel, a copy or a memset,
    the gaps between them, and the busiest names."""
    import tempfile

    from sortx_torch.runtime import profiler

    with tempfile.TemporaryDirectory() as d:
        with profiler.trace(d):
            run()                   # the profiler's start stays outside
            torch.cuda.synchronize()
            with profiler.annotate(what):
                run()
                torch.cuda.synchronize()
        (path,) = [os.path.join(d, f) for f in os.listdir(d)]
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("name") == what
              and e.get("cat") == "user_annotation"]
    check(len(window) >= 1, f"the trace holds the annotated {what}")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device = [(max(float(e["ts"]), w0),
               min(float(e["ts"]) + float(e["dur"]), w1), e["cat"],
               e.get("name", "?")) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e.get("ph") == "X"]
    device = [e for e in device if e[1] > e[0]]
    kernels = [e for e in device if e[2] == "kernel"]
    check(len(kernels) > 0, f"the trace holds {len(kernels)} CUDA kernels "
          f"inside the window of {what}")

    def union(spans):
        spans = sorted(spans)
        busy, end, gaps = 0.0, spans[0][0], []
        for a, b, *_ in spans:
            if b > end:
                busy += b - max(a, end)
                if a > end:
                    gaps.append(a - end)
                end = b
        return busy, gaps, end

    width = w1 - w0
    k_busy = union(kernels)[0]
    busy, gaps, end = union(device)
    print(f"time {what} traced window: {width / 1e3!r} ms, kernels busy "
          f"{k_busy / 1e3!r} ms (device idle share {1 - k_busy / width!r}, "
          f"{len(kernels)} kernels), kernels, copies and memsets busy "
          f"{busy / 1e3!r} ms (device idle share {1 - busy / width!r}, "
          f"{len(device)} activities) [{card}]", flush=True)
    inner = sorted(gaps, reverse=True)
    first = min(e[0] for e in device)
    print(f"time {what} idle: before the first activity "
          f"{(first - w0) / 1e3!r} ms, after the last {(w1 - end) / 1e3!r} "
          f"ms, between activities {sum(inner) / 1e3!r} ms in {len(inner)} "
          f"gaps (largest {[round(g / 1e3, 4) for g in inner[:4]]} ms) "
          f"[{card}]", flush=True)
    by_name = collections.Counter()
    for a, b, cat, name in device:
        by_name[f"{cat} {name[:60]}"] += b - a
    print(f"time {what} busiest: " + "; ".join(
        f"{name}: {t / 1e3:.4f} ms" for name, t in by_name.most_common(6))
        + f" [{card}]", flush=True)


# --- the ops inside a CUDA graph ------------------------------------------

GRAPH_N = 1 << 22      # the capture list's ops off the main path
GRAPH_KINDS = ("random", "nondecreasing", "nonincreasing", "all-equal")
GRAPH_TIMES = (1 << 16, 1 << 20, 1 << 22, N)
GRAPH_ROW = 10         # calls in a row per timing, eager and replayed
GRAPH_REPS = 7         # timings per median
HOST = sortx_torch.Config(engine="host")


def arranged(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Keys t (1-D, or rows along the last dimension) as one kind of the
    graph phase's inputs: as they are, in the order of sortx_torch.sort
    (its host engine, torch.sort on the radix image), in the reverse of
    it, or all equal to the first key."""
    if kind == "random":
        return t
    if kind == "all-equal":
        return t.reshape(-1)[:1].expand(t.shape).clone()
    down = kind == "nonincreasing"
    if t.dim() == 2:
        return sortx_torch.sort_rows(t, descending=down, config=HOST)
    return sortx_torch.sort(t, descending=down, config=HOST)


def graph_keys(gen, dtype, n: int, dev) -> torch.Tensor:
    """n random keys of dtype: duplicate-heavy 32- and 16-bit words,
    random 64-bit words, floats from a normal law."""
    if dtype.is_floating_point:
        return torch.randn(n, generator=gen, device=dev).to(dtype)
    if dtype in (torch.int64, torch.uint64):
        w = torch.randint(-2**62, 2**62, (n,), generator=gen, device=dev)
        return w.view(dtype)
    w = cwords(gen, n, dev)
    if dtype in (torch.int16, torch.uint16):
        return w.to(torch.int16).view(dtype)
    return (w & 0x0FFFFFFF).view(dtype)   # ties: 2^28 values


def same_tree(a, b) -> bool:
    """Two outputs (a tensor or a tuple of them) equal bit for bit."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(iv(x.contiguous()), iv(y.contiguous()))
        for x, y in zip(a, b))


def no_sync(run):
    """run() with every implicit synchronisation an error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return run()
    finally:
        torch.cuda.set_sync_debug_mode("default")


class Captured:
    """One op captured into a CUDA graph on static inputs: made from
    make("random"), warmed up eagerly on a side stream (which also builds
    the kernels), checked to make no implicit sync, then captured."""

    def __init__(self, name: str, make, run):
        self.name, self.make, self.run = name, make, run
        self.static = make("random")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(self.static)
        torch.cuda.current_stream().wait_stream(side)
        no_sync(lambda: run(self.static))
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = run(self.static)
        torch.cuda.synchronize()

    def load(self, inputs: dict) -> None:
        for k, t in inputs.items():
            self.static[k].copy_(t)

    def replay_checks(self, kinds, ref=None) -> None:
        """For each kind: copy_ its inputs into the static ones, replay,
        and hold the replay bit for bit against the eager call on the
        same input (and that against ref(static, kind, eager) if given)."""
        for kind in kinds:
            self.load(self.make(kind) if isinstance(kind, str) else kind[1])
            label = kind if isinstance(kind, str) else kind[0]
            self.graph.replay()
            eager = self.run(self.static)
            extra = "" if ref is None else ref(self.static, label, eager)
            check(same_tree(self.out, eager),
                  f"graph {self.name} {label}: replay == eager bit for "
                  f"bit{extra}")

    def free(self) -> None:
        del self.graph, self.out, self.static
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def pairs(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The sorted (key, value) pairs of 32-bit words, as int64."""
    return torch.sort((iv(k).to(torch.int64) << 32)
                      | (iv(v).to(torch.int64) & 0xFFFFFFFF)).values


def main_graph_ops(dev, n: int) -> dict:
    """name -> (make(kind), run(static), ref(static, kind, eager)): the
    main path's ops, each eager output held against the host engine on
    the same input (unstable sort_kv: its keys, and its (key, value)
    multiset, or on a presorted input its values as they are)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    vals = torch.arange(n, dtype=torch.int32, device=dev)

    def keys(kind):
        return {"k": arranged(graph_keys(gen, torch.uint32, n, dev), kind)}

    def kv(kind):
        return dict(keys(kind), v=cwords(gen, n, dev))

    def vs_host(fn, what):
        def ref(st, kind, eager):
            check(same_tree(eager, fn(st, HOST)),
                  f"graph {what} n={n} {kind}: eager == the host engine")
            return ""
        return ref

    def unstable_ref(st, kind, eager):
        ks, vs = eager
        want = sortx_torch.sort(st["k"], config=HOST)
        kept = (torch.equal(vs, st["v"]) if kind in ("nondecreasing",
                                                     "all-equal")
                else torch.equal(pairs(ks, vs), pairs(st["k"], st["v"])))
        check(same_tree(ks, want) and kept,
              f"graph sort_kv unstable n={n} {kind}: eager keys == the host "
              "engine's, values " + ("as they came (the presorted branch)"
                                     if kind in ("nondecreasing", "all-equal")
                                     else "a permutation within the pairs"))
        return ""

    sort = lambda st, cfg=None: sortx_torch.sort(st["k"], config=cfg)  # noqa
    kv_s = lambda st, cfg=None: sortx_torch.sort_kv(  # noqa: E731
        st["k"], st["v"], config=cfg)
    scan = lambda st, cfg=None: sortx_torch.scan(  # noqa: E731
        st["k"].view(torch.int32), with_total=True, config=cfg)
    entry = lambda st, cfg=None: sortx_torch.entry(  # noqa: E731
        st["k"], vals, config=cfg)
    return {
        "sort u32": (keys, sort, vs_host(sort, "sort u32")),
        "sort_kv stable": (kv, kv_s, vs_host(kv_s, "sort_kv stable")),
        "sort_kv unstable": (kv, lambda st: sortx_torch.sort_kv(
            st["k"], st["v"], stable=False), unstable_ref),
        "scan with total": (keys, scan, vs_host(scan, "scan")),
        "entry": (keys, entry, vs_host(entry, "entry")),
    }


def other_graph_ops(dev, n: int = GRAPH_N) -> dict:
    """name -> (make(kind), run(static)): the rest of the capture list at
    n = 2^22 (sort_rows: 64 rows of 2^16)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 52)

    def keys(dtype, m=n, **more):
        def make(kind):
            return dict({"k": arranged(graph_keys(gen, dtype, m, dev), kind)},
                        **{k: f(m) for k, f in more.items()})
        return make

    v32 = lambda m: cwords(gen, m, dev)  # noqa: E731
    v64 = lambda m: graph_keys(gen, torch.int64, m, dev)  # noqa: E731
    x32 = lambda m: cwords(gen, m, dev) & 0xFFFF  # noqa: E731

    def merged(kind):
        both = graph_keys(gen, torch.uint32, n + n // 2, dev)
        if kind == "all-equal":
            both = arranged(both, kind)
        srt = arranged(both, "nondecreasing")
        if kind == "random":       # two sorted runs that interleave
            a = arranged(both[:n], "nondecreasing")
            b = arranged(both[n:], "nondecreasing")
        else:                      # a wholly below b, or wholly above it
            a, b = srt[:n], srt[n:]
            if kind == "nonincreasing":
                a, b = srt[n // 2:], srt[:n // 2]
        return {"a": a, "b": b, "va": v32(n), "vb": v32(n // 2)}

    offsets = torch.tensor([0, 0, 17, n // 3, n // 3, n - 5, n],
                           dtype=torch.int64, device=dev)
    rows = (64, n // 64)

    def row_keys(kind):
        k = graph_keys(gen, torch.uint32, n, dev).view(rows)
        return {"k": arranged(k, kind), "v": v32(n).view(rows)}

    def ranked(kind):
        return dict(keys(torch.uint32)(kind),
                    r=torch.full((), n // 3, dtype=torch.int32, device=dev))

    S = lambda st, *a, **kw: sortx_torch.sort(st["k"], *a, **kw)  # noqa
    ops = {f"sort {name}": (keys(dt), S) for name, dt in (
        ("i32", torch.int32), ("f32", torch.float32), ("u16", torch.uint16),
        ("bf16", torch.bfloat16), ("u64", torch.uint64),
        ("i64", torch.int64), ("f64", torch.float64))}
    ops.update({
        "sort ragged u32": (keys(torch.uint32, n + 13), S),
        "sort sort_bits=8 (packed)": (keys(torch.uint32),
                                      lambda st: S(st, 8)),
        "sort sort_bits=20": (keys(torch.uint32), lambda st: S(st, 20)),
        "sort descending": (keys(torch.uint32),
                            lambda st: S(st, descending=True)),
        "sort_kv stable 64-bit values": (
            keys(torch.uint32, v=v64),
            lambda st: sortx_torch.sort_kv(st["k"], st["v"])),
        "sort_kv unstable 64-bit values": (
            keys(torch.uint32, v=v64),
            lambda st: sortx_torch.sort_kv(st["k"], st["v"], stable=False)),
        "sort_kv stable ragged sort_bits=12": (
            keys(torch.uint32, n + 13, v=v32),
            lambda st: sortx_torch.sort_kv(st["k"], st["v"], 12)),
        "argsort": (keys(torch.uint32),
                    lambda st: sortx_torch.argsort(st["k"])),
        "argsort u64": (keys(torch.uint64),
                        lambda st: sortx_torch.argsort(st["k"])),
        "lexsort": (keys(torch.uint32, v=v32),
                    lambda st: sortx_torch.lexsort((st["v"], st["k"]))),
        "merge": (merged, lambda st: sortx_torch.merge(st["a"], st["b"])),
        "merge_kv": (merged, lambda st: sortx_torch.merge_kv(
            st["a"], st["va"], st["b"], st["vb"])),
        "sort_segments": (keys(torch.uint32), lambda st:
                          sortx_torch.sort_segments(st["k"], offsets)),
        "scan_segments": (
            lambda kind: {"k": arranged(x32(n), kind)},
            lambda st: sortx_torch.scan_segments(st["k"], offsets,
                                                 with_totals=True)),
        "kth_value (rank tensor)": (ranked, lambda st: sortx_torch.kth_value(
            st["k"], st["r"])),
        "median": (keys(torch.float32),
                   lambda st: sortx_torch.median(st["k"])),
        "top_k k=64": (keys(torch.int32),
                       lambda st: sortx_torch.top_k(st["k"], 64)),
        "top_k k=64 with indices": (
            keys(torch.int32),
            lambda st: sortx_torch.top_k(st["k"], 64, return_indices=True)),
        "unique": (lambda kind: {"k": arranged(cwords(gen, n, dev) & 0xFFF,
                                               kind).view(torch.uint32)},
                   lambda st: sortx_torch.unique(st["k"], 4096)),
        "histogram": (keys(torch.uint32),
                      lambda st: sortx_torch.histogram(st["k"], 8, 20)),
        "sort_rows": (row_keys, lambda st: sortx_torch.sort_rows(st["k"])),
        "sort_kv_rows": (row_keys, lambda st: sortx_torch.sort_kv_rows(
            st["k"], st["v"])),
        "sort_rows network": (row_keys, lambda st: sortx_torch.sort_rows(
            st["k"], config=NET)),
        "sort_kv_rows network": (row_keys, lambda st: sortx_torch.sort_kv_rows(
            st["k"], st["v"], config=NET)),
    })
    return ops


def graph_timings(dev, card: str) -> None:
    """Eager calls against replays of the same op on the same input,
    GRAPH_ROW calls in a row per timing, the median of GRAPH_REPS: sort,
    stable sort_kv and scan at 2^16..2^27, and sort on nondecreasing and
    nonincreasing keys at 2^27."""
    cases = [(name, n, "random") for n in GRAPH_TIMES
             for name in ("sort u32", "sort_kv stable", "scan with total")]
    cases += [("sort u32", N, "nondecreasing"), ("sort u32", N,
                                                 "nonincreasing")]
    for name, n, kind in cases:
        make, run, _ = main_graph_ops(dev, n)[name]
        cap = Captured(name, lambda k: make(kind), run)
        what = f"{name} n={n} {kind}"
        eager = time_line(card, f"graph eager {what}, {GRAPH_ROW} calls in "
                          "a row", time_ms(lambda: run(cap.static),
                                           reps=GRAPH_REPS, calls=GRAPH_ROW))
        replay = time_line(card, f"graph replay {what}, {GRAPH_ROW} "
                           "replays in a row", time_ms(
                               cap.graph.replay, reps=GRAPH_REPS,
                               calls=GRAPH_ROW))
        print(f"graph {what}: eager / replay = {eager / replay!r}")
        cap.free()


def graph_path(dev, card: str) -> None:
    """The graph phase: every op of the capture list captured once into a
    CUDA graph and replayed on random, nondecreasing, nonincreasing and
    all-equal inputs (kth_value also on a new rank), each replay bit for
    bit the eager call; the eager call made under
    set_sync_debug_mode("error") first; the hybrid refusing capture; the
    times of eager calls and replays; the flagship entry's idle share
    under replay."""
    for n in (N, RAGGED):
        for name, (make, run, ref) in main_graph_ops(dev, n).items():
            cap = Captured(f"{name} n={n}", make, run)
            cap.replay_checks(GRAPH_KINDS, ref)
            cap.free()
    for name, (make, run) in other_graph_ops(dev).items():
        cap = Captured(f"{name} n={GRAPH_N}", make, run)
        kinds = GRAPH_KINDS
        if name.startswith("kth_value"):
            new_rank = dict(make("random"), r=torch.full(
                (), GRAPH_N - 7, dtype=torch.int32, device=dev))
            kinds += (("random, another rank", new_rank),)
        cap.replay_checks(kinds)
        cap.free()
    keys = cwords(torch.Generator(device=dev).manual_seed(SEED + 53),
                  GRAPH_N, dev).view(torch.uint32)
    graph = torch.cuda.CUDAGraph()
    refused = None
    try:
        with torch.cuda.graph(graph):
            sortx_torch.sort(keys, config=HYBRID)
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and "hybrid" in refused,
          f"the hybrid engine refuses capture: {refused!r}")
    del graph
    graph_timings(dev, card)
    for name, kind in (("entry", "random"), ("sort u32", "nondecreasing")):
        make, run, _ = main_graph_ops(dev, N)[name]
        cap = Captured(name, lambda k: make(kind), run)
        traced_idle_share(card, f"{name} n={N} {kind}, replayed from a "
                          "CUDA graph", cap.graph.replay)
        cap.free()


# --- the distributed layer ----------------------------------------------

DIST_N = 1 << 26       # the D > 1 runs' global keys: 2^25 / 2^24 a rank
DIST_RAGGED = (1 << 26) + 13
DIST_SEED = SEED + 31
# Calls of each case a rank makes: the first counts the launches and saves
# the outputs, the next WHOLE time the whole call, the rest time each
# step (profiled at level "step", which synchronises at the steps' ends).
DIST_REPS = 5
WHOLE = 2
SHARED = "processes sharing one card; not a scaling figure"
TREE = (["ragged", "bitonic", "tree"], "merge tree")
RESORT = (["ragged", "radix", "sort"], "merge sort")   # "auto" on a card
DIST_BRANCH = {       # case -> (witness, the step that must have run)
    "sort": RESORT, "sort_kv": RESORT, "sort_kv i64": TREE,
    "sort ragged": RESORT, "sort_kv network": TREE,
    "sort ragged network": TREE,
}
SKEW = "merge sort (tree skew)"


def dist_launched(counts: dict, engine: str) -> tuple:
    """(the kernels a rank's sorts on ``engine`` must have launched,
    whether it launched none of the other engine's)."""
    need, other = (RADIX, NETWORK) if engine == "radix" else (NETWORK, RADIX)
    return need, not any(counts.get(k, 0) for k in other)


def dist_same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(iv(a), iv(b))


def dist_one_rank(dev, card: str) -> dict:
    """World size 1 on NCCL (init_multihost with no environment) at 2^27:
    dist_sort (u32), stable dist_sort_kv, dist_sort_padded at 2^26 + 13
    and dist_scan, each bit for bit the single-card op on the same
    tensor; the single-card results are taken first, so the counted
    launches are the distributed calls' own."""
    import torch.distributed as dist

    from sortx_torch.parallel import init_multihost

    init_multihost()
    try:
        mesh = sortx_torch.make_sort_mesh()
        check(dist.get_backend() == "nccl" and mesh.size() == 1
              and mesh.device_type == "cuda",
              "init_multihost(): a one-rank NCCL group, a 1-rank cuda mesh")
        gen = torch.Generator(device=dev).manual_seed(SEED + 30)
        keys = cwords(gen, N, dev).view(torch.uint32)
        values = torch.arange(N, dtype=torch.int32, device=dev)
        rk = keys[:RAGGED]
        want = sortx_torch.sort(keys)
        wks, wvs = sortx_torch.sort_kv(keys, values)
        wr = sortx_torch.sort(rk)
        ws, wt = sortx_torch.scan(keys, with_total=True)
        torch.cuda.synchronize()
        _build.launches.clear()
        out = sortx_torch.dist_sort(keys, mesh=mesh)
        ds = sys.modules["sortx_torch.parallel.dist_sort"]
        witness = [ds.last_exchange, ds.last_local_engine,
                   ds.last_local_merge]
        check(dist_same(out, want) and witness == ["single", "radix",
                                                    "single"],
              f"dist_sort u32 n={N}, world size 1 (NCCL) == "
              f"sortx_torch.sort, witness {witness} (the single-card "
              "sort's radix engine)")
        ks, vs = sortx_torch.dist_sort_kv(keys, values, mesh=mesh)
        check(dist_same(ks, wks) and dist_same(vs, wvs),
              f"stable dist_sort_kv n={N}, world size 1 == sort_kv")
        out, pad = sortx_torch.dist_sort_padded(rk, mesh=mesh)
        check(pad == 0 and dist_same(out, wr), f"dist_sort_padded "
              f"n={RAGGED}, world size 1 == sort, pad 0")
        s, t = sortx_torch.dist_scan(keys, with_total=True, mesh=mesh)
        check(dist_same(s, ws) and dist_same(t, wt),
              f"dist_scan n={N}, world size 1 == scan, the same total")
        del out, ks, vs, s
        counts = read_launches("distributed, world size 1",
                               RADIX + ("scan",))
        for what, dist_fn, one in (
                ("sort u32", lambda: sortx_torch.dist_sort(keys, mesh=mesh),
                 lambda: sortx_torch.sort(keys)),
                ("scan", lambda: sortx_torch.dist_scan(keys, mesh=mesh),
                 lambda: sortx_torch.scan(keys))):
            time_line(card, f"dist {what} n={N}, world size 1 (NCCL)",
                      time_ms(dist_fn), N)
            time_line(card, f"sortx_torch.{what.split()[0]} n={N} (the same "
                      "tensor)", time_ms(one), N)
    finally:
        dist.destroy_process_group()
    return counts


def dist_values64(dev, n: int = DIST_N) -> torch.Tensor:
    """int64 values whose two words both differ from element to element."""
    i = torch.arange(n, dtype=torch.int64, device=dev)
    return (i << 32) | (i ^ 0x5A5A5A5A)


def dist_cases(mesh, keys, rkeys):
    """(name, call) of each D > 1 case, on this rank's shards."""
    values = sortx_torch.parallel.shard_1d(torch.arange(
        DIST_N, dtype=torch.int32, device=keys.device), mesh).clone()
    values64 = sortx_torch.parallel.shard_1d(dist_values64(keys.device),
                                             mesh).clone()
    net = sortx_torch.Config(engine="network")
    u = keys.view(torch.uint32)
    return (
        ("sort", lambda: (sortx_torch.dist_sort(u, mesh=mesh),)),
        ("sort_kv", lambda: sortx_torch.dist_sort_kv(u, values, mesh=mesh)),
        ("sort_kv i64", lambda: sortx_torch.dist_sort_kv(u, values64,
                                                         mesh=mesh)),
        ("scan", lambda: sortx_torch.dist_scan(keys, with_total=True,
                                               mesh=mesh)),
        ("sort ragged", lambda: (sortx_torch.dist_sort(
            rkeys.view(torch.uint32), mesh=mesh),)),
        ("sort_kv network", lambda: sortx_torch.dist_sort_kv(
            u, values, mesh=mesh, config=net)),
        ("sort ragged network", lambda: (sortx_torch.dist_sort(
            rkeys.view(torch.uint32), mesh=mesh, config=net),)))


def dist_rank(rank: int, d: int, tmp: str) -> None:
    """One of D ranks sharing the card over a gloo group: each case
    DIST_REPS times (all ranks start each call together), the first with
    its launches counted and its outputs saved for the parent, the next
    WHOLE timed whole and unprofiled, the rest with the launcher's row
    for each step (``dist_sort/<step>``, at level "step")."""
    import datetime
    import importlib

    import torch.distributed as dist

    from sortx_torch.runtime import toggle_profiling

    ds = importlib.import_module("sortx_torch.parallel.dist_sort")

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=d, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    dev = torch.device("cuda", 0)
    mesh = sortx_torch.make_sort_mesh()
    gen = torch.Generator(device=dev).manual_seed(DIST_SEED)
    keys = sortx_torch.parallel.shard_1d(cwords(gen, DIST_N, dev),
                                         mesh).clone()
    rkeys = sortx_torch.parallel.shard_1d(cwords(gen, DIST_RAGGED, dev),
                                          mesh).clone()
    csv = f"{tmp}/profile.{rank}.csv"
    report = {"mesh": mesh.device_type, "backend": dist.get_backend()}
    for case, call in dist_cases(mesh, keys, rkeys):
        steps = collections.defaultdict(list)
        totals = []
        for rep in range(DIST_REPS):
            profile = rep > WHOLE
            if profile:
                if os.path.exists(csv):
                    os.remove(csv)
                toggle_profiling(True, csv, level="step")
            dist.barrier()
            torch.cuda.synchronize()
            _build.launches.clear()
            t = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if profile:
                toggle_profiling(False, level="op")
                with open(csv) as f:
                    for row in f:
                        name, step_ms = row.split(",")[:2]
                        if name.startswith("dist_sort/"):
                            steps[name[len("dist_sort/"):]].append(
                                float(step_ms))
            elif rep:
                totals.append(ms)
            if rep == 0:
                launches = dict(_build.launches)
                for i, o in enumerate(out):
                    np.save(f"{tmp}/{case}.{rank}.{i}.npy",
                            iv(o).cpu().numpy())
            del out
        torch.cuda.empty_cache()    # D ranks and the parent share the card
        report[case] = {"launches": launches, "total_ms": totals,
                        "steps": dict(steps),
                        "witness": [ds.last_exchange, ds.last_local_engine,
                                    ds.last_local_merge]}
    with open(f"{tmp}/report.{rank}.json", "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def dist_ranks(dev, card: str, d: int, wants: dict) -> dict:
    """D ranks on the one card (spawned; the kernels are built already, so
    they only load them), held against the single-card ops of the whole
    input; returns the ranks' summed launches."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        mp.spawn(dist_rank, args=(d, tmp), nprocs=d, join=True)
        print(f"dist D={d}: ranks spawned, ran and exited in "
              f"{time.perf_counter() - t:.1f} s")
        reports = []
        for r in range(d):
            with open(f"{tmp}/report.{r}.json") as f:
                reports.append(json.load(f))
        check(all(x["mesh"] == "cuda" and x["backend"] == "gloo"
                  for x in reports), f"D={d}: every rank on a cuda mesh over "
              "a gloo group")
        total = collections.Counter()
        for case, want in wants.items():
            ok = True
            for i, w in enumerate(want):
                parts = [torch.from_numpy(np.load(f"{tmp}/{case}.{r}.{i}.npy")
                                          ).to(dev) for r in range(d)]
                if w.dim():     # shards, joined in rank order
                    ok &= dist_same(torch.cat(parts), w)
                else:           # a total, the same on every rank
                    ok &= all(dist_same(p, w) for p in parts)
                del parts
            check(ok, f"dist {case} D={d} ranks, n={want[0].shape[0]}: the "
                  "gathered shards == the single-card op of the whole input")
            for r, x in enumerate(reports):
                c = x[case]["launches"]
                need, alone = dist_launched(c, x[case]["witness"][1])
                if case == "scan":
                    need, alone = ("scan",), True
                check(all(c.get(k, 0) > 0 for k in need) and alone,
                      f"dist {case} D={d} rank {r} launched "
                      f"{', '.join(need)} and no other engine's kernels: "
                      f"{c}; witness {x[case]['witness']}")
                total.update(c)
                if case in DIST_BRANCH:
                    witness, step = DIST_BRANCH[case]
                    ran = set(x[case]["steps"])
                    check(x[case]["witness"] == witness and step in ran
                          and SKEW not in ran,
                          f"dist {case} D={d} rank {r}: witness {witness}, "
                          f"ran {step!r} and no skew re-sort: "
                          f"{x[case]['witness']}, {sorted(ran)}")
            n = DIST_RAGGED if case.startswith("sort ragged") else DIST_N
            for name in reports[0][case]["steps"]:
                ms = max(statistics.median(x[case]["steps"][name])
                         for x in reports)
                print(f"time dist {case} D={d} n={n} step (profiled): "
                      f"{name}: {ms!r} ms "
                      f"(the slowest rank's median; {d} {SHARED}) [{card}]",
                      flush=True)
            ms = max(statistics.median(x[case]["total_ms"]) for x in reports)
            print(f"time dist {case} D={d} n={n} whole call (unprofiled): "
                  f"{ms!r} ms = {n / (ms / 1e3):.6g}/s ({d} {SHARED}) "
                  f"[{card}]", flush=True)
    return total


def dist_path(dev, card: str) -> dict:
    """The distributed layer: world size 1 on NCCL, then D = 2 and 4 gloo
    ranks sharing the card. Returns the launches of K1-K4 on the path
    (the parent's and every rank's)."""
    counts = collections.Counter(dist_one_rank(dev, card))
    gen = torch.Generator(device=dev).manual_seed(DIST_SEED)
    keys = cwords(gen, DIST_N, dev)
    rkeys = cwords(gen, DIST_RAGGED, dev)
    values = torch.arange(DIST_N, dtype=torch.int32, device=dev)
    u = keys.view(torch.uint32)
    sorted_u = sortx_torch.sort(u)
    wants = {"sort": (sorted_u,),
             "sort_kv": sortx_torch.sort_kv(u, values),
             "sort_kv i64": sortx_torch.sort_kv(u, dist_values64(dev)),
             "scan": sortx_torch.scan(keys, with_total=True),
             "sort ragged": (sortx_torch.sort(rkeys.view(torch.uint32)),)}
    wants["sort_kv network"] = wants["sort_kv"]
    wants["sort ragged network"] = wants["sort ragged"]
    del keys, rkeys, values, u
    torch.cuda.synchronize()
    torch.cuda.empty_cache()    # the ranks share the card with this process
    for d in (2, 4):
        counts.update(dist_ranks(dev, card, d, wants))
    return counts


# --- the distributed layer across cards: one rank per card over NCCL ------

CARD_KEYS = 1 << 27     # keys a rank in the full-size cases (2^29 at D = 4)
CARD_BRANCH = 1 << 22   # keys a rank in the other branches' cases
CARD_SEED = SEED + 41
CARD_REPS = 5           # unprofiled whole calls a full-size case times
CARD_STEP_REPS = 2      # profiled calls it reads its steps from
# The cases that run again under engine="network" ("<case> network"),
# with their witness and step there: the network's local sort, its merge
# tree and its position lane.
NETWORK_TWINS = {
    "sort_kv i32": TREE, "sort padded": TREE, "sort_kv padded": TREE,
    "all equal": TREE, "descending": TREE, "partial bits": TREE,
    "n < D": TREE}
# case -> (witness, the step that must have run) at D = 4; the tree's
# cases must also have taken no skew re-sort
CARD_BRANCH_OF = {
    "sort": RESORT, "sort_kv i32": RESORT, "sort_kv i64": TREE,
    "sort padded": RESORT, "sort_kv padded": RESORT,
    "skew tree": (["ragged", "bitonic", "tree"], SKEW),
    "all equal": RESORT, "descending": RESORT, "partial bits": RESORT,
    "n < D": RESORT,
    **{f"{case} network": w for case, w in NETWORK_TWINS.items()}}


def card_branches(d: int) -> dict:
    """CARD_BRANCH_OF as it holds at D = d: at D = 2 a run never outgrows
    its block (so no skew re-sort); at D = 3 the tree does not run, and
    nothing is held."""
    if d == 2:
        return {**CARD_BRANCH_OF, "skew tree": TREE}
    return CARD_BRANCH_OF if d == 4 else {}


def card_digest(t: torch.Tensor) -> int:
    """A 64-bit digest of a tensor's 32-bit words: the sum, mod 2^64, of
    each word times an odd hash of its index (in chunks, on its device)."""
    w = iv(t.contiguous()).view(torch.int32).reshape(-1)
    total = 0
    for at in range(0, w.shape[0], 1 << 26):
        part = w[at:at + (1 << 26)].to(torch.int64) & 0xFFFFFFFF
        idx = torch.arange(at, at + part.shape[0], device=w.device)
        total += int(((idx * -7046029254386353131) | 1).mul_(part).sum())
    return total & (2**64 - 1)


def card_inputs(kind: str, n: int, dev, names) -> list:
    """The global arrays ``names`` of a case, made on this rank's card
    from the seed, the same on every card: "keys" (u32: uniform,
    duplicate-heavy, presorted or all equal), "scan" (the same words as
    int32), "v32" and "v64" (int32 and int64 values)."""
    gen = torch.Generator(device=dev).manual_seed(CARD_SEED)
    k = cwords(gen, n, dev)
    if kind == "dups":
        k &= 0x3F
    elif kind == "presorted":
        k = sortx_torch.sort(k.view(torch.uint32)).view(torch.int32)
    elif kind == "equal":
        k.fill_(0x2BCD1234)
    make = {"keys": lambda: k.view(torch.uint32), "scan": lambda: k,
            "v32": lambda: torch.arange(n, dtype=torch.int32, device=dev),
            "v64": lambda: dist_values64(dev, n)}
    return [make[name]() for name in names]


def card_padded(out, n: int, d: int) -> tuple:
    """The single-card sort's outputs as the padded sorts return them
    across d ranks: keys then 0xFFFFFFFF pads, values then zeros, and the
    pad count."""
    m = -(-n // d)
    pad = d * m - n
    fills = (-1,) + (0,) * (len(out) - 1)
    return tuple(torch.cat([o, torch.full((pad,), f, dtype=o.dtype,
                                          device=o.device)])
                 for o, f in zip(out, fills)) + (pad,)


def card_cases(d: int, per_rank: int, branch: int, engine: str = "auto"):
    """(name, n, input kind, the names of the inputs the calls take, the
    single-card op, the distributed call (shards, mesh), reps, step reps,
    padded) of every case of the "dist cards" phase, the distributed
    calls under Config(engine=engine)."""
    def C(**kw):
        return sortx_torch.Config(engine=engine, **kw)

    full, ragged, nb = d * per_rank, d * per_rank + 13, d * branch
    one_kv = sortx_torch.sort_kv

    def dsort(config=None, **kw):
        return lambda s, mesh: (sortx_torch.dist_sort(
            *s, mesh=mesh, config=config or C(), **kw),)

    def dkv(config=None, **kw):
        return lambda s, mesh: sortx_torch.dist_sort_kv(
            *s, mesh=mesh, config=config or C(), **kw)

    big, small = (CARD_REPS, CARD_STEP_REPS), (0, 1)
    return (
        ("sort", full, "uniform", ("keys",),
         lambda k: (sortx_torch.sort(k),), dsort(), *big, False),
        ("sort_kv i32", full, "uniform", ("keys", "v32"), one_kv, dkv(),
         *big, False),
        ("sort_kv i64", full, "uniform", ("keys", "v64"), one_kv, dkv(),
         *big, False),
        ("sort padded", ragged, "uniform", ("keys",),
         lambda k: (sortx_torch.sort(k),),
         lambda s, mesh: sortx_torch.dist_sort_padded(*s, mesh=mesh,
                                                      config=C()),
         *big, True),
        ("sort_kv padded", ragged, "uniform", ("keys", "v32"), one_kv,
         lambda s, mesh: sortx_torch.dist_sort_kv_padded(*s, mesh=mesh,
                                                         config=C()),
         *big, True),
        ("scan", full, "uniform", ("scan",),
         lambda x: sortx_torch.scan(x, with_total=True),
         lambda s, mesh: sortx_torch.dist_scan(*s, with_total=True,
                                               mesh=mesh), *big, False),
        # 3/4 of the branch size a rank: a presorted shard arrives whole,
        # a run longer than the network's power-of-two tree blocks
        ("skew tree", 3 * nb // 4, "presorted", ("keys", "v32"), one_kv,
         dkv(config=sortx_torch.Config(engine="network")), *small, False),
        ("all equal", nb, "equal", ("keys", "v32"), one_kv, dkv(), *small,
         False),
        ("descending", nb, "dups", ("keys", "v32"),
         lambda k, v: sortx_torch.sort_kv(k, v, descending=True),
         dkv(descending=True), *small, False),
        ("partial bits", nb, "uniform", ("keys", "v32"),
         lambda k, v: sortx_torch.sort_kv(k, v, 12), dkv(sort_bits=12),
         *small, False),
        ("n < D", d - 1, "uniform", ("keys", "v32"), one_kv, dkv(), *small,
         False),
        ("n = 0", 0, "uniform", ("keys",), lambda k: (sortx_torch.sort(k),),
         dsort(), *small, False))


def card_cases_all(d: int, per_rank: int, branch: int) -> tuple:
    """card_cases under "auto", then each of NETWORK_TWINS again under
    engine="network", named "<case> network"."""
    return card_cases(d, per_rank, branch) + tuple(
        (f"{c[0]} network",) + c[1:]
        for c in card_cases(d, per_rank, branch, "network")
        if c[0] in NETWORK_TWINS)


def card_steps(csv: str) -> dict:
    """The dist_sort/<step> rows of a profile CSV: step -> [ms]."""
    steps = collections.defaultdict(list)
    with open(csv) as f:
        for row in f:
            name, ms = row.split(",")[:2]
            if name.startswith("dist_sort/"):
                steps[name[len("dist_sort/"):]].append(float(ms))
    return steps


def card_case(mesh, dev, csv: str, case) -> dict:
    """One case on this rank: the global input made on its card, the
    single-card op on the whole of it (and, for full-size cases, its time
    and that of the op on this rank's shard alone), then the distributed
    call on the shards: once with its launches counted and its outputs
    held bit for bit against this rank's slice of the single-card result,
    then `reps` whole calls timed unprofiled and `step_reps` profiled at
    level "step". Returns what the parent checks and prints."""
    import importlib

    import torch.distributed as dist

    from sortx_torch.runtime import toggle_profiling

    ds = importlib.import_module("sortx_torch.parallel.dist_sort")
    _, n, kind, names, one, call, reps, step_reps, padded = case
    d = mesh.size()
    glob = card_inputs(kind, n, dev, names)
    seen = torch.tensor([card_digest(glob[0]) - (1 << 63)], device=dev)
    every = [torch.empty_like(seen) for _ in range(d)]
    dist.all_gather(every, seen)
    rec = {"n": n, "same_input": all(torch.equal(e, seen) for e in every)}
    out = one(*glob)
    out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    if padded:
        out = card_padded(out, n, d)
    shard = sortx_torch.parallel.shard_1d
    want = [shard(w, mesh).clone() if torch.is_tensor(w) and w.dim() else w
            for w in out]
    shards = [shard(x, mesh).clone() for x in glob]
    del out
    if reps:
        rec["one_whole_ms"] = time_ms(lambda: one(*glob), reps=3)
        rec["one_shard_ms"] = time_ms(lambda: one(*shards))
    del glob
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()

    def timed():
        dist.barrier()
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        got = call(shards, mesh)
        torch.cuda.synchronize(dev)
        return got, (time.perf_counter() - t) * 1e3

    _build.launches.clear()
    got, _ = timed()
    rec["launches"] = dict(_build.launches)
    rec["witness"] = [ds.last_exchange, ds.last_local_engine,
                      ds.last_local_merge]
    got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
    rec["on_card"] = all(o.device == dev for o in got if torch.is_tensor(o))
    rec["ok"] = len(got) == len(want) and all(
        same_bits(o, w) if torch.is_tensor(w) else o == w
        for o, w in zip(got, want))
    rec["digest"] = f"{card_digest(got[0]):016x}"
    del got, want
    rec["whole_ms"] = [timed()[1] for _ in range(reps)]
    if os.path.exists(csv):
        os.remove(csv)
    toggle_profiling(True, csv, level="step")
    try:
        for _ in range(step_reps):
            timed()
    finally:
        toggle_profiling(False, level="op")
    rec["steps"] = card_steps(csv) if os.path.exists(csv) else {}
    del shards
    torch.cuda.empty_cache()
    return rec


def cards_rank(rank: int, env: dict, tmp: str, per_rank: int,
               branch: int) -> None:
    """One rank of the "dist cards" phase, started as torchrun starts one
    (its environment, LOCAL_RANK = the card): init_multihost() with no
    arguments, make_sort_mesh(), then every case of card_cases_all; writes
    its report for the parent."""
    import torch.distributed as dist

    from sortx_torch.parallel import init_multihost

    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    init_multihost()
    try:
        mesh = sortx_torch.make_sort_mesh()
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        report = {"backend": dist.get_backend(),
                  "card": torch.cuda.current_device(),
                  "mesh": mesh.device_type,
                  "default_group": mesh.get_group().group_name
                  == dist.group.WORLD.group_name,
                  "cases": {c[0]: card_case(mesh, dev,
                                            f"{tmp}/profile.{rank}.csv", c)
                            for c in card_cases_all(mesh.size(), per_rank,
                                                    branch)}}
        with open(f"{tmp}/cards.{rank}.json", "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def cards_path() -> dict:
    """The "dist cards" phase: D = min(cards, 4) ranks, one a card, over
    NCCL (spawned after the kernels are built, so they only load them),
    each rank's shards held bit for bit against its slice of the
    single-card op of the whole array; the witnesses, the steps, the
    launches and the times. Returns the ranks' summed launches."""
    import tempfile

    import torch.multiprocessing as mp

    from sortx_torch.parallel.multihost import simulate_hosts_flags

    count = torch.cuda.device_count()
    if count < 2:
        print(f"dist cards: skipped, {count} card visible (needs 2)",
              flush=True)
        return {}
    d = min(count, 4)
    cards = "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[:d])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()     # rank 0 shares card 0 with this process
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        mp.spawn(cards_rank, args=(simulate_hosts_flags(d), tmp, CARD_KEYS,
                                   CARD_BRANCH), nprocs=d, join=True)
        print(f"dist cards D={d}: ranks spawned, ran and exited in "
              f"{time.perf_counter() - t:.1f} s")
        reports = []
        for r in range(d):
            with open(f"{tmp}/cards.{r}.json") as f:
                reports.append(json.load(f))
    return cards_report(reports, cards)


def cards_report(reports: list, cards: str) -> dict:
    """The parent's checks of the ranks' reports, and the time lines."""
    d = len(reports)
    check(all(x["backend"] == "nccl" and x["card"] == r
              and x["mesh"] == "cuda" and x["default_group"]
              for r, x in enumerate(reports)),
          f"dist cards D={d}: every rank on NCCL, on card LOCAL_RANK, its "
          "mesh over the default group")
    total = collections.Counter()
    label = f"{d} cards over NCCL"
    branches = card_branches(d)
    if not branches:
        print(f"dist cards D={d}: no witness or step is held (the tree "
              "needs a power-of-two D)", flush=True)
    for case in reports[0]["cases"]:
        xs = [x["cases"][case] for x in reports]
        n = xs[0]["n"]
        check(all(x["same_input"] and x["ok"] and x["on_card"] for x in xs),
              f"dist cards {case} D={d}, n={n}: every rank's shard on its "
              "card == its slice of the single-card op of the whole array, "
              f"bit for bit; digests {[x['digest'] for x in xs]}")
        need = dist_launched(xs[0]["launches"], xs[0]["witness"][1])[0]
        if case == "scan":
            need = ("scan",)
        elif case.removesuffix(" network") in ("n < D", "n = 0"):
            need = ()
        counts = [[x["launches"].get(k, 0)
                   for k in NETWORK + RADIX + ("scan",)] for x in xs]
        check(all(all(x["launches"].get(k, 0) > 0 for k in need)
                  and dist_launched(x["launches"], x["witness"][1])[1]
                  for x in xs), f"dist cards {case} D={d}: every rank "
              f"launched {', '.join(need) or 'what it needed'} and no "
              f"other engine's kernels (K1-K3, K9, K10, K4 a rank: "
              f"{counts})")
        for x in xs:
            total.update(x["launches"])
        if case in branches:
            witness, step = branches[case]
            skew_ok = step == SKEW or not any(SKEW in x["steps"]
                                              for x in xs)
            check(all(x["witness"] == witness and step in x["steps"]
                      for x in xs) and skew_ok,
                  f"dist cards {case} D={d}: witness {witness}, ran "
                  f"{step!r}: {[x['witness'] for x in xs]}, "
                  f"{sorted(xs[0]['steps'])}")
        if not xs[0]["whole_ms"]:
            continue
        for name in xs[0]["steps"]:
            ms = max(statistics.median(x["steps"][name]) for x in xs)
            print(f"time dist cards {case} D={d} n={n} step (profiled): "
                  f"{name}: {ms!r} ms (the slowest rank's median; {label}) "
                  f"[{cards}]", flush=True)
        ms = max(statistics.median(x["whole_ms"]) for x in xs)
        print(f"time dist cards {case} D={d} n={n} whole call "
              f"(unprofiled): {ms!r} ms = {n / (ms / 1e3):.6g}/s (the "
              f"slowest rank's median of {CARD_REPS}; {label}) [{cards}]",
              flush=True)
        for what, key, size in (("the whole array", "one_whole_ms", n),
                                ("one rank's shard", "one_shard_ms",
                                 -(-n // d))):
            ms = max(statistics.median(x[key]) for x in xs)
            print(f"time dist cards {case}: the single-card op on {what}, "
                  f"n={size}: {ms!r} ms = {size / (ms / 1e3):.6g}/s (the "
                  f"slowest card's median, every card at once on its own "
                  f"copy) [{cards}]",
                  flush=True)
    return total


def main() -> None:
    t0 = lap = time.perf_counter()

    def took(phase: str) -> None:
        nonlocal lap
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"phase {phase}: {now - lap:.1f} s", flush=True)
        lap = now

    card = header()
    dev = torch.device("cuda", 0)
    took("build")
    err = kernel_checks(dev)
    took("kernel checks")
    companion_walks(dev, err)
    took("companion walks")
    design_walks(dev, err)
    took("design walks")
    # each kernel's launches are read from the path it belongs to
    counts = main_path(dev)
    took("flagship path")
    ms, extra = timings(dev, card, err)   # before the other paths allocate
    took("flagship timings")
    counts["run_mover"] = hybrid_path(dev)["run_mover"]
    counts.update({k: c for k, c in rows_path(dev).items()
                   if k in ROWS_RADIX})
    counts.update(topk_rows_path(dev))
    counts["histogram"] = select_path(dev)["histogram"]
    counts["piece_mover"] = movers_path(dev)["piece_mover"]
    took("hybrid, rows, select and movers paths")
    ms2, extra2 = slice2_timings(dev, card, err)
    ms.update(ms2)
    extra.update(extra2)
    took("their timings")
    companions = companion_inputs(dev)
    companions_path(dev, companions)
    took("companions path")
    companion_timings(dev, card, err, companions)
    took("companion timings")
    del companions
    facade_checks(dev, card)
    out_of_core_checks(dev, card)
    idle_share(dev, card)
    took("runtime and out-of-core path")
    graph_path(dev, card)
    took("graph")
    for name, c in dist_path(dev, card).items():
        if name in NETWORK + RADIX + ("scan",):
            counts[name] += c
    took("distributed path")
    for name, c in cards_path().items():
        if name in NETWORK + RADIX + ("scan",):
            counts[name] += c
    took("dist cards")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts.get(name, 0),
                "max_abs_err": err[name], "ms": ms[name][0],
                "plain_ms": ms[name][1], **extra[name]}
               for name, (src, replaces) in KERNELS.items()]
    print(f"chip_smoke took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
