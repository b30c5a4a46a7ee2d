"""Time the run movers (K6, K7) on one NVIDIA GPU.

    PYTHONPATH=. python sortx_torch/tools/ab_movers.py PHASE...

The script imports whatever ``sortx_torch`` is first on ``PYTHONPATH``
(and ``chip_smoke.py``'s timer, plans and inputs from the checkout it
lies in), so two trees compare on one card in one shell command, in
turns:

    for t in old . . old; do PYTHONPATH=$t \\
        python sortx_torch/tools/ab_movers.py kernels; done

Phases, each printing one JSON object per line (``card`` is nvidia-smi's
name and power limit; times are medians of 9 CUDA-event timings in ms
after one warm-up, 10 calls in a row per timing, at n = 2^27 words):

  ptxas    compile csrc/shuffle.cu with -Xptxas -v: registers and spills
           of every kernel (fails on a spill) and counts in its SASS
  kernels  K7 on the radix-16 plan (256 tiles x 16 digits) and the 8-bit
           plan (4096 tiles x 256 digits): its C entry with the plan on
           the card (what any tree can run), ``apply_runs`` with the
           plan on the card (where the tree takes one) and from the
           numpy plan, each beside its bound; ``torch.cat`` of the
           radix-16 plan's runs in destination order; ``out.copy_(src)``
           of 2^27 words; K6 on the hybrid's partition at 1, 2 and 3
           streams. Each timed K7 and K6 output is held against its
           plain version (``equal``).
  shapes   K7's C entry on plans of 2^20 runs of 128 words in a random
           order (64 pieces a chunk, as the 8-bit plan has), with source
           and destination on one 16-byte grid, and one word off it:
           what the search costs, and what the word loads cost.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

import sortx_torch
from sortx_torch.ops import _build
from sortx_torch.ops.shuffle import (apply_runs, apply_runs_plain,
                                     build_piece_plan, move_runs,
                                     move_runs_plain)

sys.path.append(str(Path(__file__).resolve().parents[2]))
import ab_scan_hist  # noqa: E402  (this directory; its ptxas phase)
import chip_smoke  # noqa: E402

N = chip_smoke.N


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def time_ms(run, calls: int = 10) -> dict:
    times = chip_smoke.time_ms(run, reps=9, calls=calls)
    return {"ms": statistics.median(times), "min": min(times),
            "max": max(times), "calls_per_timing": calls}


def entry(src, on_card):
    """K7 through its C entry, with the plan on the card: what any tree
    can run."""
    def run():
        out = torch.empty(N, dtype=src.dtype, device=src.device)
        _build.launch("piece_mover", "sortx_apply_pieces", src.device,
                      src.data_ptr(), out.data_ptr(), src.shape[0],
                      *(t.data_ptr() for t in on_card.values()), N, 8192)
        return out
    return run


def kernels(where: str) -> None:
    dev = torch.device("cuda")
    rng = np.random.RandomState(8)
    for name, (tiles, radix) in chip_smoke.PIECE_PLANS.items():
        src, plan, runs = chip_smoke.radix_plan(rng, dev, tiles, radix)
        on_card = chip_smoke.plan_on_card(plan, dev)
        tags = dict(phase="kernels", card=where, plan=name,
                    pieces=len(plan["piece_src"]),
                    bound_ms=chip_smoke.piece_mover_bound(plan)["bound_ms"])
        want = apply_runs_plain(src, plan, N)
        rows = [("piece_mover C entry, plan on the card",
                 entry(src, on_card)),
                ("apply_runs, numpy plan", lambda: apply_runs(src, plan, N))]
        try:
            apply_runs(src, on_card, N)
            rows.append(("apply_runs, plan on the card",
                         lambda: apply_runs(src, on_card, N)))
        except (TypeError, RuntimeError):   # a tree that takes numpy only
            pass
        for what, run in rows:
            equal = torch.equal(run(), want)
            emit(kernel=what, equal=equal, **tags, **time_ms(run))
        if name == "radix-16":
            order = np.argsort(runs[1], kind="stable")
            views = [src[int(s):int(s) + int(ln)]
                     for s, ln in zip(runs[0][order], runs[2][order])]
            emit(kernel="torch.cat of the runs in destination order",
                 equal=torch.equal(torch.cat(views), want), **tags,
                 **time_ms(lambda: torch.cat(views)))
            out = torch.empty_like(src)
            emit(kernel="out.copy_(src)", **tags,
                 **time_ms(lambda: out.copy_(src)))
            del views, out
        del src, plan, on_card, want
    for ns in (1, 2, 3):
        tiles, (rs, rd, rl, _), (B, cap, chunk) = chip_smoke.hybrid_tables(
            rng, dev, ns)
        flat = tuple(t.reshape(-1) for t in tiles)
        fills = (-1,) + (0,) * (ns - 1)
        want = move_runs_plain(flat, rs, rd, rl, B * cap, fills)
        run = lambda: move_runs(flat, rs, rd, rl, B * cap,  # noqa: E731
                                fills=fills, chunk=chunk)
        emit(phase="kernels", card=where, kernel="run_mover, the hybrid's "
             "partition", streams=ns, runs=rs.shape[0], chunk=chunk,
             equal=all(torch.equal(a, b) for a, b in zip(run(), want)),
             bound_ms=chip_smoke.bound(ns * 4 * (int(rl.sum()) + B * cap)
                                       + 12 * rs.shape[0], 0)["bound_ms"],
             **time_ms(run))
        del tiles, flat, want


def shapes(where: str) -> None:
    dev = torch.device("cuda")
    rng = np.random.RandomState(9)
    src = chip_smoke.words(rng, N, dev)
    runs = N // 128
    starts = rng.permutation(runs) * 128
    for shift in (0, 1):
        plan = build_piece_plan(starts + shift, np.arange(runs) * 128,
                                np.full(runs, 128), N)
        run = entry(src, chip_smoke.plan_on_card(plan, dev))
        emit(phase="shapes", card=where, kernel="piece_mover C entry",
             plan=f"2^20 runs of 128 words, source {shift} word(s) off the "
             "destination's 16-byte grid", pieces=len(plan["piece_src"]),
             equal=torch.equal(run(), apply_runs_plain(src, plan, N)),
             bound_ms=chip_smoke.piece_mover_bound(plan)["bound_ms"],
             **time_ms(run))


def main() -> None:
    where = chip_smoke.header()     # exits without a card; builds
    emit(phase="build", card=where,
         tree=str(Path(sortx_torch.__file__).parent))
    for phase in sys.argv[1:] or ["kernels"]:
        if phase == "ptxas":
            ab_scan_hist.ptxas(where, ("shuffle.cu",))
        else:
            {"kernels": kernels, "shapes": shapes}[phase](where)


if __name__ == "__main__":
    main()
