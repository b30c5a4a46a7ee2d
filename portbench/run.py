"""Run one cell of BENCHMARK.json once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics. The run needs as many
CUDA cards as the cell asks for, and exits with a code other than 0 and
no result where there are fewer; it never falls back to the CPU. A cell
on several cards runs one process per card, started here.

``--control 1`` runs the op's control (a sort that breaks a guarantee
the configuration states: fewer key bits, or an unstable key-value sort)
in place of its call; its ``correct`` has to come out false.
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# Import the benchmark and the port from the checkout's root, and let no
# file of this directory shadow a module of the standard library.
sys.path[:] = [str(HERE.parent)] + [p for p in sys.path
                                    if Path(p or ".").resolve() != HERE]

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

# Where the timed program would load JAX through a library, it must not.
os.environ.setdefault("USE_FLAX", "0")

RUN_LIMIT_S = 340      # the ranks of a run are ended past this


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank-job", help="internal: one rank's job, as JSON")
    args = p.parse_args(argv)
    if args.rank_job is None and None in (args.workload, args.seed,
                                          args.seconds):
        p.error("--workload, --seed and --seconds are required")
    return args


def main(argv=None) -> int:
    args = _args(argv)
    from portbench import cell

    if args.rank_job is not None:
        result = cell.run_rank(json.loads(args.rank_job))
        if result is not None:
            cell.emit(result)
        else:                   # another rank, after its teardown
            cell.refuse_banned()
        return 0

    start = cell.process_start_wall()
    import torch

    from portbench import ranks, spec

    try:
        chips = spec.load_cell(args.workload).chips
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("portbench: no CUDA card (torch.cuda.is_available() is "
              "False); the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    job = {"workload": args.workload, "seed": args.seed,
           "seconds": args.seconds, "trace": args.trace,
           "control": bool(args.control), "root": str(spec.ROOT),
           "device": "cuda", "start": start}
    if chips == 1:
        cell.emit(cell.run_rank(job))
        return 0
    return ranks.spawn(str(Path(__file__).resolve()), job, chips,
                       RUN_LIMIT_S)


if __name__ == "__main__":
    sys.exit(main())
