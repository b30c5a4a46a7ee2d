"""One process per card: how the ranks start, agree and end.

``spawn`` starts a cell's ranks as ``torchrun`` would (``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` on a
free localhost port, ``OMP_NUM_THREADS=1``), each a ``run.py`` process
given its job. Rank 0 writes to this process's standard error; its
standard output (the result) is held in a file under ``TMPDIR`` and
passed on only once every rank has exited with 0, else it goes to
standard error. The others' output goes to files there and is shown
only when a rank fails. When one rank fails the others are ended, and
no rank outlives the call.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch


class Solo:
    """The harness's agreement among ranks, with one rank."""

    rank, world = 0, 1

    def keep_going(self, flag: bool) -> bool:
        return flag

    def barrier(self) -> None:
        pass

    def gather(self, obj) -> list:
        return [obj]


class Group(Solo):
    """The same over the default ``torch.distributed`` group, which the
    op's ``setup`` started; the stop flag is rank 0's, broadcast."""

    def __init__(self, device: torch.device):
        import torch.distributed as dist

        self.dist, self.device = dist, device
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self._flag = torch.zeros(1, dtype=torch.int32, device=device)

    def keep_going(self, flag: bool) -> bool:
        self._flag.fill_(int(flag))
        self.dist.broadcast(self._flag, 0)
        return bool(self._flag.item())

    def barrier(self) -> None:
        self.dist.barrier()

    def gather(self, obj) -> list:
        out = [None] * self.world
        self.dist.all_gather_object(out, obj)
        return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(run_py: str, job: dict, world: int, timeout_s: float) -> int:
    """Run ``world`` ranks of ``job`` and wait for all; returns rank 0's
    exit code, or 1 where another rank failed or time ran out."""
    base = dict(os.environ, MASTER_ADDR="localhost",
                MASTER_PORT=str(free_port()), WORLD_SIZE=str(world))
    base.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory(prefix="portbench.ranks.") as tmp:
        procs, logs = [], []
        try:
            for rank in range(world):
                env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank))
                cmd = [sys.executable, run_py, "--rank-job", json.dumps(job)]
                log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    cmd, env=env, stdout=log,
                    stderr=None if rank == 0 else subprocess.STDOUT))
            rc = _wait(procs, logs, timeout_s)
            logs[0].seek(0)
            out = logs[0].read()
            (sys.stdout if rc == 0 else sys.stderr).write(out)
            sys.stdout.flush()
            return rc
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for log in logs:
                log.close()


def _wait(procs, logs, timeout_s: float) -> int:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            for r in bad:
                if r > 0:
                    logs[r].seek(0)
                    tail = logs[r].read()[-4000:]
                    print(f"portbench: rank {r} exited with {codes[r]}:\n"
                          f"{tail}", file=sys.stderr, flush=True)
            return codes[0] if bad == [0] else 1
        if all(c == 0 for c in codes):
            return 0
        time.sleep(0.05)
    print(f"portbench: the ranks ran past {timeout_s:.0f} s",
          file=sys.stderr, flush=True)
    return 1
