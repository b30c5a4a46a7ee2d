"""Gloo ranks on the CPU for the tests of ``sortx_torch.parallel``.

``Pool(d, store)`` spawns d processes that join one gloo group through
``sortx_torch.parallel.init_multihost`` (with a ``file://`` store, so
that test workers running side by side race for no port) and then serve
tasks until the pool is closed. ``Pool.run`` hands every rank the same
global numpy input; each rank takes its ``shard_1d`` share (or its own
entry of ``shards``, a tuple of arrays), calls the op and sends back
its output shard, the dist witnesses and the names of the steps it ran
(the ``dist_sort/<step>`` rows of the launcher's profile CSV, at
``level="step"``). Nothing here imports jax, so neither do the ranks.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import traceback

TIMEOUT = 120      # seconds a call of every rank may take


class RankError(Exception):
    """A call raised on some rank: ``errors`` maps the rank to the
    exception's type name and message."""

    def __init__(self, errors: dict):
        super().__init__(errors)
        self.errors = errors


def _call(csv: str, op: str, keys=None, values=None, shards=None,
          kwargs=None):
    import importlib

    import sortx_torch
    from sortx_torch.convert import to_numpy, to_torch
    from sortx_torch.runtime import toggle_profiling

    ds = importlib.import_module("sortx_torch.parallel.dist_sort")
    mesh = sortx_torch.make_sort_mesh()
    me = mesh.get_local_rank()
    if shards is not None:
        args = [to_torch(a) for a in shards[me]]
    else:
        args = [sortx_torch.parallel.shard_1d(to_torch(a), mesh)
                for a in (keys, values) if a is not None]
    if os.path.exists(csv):
        os.remove(csv)
    toggle_profiling(True, csv, level="step")
    try:
        out = getattr(sortx_torch, op)(*args, mesh=mesh, **(kwargs or {}))
    finally:
        toggle_profiling(False, level="op")
    names = []
    if os.path.exists(csv):
        with open(csv) as f:
            names = [row.split(",")[0][len("dist_sort/"):] for row in f
                     if row.startswith("dist_sort/")]
    out = out if isinstance(out, tuple) else (out,)
    return {"out": [to_numpy(o) if hasattr(o, "dtype") else o for o in out],
            "witness": (ds.last_exchange, ds.last_local_engine,
                        ds.last_local_merge),
            "steps": names}


def _serve(rank: int, d: int, store: str, tasks, results) -> None:
    import torch

    torch.set_num_threads(1)
    from sortx_torch.parallel import init_multihost

    init_multihost(f"file://{store}", d, rank, device="cpu")
    csv = f"{store}.profile.{rank}.csv"
    while (task := tasks.get()) is not None:
        try:
            results.put((rank, True, _call(csv, **task)))
        except Exception as e:    # reported to the test, which fails
            results.put((rank, False, (type(e).__name__, str(e),
                                       traceback.format_exc())))


class Pool:
    """d gloo ranks serving calls (see the module notes)."""

    def __init__(self, d: int, store):
        ctx = multiprocessing.get_context("spawn")
        self.d = d
        self.broken = None
        self.tasks = [ctx.Queue() for _ in range(d)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, d, str(store), self.tasks[r],
                                        self.results))
                      for r in range(d)]
        for p in self.procs:
            p.start()

    def run(self, op: str, keys=None, values=None, shards=None, **kwargs):
        """Call ``sortx_torch.<op>`` on every rank; returns the ranks'
        results in rank order, or raises RankError."""
        if self.broken:
            raise RuntimeError(f"the pool of {self.d} ranks broke earlier: "
                               f"{self.broken}")
        task = dict(op=op, keys=keys, values=values, shards=shards,
                    kwargs=kwargs)
        for q in self.tasks:
            q.put(task)
        got = {}
        try:
            while len(got) < self.d:
                rank, ok, payload = self.results.get(timeout=TIMEOUT)
                got[rank] = (ok, payload)
        except queue.Empty:
            self.broken = f"{op} timed out after {TIMEOUT} s"
            self.close()
            raise
        errors = {r: p[:2] for r, (ok, p) in got.items() if not ok}
        if errors:
            raise RankError(errors)
        return [got[r][1] for r in range(self.d)]

    def stop(self) -> None:
        """Ask every rank to exit (they exit side by side)."""
        for q in self.tasks:
            q.put(None)

    def close(self) -> None:
        self.stop()
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
