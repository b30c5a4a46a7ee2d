"""Device tracing hooks.

Port of ``sortx/runtime/profiler.py`` on ``torch.profiler``: a trace of
the host's ops and, on a card, of every CUDA kernel, written as a Chrome
trace (``chrome://tracing``, Perfetto) into ``log_dir``. ``annotate``
names a region of it (``record_function``). ``profile_op`` times an op
the reference's way: synchronise after every call, subtract the
measured cost of a synchronised call that does nothing.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from ..utils.log import Channel, log
from .launcher import _PROFILE, _profile_path, _shapes_of, _sync

__all__ = ["trace", "start_trace", "stop_trace", "annotate", "profile_op"]

_DEFAULT_DIR = os.environ.get("SORTX_TRACE_DIR", os.path.join(
    tempfile.gettempdir(), "sortx_torch_trace"))
_ACTIVE: dict = {"prof": None, "dir": None}


def start_trace(log_dir: str | None = None) -> str:
    """Begin a trace of the host and, if there is one, the card."""
    if _ACTIVE["prof"] is not None:
        raise RuntimeError("a trace is already running")
    log_dir = log_dir or _DEFAULT_DIR
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _ACTIVE.update(prof=prof, dir=log_dir)
    log(f"trace started -> {log_dir}", Channel.PERF)
    return log_dir


def stop_trace() -> str:
    """End the trace and write it; returns the trace file's path."""
    prof, log_dir = _ACTIVE["prof"], _ACTIVE["dir"]
    if prof is None:
        raise RuntimeError("no trace is running")
    _ACTIVE.update(prof=None, dir=None)
    prof.stop()
    path = os.path.join(log_dir, f"sortx_torch.{os.getpid()}."
                                 f"{time.time_ns()}.trace.json")
    prof.export_chrome_trace(path)
    log(f"trace stopped -> {path}", Channel.PERF)
    return path


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Context manager: trace everything inside; yields the directory."""
    d = start_trace(log_dir)
    try:
        yield d
    finally:
        stop_trace()


def annotate(name: str):
    """Named region that shows up in the trace timeline."""
    return torch.profiler.record_function(name)


def profile_op(fn, *args, iters: int = 4, label: str | None = None,
               warmup: bool = True) -> float:
    """Measured milliseconds per call of ``fn(*args)``.

    Each call is followed by a synchronisation of the cards its
    arguments and outputs live on, and the measured time of a
    synchronised call that does nothing on the same device is
    subtracted. With profiling toggled on (``toggle_profiling``) the
    result is appended to the same CSV as the per-launch rows, named
    ``op:<label>``.
    """
    def run():
        _sync((args, fn(*args)))

    if warmup:
        run()                         # builds and first-touch outside
    devs = [t.device for t in args if isinstance(t, torch.Tensor)]
    tiny = torch.zeros(16, device=devs[0] if devs else "cpu")
    _sync(tiny + 1)
    t0 = time.perf_counter()
    for _ in range(iters):
        _sync(tiny + 1)
    overhead = (time.perf_counter() - t0) / iters

    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    ms = max((time.perf_counter() - t0) / iters - overhead, 0.0) * 1e3

    name = label or getattr(fn, "__name__", "op")
    log(f"profile_op {name}: {ms:.3f} ms ({iters} iters)", Channel.PERF)
    if _PROFILE["enabled"]:
        with open(_profile_path(), "a") as f:
            f.write(f"op:{name},{ms:.6f},{_shapes_of(list(args))}\n")
    return ms
