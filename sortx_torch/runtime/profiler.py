"""Device tracing hooks.

Port of ``sortx/runtime/profiler.py`` on ``torch.profiler``: a trace of
the host's ops and, on a card, of every CUDA kernel, written as a Chrome
trace (``chrome://tracing``, Perfetto) into ``log_dir``. ``annotate``
names a region of it (``record_function``); the port's own layers open
their spans there too (``launcher.span``). ``step_ms`` reads the
distributed sort's steps as the card timed them under the profiler.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from ..utils.log import Channel, log
from .launcher import _STEP_CALLS

__all__ = ["trace", "start_trace", "stop_trace", "annotate", "step_ms"]

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


def _elapsed_ms(start, end) -> float:
    if isinstance(start, float):              # host-clock marks (CPU)
        return (end - start) * 1e3
    end.synchronize()
    return start.elapsed_time(end)


def step_ms(clear: bool = False) -> list[dict]:
    """The steps of the last calls made under a torch profiler (at most
    ``launcher.STEP_CALLS_KEPT``), oldest first: one dict a call, step
    name (``dist_sort/<step>``, as the step rows name it) -> ms on the
    card from the step's start to its end (the host clock for CPU
    tensors). Waits for each step's end here, not while the call runs.
    ``clear`` forgets them."""
    calls = list(_STEP_CALLS)
    if clear:
        _STEP_CALLS.clear()
    out = []
    for _, steps in calls:
        ms: dict = {}
        for name, start, end in steps:
            ms[name] = ms.get(name, 0.0) + _elapsed_ms(start, end)
        out.append(ms)
    return out
