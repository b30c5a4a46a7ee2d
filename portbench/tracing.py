"""The traced slice: a fixed count of calls under ``torch.profiler``.

The events stay in memory (no Chrome trace is written). The union of
device activity is a frozen copy of ``chip_smoke.py``'s
``traced_idle_share``: kernels, copies and memsets count as busy, and
the window is a ``record_function`` annotation around the slice's calls,
so the profiler's start and its warm-up calls stay outside it.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

ANNOTATION = "portbench.slice"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAME_CHARS = 400          # a kernel's templated name is cut to this


@dataclasses.dataclass
class Slice:
    """What one process traced: the window's bounds (ns), the device
    activities inside it as (start, end, kind, name), clipped to it, the
    host's events as (start, end, name), and the calls it spans."""

    t0: int
    t1: int
    device: list
    host: list
    calls: int


def union(spans):
    """(busy, gaps) of (start, end, ...) spans: the length their union
    covers and the (start, end) of each hole between them."""
    busy, gaps, end = 0, [], None
    for a, b, *_ in sorted(spans):
        if end is None:
            end = a
        if b > end:
            busy += b - max(a, end)
            if a > end:
                gaps.append((end, a))
            end = b
    return busy, gaps


def _kind(event) -> str:
    """The event's kineto activity type; where this torch has no
    ``activity_type``, told from the device and the name as kineto names
    them ("Memcpy ...", "Memset ...", "... Sync" for a synchronisation
    span on the device's timeline, which is no work)."""
    if hasattr(event, "activity_type"):
        return str(event.activity_type())
    name = event.name()
    if event.device_type() != torch.autograd.DeviceType.CUDA:
        return "user_annotation" if name == ANNOTATION else "cpu_op"
    if name == ANNOTATION:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "cuda_sync" if name.endswith("Sync") else "kernel"


def classify(events) -> list:
    """(name, kind, start_ns, duration_ns) of kineto events. A device
    event named as a host event is a ``record_function`` span copied to
    the device's timeline (``nccl:all_to_all``), not work: where this
    torch names no kinds, ``_kind`` took it for a kernel."""
    out = [(e.name(), _kind(e), int(e.start_ns()), int(e.duration_ns()))
           for e in events]
    host = {name for name, kind, *_ in out if kind in HOST_KINDS}
    return [(name, "gpu_user_annotation" if kind == "kernel"
             and name in host else kind, s, d) for name, kind, s, d in out]


def kineto_events(prof) -> list:
    """The classified events of a stopped ``torch.profiler.profile``."""
    return classify(prof.profiler.kineto_results.events())


def from_events(events, calls: int) -> Slice | None:
    """The slice inside the annotation :data:`ANNOTATION` of ``events``
    ((name, kind, start_ns, duration_ns)); None where there is none."""
    marks = [(s, s + d) for name, kind, s, d in events
             if name == ANNOTATION and kind == "user_annotation"]
    if not marks:
        return None
    t0, t1 = marks[0]
    device, host = [], []
    for name, kind, s, d in events:
        a, b = max(s, t0), min(s + d, t1)
        if b <= a:
            continue
        if kind in DEVICE_KINDS:
            device.append((a, b, kind, name[:NAME_CHARS]))
        elif kind in HOST_KINDS and name != ANNOTATION:
            host.append((s, s + d, name[:NAME_CHARS]))
    return Slice(t0, t1, device, host, calls)


def record(run_call, calls: int, warm: int = 2) -> Slice | None:
    """Run ``run_call()`` (one whole call, synchronised) ``warm`` times
    and then ``calls`` times inside the annotation, under the profiler
    (the host and, on a card, CUDA); returns the slice."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        for _ in range(warm):
            run_call()
        with record_function(ANNOTATION):
            for _ in range(calls):
                run_call()
    finally:
        prof.stop()
    return from_events(kineto_events(prof), calls)


def busy_ns(sl: Slice) -> int:
    return union(sl.device)[0] if sl.device else 0


def idle_share(sl: Slice) -> float | None:
    """100 x (1 - the union of device activity / the window), or None
    where the slice holds no device activity."""
    if sl is None or not sl.device:
        return None
    return 100.0 * (1.0 - busy_ns(sl) / (sl.t1 - sl.t0))


def activity_s(sl: Slice) -> float:
    """The summed seconds of every device activity in the window."""
    return sum(b - a for a, b, *_ in sl.device) / 1e9


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters (``bitonic_global_kernel``), so that the
    instances of one kernel count together; a copy's or a memset's name
    as it is."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    depth, head = 0, []
    for ch in name.removeprefix("void ").replace("(anonymous namespace)::",
                                                 ""):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            head.append(ch)
    return "".join(head).rsplit("::", 1)[-1].strip() or name


def device_ops(sl: Slice, top: int = 10) -> list:
    """[[kernel name, seconds]] of the device operations that took most
    time, every instance of a kernel counted under its name."""
    by_name = collections.Counter()
    for a, b, _, name in sl.device:
        by_name[kernel_name(name)] += (b - a) / 1e9
    return [[name, s] for name, s in by_name.most_common(top)]


def _host_label(sl: Slice, a: int, b: int) -> str:
    """What the host was in at the middle of the gap (a, b): the names
    of the events that cover it, outermost first (the last three)."""
    mid = (a + b) // 2
    covering = sorted((s, -e, name) for s, e, name in sl.host
                      if s <= mid < e)
    names = [name for *_, name in covering][-3:]
    return " > ".join(names) if names else "host outside any traced op"


def idle_gaps(sl: Slice, top: int = 10) -> list:
    """[[what the host was doing, seconds]] of the device's idle time in
    the window, summed by that label, the largest first."""
    if not sl.device:
        return []
    _, gaps = union(sl.device + [(sl.t0, sl.t0), (sl.t1, sl.t1)])
    by_label = collections.Counter()
    for a, b in gaps:
        by_label[_host_label(sl, a, b)] += (b - a) / 1e9
    return [[label, s] for label, s in by_label.most_common(top)]
