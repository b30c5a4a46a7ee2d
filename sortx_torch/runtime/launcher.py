"""Launch profiling and capture / replay.

Port of ``sortx/runtime/launcher.py`` (the reference's ``Launcher`` /
``LauncherCL``, ``Adl/AdlKernel.h:59-143``,
``Adl/CL/AdlKernelUtilsCL.inl:541-791``):

  - per-launch CSV profiling (``Device::toggleProfiling`` ->
    ``Profile.<device name>.csv``, one row ``name,ms,shapes`` per call):
    every public op of the port is ``@profiled``; at ``level="step"``
    the named steps inside an op (``profiled_step``: the distributed
    sort's local sort, exchange, merge, ...) add a row each, and at
    ``level="kernel"`` each kernel wrapper in ``ops/`` adds one row per
    call too, from the place where it chooses between the kernel and its
    plain version (so CPU tensors give rows too). Timing is the
    reference's recipe: synchronise the devices of the arguments, run,
    synchronise the devices of the results, host clock;
  - capture of one launch to an ``.npz`` (every tensor argument, the
    scalars and a ``Config``) and its replay (``serializeToFile`` /
    ``deserializeFromFile``, ``AdlKernelUtilsCL.inl:680-791``).

While a CUDA graph is being captured (``torch.cuda.
is_current_stream_capturing()``) nothing is timed, synchronised,
written or captured: a synchronisation would break the capture. That is
the port's case of the reference's "no rows under a user jit".
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..utils.log import Channel, log

__all__ = ["Launcher", "replay", "toggle_profiling", "profiling_enabled",
           "profiling_level", "profile_call", "profiled",
           "profiled_step", "capture_next_op", "replay_op"]

_PROFILE = {"enabled": False, "path": None, "level": "op"}
_LEVELS = ("op", "step", "kernel")
# One-shot capture of the next launch the library makes: armed by
# capture_next_op, consumed by the first matching @profiled op (or, at
# level="kernel", kernel wrapper).
_CAPTURE: dict = {"path": None, "match": None}


def toggle_profiling(enable: bool, csv_path: Optional[str] = None,
                     level: Optional[str] = None) -> None:
    """Analog of Device::toggleProfiling (Adl/Adl.h:142,153).

    When enabled, every public library call (``sortx_torch.sort``,
    ``sort_kv``, ``scan``, ``sort_large``, ...) appends a CSV row
    ``name,ms,shapes``; ``level="step"`` adds a row for each named step
    inside them (``profiled_step``), ``level="kernel"`` also a row for
    each kernel call (``bitonic_block``, ``bitonic_tail``,
    ``bitonic_global``, ``scan``, ``histogram``, ``run_mover``,
    ``piece_mover``). Each timed call synchronises the card before and
    after, so profiled runs are slower than unprofiled ones.
    """
    _PROFILE["enabled"] = enable
    if csv_path:
        _PROFILE["path"] = csv_path
    if level is not None:
        if level not in _LEVELS:
            raise ValueError(f"profiling level must be one of {_LEVELS}")
        _PROFILE["level"] = level


def profiling_enabled() -> bool:
    return _PROFILE["enabled"]


def profiling_level() -> str:
    return _PROFILE["level"]


def _capturing() -> bool:
    """True while the current CUDA stream records a graph."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _leaves(tree):
    """The tensors and numpy arrays in nested tuples, lists and dicts."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)


def _sync(tree) -> None:
    """Wait for the cards that hold the tensors in ``tree``."""
    for dev in {t.device for t in _leaves(tree)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def _shapes_of(tree) -> str:
    return ";".join(f"{tuple(a.shape)}/{a.dtype}" for a in _leaves(tree)
                    if a.ndim > 0)


def _append_row(name: str, ms: float, shapes: str) -> None:
    with open(_profile_path(), "a") as f:
        f.write(f"{name},{ms:.6f},{shapes}\n")
    log(f"launch {name}: {ms:.3f} ms", Channel.PERF)


def capture_next_op(path: str, match: Optional[str] = None) -> None:
    """Arm a one-shot capture of the next library launch.

    The next ``@profiled`` op call (or, with profiling at
    ``level="kernel"``, kernel call) whose name starts with ``match``
    (None = any) writes its inputs and config to ``path`` as an ``.npz``
    and then runs normally. Public-op captures replay in any process
    through ``replay_op(path)``; kernel-level captures hold the raw
    buffers and replay through ``replay(path, registry)``."""
    _CAPTURE["path"] = path
    _CAPTURE["match"] = match


def _pack(name: str, args, kw):
    """The arrays (host copies, bit for bit), scalars, devices and
    keyword metadata of a launch's arguments, or None (logged) when an
    argument cannot be written."""
    from ..convert import to_numpy

    arrays, scalars, devices, kwmeta = {}, {}, {}, {}
    named = [(f"arg{i}", a) for i, a in enumerate(args)]
    named += [(f"kw_{k}", v) for k, v in kw.items()]
    for key, a in named:
        if isinstance(a, (torch.Tensor, np.ndarray)):
            arrays[key] = to_numpy(a) if isinstance(a, torch.Tensor) else a
            devices[key] = (str(a.device) if isinstance(a, torch.Tensor)
                            else None)
        elif key.startswith("kw_"):
            k = key[3:]
            if dataclasses.is_dataclass(a) and not isinstance(a, type):
                kwmeta[k] = {"__dataclass__": type(a).__name__,
                             "fields": dataclasses.asdict(a)}
            elif isinstance(a, (int, float, bool, str, type(None))):
                kwmeta[k] = a
            else:
                kwmeta[k] = {"__repr__": repr(a)}
        elif isinstance(a, np.generic):       # numpy scalar -> JSON-safe
            scalars[key] = a.item()
        elif isinstance(a, (int, float, bool, str, type(None))):
            scalars[key] = a
        else:
            # Not capturable (e.g. lexsort's list of tensors): skip the
            # capture rather than fail the user's op call.
            log(f"capture of {name} skipped: {key} "
                f"({type(a).__name__}) is not serializable", Channel.IO)
            return None
    return arrays, scalars, devices, kwmeta


def _maybe_capture(name: str, args, kw) -> None:
    if _CAPTURE["path"] is None:
        return
    if _CAPTURE["match"] is not None and not name.startswith(
            _CAPTURE["match"]):
        return
    path, _CAPTURE["path"] = _CAPTURE["path"], None
    _CAPTURE["match"] = None
    packed = _pack(name, args, kw)
    if packed is None:
        return
    arrays, scalars, devices, kwmeta = packed
    meta = {"name": name, "scalars": scalars, "n_args": len(args),
            "kwargs": kwmeta,
            "array_kwargs": [k[3:] for k in arrays if k.startswith("kw_")],
            "devices": devices, "static_config": {}}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    log(f"captured launch {name} -> {path}", Channel.IO)


def _load_array(data, meta: dict, key: str):
    """A captured argument as it was passed: a tensor on its device, or
    numpy."""
    from ..convert import to_torch

    device = meta.get("devices", {}).get(key)
    return data[key] if device is None else to_torch(data[key], device)


def replay_op(path: str):
    """Re-run a captured library op by name: every ``@profiled`` public
    op is ``sortx_torch.<name>``. Rebuilds the tensor arguments on the
    devices they were captured on, the scalars and a ``Config``."""
    import sortx_torch

    from ..config import Config

    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    fn = getattr(sortx_torch, meta["name"], None)
    if fn is None:
        raise KeyError(f"captured launch {meta['name']!r} is not a "
                       f"public sortx_torch op; use replay(path, registry)")
    args: list = []
    for i in range(meta["n_args"]):
        key = f"arg{i}"
        args.append(_load_array(data, meta, key) if key in data
                    else meta["scalars"][key])
    kw = {k: _load_array(data, meta, f"kw_{k}")
          for k in meta.get("array_kwargs", [])}
    for k, v in meta.get("kwargs", {}).items():
        if isinstance(v, dict) and v.get("__dataclass__") == "Config":
            kw[k] = Config(**v["fields"])
        elif isinstance(v, dict) and "__repr__" in v:
            continue       # not serializable: the op's default applies
        else:
            kw[k] = v
    return fn(*args, **kw)


def profile_call(name: str, fn: Callable, *args, _level: str = "op", **kw):
    """Run ``fn(*args, **kw)``; when profiling is on at ``_level`` and no
    CUDA graph is being captured, time it (synchronise, run, synchronise,
    host clock) and append a CSV row. Also serves an armed
    ``capture_next_op``."""
    if _capturing():
        return fn(*args, **kw)
    if _CAPTURE["path"] is not None and (
            _level == "op" or _PROFILE["level"] == "kernel"):
        _maybe_capture(name, args, kw)
    if (not _PROFILE["enabled"]
            or _LEVELS.index(_level) > _LEVELS.index(_PROFILE["level"])):
        return fn(*args, **kw)
    _sync((args, kw))
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _sync((args, kw, out))
    ms = (time.perf_counter() - t0) * 1e3
    _append_row(name, ms, _shapes_of(args))
    return out


def profiled(name: str, level: str = "op"):
    """Decorator wiring a library op (or, with ``level="kernel"``, a
    kernel wrapper) into ``toggle_profiling`` and ``capture_next_op``.
    Two dict lookups when both are off."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not _PROFILE["enabled"] and _CAPTURE["path"] is None:
                return fn(*args, **kw)
            return profile_call(name, fn, *args, _level=level, **kw)
        return wrapper
    return deco


@contextlib.contextmanager
def profiled_step(name: str, device: torch.device):
    """A named step inside a library op: when profiling is on at
    ``level="step"`` or ``"kernel"`` and no CUDA graph is being captured,
    the block is timed as ``profile_call`` times a call (synchronise
    ``device``, run, synchronise, host clock) and appends the row
    ``name,ms,``."""
    if (not _PROFILE["enabled"] or _PROFILE["level"] == "op"
            or _capturing()):
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    _append_row(name, (time.perf_counter() - t0) * 1e3, "")


def _profile_path() -> str:
    if _PROFILE["path"] is None:
        kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "cpu")
        _PROFILE["path"] = f"Profile.{kind.replace(' ', '_')}.csv"
    return _PROFILE["path"]


class Launcher:
    """Wraps a callable with profiling and capture hooks.

    Unlike the reference's per-launch argument binding
    (setBuffers/setConst, ``Adl/AdlKernel.inl:240-293``), arguments are
    plain Python calls; the Launcher records them when capture or
    profiling is on.
    """

    def __init__(self, fn: Callable, name: str, *,
                 static_config: Optional[dict] = None):
        self.fn = fn
        self.name = name
        self.static_config = static_config or {}

    def __call__(self, *args):
        if not _PROFILE["enabled"] or _capturing():
            return self.fn(*args)
        # Reference recipe: sync before, run, sync after, host clock
        # (AdlKernelUtilsCL.inl:664-677 forces finish around the launch).
        _sync(args)
        t0 = time.perf_counter()
        out = self.fn(*args)
        _sync((args, out))
        ms = (time.perf_counter() - t0) * 1e3
        _append_row(self.name, ms, _shapes_of(args))
        return out

    # -- capture/replay (serializeToFile analog) ----------------------
    def capture(self, path: str, *args) -> Any:
        """Run the launch and write its inputs and config to ``path``
        (LauncherCL::serializeToFile, ``AdlKernelUtilsCL.inl:680-734``).
        """
        packed = _pack(self.name, args, {})
        if packed is None:
            raise TypeError(f"{self.name}: an argument is not serializable")
        arrays, scalars, devices, _ = packed
        meta = {"name": self.name, "static_config": self.static_config,
                "scalars": scalars, "n_args": len(args),
                "devices": devices}
        np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
        return self.fn(*args)


def replay(path: str, registry: dict[str, Callable]) -> Any:
    """Re-run a captured launch (deserializeFromFile analog,
    ``Adl/CL/AdlKernelUtilsCL.inl:736-791``); ``registry`` maps launch
    names to callables."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    fn = registry[meta["name"]]
    args: list[Any] = []
    for i in range(meta["n_args"]):
        key = f"arg{i}"
        args.append(_load_array(data, meta, key) if key in data
                    else meta["scalars"][key])
    return fn(*args)
