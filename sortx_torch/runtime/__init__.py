"""Runtime layer: device, buffers, launch profiling and capture, timing,
tracing and the build cache.

Port of ``sortx/runtime/`` (the reference's Adl layer) on torch: a
``SortxDevice`` is a CUDA card (or the CPU), a ``Buffer`` a 1-D tensor
on it, the profiler ``torch.profiler``, and the cache the build
directory of the port's two libraries (``ops/_build.py``, ``native.py``).
"""

from . import native
from . import profiler
from .buffer import Buffer, SyncObject
from .cache import enable_cache, warmup
from .device import DeviceConfig, SortxDevice, allocate_device, device_count
from .launcher import (Launcher, capture_next_op, profiling_enabled,
                       profiling_level, replay, replay_op,
                       toggle_profiling)
from .mirror import MirroredArray, MirrorState
from .stopwatch import Stopwatch

__all__ = [
    "Buffer",
    "SyncObject",
    "DeviceConfig",
    "SortxDevice",
    "allocate_device",
    "device_count",
    "Launcher",
    "replay",
    "replay_op",
    "capture_next_op",
    "toggle_profiling",
    "profiling_enabled",
    "profiling_level",
    "MirroredArray",
    "MirrorState",
    "Stopwatch",
    "enable_cache",
    "warmup",
    "profiler",
    "native",
]
