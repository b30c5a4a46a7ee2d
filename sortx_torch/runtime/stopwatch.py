"""Split-capable timer.

Port of ``sortx/runtime/stopwatch.py`` (the reference's ``Stopwatch``
family, ``Adl/AdlStopwatch.h:60-83``; the CL one is device sync + host
clock, ``Adl/CL/AdlStopwatchCL.inl:49-53``). The same recipe: each
split first synchronises the cards that hold the tensors passed to it,
then reads the host's monotonic clock.
"""

from __future__ import annotations

import time

from .launcher import _sync

__all__ = ["Stopwatch"]


class Stopwatch:
    """Monotonic timer with up to ``capacity`` splits (reference: 64)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._t = []

    def start(self, *sync) -> None:
        _sync(sync)
        self._t = [time.perf_counter()]

    def split(self, *sync) -> None:
        """Record a split; pass tensors being computed to wait for them
        first."""
        _sync(sync)
        if len(self._t) < self.capacity:
            self._t.append(time.perf_counter())

    def stop(self, *sync) -> None:
        self.split(*sync)

    def get_ms(self, start_idx: int = 0, end_idx: int = -1) -> float:
        """Elapsed ms between two splits (Stopwatch::getMs analog)."""
        if len(self._t) < 2:
            return 0.0
        return (self._t[end_idx] - self._t[start_idx]) * 1e3

    @property
    def n_splits(self) -> int:
        return len(self._t)

    def split_times_ms(self) -> list[float]:
        return [(b - a) * 1e3 for a, b in zip(self._t, self._t[1:])]
