"""The 95th percentile (nearest rank) of the latency of every call in
the window, in ms: issue to the return of its synchronise."""

from portbench.stats import percentile


def read(w) -> float:
    return percentile(w.latency_s, 95) * 1e3
