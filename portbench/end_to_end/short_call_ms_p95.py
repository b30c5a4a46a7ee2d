"""The 95th percentile (nearest rank) of the latency of every call in
the window, in ms, for calls short enough that the host's launches set
their time (a name of its own: such calls spread far more)."""

from portbench.stats import percentile


def read(w) -> float:
    return percentile(w.latency_s, 95) * 1e3
