"""The host's time to issue one call, in ms: the harness's span from
the call to its return, before the synchronise; the median over the
window's untraced calls."""

from portbench.stats import percentile


def read(r):
    if not r.enqueue_s:
        return None
    return percentile(r.enqueue_s, 50) * 1e3
