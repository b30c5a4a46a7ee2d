"""The row network's kernels (``bitonic_*``) in the traced slice over its
calls: its passes a call, a count, so it repeats exactly. None where the
slice holds none of them."""

from portbench import tracing


def read(r):
    if r.slice is None:
        return None
    passes = sum(tracing.kernel_name(name).startswith("bitonic_")
                 for *_, name in r.slice.device)
    return passes / r.slice.calls if passes else None
