"""The rows' radix engine's kernels (``radix_rows_*``: K11 and each K12
pass) in the traced slice over its calls: a count, 5 a call where the
engine serves it (K11 and four passes), so it repeats exactly. None where
the slice holds none of them (the row network's path, or no trace)."""

from portbench import tracing


def read(r):
    if r.slice is None:
        return None
    passes = sum(tracing.kernel_name(name).startswith("radix_rows_")
                 for *_, name in r.slice.device)
    return passes / r.slice.calls if passes else None
