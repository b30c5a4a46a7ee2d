"""Device operations (kernels, copies and memsets) per call of the
per-row top-k in the traced slice: a count, so it repeats exactly. Its
path is a memset, four K13 (``topk_rows_histogram_kernel``), K14
(``topk_rows_gather_kernel``) and the row network's passes (one at k =
2048). None where the slice holds no ``topk_rows_*`` kernel (another
path, or no trace)."""

from portbench import tracing


def read(r):
    if r.slice is None or not any(
            tracing.kernel_name(name).startswith("topk_rows_")
            for *_, name in r.slice.device):
        return None
    return len(r.slice.device) / r.slice.calls
