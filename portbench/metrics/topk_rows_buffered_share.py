"""The share of the per-row top-k's rows whose later rounds and gather
read only their candidate buffer, against all rows it selected, in %:
the port's own running count (``sortx_torch.ops.topk_rows.buffer_counts()``,
kept by ``topk_rows_buffer_select_kernel`` on the card), read once after
the window, so it covers the run's calls (captured calls are not
counted). A row reads its whole row again where its bucket of the k-th
key outgrew its buffer, as a low-entropy row does. None where the port
has no such count (an older port) or no row was counted."""

import importlib


def read(r):
    try:
        select = importlib.import_module("sortx_torch.ops.topk_rows")
    except ImportError:
        return None
    counts = getattr(select, "buffer_counts", None)
    if counts is None:
        return None
    buffered, rows = counts()
    return 100.0 * buffered / rows if rows else None
