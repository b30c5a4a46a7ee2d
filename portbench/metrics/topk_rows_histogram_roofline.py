"""K13's (``topk_rows_histogram_kernel``) least time at the card's
memory bandwidth over its summed device time in the traced slice, in %.

The least bytes are reckoned here from the cell, never read from the
program: each launch (a round) reads every valid key once, 4 bytes a key
(the cell's ``keys_per_card`` is its valid keys), and its outputs (each
row's need and prefix, a few words a row) are left out. None where the
slice holds no launch of the kernel."""

from portbench import peaks, tracing

KERNEL = "topk_rows_histogram_kernel"


def kernel_share(r, kernel: str, bytes_per_launch: float):
    """100 x (launches x the least seconds of ``bytes_per_launch``) / the
    kernel's summed device seconds in the slice; None without a launch.
    The other ``topk_rows_*_roofline`` reader loads this file for it."""
    if r.slice is None:
        return None
    spans = [b - a for a, b, _, name in r.slice.device
             if tracing.kernel_name(name) == kernel]
    if not spans:
        return None
    least, _ = peaks.least_seconds(bytes_per_launch)
    return 100.0 * least * len(spans) / (sum(spans) / 1e9)


def read(r):
    return kernel_share(r, KERNEL, 4 * r.keys_per_card)
