"""K14's (``topk_rows_gather_kernel``) least time at the card's memory
bandwidth over its summed device time in the traced slice, in %.

The least bytes are reckoned from the cell, never read from the program:
a launch reads every valid key once, 4 bytes a key (the cell's
``keys_per_card`` is its valid keys). Its writes (each row's k slots of
a mapped word, an index and the key's own word) are left out, as the
K13 reader leaves out its row state: they are a few percent of the
reads where rows are far longer than k, and leaving them out only lowers
the share. None where the slice holds no launch of the kernel."""

from pathlib import Path

from portbench import spec

KERNEL = "topk_rows_gather_kernel"


def read(r):
    share = spec.load_module(Path(__file__).resolve().with_name(
        "topk_rows_histogram_roofline.py"))
    return share.kernel_share(r, KERNEL, 4 * r.keys_per_card)
