"""Faults planted under the indexer cell's timed path, for the tests that
see its ``correct`` come out false. Each function patches
``topk_rows_select`` as ``top_k_rows`` finds it, in the process that
calls it (a run calls it through its job's hooks)."""

from __future__ import annotations

import importlib

import torch

from sortx_torch.ops.radix_rows import encode_plain
from sortx_torch.utils.words import as_u64

# the module, which the package's function of the same name shadows
topk_mod = importlib.import_module("sortx_torch.ops.topk_rows")


def _on_select(change):
    """Patch the select so that ``change(select, *args)`` gives its
    outputs (``select`` the real one)."""
    real = topk_mod.topk_rows_select

    def topk_rows_select(*args, **kw):
        return change(real, *args, **kw)

    topk_mod.topk_rows_select = topk_rows_select


def lengths_ignored() -> None:
    """The rows' lengths are left out: every row is read to its end."""
    _on_select(lambda real, words, lengths, *rest, **kw:
               real(words, None, *rest, **kw))


def index_altered() -> None:
    """One index of the output is altered where it is produced: the low
    bit of an index a third of the way into the batch."""
    def change(real, *args, **kw):
        words, idx = real(*args, **kw)
        idx = idx.clone()
        idx.view(-1)[idx.numel() // 3] ^= 1
        return words, idx

    _on_select(change)


def ties_reversed() -> None:
    """Tied keys come back in descending position: each row of kept keys
    re-ordered by (mapped word, -index)."""
    def change(real, words, lengths, kind, *rest, **kw):
        vals, idx = real(words, lengths, kind, *rest, **kw)
        key = (as_u64(encode_plain(vals, kind, True)) << 31) | (
            (1 << 31) - 1 - idx.to(torch.int64).clamp(min=0))
        order = torch.sort(key, dim=1).indices
        return vals.gather(1, order), idx.gather(1, order)

    _on_select(change)
