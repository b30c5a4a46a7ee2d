"""Faults planted in the row network under the sampler cell's timed path,
for the tests that see its ``correct`` come out false. Each function
patches ``network_rows`` as ``sort_rows`` finds it, in the process that
calls it (a run calls it through its job's hooks)."""

from __future__ import annotations

import importlib

import torch

# the module, which the package's function of the same name shadows
rows_mod = importlib.import_module("sortx_torch.ops.rows")


def _in_place(rows, positions: bool):
    """``rows`` as they came, and with ``positions`` each slot's own
    in-row position: what a sort that moved nothing would return."""
    out = [r.clone() for r in rows]
    if positions:
        R, L = rows[0].shape
        out.append(torch.arange(L, dtype=torch.int32,
                                device=rows[0].device).repeat(R, 1))
    return out


def _on_rows(change):
    """Patch the row network so that ``change(rows, positions, out)``
    gives its outputs (``out`` the real network's)."""
    net = rows_mod.network_rows

    def network_rows(rows, positions=False):
        return change(rows, positions, net(rows, positions))

    rows_mod.network_rows = network_rows


def state_unchanged() -> None:
    """The row sort returns its rows as they came."""
    _on_rows(lambda rows, positions, out: _in_place(rows, positions))


def half_left_out() -> None:
    """Only the first half of the rows is sorted; the rest pass as they
    came."""
    def change(rows, positions, out):
        h = rows[0].shape[0] // 2
        rest = _in_place([r[h:] for r in rows], positions)
        return [torch.cat([a[:h], b]) for a, b in zip(out, rest)]

    _on_rows(change)


def answer_altered() -> None:
    """One word of the output is altered where it is produced: the low bit
    of a key in the middle of the batch."""
    def change(rows, positions, out):
        k = out[0].clone()
        k.view(-1)[k.numel() // 3] ^= 1
        return [k] + out[1:]

    _on_rows(change)
