"""The call into the port for a stable ``sortx_torch.sort_kv`` of u32
keys with u32 values, the index payload ``arange(n)`` of the flagship
(``__graft_entry__.py:entry``).

The configuration's default: no ``config`` argument, ``stable=True``.
"""

import torch

import sortx_torch

BYTES_PER_KEY = 16      # each key and value read once and written once


def setup(device, config: dict, cards: int):
    return {}


def inputs(state, keys):
    """(keys, values): the values are one ``arange`` shared by the pool."""
    n = keys.shape[0]
    values = state.get(n)
    if values is None or values.device != keys.device:
        values = torch.arange(n, dtype=torch.int32, device=keys.device
                              ).view(torch.uint32)
        state[n] = values
    return keys, values


def call(state, keys, values):
    return sortx_torch.sort_kv(keys, values)


def control(state, keys, values):
    """The port's own unstable path: the values of equal keys may come
    back in another order, which breaks the stated stability."""
    return sortx_torch.sort_kv(keys, values, stable=False)


def teardown(state) -> None:
    state.clear()
