"""The call into the port for ``sortx_torch.sort`` of u32 keys.

The configuration's default: no ``config`` argument, so the port picks
its engine as a user's call would (the network engine on a CUDA card).
"""

import sortx_torch

BYTES_PER_KEY = 8       # the least traffic: each u32 key read and written once
CONTROL_BITS = 31       # the control sorts on one key bit fewer than stated


def setup(device, config: dict, cards: int):
    return None


def inputs(state, keys):
    return (keys,)


def call(state, keys):
    return (sortx_torch.sort(keys),)


def control(state, keys):
    return (sortx_torch.sort(keys, CONTROL_BITS),)


def teardown(state) -> None:
    pass
