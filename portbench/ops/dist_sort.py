"""The call into the port for ``sortx_torch.parallel.dist_sort`` of u32
keys, one rank per card over NCCL.

``setup`` starts the group as a user's process would under torchrun
(``init_multihost()`` on the card ``LOCAL_RANK`` names) and makes the
mesh; the call takes this rank's shard and returns its shard of the
sorted array. The default ``dist_*`` configuration: the ragged exchange,
the merge tree.
"""

import sortx_torch
from sortx_torch.parallel import init_multihost
from sortx_torch.runtime import toggle_profiling

BYTES_PER_KEY = 8       # each u32 key read once and written once
CONTROL_BITS = 31       # the control sorts on one key bit fewer than stated


def setup(device, config: dict, cards: int):
    init_multihost(device=device.type)
    return {"mesh": sortx_torch.make_sort_mesh()}


def inputs(state, keys):
    return (keys,)


def call(state, keys):
    return (sortx_torch.dist_sort(keys, mesh=state["mesh"]),)


def control(state, keys):
    return (sortx_torch.dist_sort(keys, CONTROL_BITS, mesh=state["mesh"]),)


def step_rows(state, csv: str, on: bool) -> None:
    """The port's ``dist_sort/<step>`` rows (``level="step"``) into
    ``csv`` while ``on``."""
    toggle_profiling(on, csv, level="step" if on else "op")


def teardown(state) -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
