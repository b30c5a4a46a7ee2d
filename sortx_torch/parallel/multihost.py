"""Starting the process group the distributed sort runs on.

Counterpart of ``sortx/parallel/multihost.py``. Where the reference
starts JAX's distributed runtime once per host, the port starts one
``torch.distributed`` process per rank (``torchrun`` starts them, or the
caller does): NCCL on the card, gloo where the caller asks for the CPU.
An NCCL rank takes the card :func:`local_card` names and binds its
group to it; a collective that waits longer than :data:`TIMEOUT` fails
the run instead of hanging it. :func:`simulate_hosts_flags` is the
environment for n such processes on one machine's CPU, the port's
counterpart of the reference's recipe of n virtual XLA devices.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ..ops._build import check_device
from ..utils.log import Channel, log

__all__ = ["init_multihost", "is_multihost", "host_count", "local_card",
           "simulate_hosts_flags", "TIMEOUT"]

TIMEOUT = datetime.timedelta(seconds=300)


def local_card(local_rank, rank, count: int) -> int:
    """The card of a process: ``local_rank`` (torchrun's ``LOCAL_RANK``,
    a string or an int) where the launcher set it, else ``rank`` (0 for
    None) mod the ``count`` cards visible. A ``local_rank`` that names no
    visible card raises, as does a machine without cards."""
    if count < 1:
        raise RuntimeError("no CUDA card visible for an NCCL rank")
    if local_rank is None:
        return (rank or 0) % count
    card = int(local_rank)
    if not 0 <= card < count:
        raise ValueError(f"LOCAL_RANK={local_rank} names no card: {count} "
                         "visible")
    return card


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   device=None) -> None:
    """Start the default process group (one call per process).

    The arguments default to torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). ``coordinator_address``
    is "host:port" or an ``init_method`` URL ("tcp://...", "file://...").
    With none of them set it starts a one-rank group. ``device`` is
    "cuda" (the default: NCCL, on the card ``LOCAL_RANK`` names, else
    rank mod the card count; the group is bound to that card) or "cpu"
    (gloo); a CUDA device without a card raises, and so does a group
    that fails to start: nothing falls back to another backend.
    """
    dev = check_device(device or "cuda")
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    backend, kw = "gloo", {"timeout": TIMEOUT}
    if dev.type == "cuda":
        card = local_card(env.get("LOCAL_RANK"), process_id,
                          torch.cuda.device_count())
        torch.cuda.set_device(card)
        backend, kw["device_id"] = "nccl", torch.device("cuda", card)
    if coordinator_address is None and num_processes in (None, 1):
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, **kw)
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("init_multihost needs the coordinator address, "
                             "the number of processes and this process's "
                             "id (or MASTER_ADDR, WORLD_SIZE and RANK)")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id,
                                **kw)
    log(f"multihost init: rank {dist.get_rank()}/{dist.get_world_size()} "
        f"on {backend}", Channel.DEVICE)


def is_multihost() -> bool:
    return host_count() > 1


def host_count() -> int:
    """The default process group's world size (1 without a group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def simulate_hosts_flags(n_devices: int = 8) -> dict:
    """The environment for an n-process gloo run on this machine's CPU: a
    free localhost port and the world size. Each process adds its own
    ``RANK`` and calls ``init_multihost(device="cpu")``."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
            "WORLD_SIZE": str(n_devices)}
