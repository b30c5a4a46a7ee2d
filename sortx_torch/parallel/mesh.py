"""The rank mesh of the distributed sort.

Counterpart of ``sortx/parallel/mesh.py`` on ``torch.distributed``: one
process per rank, and a mesh is a 1-D ``DeviceMesh`` named "x" over
every rank of the default process group, in rank order. The key axis is
split over it as :func:`shard_1d` splits it: m = ceil(n / D) elements a
rank, so the last ranks are short or empty.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.math import cdiv

__all__ = ["make_sort_mesh", "shard_1d", "mesh_ranks", "AXIS"]

AXIS = "x"


def make_sort_mesh(n_devices: int | None = None, devices=None):
    """A 1-D ``DeviceMesh`` over every rank of the default process group.

    ``devices`` (global ranks) and ``n_devices`` may only name the whole
    group in rank order: the mesh's order is the order of the shards.
    The mesh's device type is "cuda", or "cpu" for a gloo group in a
    process that sees no card. Over an NCCL group its one dimension is
    the default group itself, so a call builds no communicator. Raises
    if no process group exists.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_sort_mesh needs a torch.distributed process group: call "
            "sortx_torch.parallel.init_multihost() in every process first")
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r)
                                                        for r in devices]
    if n_devices is not None:
        ranks = ranks[:n_devices]
    if ranks != list(range(world)):
        raise ValueError(f"the sort mesh spans the whole process group in "
                         f"rank order, ranks 0..{world - 1}; got {ranks}")
    cpu = dist.get_backend() == "gloo" and not torch.cuda.is_available()
    return DeviceMesh("cpu" if cpu else "cuda", ranks,
                      mesh_dim_names=(AXIS,))


def mesh_ranks(mesh):
    """(D, this process's rank on the mesh, the mesh's process group)."""
    return mesh.size(), mesh.get_local_rank(), mesh.get_group()


def shard_1d(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's shard of the global 1-D tensor ``x`` (a view)."""
    d, me, _ = mesh_ranks(mesh)
    n = x.shape[0]
    m = cdiv(n, d)
    return x[min(me * m, n):min((me + 1) * m, n)]
