"""Device mesh and placement helpers.

The counterpart of ``sdrpp_tpu.parallel.mesh``. The TPU-native scaling
axes are (a) channels, a VFO bank sharded over devices, and (b) time,
long IQ blocks split with a FIR halo exchange. Here the mesh is a
``torch.distributed`` ``DeviceMesh`` with dims ``("channels", "time")``
over the initialised world, one process per rank and one device per
process, and a placement is the ``torch.distributed.tensor`` list that
says, per mesh dim, which tensor dim it splits (``Shard``) or that it
copies the tensor (``Replicate``). The per-block compute does not go
through DTensor dispatch: each rank runs plain tensor code on its own
block (``multihost.put_global``), and the collectives are explicit (NCCL on the
card, gloo on the CPU). ``torch.distributed.tensor``, which holds the
placement classes, is imported where a placement is built or read: it
adds over a second to an import of the bank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .spmd import axis_names

__all__ = ["make_mesh", "channel_sharding", "time_sharding", "replicated",
           "shard_placements", "all_gather", "mesh_device"]


def make_mesh(n_channels_axis: int | None = None, n_time_axis: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("channels", "time") mesh over the initialised world's ranks,
    row-major (rank = channel coordinate * n_time_axis + time coordinate).
    """
    world = dist.get_world_size()
    if n_channels_axis is None:
        n_channels_axis = world // n_time_axis
    return init_device_mesh(device_type, (n_channels_axis, n_time_axis),
                            mesh_dim_names=("channels", "time"))


def shard_placements(mesh: DeviceMesh, axis, dim: int) -> list:
    """Tensor dim ``dim`` split over ``axis`` (a mesh dim name or a tuple
    of them, jointly and row-major, which must follow the mesh's dim
    order); every other mesh dim replicates."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(axis)
    order = [mesh.mesh_dim_names.index(n) for n in names]
    if order != sorted(order):
        raise ValueError(f"axis {names} must follow the mesh's dim order "
                         f"{mesh.mesh_dim_names}")
    return [Shard(dim) if name in names else Replicate()
            for name in mesh.mesh_dim_names]


def channel_sharding(mesh: DeviceMesh, ndim: int = 2) -> list:
    """Shard the leading (channel) dim over "channels"; replicate the rest.
    ``ndim`` is kept for the JAX package's signature: the placement does
    not depend on it."""
    return shard_placements(mesh, "channels", 0)


def time_sharding(mesh: DeviceMesh, ndim: int = 1) -> list:
    """Shard the trailing (time) dim of an ``ndim``-dim tensor over
    "time"."""
    return shard_placements(mesh, "time", ndim - 1)


def replicated(mesh: DeviceMesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def all_gather(t: torch.Tensor, mesh: DeviceMesh, name) -> torch.Tensor:
    """Every rank's ``t`` along mesh dim ``name``, stacked as [p, ...] in
    coordinate order, on every rank of that dim. Complex tensors travel as
    their real view, which every backend takes."""
    group = mesh.get_group(name)
    src = (torch.view_as_real(t) if t.is_complex() else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return torch.view_as_complex(out) if t.is_complex() else out


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on for ``mesh``: the current CUDA
    device for a "cuda" mesh, the CPU otherwise."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
