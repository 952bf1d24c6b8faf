"""Channel-shard context: lets the bank's per-channel tables follow a
rank's channel shard.

The counterpart of ``sdrpp_tpu.parallel.spmd``. The JAX package runs the
sharded bank under ``shard_map``, where each device traces the bank on
its local [C/d, ...] shard and a per-channel table built for all C
channels no longer lines up. The port runs one process per rank, each on
its own device, with the same mismatch: ``ScannerBank.sharded_step``
holds only this rank's channel rows in its state, while ``mix_bank`` and
``FFTChannelizerBank`` build their tables for every channel.

So the fix is the JAX package's: the sharded step enters
``channel_shard(axis, mesh)`` around the bank body; the two table-holding
stages check :func:`current_channel_axis` and, when it is set and the
state's leading dimension is smaller than the full channel count, take
this rank's row block of their (full, device-resident) tables with
:func:`local_rows`. Everything else in the bank follows the leading
dimension of its state and input.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["channel_shard", "current_channel_axis", "current_mesh",
           "axis_names", "axis_size", "shard_index", "local_rows"]

_state = threading.local()


@contextmanager
def channel_shard(axis, mesh):
    """Mark the dynamic extent as this rank's shard of a bank whose
    channel dim is split over ``axis`` of ``mesh`` (a mesh dim name, or a
    tuple of names sharding the channel dim jointly, e.g. ("host",
    "chip")). Thread-local, as the bank runs on the caller's thread."""
    prev = getattr(_state, "shard", None)
    _state.shard = (axis, mesh)
    try:
        yield
    finally:
        _state.shard = prev


def current_channel_axis():
    """The active channel-shard axis name(s), or None outside
    ``channel_shard``."""
    shard = getattr(_state, "shard", None)
    return None if shard is None else shard[0]


def current_mesh():
    """The mesh of the active ``channel_shard``, or None outside it."""
    shard = getattr(_state, "shard", None)
    return None if shard is None else shard[1]


def axis_names(axis) -> tuple:
    """``axis`` (a name or a tuple / list of names) as a tuple."""
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def axis_size(mesh, axis) -> int:
    """The number of shards along ``axis``: the product of the sizes of
    its mesh dims."""
    size = 1
    for name in axis_names(axis):
        size *= mesh.shape[mesh.mesh_dim_names.index(name)]
    return size


def shard_index(axis, mesh=None) -> int:
    """This rank's coordinate along ``axis`` of ``mesh`` (the active
    ``channel_shard``'s mesh when None); a tuple of names flattens
    row-major, like JAX's PartitionSpec((a, b), ...)."""
    if mesh is None:
        mesh = current_mesh()
    idx = 0
    for name in axis_names(axis):
        size = mesh.shape[mesh.mesh_dim_names.index(name)]
        idx = idx * size + mesh.get_local_rank(name)
    return idx


def local_rows(full: torch.Tensor, n_local: int, axis=None,
               mesh=None) -> torch.Tensor:
    """This rank's ``n_local``-row block of a full [C_total, ...] table
    that already lives on the device: a view starting at row
    ``shard_index(axis) * n_local``; nothing is uploaded."""
    if axis is None:
        axis = current_channel_axis()
    start = shard_index(axis, mesh) * n_local
    if start + n_local > full.shape[0]:
        raise ValueError(f"rows {start}:{start + n_local} out of a "
                         f"{full.shape[0]}-row table")
    return full.narrow(0, start, n_local)
