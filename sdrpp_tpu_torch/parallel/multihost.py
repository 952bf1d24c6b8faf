"""Multi-process execution: process-group start-up and per-rank ingest.

The counterpart of ``sdrpp_tpu.parallel.multihost``. The JAX package runs
one process per host over many devices (``jax.distributed``); the port
runs one process per rank, each with one device, joined in a
``torch.distributed`` process group: NCCL between cards, gloo between CPU
processes. Every rank ingests the same wideband block (its copy or its
read of the capture stream), runs the bank on its channel rows
(``ScannerBank.sharded_step``), and the audio is gathered where it is
wanted whole. On N processes:

    # on every process (rank i; the coordinator is rank 0's address):
    rx = MultiHostReceiver(offsets, fs, coordinator="host0:8476",
                           num_processes=N, process_id=i)
    audio_local = rx.process_block(iq)      # this rank's [C/N, n] rows
    audio = rx.gather_audio(audio_local)    # [C, n] on every rank

Importing this module initialises nothing; ``distributed_init`` does, and
the caller ends the group (``torch.distributed.destroy_process_group``).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..io.sources import FileSource
from .mesh import all_gather
from .vfo_bank import ScannerBank

__all__ = ["distributed_init", "global_channel_mesh", "MultiHostReceiver",
           "host_shard_paths", "put_global", "gather_global"]

DEFAULT_TIMEOUT_S = 300.0


def _rank_device(device=None) -> torch.device:
    """``device``, or by default ``cuda:{LOCAL_RANK}`` (LOCAL_RANK from the
    environment, 0 when unset)."""
    if device is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device(device)


def distributed_init(coordinator: str | None = None, num_processes: int = 1,
                     process_id: int = 0, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join (or start) the process group: NCCL for a CUDA ``device`` (made
    the current device first), gloo for the CPU. ``coordinator`` is
    "host:port" (TCP, rank 0 listens) or an init URL ("tcp://...",
    "file://...", whose file the group keeps using: NCCL sets up its
    communicator at the first collective); one process without a
    coordinator starts a world of 1 on an in-process store, so the same
    collectives run. A group already
    up is reused when its world size and rank agree. Collectives and the
    start-up fail after ``timeout_s`` seconds. Returns (world_size, rank).
    """
    device = _rank_device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"distributed_init on {device}: no CUDA device")
        torch.cuda.set_device(device)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if (world, rank) != (num_processes, process_id):
            raise RuntimeError(f"a process group of world {world}, rank "
                               f"{rank} is up; asked for {num_processes}, "
                               f"{process_id}")
        return world, rank
    backend = "nccl" if device.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator is None:
        if num_processes != 1:
            raise ValueError("more than one process needs a coordinator")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    return dist.get_world_size(), dist.get_rank()


def global_channel_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A 1-D "channels" mesh over every rank of the process group."""
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("channels",))


def host_shard_paths(paths, process_index: int, process_count: int):
    """Per-process file sharding: process i reads every i-th capture file
    (the per-host ingest half of the plan)."""
    return list(paths)[process_index::process_count]


def put_global(arr, mesh: DeviceMesh, placements, device) -> torch.Tensor:
    """This rank's block of the full array ``arr`` (the same on every
    rank) under ``placements``, on ``device``: cut mesh dim by mesh dim
    (so a tensor dim split over two mesh dims splits row-major); every
    split must be even, and only the block moves."""
    from torch.distributed.tensor import Shard

    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.asarray(arr))
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d, size = pl.dim % t.ndim, mesh.shape[i]
            if t.shape[d] % size:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split evenly over {size} ranks")
            step = t.shape[d] // size
            t = t.narrow(d, mesh.get_local_rank(i) * step, step)
    return t.to(device).contiguous()


def gather_global(x: torch.Tensor, mesh: DeviceMesh, placements):
    """The inverse of ``put_global``: the full tensor on every rank from
    each rank's block ``x``, gathered mesh dim by mesh dim from the last
    (an ``all_gather`` per split mesh dim)."""
    from torch.distributed.tensor import Shard

    for i in reversed(range(len(placements))):
        pl = placements[i]
        if isinstance(pl, Shard):
            parts = all_gather(x, mesh, mesh.mesh_dim_names[i])
            x = torch.cat(list(parts.unbind(0)), dim=pl.dim % x.ndim)
    return x


class MultiHostReceiver:
    """Channel-sharded scanner bank over every rank of the process group.

    Each rank runs the bank on its C/P channel rows (the state split by
    ``ScannerBank.shard``, kept on this rank's device); the wideband block
    is the same on every rank. ``process_block`` returns this rank's audio
    rows, ``gather_audio`` the whole [C, n] on every rank."""

    def __init__(self, offsets_hz, in_samplerate: float, mode: str = "nfm",
                 if_rate: float = 48000.0, bandwidth: float = 12500.0,
                 coordinator: str | None = None, num_processes: int = 1,
                 process_id: int = 0, device=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.device = _rank_device(device)
        distributed_init(coordinator, num_processes, process_id, self.device,
                         timeout_s)
        self.mesh = global_channel_mesh(self.device.type)
        self.bank = ScannerBank(offsets_hz, in_samplerate, mode=mode,
                                if_rate=if_rate, bandwidth=bandwidth,
                                device=self.device)
        self.block_multiple = self.bank.block_multiple
        self._step, _ = self.bank.sharded_step(self.mesh)
        self._state, _, self._out = self.bank.shard(self.mesh,
                                                    self.bank.init_state())

    def process_block(self, iq) -> torch.Tensor:
        """Feed one wideband block (the same content on every rank).
        Returns this rank's [C/P, n] audio rows, on its device."""
        x = torch.as_tensor(np.asarray(iq) if not isinstance(
            iq, torch.Tensor) else iq).to(self.device)
        self._state, audio = self._step(self._state, x)
        return audio

    def gather_audio(self, audio: torch.Tensor) -> torch.Tensor:
        """The full [channels, n] audio on every rank."""
        return gather_global(audio, self.mesh, self._out)

    def run_file(self, path, num_blocks: int, block_size: int):
        """This rank's audio rows of ``num_blocks`` blocks of a WAV
        capture."""
        src = FileSource(path)
        return [self.process_block(src.read(block_size))
                for _ in range(num_blocks)]
