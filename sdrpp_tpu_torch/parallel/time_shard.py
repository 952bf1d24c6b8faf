"""Time-axis sharding: long IQ blocks split over ranks with halo exchange.

The counterpart of ``sdrpp_tpu.parallel.time_shard``. A block of n
samples is split over a mesh dim (``"time"``) into P contiguous shards,
rank k holding samples [k n / P, (k + 1) n / P); the stateful ops need
little communication:

- FIR / overlap-save: each shard needs the previous shard's last
  ntaps - 1 samples, a neighbour halo (shard 0 takes the tail carried
  from the block before instead);
- first-order linear recurrences (DC blocker, de-emphasis): each shard
  reduces its samples to one affine map (a^len, B); the P maps compose in
  a small all-gathered exclusive scan, then every shard applies its
  prefix locally;
- pointwise ops with index-dependent terms (the NCO mix): per-shard phase
  offsets are static (shard length x omega), a 65-entry table.

The JAX package runs these under ``shard_map``; here each rank is a
process that runs plain tensor code on its own shard, and the collectives
are explicit ``torch.distributed`` calls over the mesh dim's group (NCCL
on the card, gloo on the CPU): an all-gather of the small tails for the
halo, a broadcast from the last shard for the carries. The carried state
is replicated: every rank holds the same value.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..ops import taps as taps_mod
from ..ops.fir import _fft_len, fir_correlate, taps_spectrum
from ..ops.fm import quadrature_demod
from ..ops.mix import TWO_PI, _TWO_PI32, hz_to_rads
from ..ops.scans import affine_scan
from .mesh import all_gather, mesh_device
from .spmd import axis_size, shard_index

__all__ = [
    "sharded_fir", "sharded_affine_scan", "sharded_mix", "sharded_quadrature",
    "make_time_step_nfm",
]

MAX_SHARDS = 64  # sharded_mix's offset table has MAX_SHARDS + 1 entries


def _right_halo(x_tail: torch.Tensor, mesh, axis: str = "time"):
    """Each shard's tail to its RIGHT neighbour; shard 0 gets zeros."""
    if axis_size(mesh, axis) == 1:
        return torch.zeros_like(x_tail)
    idx = shard_index(axis, mesh)
    tails = all_gather(x_tail, mesh, axis)
    return tails[idx - 1] if idx > 0 else torch.zeros_like(x_tail)


def _from_last_shard(val: torch.Tensor, mesh, axis: str = "time"):
    """The LAST shard's ``val`` on every shard (a broadcast from it; a copy,
    so ``val``'s storage is not written)."""
    group = mesh.get_group(axis)
    src = dist.get_global_rank(group, axis_size(mesh, axis) - 1)
    out = val.clone()
    dist.broadcast(torch.view_as_real(out) if out.is_complex() else out,
                   src=src, group=group)
    return out


@functools.lru_cache(maxsize=16)
def _spectrum(taps: bytes, dtype: str, fft_len: int, device: str):
    return taps_spectrum(np.frombuffer(taps, dtype=dtype), fft_len, device)


def sharded_fir(tail: torch.Tensor, x_local: torch.Tensor, taps: np.ndarray,
                mesh, axis: str = "time"):
    """Overlap-save FIR over a time-sharded block.

    ``tail``: [m-1] carried tail of the whole stream (replicated).
    ``x_local``: this shard's samples. Returns (new_tail [m-1] replicated,
    y_local)."""
    taps = np.asarray(taps)
    m = taps.shape[0]
    if m == 1:
        return tail, x_local * taps[0].item()
    my_tail = x_local[-(m - 1):]
    left = _right_halo(my_tail, mesh, axis)
    if shard_index(axis, mesh) == 0:
        left = tail.to(left.dtype)
    spec = _spectrum(taps.tobytes(), taps.dtype.str,
                     _fft_len(x_local.shape[-1], m), str(x_local.device))
    _, y = fir_correlate(left, x_local, taps, spec)
    if y.is_complex():
        y = y.to(torch.complex64)
    return _from_last_shard(my_tail, mesh, axis), y


@functools.lru_cache(maxsize=16)
def _powers(a: float, n: int, device: str) -> torch.Tensor:
    """a^(i+1) for i < n: float64 on the host, float32 on ``device``."""
    p = np.power(a, np.arange(1, n + 1, dtype=np.float64))
    return torch.from_numpy(p.astype(np.float32)).to(device)


def sharded_affine_scan(a: float, b_local: torch.Tensor, y0, mesh,
                        axis: str = "time"):
    """y[i] = a*y[i-1] + b[i] across the whole time-sharded block.

    ``y0`` is the value carried into the block (replicated). Each shard
    scans its own samples from 0 (the port's blocked ``affine_scan``,
    which holds float32 to ~2e-8 of float64 near a = 1), its last value
    B_k goes to every shard, and shard k folds the maps of the shards to
    its left, y_in = a^len y_in + B_j for j < k, from y0. Returns (final
    value replicated, y_local)."""
    a = float(a)
    n = b_local.shape[-1]
    dev = b_local.device
    zero = torch.zeros((), dtype=b_local.dtype, device=dev)
    local = affine_scan(a, b_local, zero)  # y_local with y_in = 0
    shard_b = all_gather(local[-1], mesh, axis)  # [P]
    a_len = float(np.float32(a ** n))
    y_in = torch.as_tensor(y0, dtype=b_local.dtype).to(dev)
    for k in range(shard_index(axis, mesh)):
        y_in = a_len * y_in + shard_b[k]
    y_local = local + _powers(a, n, str(dev)) * y_in
    return _from_last_shard(y_local[-1], mesh, axis), y_local


@functools.lru_cache(maxsize=16)
def _mix_tables(omega: float, shard_len: int, device: str):
    """(offsets [MAX_SHARDS + 1] = k * shard_len * omega mod 2pi, ramp
    [shard_len] = i * omega mod 2pi): float64 on the host, float32 on
    ``device``."""
    offs = np.mod(np.arange(MAX_SHARDS + 1, dtype=np.float64)
                  * shard_len * omega, TWO_PI)
    ramp = np.mod(np.arange(shard_len, dtype=np.float64) * omega, TWO_PI)
    return tuple(torch.from_numpy(t.astype(np.float32)).to(device)
                 for t in (offs, ramp))


def sharded_mix(phase0: torch.Tensor, x_local: torch.Tensor, omega: float,
                shard_len: int, mesh, axis: str = "time"):
    """NCO mix of a time-sharded block with the exact global phase.

    ``phase0``: the phase carried into the block (replicated). Shard k
    starts at phase0 + (k * shard_len * omega mod 2pi), from a host-built
    table of MAX_SHARDS + 1 offsets, so at most MAX_SHARDS shards."""
    p = axis_size(mesh, axis)
    if p > MAX_SHARDS:
        raise ValueError(f"sharded_mix takes at most {MAX_SHARDS} shards, "
                         f"got {p}")
    offs, ramp = _mix_tables(float(omega), int(shard_len),
                             str(x_local.device))
    idx = shard_index(axis, mesh)
    ph = torch.remainder(phase0 + offs[idx] + ramp, _TWO_PI32)
    y = x_local * torch.complex(torch.cos(ph), torch.sin(ph))
    # the whole block's advance, p * shard_len * omega mod 2pi
    return torch.remainder(phase0 + offs[p], _TWO_PI32), y


def sharded_quadrature(last: torch.Tensor, x_local: torch.Tensor,
                       inv_deviation: float, mesh, axis: str = "time"):
    """FM discriminator over a time-sharded block (a 1-sample halo).
    ``last``: [1], the sample before the block (replicated)."""
    my_last = x_local[-1:]
    left = _right_halo(my_last, mesh, axis)
    if shard_index(axis, mesh) == 0:
        left = last
    _, y = quadrature_demod(left, x_local, float(np.float32(inv_deviation)))
    return _from_last_shard(my_last, mesh, axis), y


def make_time_step_nfm(mesh, offset_hz: float, samplerate: float,
                       bandwidth: float, block_size: int):
    """A time-sharded NFM receive step over ``mesh``'s "time" dim: mix ->
    channel low-pass FIR -> quadrature FM -> audio low-pass.

    Returns (step, init_state): ``step(state, x_local)`` takes this rank's
    contiguous shard of a ``block_size``-sample block and returns (state,
    audio_local); the state leaves are replicated, on the mesh's device."""
    p = axis_size(mesh, "time")
    if block_size % p:
        raise ValueError(f"block size {block_size} does not split over "
                         f"{p} shards")
    shard_len = block_size // p
    omega = float(hz_to_rads(-offset_hz, samplerate))
    chan_taps = taps_mod.low_pass(bandwidth / 2.0, bandwidth * 0.05, samplerate)
    audio_taps = taps_mod.low_pass(bandwidth / 2.0, bandwidth * 0.1, samplerate)
    inv_dev = 1.0 / hz_to_rads(bandwidth / 2.0, samplerate)
    device = mesh_device(mesh)

    def step(state, x_local):
        if x_local.shape[-1] != shard_len:
            raise ValueError(f"a shard of {x_local.shape[-1]} samples; this "
                             f"step takes {shard_len}")
        phase, ctail, qlast, atail = state
        phase, y = sharded_mix(phase, x_local, omega, shard_len, mesh)
        ctail, y = sharded_fir(ctail, y, chan_taps, mesh)
        qlast, y = sharded_quadrature(qlast, y, inv_dev, mesh)
        atail, y = sharded_fir(atail, y, audio_taps, mesh)
        return (phase, ctail, qlast, atail), y

    def init_state():
        return (
            torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros(len(chan_taps) - 1, dtype=torch.complex64,
                        device=device),
            torch.zeros(1, dtype=torch.complex64, device=device),
            torch.zeros(len(audio_taps) - 1, dtype=torch.float32,
                        device=device),
        )

    return step, init_state
