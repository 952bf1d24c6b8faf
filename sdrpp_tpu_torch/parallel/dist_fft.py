"""Distributed FFT: one large FFT split over the ranks of a mesh dim.

The counterpart of ``sdrpp_tpu.parallel.dist_fft``: the four-step
Cooley-Tukey FFT over a mesh dim ``fft`` of d ranks. View x[n] (n = i*c +
j) as an [r, c] matrix whose COLUMN index j is split over the ranks:
rank k holds columns [k c/d, (k + 1) c/d) (``shard_input``).

1. length-r FFTs down each column (local: every rank holds whole columns);
2. the twiddles W_N^(j*k1) (local, with the global column index);
3. the transposition: one ``all_to_all_single`` that splits the rows and
   concatenates the columns;
4. length-c FFTs along each row (local: every rank now holds whole rows).

The result C[k1, k2] = X[k1 + r*k2] comes back k1-split: rank k holds
rows [k r/d, (k + 1) r/d) of C (``natural=False``). ``natural=True``
returns X in natural order, rank k holding its contiguous n/d bins
[k n/d, (k + 1) n/d): C's column block k2 in [k c/d, (k + 1) c/d) over
all rows, moved there by a second ``all_to_all_single`` and read
transposed. The FFTs are ``torch.fft`` (cuFFT on the card), as the JAX
package leaves them to XLA; complex data crosses the collectives as its
real view.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from .mesh import mesh_device
from .spmd import axis_size, shard_index

__all__ = ["dist_fft", "dist_power_spectrum", "shard_input"]


@functools.lru_cache(maxsize=8)
def _twiddles(n: int, r: int, c: int) -> np.ndarray:
    """W_N^(j*k1) as [r, c] (k1 row, j column), complex64 on the host;
    cached, so a caller does not pay an O(n) host exp per spectrum."""
    return np.exp(-2j * np.pi
                  * (np.arange(r)[:, None] * np.arange(c)[None, :]) / n) \
        .astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _local_twiddles(n: int, r: int, c: int, d: int, k: int, device: str):
    """Rank k's [r, c/d] columns of ``_twiddles`` on ``device``."""
    w = c // d
    return torch.from_numpy(
        np.ascontiguousarray(_twiddles(n, r, c)[:, k * w:(k + 1) * w])
    ).to(device)


def _splits(n: int, d: int) -> tuple[int, int]:
    """Pick r*c = n with d | r and d | c, r as close to sqrt(n) as fits."""
    r = 1 << (int(np.log2(n)) // 2)
    while r % d or (n // r) % d:
        r *= 2
        if r > n:
            raise ValueError(f"cannot split n={n} over {d} ranks")
    return r, n // r


def _all_to_all(blocks: torch.Tensor, group) -> torch.Tensor:
    """[d, ...] blocks: block s goes to rank s; returns [d, ...] with block
    s from rank s."""
    src = torch.view_as_real(blocks.contiguous())
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.view_as_complex(out)


def dist_fft(x_local: torch.Tensor, mesh, axis_name: str = "fft",
             natural: bool = True) -> torch.Tensor:
    """FFT of a length-n (power-of-2) complex signal split over
    ``mesh[axis_name]``. ``x_local``: this rank's [r, c/d] column block
    (``shard_input``). ``natural=True`` returns this rank's contiguous
    [n/d] bins of X; ``natural=False`` its [r/d, c] row block of the
    matrix with X[k1 + r*k2] at (k1, k2), which skips the second
    transposition."""
    d = axis_size(mesh, axis_name)
    k = shard_index(axis_name, mesh)
    group = mesh.get_group(axis_name)
    r, w = x_local.shape
    c = w * d
    n = r * c
    if (r, c) != _splits(n, d):
        raise ValueError(f"x_local {tuple(x_local.shape)} is not the "
                         f"[r, c/d] block of n={n} over {d} ranks")
    tw = _local_twiddles(n, r, c, d, k, str(x_local.device))
    a = torch.fft.fft(x_local.to(torch.complex64), dim=0)  # 1. columns
    b = a * tw                                             # 2. twiddles
    # 3. rows split to their ranks, columns concatenated: [r/d, c]
    got = _all_to_all(b.reshape(d, r // d, w), group)
    rows = got.permute(1, 0, 2).reshape(r // d, c)
    cmat = torch.fft.fft(rows, dim=1)                      # 4. rows
    if not natural:
        return cmat
    # columns [k w, (k + 1) w) of every row: [r, w], read transposed
    got = _all_to_all(cmat.reshape(r // d, d, w).permute(1, 0, 2), group)
    return got.reshape(r, w).transpose(0, 1).reshape(n // d)


def dist_power_spectrum(x_local: torch.Tensor, window, mesh,
                        axis_name: str = "fft") -> torch.Tensor:
    """Windowed centred dB power line of ONE large FFT, distributed: this
    rank's contiguous [n/d] bins. ``window`` is the whole [n] window
    (``ops.spectrum.SpectrumFFT``'s: unity gain, the centring sign flips
    baked in, so the line comes out fftshifted), best a tensor already on
    the device (an array is uploaded each call); ``x_local`` is the
    [r, c/d] block of ``shard_input``."""
    d = axis_size(mesh, axis_name)
    r, w = x_local.shape
    k = shard_index(axis_name, mesh)
    win = torch.as_tensor(window, dtype=torch.float32,
                          device=x_local.device).reshape(r, w * d)
    X = dist_fft((x_local * win[:, k * w:(k + 1) * w]).to(torch.complex64),
                 mesh, axis_name)
    p = X.real * X.real + X.imag * X.imag
    return 10.0 * torch.log10(torch.clamp(p, min=1e-30))


def shard_input(x, mesh, axis_name: str = "fft") -> torch.Tensor:
    """This rank's [r, c/d] column block of the [n] signal ``x`` (a host
    array or tensor, whole on every rank), on the mesh's device: the
    layout ``dist_fft`` takes."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    n = x.shape[-1]
    d = axis_size(mesh, axis_name)
    r, c = _splits(n, d)
    k = shard_index(axis_name, mesh)
    w = c // d
    return x.reshape(r, c)[:, k * w:(k + 1) * w].to(
        mesh_device(mesh)).contiguous()
