"""The strided decimating-FIR kernel: the power-of-2 decimator's r >= 8
stages.

The counterpart of ``sdrpp_tpu.ops.fir_pallas``: ``decimating_fir``
replaces the Pallas kernel ``_run`` (fir_pallas.py:74, called through
``decimating_fir_pallas``), which computes the reference's decimating FIR
(decimating_fir.h:49-69) with real float32 taps:

    y[o] = sum_{j<m} taps[j] * buf[r*o + j],   buf = [tail | x].

On a CUDA tensor it launches ``csrc/decim_fir.cu`` through a compiled
host path, ``decim_fir`` of ``csrc/kernels_host.cpp``, which checks the
arguments, allocates the outputs and launches in one C++ call (both built
on first use; a failed build raises), and adds one to its ``launches``
count; on a CPU tensor it runs ``decimating_fir_plain``, the same sum in
the same order (j = 0..m-1 from 0.0, one rounding per product and per
sum) on real float32 planes. Any other device raises.

What bounds it on an H100 is bytes: it reads its input once and writes an
r-fold smaller output, at ~9 float operations per input byte where the
card balances at ~20. The kernel stages each block's input span in shared
memory, so every input byte leaves device memory once, and reads tail and
block through two pointers, so ``[tail | x]`` is never materialised (at
the /256 front end that concatenation alone would be a full extra pass
over the 128 MiB block). The JAX package runs its kernel only under
``SDRPP_TPU_DECIM_PALLAS=1``, for single rows whose length tiles its
[4096, r] grid; the port runs it on every r >= 8 stage (the Pallas
kernel's domain), any row count and any multiple of r, with no switch.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_lib

__all__ = ["decimating_fir", "decimating_fir_plain"]


_C64, _F32 = torch.complex64, torch.float32


def _check(tail, x, taps, r):
    """Validates the arguments; returns (m, r). On CUDA tensors the
    compiled host path (csrc/kernels_host.cpp) makes the same checks."""
    dtype = x.dtype
    if dtype != _C64 and dtype != _F32:
        raise ValueError("x must be complex64 or float32")
    if taps.dtype != _F32 or taps.dim() != 1 or taps.shape[0] < 1:
        raise ValueError("taps must be a float32 vector")
    m = taps.shape[0]
    ts, xs = tail.shape, x.shape
    nd = len(xs)
    if (tail.dtype != dtype or len(ts) != nd or ts[-1] != m - 1
            or (nd == 2 and ts[0] != xs[0])
            or (nd > 2 and ts[:-1] != xs[:-1])):
        raise ValueError(f"tail must be {dtype} {[*xs[:-1], m - 1]}, "
                         f"got {tail.dtype} {list(ts)}")
    device = x.device
    if tail.device != device or taps.device != device:
        raise ValueError("decimating_fir takes tensors on one device")
    r = int(r)
    if r < 1 or xs[-1] % r:
        raise ValueError(f"block length {xs[-1]} must be a multiple of "
                         f"decimation {r}")
    return m, r


def decimating_fir_plain(tail, x, taps, r):
    """Plain PyTorch version of ``decimating_fir``."""
    m, r = _check(tail, x, taps, r)
    n = x.shape[-1]
    n_out = n // r
    buf = torch.cat([tail, x], dim=-1)
    # [..., planes, n + m - 1] real planes: real arithmetic only, so each
    # product and sum rounds once, as in the kernel
    planes = (torch.view_as_real(buf).movedim(-1, -2) if buf.is_complex()
              else buf[..., None, :])
    acc = torch.zeros((*planes.shape[:-1], n_out), dtype=torch.float32,
                      device=x.device)
    for j in range(m):
        acc = acc + taps[j] * planes[..., j::r][..., :n_out]
    if buf.is_complex():
        y = torch.view_as_complex(acc.movedim(-2, -1).contiguous())
    else:
        y = acc[..., 0, :]
    return buf[..., n:].clone(), y


_host = None


def _bind_host():
    """kernels_host.decim_fir (csrc/kernels_host.cpp), bound to the kernel
    library's two C entries; both built and loaded on first use."""
    global _host
    lib = cuda_lib.load("decim_fir")
    mod = cuda_lib.load_host("kernels_host")
    mod.bind_decim_fir(*(ctypes.cast(getattr(lib, e), ctypes.c_void_p).value
                         for e in ("decim_fir_c64", "decim_fir_f32")))
    _host = mod.decim_fir
    return _host


def _launch(tail, x, taps, r):
    """The compiled host path: the checks of ``_check`` (ValueError), the
    outputs allocated in x's leading shape, non-contiguous inputs copied,
    and the kernel launched on x's current stream."""
    return (_host or _bind_host())(tail, x, taps, r)


def decimating_fir(tail, x, taps, r):
    """Filter and decimate one block of ``[..., n]`` complex64 or float32
    rows (leading axes flattened into rows; n any multiple of ``r``).

    ``tail`` [..., m-1] is the carried input, ``taps`` the [m] float32
    taps on x's device. Returns ``(new_tail, y)``: the last m-1 samples of
    ``[tail | x]`` and ``y`` [..., n/r]."""
    if x.is_cuda:
        result = _launch(tail, x, taps, r)
        decimating_fir.launches += 1
        return result
    if x.is_cpu:
        return decimating_fir_plain(tail, x, taps, r)
    _check(tail, x, taps, r)
    raise RuntimeError(f"decimating_fir runs on CUDA or CPU tensors, not "
                       f"{x.device}")


decimating_fir.launches = 0
