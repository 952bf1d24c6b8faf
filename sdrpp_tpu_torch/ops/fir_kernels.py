"""The strided decimating-FIR kernel: the power-of-2 decimator's r >= 8
stages.

The counterpart of ``sdrpp_tpu.ops.fir_pallas``: ``decimating_fir``
replaces the Pallas kernel ``_run`` (fir_pallas.py:74, called through
``decimating_fir_pallas``), which computes the reference's decimating FIR
(decimating_fir.h:49-69) with real float32 taps:

    y[o] = sum_{j<m} taps[j] * buf[r*o + j],   buf = [tail | x].

On a CUDA tensor it launches ``csrc/decim_fir.cu`` (built on first use; a
failed build raises) and adds one to its ``launches`` count; on a CPU
tensor it runs ``decimating_fir_plain``, the same sum in the same order
(j = 0..m-1 from 0.0, one rounding per product and per sum) on real
float32 planes. Any other device raises.

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


def _check(tail, x, taps, r):
    if x.dtype not in (torch.complex64, torch.float32):
        raise ValueError("x must be complex64 or float32")
    if taps.dtype != torch.float32 or taps.ndim != 1 or taps.shape[0] < 1:
        raise ValueError("taps must be a float32 vector")
    m = taps.shape[0]
    if tail.dtype != x.dtype or tuple(tail.shape) != (*x.shape[:-1], m - 1):
        raise ValueError(f"tail must be {x.dtype} {[*x.shape[:-1], m - 1]}, "
                         f"got {tail.dtype} {list(tail.shape)}")
    if tail.device != x.device or taps.device != x.device:
        raise ValueError("decimating_fir takes tensors on one device")
    r = int(r)
    if r < 1 or x.shape[-1] % r:
        raise ValueError(f"block length {x.shape[-1]} must be a multiple of "
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


def _launch(tail, x, taps, m, r):
    lib = cuda_lib.load("decim_fir")
    lead = x.shape[:-1]
    n = x.shape[-1]
    rows = 1
    for d in lead:
        rows *= int(d)
    xs = x.reshape(rows, n).contiguous()
    ts = tail.reshape(rows, m - 1).contiguous()
    taps = taps.contiguous()
    y = torch.empty((rows, n // r), dtype=x.dtype, device=x.device)
    new_tail = torch.empty((rows, m - 1), dtype=x.dtype, device=x.device)
    fn = lib.decim_fir_c64 if x.is_complex() else lib.decim_fir_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ts.data_ptr(), xs.data_ptr(), taps.data_ptr(),
                new_tail.data_ptr(), y.data_ptr(), rows, n, m, r, stream)
    if rc != 0:
        raise RuntimeError(f"decimating_fir launch failed: CUDA error {rc} "
                           f"at rows={rows}, n={n}, m={m}, r={r}")
    return new_tail.reshape(*lead, m - 1), y.reshape(*lead, n // r)


def decimating_fir(tail, x, taps, r):
    """Filter and decimate one block of ``[..., n]`` complex64 or float32
    rows (leading axes flattened into rows; n any multiple of ``r``).

    ``tail`` [..., m-1] is the carried input, ``taps`` the [m] float32
    taps on x's device. Returns ``(new_tail, y)``: the last m-1 samples of
    ``[tail | x]`` and ``y`` [..., n/r]."""
    m, r = _check(tail, x, taps, r)
    if x.device.type == "cpu":
        return decimating_fir_plain(tail, x, taps, r)
    if x.device.type != "cuda":
        raise RuntimeError(f"decimating_fir runs on CUDA or CPU tensors, not "
                           f"{x.device}")
    result = _launch(tail, x, taps, m, r)
    decimating_fir.launches += 1
    return result


decimating_fir.launches = 0
