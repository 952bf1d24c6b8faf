"""The batched Viterbi kernels: add-compare-select and traceback.

The counterpart of ``sdrpp_tpu.ops.fec_pallas``. Two entry points:

- ``viterbi_acs_batched``       [B, T, R] soft bits -> [B, T, 64] int8
                                decisions (replaces
                                ``viterbi_acs_pallas_batched``,
                                fec_pallas.py:51, and with B = 1
                                ``viterbi_acs_pallas``, fec_pallas.py:221);
- ``viterbi_traceback_batched`` [B, T, 64] decisions -> [B, T] uint8 bits,
                                walking back from state 0 (replaces
                                ``viterbi_traceback_pallas_batched``,
                                fec_pallas.py:132).

On a CUDA tensor each launches ``csrc/viterbi.cu`` (built on first use; a
failed build raises) and adds one to its ``launches`` count; on a CPU
tensor each runs its plain PyTorch version, a Python loop over trellis
steps on [B, S] tensors. Any other device raises. The kernels take the
64-state (K = 7) codes; the plain versions any power-of-two state count.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_lib

__all__ = ["viterbi_acs_batched", "viterbi_traceback_batched",
           "viterbi_acs_batched_plain", "viterbi_traceback_batched_plain"]

KERNEL_STATES = 64
KERNEL_MAX_RATE = 4


def _kernel_device(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{what} runs on CUDA or CPU tensors, not "
                           f"{t.device}")
    return True


def viterbi_acs_batched_plain(soft, expected):
    """Plain PyTorch version of ``viterbi_acs_batched``."""
    B, T, R = soft.shape
    S = expected.shape[0] // 2
    dev = soft.device
    n = torch.arange(S, device=dev)
    p0, p1 = n >> 1, (n >> 1) + S // 2
    m = torch.full((B, S), 1e9, dtype=torch.float32, device=dev)
    m[:, 0] = 0.0
    dec = torch.empty((B, T, S), dtype=torch.int8, device=dev)
    for t in range(T):
        bm = torch.abs(soft[:, t, None, :] - expected).sum(-1)  # [B, 2S]
        cand0 = m[:, p0] + bm[:, :S]
        cand1 = m[:, p1] + bm[:, S:]
        take1 = cand1 < cand0
        new = torch.where(take1, cand1, cand0)
        m = new - new.min(dim=1, keepdim=True).values
        dec[:, t] = take1.to(torch.int8)
    return dec


def viterbi_acs_batched(soft, expected):
    """Add-compare-select over B windows: ``soft`` [B, T, R] float32,
    ``expected`` [2S, R] float32 (each shift register's output bits times
    255) -> [B, T, S] int8 decisions (1 = took predecessor (n>>1)+S/2).
    Metrics start at 0 for state 0 and 1e9 elsewhere."""
    if soft.ndim != 3 or soft.dtype != torch.float32:
        raise ValueError("soft must be float32 [B, T, R]")
    if expected.dtype != torch.float32 or expected.device != soft.device \
            or expected.ndim != 2 or expected.shape[1] != soft.shape[2]:
        raise ValueError("expected must be float32 [2S, R] on soft's device")
    if not _kernel_device(soft, "viterbi_acs_batched"):
        return viterbi_acs_batched_plain(soft, expected)
    B, T, R = soft.shape
    if expected.shape[0] != 2 * KERNEL_STATES or R > KERNEL_MAX_RATE:
        raise ValueError(f"the kernel takes {KERNEL_STATES} states and at "
                         f"most {KERNEL_MAX_RATE} soft bits per step")
    soft, expected = soft.contiguous(), expected.contiguous()
    dec = torch.empty((B, T, KERNEL_STATES), dtype=torch.int8,
                      device=soft.device)
    fn = cuda_lib.bind("viterbi", "viterbi_acs_batched",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    rc = cuda_lib.launch(fn, soft.device, soft.data_ptr(), expected.data_ptr(),
                         dec.data_ptr(), B, T, R)
    if rc != 0:
        raise RuntimeError(f"viterbi_acs_batched launch failed: CUDA error "
                           f"{rc} at B={B}, T={T}, R={R}")
    viterbi_acs_batched.launches += 1
    return dec


viterbi_acs_batched.launches = 0


def viterbi_traceback_batched_plain(dec):
    """Plain PyTorch version of ``viterbi_traceback_batched``."""
    B, T, S = dec.shape
    s = torch.zeros((B, 1), dtype=torch.int64, device=dec.device)
    bits = torch.empty((B, T), dtype=torch.uint8, device=dec.device)
    for t in range(T - 1, -1, -1):
        bits[:, t] = (s[:, 0] & 1).to(torch.uint8)
        took = torch.gather(dec[:, t], 1, s) != 0
        s = (s >> 1) + took.long() * (S // 2)
    return bits


def viterbi_traceback_batched(dec):
    """Survivor walk of B windows from state 0 at the last step: ``dec``
    [B, T, S] int8 -> [B, T] uint8, the low bit of each step's state."""
    if dec.ndim != 3 or dec.dtype != torch.int8:
        raise ValueError("dec must be int8 [B, T, S]")
    if not _kernel_device(dec, "viterbi_traceback_batched"):
        return viterbi_traceback_batched_plain(dec)
    B, T, S = dec.shape
    if S != KERNEL_STATES:
        raise ValueError(f"the kernel takes {KERNEL_STATES} states")
    dec = dec.contiguous()
    bits = torch.empty((B, T), dtype=torch.uint8, device=dec.device)
    fn = cuda_lib.bind("viterbi", "viterbi_traceback_batched",
                       [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    rc = cuda_lib.launch(fn, dec.device, dec.data_ptr(), bits.data_ptr(), B, T)
    if rc != 0:
        raise RuntimeError(f"viterbi_traceback_batched launch failed: CUDA "
                           f"error {rc} at B={B}, T={T}")
    viterbi_traceback_batched.launches += 1
    return bits


viterbi_traceback_batched.launches = 0
