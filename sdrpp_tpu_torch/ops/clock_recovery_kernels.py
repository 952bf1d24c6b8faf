"""The M&M and FD clock-recovery walks: one dependent chain per stream.

The counterpart of ``sdrpp_tpu.ops.clock_recovery_pallas`` and of
``FDClockRecovery``'s scan. ``mm_symbols`` runs a whole block's M&M
recurrence for C independent streams in one launch (replaces the Pallas
kernel ``_mm_chunk_call``, clock_recovery_pallas.py:35); ``fd_symbols``
runs the FD (early-late) synchronizer's (replaces the ``lax.scan`` of
``FDClockRecovery``, clock_recovery.py:162). On a CUDA tensor each
launches its entry of ``csrc/mm_clock.cu`` through the compiled host path
(``csrc/kernels_host.cpp``, which checks the arguments, allocates and
launches in one C++ call; both built on first use, a failed build raises)
and adds one to its ``launches`` count; on a CPU tensor it runs its plain
version (``mm_symbols_plain`` / ``fd_symbols_plain``), a Python loop over
each stream's symbols in numpy float32 scalars, operation for operation
the kernel's. Any other device raises. The kernels take the 128 x 8 bank
every caller builds (a CUDA call with another bank shape raises) and
write each stream's symbol count, from which the wrapper builds the valid
prefix mask with one comparison on the device.

``MMClockRecovery`` (ops/clock_recovery.py) is the exact block that calls
``mm_symbols``; ``MMClockRecoveryChunked`` (ops/clock_recovery_chunked.py)
takes it on short blocks and under SDRPP_TPU_LOOPS=exact.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import cuda_lib

__all__ = ["mm_symbols", "mm_symbols_plain", "fd_symbols", "fd_symbols_plain",
           "host_module"]


def _check(buf, offset, fstate, bank):
    if buf.ndim != 2:
        raise ValueError("buf must be [C, n + taps - 1]")
    C = buf.shape[0]
    kf = 10 if buf.is_complex() else 3
    if buf.dtype not in (torch.complex64, torch.float32):
        raise ValueError("buf must be complex64 or float32")
    if offset.dtype != torch.int32 or tuple(offset.shape) != (C,):
        raise ValueError("offset must be int32 [C]")
    if fstate.dtype != torch.float32 or tuple(fstate.shape) != (C, kf):
        raise ValueError(f"fstate must be float32 [C, {kf}]")
    if bank.dtype != torch.float32 or bank.ndim != 2:
        raise ValueError("bank must be float32 [phases, taps]")
    for t in (offset, fstate, bank):
        if t.device != buf.device:
            raise ValueError("mm_symbols takes tensors on one device")
    n = buf.shape[1] - (bank.shape[1] - 1)
    if n < 1:
        raise ValueError("empty block")
    return n


def mm_symbols_plain(buf, offset, fstate, bank, max_syms, mu, omega_gain,
                     min_freq, max_freq):
    """Plain version of ``mm_symbols``: each stream's symbols in a Python
    loop over numpy float32 scalars, one rounding a product or sum as in
    the kernel (--fmad=false), the taps summed in order; tensors in and
    out on ``buf``'s device. (A torch op on a one-element tensor costs
    about five times a numpy scalar op, and the decode paths run this
    loop over hundreds of thousands of symbols on the CPU.)"""
    n = _check(buf, offset, fstate, bank)
    C = buf.shape[0]
    P, T = bank.shape
    cplx = buf.is_complex()
    dev = buf.device
    f32 = np.float32
    b = buf.detach().cpu().numpy()
    # [C, planes, n + T - 1] real planes: real arithmetic only
    planes = np.ascontiguousarray(
        np.stack([b.real, b.imag], 1) if cplx else b[:, None], np.float32)
    npl = planes.shape[1]
    bk = bank.detach().cpu().numpy().astype(np.float32)
    mu, og, lo, hi = (f32(v) for v in (mu, omega_gain, min_freq, max_freq))
    one, zero, fP = f32(1.0), f32(0.0), f32(P)
    offs = offset.cpu().numpy().astype(np.int64)
    st = fstate.detach().cpu().numpy().astype(np.float32)
    outs = np.zeros((C, npl, max_syms), np.float32)
    count = np.zeros(C, np.int64)
    new_off = np.zeros(C, np.int32)

    def sign(v):
        return one if v > 0 else -one

    for c in range(C):
        off = int(offs[c])
        s = list(st[c])
        k = 0
        while k < max_syms and off < n:
            phase, freq = s[0], s[1]
            ph = min(max(int(np.floor(phase * fP)), 0), P - 1)
            base = min(max(off, 0), n - 1)
            prod = planes[c, :, base:base + T] * bk[ph]  # [planes, T]
            acc = []
            for row in prod:
                a = zero + row[0]
                for j in range(1, T):
                    a = a + row[j]
                acc.append(a)
            if cplx:
                accr, acci = acc
                c0r, c0i = sign(accr), sign(acci)
                err = ((accr - s[4]) * s[6] + (acci - s[5]) * s[7]) \
                    - ((c0r - s[8]) * s[2] + (c0i - s[9]) * s[3])
                s_err = [accr, acci, s[2], s[3], c0r, c0i, s[6], s[7]]
            else:
                last = s[2]
                err = sign(last) * acc[0] - last * sign(acc[0])
                s_err = acc
            err = min(max(err, -one), one)
            new_freq = min(max(freq + og * err, lo), hi)
            new_phase = phase + new_freq + mu * err
            delta = np.floor(new_phase)
            off += int(delta)
            s = [new_phase - delta, new_freq] + s_err
            outs[c, :, k] = acc
            k += 1
        count[c] = k
        new_off[c] = off - n
        st[c] = s
    o = torch.from_numpy(outs).to(dev)
    syms = torch.complex(o[:, 0], o[:, 1]) if cplx else o[:, 0]
    valid = (torch.arange(max_syms, device=dev)[None]
             < torch.from_numpy(count).to(dev)[:, None])
    return (syms, valid, torch.from_numpy(new_off).to(dev),
            torch.from_numpy(st).to(dev))


KERNEL_PHASES, KERNEL_TAPS = 128, 8   # the bank shape the kernels take
_positions: dict[tuple[int, torch.device], torch.Tensor] = {}


def _prefix_mask(count, max_syms):
    """[C, max_syms] bool: position < count, one comparison on the device
    against a cached arange."""
    key = (max_syms, count.device)
    pos = _positions.get(key)
    if pos is None:
        pos = _positions[key] = torch.arange(max_syms, dtype=torch.int32,
                                             device=count.device)
    return pos < count[:, None]


_host = None


def host_module():
    """csrc/kernels_host.cpp's module with mm_clock.cu's C entries bound
    (mm_symbols, mm_chunked, mm_chunked_block, fd_symbols); both built and
    loaded on first use."""
    global _host
    if _host is None:
        lib = cuda_lib.load("mm_clock")
        mod = cuda_lib.load_host("kernels_host")

        def entries(names):
            return (ctypes.cast(getattr(lib, e), ctypes.c_void_p).value
                    for e in names)

        mod.bind_mm_clock(*entries(MM_CLOCK_ENTRIES))
        mod.bind_mm_chunked_block(*entries(MM_CHUNKED_BLOCK_ENTRIES))
        _host = mod
    return _host


# the C entries of csrc/mm_clock.cu, in bind_mm_clock's order
MM_CLOCK_ENTRIES = ("mm_symbols_complex", "mm_symbols_real",
                    "mm_chunked_complex", "mm_chunked_real", "fd_symbols")
# the chunked M&M's block entries, in bind_mm_chunked_block's order
MM_CHUNKED_BLOCK_ENTRIES = ("mm_chunked_block_complex",
                            "mm_chunked_block_real")


def mm_symbols(buf, offset, fstate, bank, max_syms, mu, omega_gain, min_freq,
               max_freq, cycles=None):
    """Run the M&M loop over C streams of one block.

    ``buf`` [C, n + T - 1] complex64 or float32: each stream's carried
    tail followed by the block. ``offset`` [C] int32 and ``fstate``
    [C, 10 | 3] float32: the carried state (phase, freq, then the error
    history as re/im pairs p1 p2 c1 c2, or ``last``). ``bank`` [P, T]
    float32 ([128, 8] on CUDA). Returns (symbols [C, max_syms], valid
    [C, max_syms] bool, a prefix, next offset [C], next fstate); symbols
    past the prefix are 0. On CUDA, ``cycles`` (an int64 [C] tensor, or
    None) receives each stream's clock64() cycles over its walk."""
    max_syms = int(max_syms)
    params = tuple(float(np.float32(v))
                   for v in (mu, omega_gain, min_freq, max_freq))
    if buf.device.type == "cpu":
        return mm_symbols_plain(buf, offset, fstate, bank, max_syms, *params)
    if buf.device.type != "cuda":
        raise RuntimeError(f"mm_symbols runs on CUDA or CPU tensors, not "
                           f"{buf.device}")
    syms, count, off, fst = host_module().mm_symbols(
        buf, offset, fstate, bank, max_syms, params, cycles)
    mm_symbols.launches += 1
    return syms, _prefix_mask(count, max_syms), off, fst


mm_symbols.launches = 0


def _check_fd(buf, offset, fstate, bank):
    if buf.dtype != torch.float32 or buf.ndim != 2:
        raise ValueError("buf must be float32 [C, n + taps - 1]")
    C = buf.shape[0]
    if offset.dtype != torch.int32 or tuple(offset.shape) != (C,):
        raise ValueError("offset must be int32 [C]")
    if fstate.dtype != torch.float32 or tuple(fstate.shape) != (C, 2):
        raise ValueError("fstate must be float32 [C, 2]")
    if bank.dtype != torch.float32 or bank.ndim != 2:
        raise ValueError("bank must be float32 [phases, taps]")
    for t in (offset, fstate, bank):
        if t.device != buf.device:
            raise ValueError("fd_symbols takes tensors on one device")
    n = buf.shape[1] - (bank.shape[1] - 1)
    if n < 1:
        raise ValueError("empty block")
    return n


def fd_symbols_plain(buf, offset, fstate, bank, max_syms, omega_gain, mu,
                     min_freq, max_freq):
    """Plain version of ``fd_symbols``: each stream's symbols in a Python
    loop over numpy float32 scalars, one rounding a product or sum as in
    the kernel, each of the three tap sums in order."""
    n = _check_fd(buf, offset, fstate, bank)
    C = buf.shape[0]
    P, T = bank.shape
    f32 = np.float32
    b = buf.detach().cpu().numpy().astype(np.float32)
    bk = bank.detach().cpu().numpy().astype(np.float32)
    og, mu, lo, hi = (f32(v) for v in (omega_gain, mu, min_freq, max_freq))
    one, zero, half, fP = f32(1.0), f32(0.0), f32(0.5), f32(P)
    offs = offset.cpu().numpy().astype(np.int64)
    st = fstate.detach().cpu().numpy().astype(np.float32)
    outs = np.zeros((C, max_syms), np.float32)
    count = np.zeros(C, np.int64)
    new_off = np.zeros(C, np.int32)

    def dot(win, row):
        a = zero + win[0] * row[0]
        for j in range(1, T):
            a = a + win[j] * row[j]
        return a

    for c in range(C):
        off = int(offs[c])
        phase, freq = st[c]
        k = 0
        while k < max_syms and off < n:
            ph = min(max(int(np.floor(phase * fP)), 0), P - 1)
            base = min(max(off, 0), n - 1)
            win = b[c, base:base + T]
            out = dot(win, bk[ph])
            lo_v = dot(win, bk[max(ph - 1, 0)])
            hi_v = dot(win, bk[min(ph + 1, P - 1)])
            if ph == 0:
                dfdt = hi_v - out
            elif ph == P - 1:
                dfdt = out - lo_v
            else:
                dfdt = (hi_v - lo_v) * half
            err = dfdt * (one if out > 0 else -one)
            err = min(max(err, -one), one)
            freq = min(max(freq + og * err, lo), hi)
            new_phase = (phase + freq) + mu * err
            delta = np.floor(new_phase)
            off += int(delta)
            phase = new_phase - delta
            outs[c, k] = out
            k += 1
        count[c] = k
        new_off[c] = off - n
        st[c] = (phase, freq)
    dev = buf.device
    valid = (torch.arange(max_syms, device=dev)[None]
             < torch.from_numpy(count).to(dev)[:, None])
    return (torch.from_numpy(outs).to(dev), valid,
            torch.from_numpy(new_off).to(dev), torch.from_numpy(st).to(dev))


def fd_symbols(buf, offset, fstate, bank, max_syms, omega_gain, mu, min_freq,
               max_freq):
    """Run the FD (early-late) symbol synchronizer over C float streams of
    one block.

    ``buf`` [C, n + T - 1] float32: each stream's carried tail and the
    block. ``offset`` [C] int32, ``fstate`` [C, 2] float32 (phase, freq):
    the carried state. ``bank`` [P, T] float32 ([128, 8] on CUDA). Returns
    (symbols [C, max_syms], valid [C, max_syms] bool, a prefix, next offset
    [C], next fstate)."""
    max_syms = int(max_syms)
    params = tuple(float(np.float32(v))
                   for v in (omega_gain, mu, min_freq, max_freq))
    if buf.device.type == "cpu":
        return fd_symbols_plain(buf, offset, fstate, bank, max_syms, *params)
    if buf.device.type != "cuda":
        raise RuntimeError(f"fd_symbols runs on CUDA or CPU tensors, not "
                           f"{buf.device}")
    syms, count, off, fst = host_module().fd_symbols(
        buf, offset, fstate, bank, max_syms, params)
    fd_symbols.launches += 1
    return syms, _prefix_mask(count, max_syms), off, fst


fd_symbols.launches = 0
