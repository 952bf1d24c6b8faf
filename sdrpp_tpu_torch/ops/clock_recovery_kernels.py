"""The M&M clock-recovery kernel and the chunked block's exact branch.

The counterpart of ``sdrpp_tpu.ops.clock_recovery_pallas`` and
``clock_recovery_chunked``. ``mm_symbols`` runs a whole block's M&M
recurrence for C independent streams in one launch (replaces the Pallas
kernel ``_mm_chunk_call``, clock_recovery_pallas.py:35). On a CUDA tensor
it launches ``csrc/mm_clock.cu`` (built on first use; a failed build
raises) and adds one to its ``launches`` count; on a CPU tensor it runs
``mm_symbols_plain``, a Python loop over each stream's symbols in numpy
float32 scalars, operation for operation the kernel's. Any other device
raises. The kernel takes the
128 x 8 bank every caller builds (a CUDA call with another bank shape
raises), reads the complex64 row as it is and writes each stream's symbol
count, from which the wrapper builds the valid prefix mask with one
comparison on the device.

``MMClockRecovery`` (ops/clock_recovery.py) is the block that calls it,
the counterpart of both ``MMClockRecovery`` and ``MMClockRecoveryPallas``:
the port has one path, the kernel's. ``MMClockRecoveryChunked`` carries
the JAX chunked block's state tree (a ``hist`` of raw samples) and always
takes its exact branch, which is what the JAX package does off the TPU and
under SDRPP_TPU_LOOPS=exact; the group-predictive chunked MM
(``mm_symbols_chunked``) was built around TPU gathers and is not ported.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import cuda_lib
from .clock_recovery import MMClockRecovery

__all__ = ["mm_symbols", "mm_symbols_plain", "MMClockRecoveryChunked"]


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


KERNEL_PHASES, KERNEL_TAPS = 128, 8   # the bank shape the kernel takes
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
             + [ctypes.c_int] + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 2)
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


def _launch(buf, offset, fstate, bank, n, max_syms, params, cycles):
    if tuple(bank.shape) != (KERNEL_PHASES, KERNEL_TAPS):
        raise ValueError(f"the mm_symbols kernel takes a [{KERNEL_PHASES}, "
                         f"{KERNEL_TAPS}] bank, not {list(bank.shape)}")
    C = buf.shape[0]
    dev = buf.device
    buf, offset, fstate, bank = (t if t.is_contiguous() else t.contiguous()
                                 for t in (buf, offset, fstate, bank))
    if cycles is not None and (cycles.dtype != torch.int64
                               or tuple(cycles.shape) != (C,)
                               or cycles.device != dev
                               or not cycles.is_contiguous()):
        raise ValueError("cycles must be a contiguous int64 [C] tensor on "
                         "buf's device")
    off = offset.new_empty(offset.shape)
    fst = fstate.new_empty(fstate.shape)
    syms = buf.new_empty((C, max_syms))
    count = offset.new_empty((C,))
    fn = cuda_lib.bind("mm_clock", "mm_symbols_complex" if buf.is_complex()
                       else "mm_symbols_real", _ARGTYPES)
    rc = cuda_lib.launch(fn, dev, buf.data_ptr(), n, C, bank.data_ptr(),
                         offset.data_ptr(), fstate.data_ptr(), off.data_ptr(),
                         fst.data_ptr(), syms.data_ptr(), count.data_ptr(),
                         max_syms, *params,
                         None if cycles is None else cycles.data_ptr())
    if rc != 0:
        raise RuntimeError(f"mm_symbols launch failed: CUDA error {rc} at "
                           f"n={n}, C={C}")
    return syms, _prefix_mask(count, max_syms), off, fst


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
    n = _check(buf, offset, fstate, bank)
    max_syms = int(max_syms)
    params = tuple(float(np.float32(v))
                   for v in (mu, omega_gain, min_freq, max_freq))
    if buf.device.type == "cpu":
        return mm_symbols_plain(buf, offset, fstate, bank, max_syms, *params)
    if buf.device.type != "cuda":
        raise RuntimeError(f"mm_symbols runs on CUDA or CPU tensors, not "
                           f"{buf.device}")
    result = _launch(buf, offset, fstate, bank, n, max_syms, params, cycles)
    mm_symbols.launches += 1
    return result


mm_symbols.launches = 0


class MMClockRecoveryChunked(MMClockRecovery):
    """The JAX chunked MM block's interface (clock_recovery_chunked.py:477):
    its state tree grows ``hist``, the last ``warmup + tap_count - 1`` raw
    samples. This port always runs the exact recurrence."""

    def __init__(self, *args, warmup: int = 512, **kwargs):
        super().__init__(*args, **kwargs)
        self.warmup = int(warmup)

    def _hist_len(self):
        return self.warmup + self.tap_count - 1

    def init_state(self):
        st = super().init_state()
        st["hist"] = torch.zeros(self._hist_len(), dtype=self.dtype,
                                 device=self.device)
        return st

    def __call__(self, state, x):
        sub = {k: v for k, v in state.items() if k != "hist"}
        sub, out = super().__call__(sub, x)
        hist = torch.cat([state["hist"], x.to(self.dtype)])[-self._hist_len():]
        return {**sub, "hist": hist}, out
