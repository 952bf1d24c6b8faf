"""The ATV and DAB OFDM decoders' sequential walks: one launch a block.

Three walks that the JAX package runs as XLA-lowered ``lax.scan``s (not
Pallas kernels), each a CUDA kernel of ``csrc/sync_walk.cu`` here:

- ``line_sync_walk``: ``LineSync``'s scan over lines
  (sdrpp_tpu/decoders/atv.py:97-127): per line, the 720-point fractional
  interpolation at a uniform step through the 128 x 8 bank, the sync
  error from the two 44-sample halves of the sync region, the
  phase-control update of pos / freq / locked;
- ``chroma_burst_walk``: ``ChromaPLL``'s burst carry
  (sdrpp_tpu/decoders/atv.py:178-203): per line, the free-run phase to the
  burst, 28 locked steps over the colour burst, the free-run phase past
  it; the free-run segments themselves are mixed by the caller from the
  phases recorded here;
- ``cyclic_sync_walk``: ``CyclicSync``'s framing state machine
  (sdrpp_tpu/ops/ofdm.py:109-126) over every sample: peak tracking against
  the AGC'd average, the symbol count since the last peak, the emits.

On a CUDA tensor a wrapper launches its kernel (built on first use; a
failed build raises) and adds one to its ``launches`` count; on a CPU
tensor it runs its ``*_plain`` version, the same arithmetic in the same
order (numpy float32 scalars for the carries, as
``clock_recovery_kernels.mm_symbols_plain``, torch float32 vectors within a
line). Any other device raises. ``line_sync_walk`` and ``cyclic_sync_walk``
equal their plain versions bit for bit; ``chroma_burst_walk`` calls the
card's cosf / sinf / atan2f and is held to its plain version at a
tolerance. Every argument is checked before a launch (ValueError).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import cuda_lib

__all__ = ["line_sync_walk", "line_sync_walk_plain", "chroma_burst_walk",
           "chroma_burst_walk_plain", "cyclic_sync_walk",
           "cyclic_sync_walk_plain", "LINE_LEN", "SYNC_TREE"]

LINE_LEN = 720
LINE_PHASES, LINE_TAPS = 128, 8   # the interpolation bank the kernel takes
SYNC_TREE = 64                    # the sync sums' tree width (44 zero-padded)
FL_PI = np.float32(3.1415926535)
_TWO_PI = np.float32(2) * FL_PI


def _device_of(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} takes tensors on one device")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name} runs on CUDA or CPU tensors, not {dev}")
    return dev


def _contig(*ts):
    return tuple(t if t.is_contiguous() else t.contiguous() for t in ts)


def _rc(name, rc, what):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} at {what}")


# ------------------------------------------------------------- LineSync

def tree_sum44(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis (44 values) in the kernel's order: zero
    padded to 64, then halves added pairwise (s[i] = v[i] + v[i + 32], then
    16, 8, 4, 2, 1)."""
    s = torch.nn.functional.pad(v, (0, SYNC_TREE - v.shape[-1]))
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s[..., 0]


def _check_line(buf, bank, carry, locked, max_lines):
    if buf.dtype != torch.float32 or buf.ndim != 1:
        raise ValueError("buf must be float32 [n + 7]")
    if bank.dtype != torch.float32 or tuple(bank.shape) != (LINE_PHASES,
                                                           LINE_TAPS):
        raise ValueError(f"bank must be float32 [{LINE_PHASES}, {LINE_TAPS}]")
    if carry.dtype != torch.float32 or tuple(carry.shape) != (2,):
        raise ValueError("carry must be float32 [2] (pos, freq)")
    if locked.dtype != torch.bool or locked.numel() != 1:
        raise ValueError("locked must be one bool")
    n = buf.shape[0] - (LINE_TAPS - 1)
    if n < 1 or int(max_lines) < 1:
        raise ValueError("empty block or no lines")
    return n


def line_sync_walk_plain(buf, bank, carry, locked, max_lines, omega_gain,
                         mu_gain, min_freq, max_freq, sync_level, sync_bias):
    """Plain version of ``line_sync_walk``: a loop over lines, each line's
    720 samples as float32 torch vectors, the carries as numpy float32
    scalars, every sum in the kernel's order."""
    n = _check_line(buf, bank, carry, locked, max_lines)
    dev = buf.device
    f32 = np.float32
    b = buf.detach().cpu()
    bk = bank.detach().cpu()
    ks = torch.arange(LINE_LEN, dtype=torch.float32)
    taps_off = torch.arange(LINE_TAPS)
    pos, freq = (f32(v) for v in carry.detach().cpu().numpy())
    lock = bool(locked.reshape(()).item())
    og, mg, lo, hi, level, bias = (f32(v) for v in (
        omega_gain, mu_gain, min_freq, max_freq, sync_level, sync_bias))
    fn, c720, c719, c44 = f32(n), f32(720), f32(719), f32(44)
    lines = torch.zeros(int(max_lines), LINE_LEN, dtype=torch.float32)
    count = 0
    while count < max_lines and pos + c720 * freq < fn:
        p = torch.from_numpy(np.array(pos)) + ks * torch.from_numpy(
            np.array(freq))
        fp = torch.floor(p)
        mu = p - fp
        ph = (mu * 128.0).to(torch.int64).clamp(0, LINE_PHASES - 1)
        base = fp.to(torch.int64).clamp(0, n - 1)
        w = b[base[:, None] + taps_off]           # [720, 8]
        taps = bk[ph]                             # [720, 8]
        acc = w[:, 0] * taps[:, 0]
        for j in range(1, LINE_TAPS):
            acc = acc + w[:, j] * taps[:, j]
        lines[count] = acc
        left = f32(tree_sum44(torch.cat([acc[703:], acc[:27]])).item()) / c44
        right = f32(tree_sum44(acc[27:71]).item()) / c44
        ok = bool(left < level and right < level)
        err = (left + bias) - right if ok else f32(0)
        nf = min(max(freq + og * err, lo), hi)
        pos = ((pos + c719 * freq) + nf) + mg * err
        freq, lock = f32(nf), ok
        count += 1
    return (lines.to(dev), torch.tensor(count, dtype=torch.int32, device=dev),
            torch.tensor([pos, freq], dtype=torch.float32, device=dev),
            torch.tensor(lock, device=dev))


# each C entry's argument types, the stream last (cuda_lib.launch appends it)
_LINE_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
              + [ctypes.c_int] + [ctypes.c_float] * 6 + [ctypes.c_void_p])


def line_sync_walk(buf, bank, carry, locked, max_lines, omega_gain, mu_gain,
                   min_freq, max_freq, sync_level, sync_bias):
    """One block of LineSync. ``buf`` float32 [n + 7] ([tail | x]),
    ``bank`` [128, 8], ``carry`` float32 [2] (pos, freq), ``locked`` bool.
    Returns (lines [max_lines, 720] float32, the active lines first and
    zeros after, count int32 (0-d), carry [2] after the block, locked)."""
    dev = _device_of("line_sync_walk", buf, bank, carry, locked)
    n = _check_line(buf, bank, carry, locked, max_lines)
    params = tuple(float(np.float32(v)) for v in (
        omega_gain, mu_gain, min_freq, max_freq, sync_level, sync_bias))
    if dev.type == "cpu":
        return line_sync_walk_plain(buf, bank, carry, locked, max_lines,
                                    *params)
    buf, bank, carry, locked = _contig(buf, bank, carry, locked)
    max_lines = int(max_lines)
    lines = buf.new_empty((max_lines, LINE_LEN))
    count = torch.empty((), dtype=torch.int32, device=dev)
    carry_out = carry.new_empty(2)
    locked_out = torch.empty((), dtype=torch.bool, device=dev)
    fn = cuda_lib.bind("sync_walk", "line_sync_walk", _LINE_ARGS)
    rc = cuda_lib.launch(fn, dev, buf.data_ptr(), n, bank.data_ptr(),
                         carry.data_ptr(), locked.data_ptr(),
                         carry_out.data_ptr(), locked_out.data_ptr(),
                         lines.data_ptr(), count.data_ptr(), max_lines,
                         *params)
    _rc("line_sync_walk", rc, f"n={n}, max_lines={max_lines}")
    line_sync_walk.launches += 1
    return lines, count, carry_out, locked_out


line_sync_walk.launches = 0


# ------------------------------------------------------------ ChromaPLL

def _normalize_phase(d):
    if d > FL_PI:
        d = d - _TWO_PI
    if d <= -FL_PI:
        d = d + _TWO_PI
    return d


def _py_mod(x, y):
    r = np.fmod(x, y)
    if r != 0 and ((y < 0) != (r < 0)):
        r = r + y
    return r


def _check_burst(burst, ref_phases, carry, pre_len, post_len):
    if burst.dtype != torch.complex64 or burst.ndim != 2:
        raise ValueError("burst must be complex64 [L, nb]")
    if ref_phases.dtype != torch.float32 or tuple(ref_phases.shape) != (
            burst.shape[0],):
        raise ValueError("ref_phases must be float32 [L]")
    if carry.dtype != torch.float32 or tuple(carry.shape) != (2,):
        raise ValueError("carry must be float32 [2] (phase, freq)")
    if int(pre_len) < 0 or int(post_len) < 0:
        raise ValueError("segment lengths must be >= 0")


def chroma_burst_walk_plain(burst, ref_phases, carry, pre_len, post_len,
                            alpha, beta, min_freq, max_freq):
    """Plain version of ``chroma_burst_walk``: numpy float32 scalars,
    line by line and burst sample by burst sample."""
    _check_burst(burst, ref_phases, carry, pre_len, post_len)
    dev = burst.device
    f32 = np.float32
    v = burst.detach().cpu().numpy()
    refs = ref_phases.detach().cpu().numpy()
    L, nb = v.shape
    a, bt, lo, hi = (f32(x) for x in (alpha, beta, min_freq, max_freq))
    pre_k, post_k = f32(int(pre_len) - 1), f32(int(post_len) - 1)
    phase, freq = (f32(x) for x in carry.detach().cpu().numpy())
    line_phase = np.zeros((L, 4), np.float32)
    out = np.zeros((L, nb), np.complex64)
    for l in range(L):
        line_phase[l, 0], line_phase[l, 1] = phase, freq
        ph = (phase + pre_k * freq) + freq if pre_len > 0 else phase
        fr = freq
        ref = refs[l]
        for j in range(nb):
            xr, xi = f32(v[l, j].real), f32(v[l, j].imag)
            c, s = np.cos(-ph), np.sin(-ph)
            ore = xr * c - xi * s
            oim = xr * s + xi * c
            out[l, j] = complex(ore, oim)
            err = _normalize_phase(np.arctan2(oim, ore) - ref)
            fr = min(max(fr + bt * err, lo), hi)
            ph = (ph + fr) + a * err
            ph = _normalize_phase(_py_mod(ph + FL_PI, _TWO_PI) - FL_PI)
        line_phase[l, 2], line_phase[l, 3] = ph, fr
        p3 = (ph + post_k * fr) + fr if post_len > 0 else ph
        phase = _normalize_phase(_py_mod(p3 + FL_PI, _TWO_PI) - FL_PI)
        freq = fr
    return (torch.from_numpy(line_phase).to(dev),
            torch.from_numpy(out).to(dev),
            torch.tensor([phase, freq], dtype=torch.float32, device=dev))


_BURST_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
               + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
               + [ctypes.c_float] * 4 + [ctypes.c_void_p])


def chroma_burst_walk(burst, ref_phases, carry, pre_len, post_len, alpha,
                      beta, min_freq, max_freq):
    """ChromaPLL's carry over L lines. ``burst`` complex64 [L, nb]: each
    line's samples [pre_len, pre_len + nb); ``ref_phases`` float32 [L];
    ``carry`` float32 [2] (phase, freq). Returns (line_phase [L, 4]:
    phase and freq before each line's pre-burst segment, then after its
    burst; the burst's mixed samples [L, nb]; the carry after the last
    line)."""
    dev = _device_of("chroma_burst_walk", burst, ref_phases, carry)
    _check_burst(burst, ref_phases, carry, pre_len, post_len)
    params = tuple(float(np.float32(v))
                   for v in (alpha, beta, min_freq, max_freq))
    if dev.type == "cpu":
        return chroma_burst_walk_plain(burst, ref_phases, carry, pre_len,
                                       post_len, *params)
    burst, ref_phases, carry = _contig(burst, ref_phases, carry)
    L, nb = burst.shape
    line_phase = carry.new_empty((L, 4))
    out = burst.new_empty((L, nb))
    carry_out = carry.new_empty(2)
    fn = cuda_lib.bind("sync_walk", "chroma_burst_walk", _BURST_ARGS)
    rc = cuda_lib.launch(fn, dev, burst.data_ptr(), L, nb,
                         ref_phases.data_ptr(), carry.data_ptr(),
                         carry_out.data_ptr(), line_phase.data_ptr(),
                         out.data_ptr(), int(pre_len), int(post_len), *params)
    _rc("chroma_burst_walk", rc, f"L={L}, nb={nb}")
    chroma_burst_walk.launches += 1
    return line_phase, out, carry_out


chroma_burst_walk.launches = 0


# ------------------------------------------------------------ CyclicSync

def _check_cyclic(rcorr, vals, carry, since, symbuf, max_syms):
    if rcorr.dtype != torch.float32 or rcorr.ndim != 1:
        raise ValueError("rcorr must be float32 [n]")
    if vals.dtype != torch.complex64 or tuple(vals.shape) != tuple(
            rcorr.shape):
        raise ValueError("vals must be complex64 [n], like rcorr")
    if carry.dtype != torch.float32 or tuple(carry.shape) != (3,):
        raise ValueError("carry must be float32 [3] (avg, peak, last)")
    if since.dtype != torch.int32 or since.numel() != 1:
        raise ValueError("since must be one int32")
    if symbuf.dtype != torch.complex64 or symbuf.ndim != 1:
        raise ValueError("symbuf must be complex64 [symbol_samps]")
    if rcorr.shape[0] < 1 or symbuf.shape[0] < 1 or int(max_syms) < 1:
        raise ValueError("empty block, symbol or output")


def cyclic_sync_walk_plain(rcorr, vals, carry, since, symbuf, max_syms, agc):
    """Plain version of ``cyclic_sync_walk``: numpy float32 scalars over
    every sample."""
    _check_cyclic(rcorr, vals, carry, since, symbuf, max_syms)
    dev = rcorr.device
    f32 = np.float32
    r = rcorr.detach().cpu().numpy()
    v = vals.detach().cpu().numpy()
    buf = symbuf.detach().cpu().numpy().copy()
    sym = buf.shape[0]
    agc = f32(agc)
    agc_inv = f32(1) - agc
    avg, peak, last = (f32(x) for x in carry.detach().cpu().numpy())
    s = int(since.reshape(()).item())
    zero = f32(0)
    emits = []
    for i in range(r.shape[0]):
        rc = r[i]
        if rc > avg and rc > peak:
            peak, s = rc, 0
        buf[min(max(s, 0), sym - 1)] = v[i]
        s += 1
        if s >= sym:
            emits.append(i)
            s, peak = 0, zero
        avg = agc * rc + agc_inv * avg
        last = rc
    max_syms = int(max_syms)
    pos = np.full(max_syms, -1, np.int32)
    c = min(len(emits), max_syms)
    pos[:c] = emits[:c]
    return (torch.from_numpy(pos).to(dev),
            torch.tensor(c, dtype=torch.int32, device=dev),
            torch.tensor([avg, peak, last], dtype=torch.float32, device=dev),
            torch.tensor(s, dtype=torch.int32, device=dev),
            torch.from_numpy(buf).to(dev))


_CYCLIC_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                + [ctypes.c_int] + [ctypes.c_float] * 2
                + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2)


def cyclic_sync_walk(rcorr, vals, carry, since, symbuf, max_syms, agc):
    """CyclicSync's framing over one block. ``rcorr`` float32 [n],
    ``vals`` complex64 [n] (the delayed samples the symbols are cut from),
    ``carry`` float32 [3] (avg, peak, last), ``since`` int32, ``symbuf``
    complex64 [symbol_samps]. Returns (emit sample indices [max_syms]
    int32, -1 past the count; count int32 (0-d); carry [3]; since;
    symbuf after the block)."""
    dev = _device_of("cyclic_sync_walk", rcorr, vals, carry, since, symbuf)
    _check_cyclic(rcorr, vals, carry, since, symbuf, max_syms)
    agc = float(np.float32(agc))
    if dev.type == "cpu":
        return cyclic_sync_walk_plain(rcorr, vals, carry, since, symbuf,
                                      max_syms, agc)
    rcorr, vals, carry, since, symbuf = _contig(rcorr, vals, carry, since,
                                                symbuf)
    max_syms = int(max_syms)
    n, sym = rcorr.shape[0], symbuf.shape[0]
    emits = torch.empty(max_syms, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    carry_out = carry.new_empty(3)
    since_out = torch.empty((), dtype=torch.int32, device=dev)
    symbuf_out = symbuf.new_empty(sym)
    agc_inv = float(np.float32(1) - np.float32(agc))
    fn = cuda_lib.bind("sync_walk", "cyclic_sync_walk", _CYCLIC_ARGS)
    rc = cuda_lib.launch(fn, dev, rcorr.data_ptr(), vals.data_ptr(), n,
                         carry.data_ptr(), since.data_ptr(),
                         symbuf.data_ptr(), sym, agc, agc_inv,
                         carry_out.data_ptr(), since_out.data_ptr(),
                         symbuf_out.data_ptr(), emits.data_ptr(), max_syms,
                         count.data_ptr())
    _rc("cyclic_sync_walk", rc, f"n={n}, sym={sym}")
    cyclic_sync_walk.launches += 1
    return emits, count, carry_out, since_out, symbuf_out


cyclic_sync_walk.launches = 0
