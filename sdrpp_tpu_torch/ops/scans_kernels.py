"""The loop-scan kernels (PLL, AGC, FastAGC, Costas) and the chunk-parallel
loops.

The counterpart of ``sdrpp_tpu.ops.scans_pallas``. Two entry points run a
per-sample recurrence ("body") sequentially in time:

- ``lane_scan``   C lanes of time-major [n, *lanes] streams (one or two
                  lane axes; replaces the Pallas kernel
                  ``_lane_scan_call``, scans_pallas.py:147);
- ``single_scan`` one [n] stream (replaces ``_smem_scan_call``,
                  scans_pallas.py:68); the same CUDA kernel with C = 1.

Both read their streams where they lie (any strides, overlapping lanes
included); ``lane_scan`` writes into a caller-given output view when one
is passed, with an optional count of leading steps not stored there
(``skip``) and a side output for the last steps before them (``side``).
On a CUDA tensor each launches the hand-written kernel in
``csrc/loop_scan.cu`` through a compiled host path, ``loop_scan`` of
``csrc/kernels_host.cpp``, which checks the arguments, allocates and
launches in one C++ call (both built on first use; a failed build
raises), and adds one to its ``launches`` count. On a CPU tensor each
runs its plain PyTorch version (``lane_scan_plain`` /
``single_scan_plain``, same arguments): a Python loop over time on
[*lanes] vectors, operation for operation the kernel's body. Any other
device raises.

The chunk-parallel loops (``pll_phases_chunked``, ``agc_gains_chunked``,
``fast_agc_gains_chunked``, ``costas_phases_chunked``) cut a long block
into K overlapping lanes that each re-acquire over a W-sample warm-up
window and run them through ``lane_scan``; see the JAX module for the
approximation contract. The lanes are strided views of one extended
stream [hist | block] and each lane's payload lands in sample order in
the output, so the only copy around the kernel is that extension.
Whether a loop runs chunked or exact is decided by ``_chunk_lanes_for``
alone, on every device, so the CPU tests exercise the same glue the card
runs; ``SDRPP_TPU_LOOPS=exact`` (``LOOPS_MODE``) makes it 0 everywhere,
for these loops and the chunked M&M alike.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils import cuda_lib
from .scans import AGC, FL_PI, PLL, Costas, FastAGC

__all__ = ["LoopBody", "pll_body", "agc_body", "fast_agc_body", "costas_body",
           "lane_scan", "single_scan", "lane_scan_plain", "single_scan_plain",
           "pll_phases", "agc_gains", "fast_agc_gains", "costas_streams",
           "costas_phases", "rotate_back", "suffix_max", "pll_phases_chunked",
           "agc_gains_chunked", "fast_agc_gains_chunked",
           "costas_phases_chunked", "PLLChunked", "AGCChunked",
           "FastAGCChunked", "CostasChunked", "WARMUP_TCS",
           "settled_warmup", "loop_time_constant"]

_TWO_PI = np.float32(2.0) * FL_PI

METEOR_PHASES = (0.47439988279190737, 2.1777839908413044,
                 3.8682349942715186, -0.29067248091319986)


class LoopBody(NamedTuple):
    """One recurrence: ``name`` picks the kernel's body (csrc/loop_scan.h);
    ``k`` carries, ``nstreams`` input streams; ``params`` are the float32
    scalars the body takes; ``step(carry, inputs) -> (carry, out)`` is the
    plain PyTorch step on [C] vectors."""
    name: str
    k: int
    nstreams: int
    params: tuple
    step: Callable


def pll_body(alpha, beta, min_freq, max_freq) -> LoopBody:
    """The PLL recurrence (scans_pallas.py:228 _pll_make_body): out[t] is
    the VCO phase BEFORE consuming in[t] (reference pll.h:64-70)."""
    alpha, beta = float(np.float32(alpha)), float(np.float32(beta))
    lo, hi = float(np.float32(min_freq)), float(np.float32(max_freq))
    pi, two_pi = float(FL_PI), float(_TWO_PI)

    def step(carry, ins):
        phase, freq = carry
        (x,) = ins
        d = x - phase
        d = torch.where(d > pi, d - two_pi, d)
        d = torch.where(d <= -pi, d + two_pi, d)
        freq = torch.clamp(freq + beta * d, lo, hi)
        new = phase + freq + alpha * d
        # remainder lands in [0, 2pi) (sign of the divisor, as jnp.mod), so
        # only the `<= -pi` wrap can fire
        new = torch.remainder(new + pi, two_pi) - pi
        new = torch.where(new <= -pi, new + two_pi, new)
        return (new, freq), phase

    return LoopBody("pll", 2, 1, (alpha, beta, lo, hi), step)


def agc_body(set_point, attack, decay, max_gain, max_output_amp) -> LoopBody:
    """The full AGC recurrence (scans_pallas.py:417 _agc_make_body); the
    second stream is the look-ahead suffix max of the amplitudes."""
    sp = np.float32(set_point)
    att, dec = np.float32(attack), np.float32(decay)
    inv_att, inv_dec = np.float32(1.0) - att, np.float32(1.0) - dec
    mg, mo = np.float32(max_gain), np.float32(max_output_amp)
    params = tuple(float(v) for v in (sp, att, inv_att, dec, inv_dec, mg, mo))

    def step(carry, ins):
        amp, gain = carry
        a, smax = ins
        # a tensor numerator keeps set_point / amp an IEEE division
        # (python-scalar / tensor is reciprocal-then-multiply in torch)
        spt = torch.full_like(amp, float(sp))
        nonzero = a != 0.0
        amp_upd = torch.where(a > amp, amp * float(inv_att) + a * float(att),
                              amp * float(inv_dec) + a * float(dec))
        amp1 = torch.where(nonzero, amp_upd, amp)
        gain1 = torch.where(nonzero, torch.clamp(spt / amp1, max=float(mg)),
                            1.0)
        clipping = a * gain1 > float(mo)
        amp2 = torch.where(clipping, smax, amp1)
        gain2 = torch.where(clipping, torch.clamp(spt / amp2, max=float(mg)),
                            gain1)
        return (amp2, gain2), gain2

    return LoopBody("agc", 2, 2, params, step)


def fast_agc_body(set_point, max_gain, rate) -> LoopBody:
    """The FastAGC recurrence (scans_pallas.py:276 _fast_agc_make_body):
    out[t] is the gain BEFORE consuming |x[t]|."""
    sp, mg, r = (float(np.float32(v)) for v in (set_point, max_gain, rate))

    def step(carry, ins):
        (gain,) = carry
        (a,) = ins
        return (torch.clamp(gain + (sp - a * gain) * r, max=mg),), gain

    return LoopBody("fast_agc", 1, 1, (sp, mg, r), step)


def _wrap(d, pi, two_pi):
    d = torch.where(d > pi, d - two_pi, d)
    return torch.where(d <= -pi, d + two_pi, d)


def costas_body(order, alpha, beta, min_freq, max_freq) -> LoopBody:
    """The Costas recurrence (scans_pallas.py:310 _costas_make_body).
    ``order`` 2/4/8: streams re/im, the sample rotated by -phase inside
    the body; "meteor": streams atan2/|v| (``costas_streams``), the
    phase-domain broken-modulation error. out[t] is the phase BEFORE
    consuming sample t."""
    if order not in (2, 4, 8, "meteor"):
        raise ValueError(f"invalid costas order {order}")
    alpha, beta = float(np.float32(alpha)), float(np.float32(beta))
    lo, hi = float(np.float32(min_freq)), float(np.float32(max_freq))
    pi, two_pi = float(FL_PI), float(_TWO_PI)
    k8 = float(np.float32(np.sqrt(2.0) - 1.0))
    phases = [float(np.float32(p)) for p in METEOR_PHASES]

    def sign(v):
        return torch.where(v > 0, 1.0, -1.0)

    def step(carry, ins):
        phase, freq = carry
        a, b = ins
        if order == "meteor":
            d0 = _wrap(a - phase, pi, two_pi)
            best = torch.zeros_like(d0)
            best_abs = torch.full_like(d0, 1e9)
            for p in phases:
                d = _wrap(d0 - p, pi, two_pi)
                take = torch.abs(d) < best_abs
                best = torch.where(take, d, best)
                best_abs = torch.where(take, torch.abs(d), best_abs)
            err = best * b
        else:
            c, s = torch.cos(-phase), torch.sin(-phase)
            rr = a * c - b * s
            ri = a * s + b * c
            if order == 2:
                err = rr * ri
            elif order == 4:
                err = sign(rr) * ri - sign(ri) * rr
            else:
                sr, si = sign(rr), sign(ri)
                err = torch.where(torch.abs(rr) >= torch.abs(ri),
                                  sr * ri - si * rr * k8,
                                  sr * ri * k8 - si * rr)
        err = torch.clamp(err, -1.0, 1.0)
        freq = torch.clamp(freq + beta * err, lo, hi)
        new = phase + freq + alpha * err
        new = torch.remainder(new + pi, two_pi) - pi
        new = torch.where(new <= -pi, new + two_pi, new)
        return (new, freq), phase

    name = "costas_meteor" if order == "meteor" else f"costas{order}"
    return LoopBody(name, 2, 2, (alpha, beta, lo, hi), step)


# ---------------------------------------------------------------------------
# Entry points: kernel on CUDA tensors, plain loop on CPU tensors
# ---------------------------------------------------------------------------

# csrc/loop_scan.h's body indices, and the lanes of one CTA
_BODY_IDS = {"pll": 0, "agc": 1, "fast_agc": 2, "costas2": 3, "costas4": 4,
             "costas8": 5, "costas_meteor": 6}
KERNEL_LANES = 32


def _overlaps(t) -> bool:
    """True unless t's elements lie at distinct addresses: the dims of size
    > 1, by stride, must each step past the span of the smaller ones (as
    csrc/kernels_host.cpp tests it)."""
    span = 0
    for stride, size in sorted((st, sz) for st, sz in zip(t.stride(), t.shape)
                               if sz > 1):
        if stride <= span:
            return True
        span += stride * (size - 1)
    return False


def _check(body: LoopBody, state, streams, single: bool, valid=None,
           out=None, skip=0, side=None):
    """Validates a scan's arguments; returns (n, valid, skip). On CUDA
    tensors the compiled host path (csrc/kernels_host.cpp) makes the
    same checks, in this order and with these messages."""
    if len(streams) != body.nstreams:
        raise ValueError(f"{body.name} takes {body.nstreams} streams, "
                         f"got {len(streams)}")
    for s in (state, *streams):
        if s.dtype != torch.float32 or s.device != state.device:
            raise ValueError("loop scans take float32 tensors on one device")
    shape = streams[0].shape
    ok = len(shape) == 1 if single else len(shape) in (2, 3)
    if not ok or any(s.shape != shape for s in streams):
        raise ValueError("streams must share one 1-D shape" if single else
                         "streams must share one 2- or 3-D shape")
    n, lanes = shape[0], list(shape[1:])
    if list(state.shape) != [body.k, *lanes]:
        raise ValueError(f"state shape {list(state.shape)} != "
                         f"{[body.k, *lanes]}")
    valid = n if valid is None else int(valid)
    if not 0 <= valid <= n:
        raise ValueError(f"valid {valid} outside [0, {n}]")
    skip = int(skip)
    if not 0 <= skip <= n:
        raise ValueError(f"skip {skip} outside [0, {n}]")
    for name, t in (("out", out), ("side", side)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != state.device:
            raise ValueError(f"{name} must be float32 on the streams' device")
        if (t.dim() != len(shape) or list(t.shape[1:]) != lanes
                or (t.shape[0] != n - skip if name == "out"
                    else t.shape[0] > skip)):
            raise ValueError(
                f"{name} shape {list(t.shape)} != {[n - skip, *lanes]}"
                if name == "out" else f"side shape {list(t.shape)} must "
                f"have m <= {skip} rows of {lanes}")
        if _overlaps(t):
            raise ValueError(f"{name} has overlapping elements: the kernel "
                             f"cannot write it")
    return n, valid, skip


def _scan_plain(body: LoopBody, state, streams, n, valid, out, skip, side):
    """The plain loop over time on [*lanes] vectors; writes steps >= skip
    into ``out`` (allocated when None) and the ``side`` rows before them."""
    lanes = streams[0].shape[1:]
    if out is None:
        out = torch.empty((n - skip, *lanes), dtype=torch.float32,
                          device=state.device)
    carry = tuple(state[j] for j in range(body.k))
    rows = [s.unbind(0) for s in streams]
    full = torch.zeros((n, *lanes), dtype=torch.float32, device=state.device)
    for t in range(valid):
        carry, full[t] = body.step(carry, tuple(r[t] for r in rows))
    out.copy_(full[skip:])
    if side is not None:
        side.copy_(full[skip - side.shape[0]:skip])
    return out, torch.stack(carry)


def lane_scan_plain(body: LoopBody, state, streams, valid=None, out=None,
                    skip=0, side=None):
    """Plain PyTorch version of ``lane_scan``: (out, fin [k, *lanes])."""
    n, valid, skip = _check(body, state, streams, False, valid, out, skip,
                            side)
    return _scan_plain(body, state, streams, n, valid, out, skip, side)


def single_scan_plain(body: LoopBody, state, streams, valid=None):
    """Plain PyTorch version of ``single_scan``: (out [n], fin [k])."""
    n, valid, _ = _check(body, state, streams, True, valid)
    out, fin = _scan_plain(body, state[:, None], [s[:, None] for s in streams],
                           n, valid, None, 0, None)
    return out[:, 0], fin[:, 0]


_host = None


def _bind_host():
    """kernels_host.loop_scan (csrc/kernels_host.cpp), bound to the kernel
    library's C entry; both built and loaded on first use."""
    global _host
    lib = cuda_lib.load("loop_scan")
    mod = cuda_lib.load_host("kernels_host")
    mod.bind_loop_scan(ctypes.cast(lib.loop_scan, ctypes.c_void_p).value)
    _host = mod.loop_scan
    return _host


def _launch(body: LoopBody, state, streams, valid, out, skip, side, cycles,
            single):
    """The compiled host path: the checks of ``_check`` (ValueError), the
    outputs allocated, and csrc/loop_scan.cu launched on the state's
    current stream over the streams as they lie."""
    return (_host or _bind_host())(_BODY_IDS[body.name], body.params, state,
                                   streams, valid, out, skip, side, cycles,
                                   single)


def _scan(fn, body, state, streams, single, valid, out, skip, side, cycles):
    if state.is_cuda:
        result = _launch(body, state, streams, valid, out, skip, side,
                         cycles, single)
        fn.launches += 1
        return result
    _check(body, state, streams, single, valid, out, skip, side)
    if state.is_cpu:
        if single:
            return single_scan_plain(body, state, streams, valid)
        return lane_scan_plain(body, state, streams, valid, out, skip, side)
    raise RuntimeError(f"loop scans run on CUDA or CPU tensors, not "
                       f"{state.device}")


def lane_scan(body: LoopBody, state, streams, valid=None, out=None, skip=0,
              side=None, cycles=None):
    """Run ``body`` over ``streams`` (time-major [n, *lanes] float32, one
    or two lane axes, read where they lie: any strides, overlapping lanes
    included) from the seed carry ``state`` [k, *lanes]. Only steps t <
    ``valid`` (default n) advance the carry; stored steps past it are 0.
    Step t >= ``skip`` is written to row t - skip of ``out`` ([n - skip,
    *lanes], allocated when None, else written in place: any strides
    whose elements do not overlap), and the m steps before ``skip`` to
    ``side`` ([m, *lanes], when given). On CUDA, ``cycles`` (an int64
    [ceil(C / 32)] tensor, or None) receives each CTA's walker clock64
    cycles. Returns (out, fin [k, *lanes])."""
    return _scan(lane_scan, body, state, streams, False, valid, out, skip,
                 side, cycles)


lane_scan.launches = 0


def single_scan(body: LoopBody, state, streams, valid=None, cycles=None):
    """``lane_scan`` for one [n] stream, the output allocated: state [k]
    -> (out [n], fin [k]); ``cycles`` an int64 [1] tensor or None."""
    return _scan(single_scan, body, state, streams, True, valid, None, 0,
                 None, cycles)


single_scan.launches = 0


def _dispatch_scan(body: LoopBody, state, streams):
    """[n] streams -> single_scan; [..., n] streams -> lane_scan over their
    time-major views, the leading axes flattened into lanes, writing a
    streams-shaped output. Returns (output, a [k, ...] final carry)."""
    lead = streams[0].shape[:-1]
    n = streams[0].shape[-1]
    if not lead:
        return single_scan(body, state, streams)
    tm = [s.reshape(-1, n).T for s in streams]
    res = streams[0].new_empty((tm[0].shape[1], n), dtype=torch.float32)
    _, fin = lane_scan(body, state.reshape(body.k, -1), tm, out=res.T)
    return res.reshape(*lead, n), fin.reshape(body.k, *lead)


def pll_phases(in_phases, phase0, freq0, alpha, beta, min_freq, max_freq):
    """Exact sequential PLL phase recurrence -> (out_phases, phase_f,
    freq_f); the counterpart of scans_pallas.pll_phases_pallas."""
    state = torch.stack([phase0.float(), freq0.float()])
    out, fin = _dispatch_scan(pll_body(alpha, beta, min_freq, max_freq),
                              state, [in_phases.float()])
    return out, fin[0], fin[1]


def suffix_max(amps):
    """Reverse cummax along the last axis: the AGC's look-ahead clip table."""
    return torch.flip(torch.cummax(torch.flip(amps, [-1]), dim=-1).values,
                      [-1])


def agc_gains(amps, smax, amp0, gain0, set_point, attack, decay, max_gain,
              max_output_amp):
    """Exact full-AGC gain recurrence -> (gains, amp_f, gain_f); the
    counterpart of scans_pallas.agc_gains_pallas."""
    body = agc_body(set_point, attack, decay, max_gain, max_output_amp)
    state = torch.stack([amp0.float(), gain0.float()])
    out, fin = _dispatch_scan(body, state, [amps.float(), smax.float()])
    return out, fin[0], fin[1]


def fast_agc_gains(amps, gain0, set_point, max_gain, rate):
    """Exact FastAGC gain recurrence -> (gains, gain_f); the counterpart of
    scans_pallas.fast_agc_gains_pallas."""
    out, fin = _dispatch_scan(fast_agc_body(set_point, max_gain, rate),
                              gain0.float()[None], [amps.float()])
    return out, fin[0]


def costas_streams(re, im, order):
    """The two streams the Costas body consumes (scans_pallas.py:378):
    re/im for orders 2/4/8, atan2/|v| for "meteor"."""
    re, im = re.float(), im.float()
    if order == "meteor":
        return [torch.atan2(im, re), torch.sqrt(re * re + im * im)]
    return [re, im]


def costas_phases(re, im, phase0, freq0, order, alpha, beta, min_freq,
                  max_freq):
    """Exact Costas recurrence -> (out_phases, phase_f, freq_f); the
    counterpart of scans_pallas.costas_phases_pallas."""
    state = torch.stack([phase0.float(), freq0.float()])
    out, fin = _dispatch_scan(
        costas_body(order, alpha, beta, min_freq, max_freq), state,
        costas_streams(re, im, order))
    return out, fin[0], fin[1]


def rotate_back(x, phases):
    """x * phasor(-phases): the Costas loop's mixed-down output."""
    return x * torch.complex(torch.cos(-phases), torch.sin(-phases))


# ---------------------------------------------------------------------------
# Chunk-parallel approximate loops (scans_pallas.py:590-833)
# ---------------------------------------------------------------------------

def _lane_len(n, K, W):
    """The lane payload L = ceil(n / K); the warm-up must fit in it."""
    L = -(-n // K)
    if W > L:
        raise ValueError(f"warm-up {W} longer than the lane payload {L}")
    return L


def _extend(s, h, K, L):
    """[hist | block | the block's last sample repeated to K*L samples] as
    one [M, W + K*L] float32 tensor, the leading axes flattened into M (a
    constant tail keeps a locked loop locked); the drivers' one copy."""
    n = s.shape[-1]
    parts = [h.reshape(-1, h.shape[-1]).float(), s.reshape(-1, n).float()]
    if K * L > n:
        parts.append(parts[1][:, -1:].expand(-1, K * L - n))
    return torch.cat(parts, dim=-1)


def _lanes(ext, K, L, W):
    """The K overlapping lanes of ``ext`` [M, W + K*L] (lane j =
    ext[:, j*L : j*L + W + L]) as views, no copy: ([M, K, W + L], and the
    same lanes time-major, [W + L, M, K], for ``lane_scan``)."""
    lanes = ext.as_strided((ext.shape[0], K, W + L), (ext.stride(0), L, 1))
    return lanes, lanes.permute(2, 0, 1)


def _run_lanes(body: LoopBody, state, lanes_tm, W, side=None):
    """Run ``body`` over time-major [W + L, M, K] lane views from the
    [k, M, K] seeds, each lane's payload (steps W..W+L-1) written in sample
    order into an [M, K*L] output and its last ``side.shape[0]`` warm-up
    steps into ``side``. Returns (output [M, K*L], fin [k, M, K])."""
    n, M, K = lanes_tm[0].shape
    res = lanes_tm[0].new_empty((M, K * (n - W)))
    _, fin = lane_scan(body, state, lanes_tm,
                       out=res.as_strided((n - W, M, K), (1, K * (n - W),
                                                          n - W)),
                       skip=W, side=side)
    return res, fin


def pll_phases_chunked(in_phases, hist, alpha, beta, min_freq, max_freq,
                       lanes_k: int = 128):
    """Chunk-parallel PLL phase recurrence over K lanes. ``hist``: the
    previous block's last W input phases. Seeds: per-lane phase = first
    warm-up input, per-lane freq = mean wrapped warm-up phase increment,
    clipped. Returns (out_phases [..., n], new_hist [..., W], phase_f,
    freq_f)."""
    n = in_phases.shape[-1]
    lead = in_phases.shape[:-1]
    W = hist.shape[-1]
    L = _lane_len(n, lanes_k, W)
    lane, lane_tm = _lanes(_extend(in_phases, hist, lanes_k, L), lanes_k, L,
                           W)
    pi, two_pi = float(FL_PI), float(_TWO_PI)
    d = lane[..., 1:W + 1] - lane[..., :W]
    d = torch.where(d > pi, d - two_pi, d)
    d = torch.where(d <= -pi, d + two_pi, d)
    seed_freq = torch.clamp(torch.mean(d, dim=-1), float(np.float32(min_freq)),
                            float(np.float32(max_freq)))
    state = torch.stack([lane[..., 0], seed_freq])
    out, fin = _run_lanes(pll_body(alpha, beta, min_freq, max_freq), state,
                          [lane_tm], W)
    new_hist = in_phases[..., n - W:].float().clone()
    return (out.reshape(*lead, -1)[..., :n], new_hist,
            fin[0, :, -1].reshape(lead), fin[1, :, -1].reshape(lead))


def agc_gains_chunked(amps, hist, set_point, attack, decay, max_gain,
                      max_output_amp, lanes_k: int = 128):
    """Chunk-parallel full-AGC gain recurrence. The suffix max is taken over
    the whole extended block (hist + block) and lane-sliced, so every lane
    sees the exact scan's look-ahead table. Seeds: each lane's warm-up mean
    amplitude. Returns (gains, new_hist, amp_f, gain_f)."""
    n = amps.shape[-1]
    lead = amps.shape[:-1]
    W = hist.shape[-1]
    K = lanes_k
    L = _lane_len(n, K, W)
    ext = _extend(amps, hist, K, L)
    lane_a, tm_a = _lanes(ext, K, L, W)
    _, tm_s = _lanes(suffix_max(ext), K, L, W)
    mean_amp = torch.mean(lane_a[..., :W], dim=-1)
    seed_amp = torch.where(mean_amp > 0, mean_amp, 1.0)
    sp = torch.full_like(seed_amp, float(np.float32(set_point)))
    seed_gain = torch.clamp(sp / seed_amp, max=float(np.float32(max_gain)))
    out, fin = _run_lanes(
        agc_body(set_point, attack, decay, max_gain, max_output_amp),
        torch.stack([seed_amp, seed_gain]), [tm_a, tm_s], W)
    new_hist = amps[..., n - W:].float().clone()
    return (out.reshape(*lead, -1)[..., :n], new_hist,
            fin[0, :, -1].reshape(lead), fin[1, :, -1].reshape(lead))


def fast_agc_gains_chunked(amps, hist, set_point, max_gain, rate,
                           lanes_k: int = 128):
    """Chunk-parallel FastAGC gain recurrence. Seeds each lane at the
    steady-state gain for its warm-up window's mean amplitude. Returns
    (gains, new_hist, gain_f)."""
    n = amps.shape[-1]
    lead = amps.shape[:-1]
    W = hist.shape[-1]
    L = _lane_len(n, lanes_k, W)
    lane, lane_tm = _lanes(_extend(amps, hist, lanes_k, L), lanes_k, L, W)
    mean_amp = torch.mean(lane[..., :W], dim=-1)
    sp = torch.full_like(mean_amp, float(np.float32(set_point)))
    seed_gain = torch.where(
        mean_amp > 0, torch.clamp(sp / mean_amp, max=float(np.float32(max_gain))),
        1.0)
    out, fin = _run_lanes(fast_agc_body(set_point, max_gain, rate),
                          seed_gain[None], [lane_tm], W)
    return (out.reshape(*lead, -1)[..., :n], amps[..., n - W:].float().clone(),
            fin[0, :, -1].reshape(lead))


def costas_phases_chunked(s1, s2, hist1, hist2, phase0, freq0, order, alpha,
                          beta, min_freq, max_freq, lanes_k: int = 128):
    """Chunk-parallel Costas recurrence with seam rotation alignment
    (scans_pallas.py:730; see it for the seeding and the contract).
    ``s1``/``s2`` follow ``costas_streams``; ``hist1``/``hist2`` are the
    previous block's last W stream samples. Orders 2/4/8 seed each lane's
    frequency by a coherence-gated M-th-power estimate over its warm-up
    window and snap every lane into lane 0's constellation rotation,
    measured on the lane overlaps; "meteor" has a unique lock point and
    needs neither. Returns (out_phases, new_hist1, new_hist2, phase_f,
    freq_f)."""
    n = s1.shape[-1]
    lead = s1.shape[:-1]
    W = hist1.shape[-1]
    K = lanes_k
    pi, two_pi = float(FL_PI), float(_TWO_PI)
    lo, hi = float(np.float32(min_freq)), float(np.float32(max_freq))
    L = _lane_len(n, K, W)
    a, a_tm = _lanes(_extend(s1, hist1, K, L), K, L, W)
    b, b_tm = _lanes(_extend(s2, hist2, K, L), K, L, W)
    M = a.shape[0]
    phase0 = phase0.float().reshape(M, 1)
    carried = freq0.float().reshape(M, 1).expand(M, K)
    meteor = order == "meteor"
    if meteor:
        seed_freq = carried
    else:
        P = float(int(order))
        ang = torch.atan2(b[..., :W], a[..., :W])
        d = P * (ang[..., 1:] - ang[..., :-1])
        zr, zi = torch.mean(torch.cos(d), -1), torch.mean(torch.sin(d), -1)
        est = torch.atan2(zi, zr) / P
        coh = torch.sqrt(zr * zr + zi * zi)
        energy = torch.mean(a[..., :W] ** 2 + b[..., :W] ** 2, dim=-1)
        ok = (coh > 0.5) & (energy > 1e-12)
        seed_freq = torch.clamp(torch.where(ok, est, carried), lo, hi)
    t0 = (torch.arange(K, dtype=torch.float32, device=a.device) * float(L)
          - float(W))
    seed_phase = torch.remainder(phase0 + seed_freq * t0 + pi, two_pi) - pi
    tail = 0 if meteor else min(W, 32)
    # lane j's last `tail` warm-up steps and lane j-1's last `tail` payload
    # steps hold the phase for the SAME input samples: the warm-up ones go
    # to a side output, as the payload output holds lane j-1's
    seam = a.new_empty((M, K, tail))
    out, fin = _run_lanes(
        costas_body(order, alpha, beta, min_freq, max_freq),
        torch.stack([seed_phase, seed_freq]), [a_tm, b_tm], W,
        side=None if meteor else seam.permute(2, 0, 1))
    out = out.view(M, K, L)
    if meteor:
        rot = torch.zeros((M, K), dtype=torch.float32, device=a.device)
    else:
        step_rot = float(_TWO_PI / np.float32(P))
        d_seam = seam[:, 1:] - out[:, :-1, L - tail:]
        d_hat = torch.atan2(torch.mean(torch.sin(d_seam), -1),
                            torch.mean(torch.cos(d_seam), -1))
        d0 = torch.remainder(out[:, 0, 0] - phase0[:, 0] + pi, two_pi) - pi
        k_rot = torch.round(torch.cat([d0[:, None], d_hat], dim=-1)
                            / step_rot)
        rot = torch.cumsum(k_rot, dim=-1) * step_rot
    out = torch.remainder(out - rot[..., None] + pi, two_pi) - pi
    phase_f = torch.remainder(fin[0, :, -1] - rot[:, -1] + pi, two_pi) - pi
    return (out.reshape(*lead, K * L)[..., :n], s1[..., n - W:].float().clone(),
            s2[..., n - W:].float().clone(), phase_f.reshape(lead),
            fin[1, :, -1].reshape(lead))


# A chunked lane starts from a seed estimated over its warm-up and settles
# onto the exact loop's trajectory at the loop's own rate, so its payload
# agrees with the exact loop only once the warm-up spans a few of the
# loop's time constants: WARMUP_TCS of them leave exp(-WARMUP_TCS) of the
# seed's error. A warm-up that long which fits in no lane runs the loop
# exact (``_chunk_lanes_for`` returns 0 when no lane payload holds it).
WARMUP_TCS = 4


def settled_warmup(time_constant: float, least: int = 0) -> int:
    """The warm-up a chunked lane needs to settle: WARMUP_TCS loop time
    constants (in samples), and at least ``least``."""
    return max(int(least), int(np.ceil(WARMUP_TCS * float(time_constant))))


def loop_time_constant(alpha: float) -> float:
    """A second-order phase loop's settling time constant in samples,
    2 / alpha: the poles of its step (proportional gain alpha, integral
    gain beta) have modulus sqrt(1 - alpha), about 1 - alpha / 2."""
    return 2.0 / float(alpha)


# "auto": the chunk-parallel loops (and the chunked M&M) for long 1-D
# blocks; "exact": always the exact recurrences. Read once, at import, as
# the JAX package reads SDRPP_TPU_LOOPS (scans_pallas.py:57).
LOOPS_MODE = os.environ.get("SDRPP_TPU_LOOPS", "auto")


def _chunk_lanes_for(n: int, warmup: int, max_lanes: int,
                     channels: int = 1) -> int:
    """Per-channel lane count K minimizing the JAX package's cost model
    ``ceil(channels*K / 128) * (W + ceil(n/K))``, or 0 (run exact) unless
    the best chunked cost beats half the exact ``ceil(channels/128)*n``,
    and always 0 under ``LOOPS_MODE == "exact"``. Kept as
    scans_pallas.py:835 has it, so both packages take the same branch;
    re-deriving it for the GPU is the kernel's tuning work."""
    if LOOPS_MODE == "exact" or warmup <= 0:
        return 0
    best_k, best_cost = 0, None
    for k in range(1, max_lanes + 1):
        L = -(-n // k)
        if L < warmup:
            break
        cost = -(-(channels * k) // 128) * (warmup + L)
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
    exact_cost = -(-channels // 128) * n
    if best_k < 2 or best_cost is None or 2 * best_cost > exact_cost:
        return 0
    return best_k


def _lanes_of(x) -> int:
    return 1 if x.ndim == 1 else int(np.prod(x.shape[:-1]))


class PLLChunked(PLL):
    """PLL that runs chunk-parallel for long blocks and exact otherwise.
    State grows a ``hist`` buffer of the last ``warmup`` input phases so
    lane 0 warms up on real history."""

    def __init__(self, *args, warmup: int = 512, max_lanes: int = 512,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)

    def init_state(self):
        st = super().init_state()
        # synthetic history: the input phases a locked loop at
        # (init_phase, init_freq) would have seen
        pi, two_pi = float(FL_PI), float(_TWO_PI)
        t = torch.arange(self.warmup, dtype=torch.float32,
                         device=self.device) - float(self.warmup)
        ramp = float(self.init_phase) + float(self.init_freq) * t
        ramp = torch.remainder(ramp + pi, two_pi) - pi
        ramp = torch.where(ramp <= -pi, ramp + two_pi, ramp)
        st["hist"] = ramp.expand(*self.lead_shape, self.warmup).clone()
        return st

    def __call__(self, state, x):
        k = _chunk_lanes_for(x.shape[-1], self.warmup, self.max_lanes,
                             _lanes_of(x))
        if k < 1:
            sub = {"phase": state["phase"], "freq": state["freq"]}
            sub, y = PLL.__call__(self, sub, x)
            in_phase = torch.atan2(x.imag, x.real)
            hist = torch.cat([state["hist"], in_phase],
                             dim=-1)[..., -self.warmup:]
            return {**sub, "hist": hist}, y
        in_phase = torch.atan2(x.imag, x.real)
        out_phases, hist, phase_f, freq_f = pll_phases_chunked(
            in_phase, state["hist"], self.alpha, self.beta, self.min_freq,
            self.max_freq, lanes_k=k)
        y = torch.complex(torch.cos(out_phases), torch.sin(out_phases))
        return {"phase": phase_f, "freq": freq_f, "hist": hist}, y


class AGCChunked(AGC):
    """Full AGC, chunk-parallel for long blocks and exact otherwise (state
    grows a ``hist`` buffer of the last ``warmup`` input amplitudes). With
    ``enabled=False`` the manual gain of ``AGC`` runs, at any length.

    The default warm-up spans WARMUP_TCS of the loop's slow time constant,
    1 / decay (at least the JAX package's 2048 samples): a lane seeded at
    its warm-up's mean amplitude settles onto the exact tracker at the
    decay rate, and the JAX package's fixed 2048 samples, shorter than
    1 / decay at the radio's rates (4800 samples at 24 kHz), leave the
    lanes unsettled. Where that warm-up fits in no lane the AGC runs
    exact. An explicit ``warmup`` is used as given."""

    def __init__(self, *args, warmup: int | None = None,
                 max_lanes: int = 512, **kwargs):
        super().__init__(*args, **kwargs)
        if warmup is None:
            warmup = (settled_warmup(1.0 / float(self.decay), 2048)
                      if self.decay > 0 else 2048)
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)

    def init_state(self):
        st = super().init_state()
        # constant history at the configured initial tracked amplitude, so
        # lane 0's first-block seeds land on the exact loop's init_state
        st["hist"] = torch.full((*self.lead_shape, self.warmup),
                                float(self.set_point / self.init_gain),
                                dtype=torch.float32, device=self.device)
        return st

    def __call__(self, state, x):
        amps = torch.abs(x)
        k = _chunk_lanes_for(x.shape[-1], self.warmup, self.max_lanes,
                             _lanes_of(x))
        if k < 1 or not self.enabled:
            sub = {"amp": state["amp"], "gain": state["gain"]}
            sub, y = AGC.__call__(self, sub, x)
            hist = torch.cat([state["hist"], amps], dim=-1)[..., -self.warmup:]
            return {**sub, "hist": hist}, y
        gains, hist, amp_f, gain_f = agc_gains_chunked(
            amps, state["hist"], self.set_point, self.attack, self.decay,
            self.max_gain, self.max_output_amp, lanes_k=k)
        return {"amp": amp_f, "gain": gain_f, "hist": hist}, x * gains


class FastAGCChunked(FastAGC):
    """FastAGC, chunk-parallel for long blocks and exact otherwise. State:
    {"gain", "hist"}, ``hist`` the last ``warmup`` input amplitudes."""

    def __init__(self, *args, warmup: int = 1024, max_lanes: int = 512,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)

    def init_state(self):
        # constant history at set_point/init_gain: lane 0's first-block
        # seed gain lands exactly on the configured init_gain
        hist = torch.full((*self.lead_shape, self.warmup),
                          float(self.set_point / self.init_gain),
                          dtype=torch.float32, device=self.device)
        return {"gain": super().init_state(), "hist": hist}

    def __call__(self, state, x):
        amps = torch.abs(x)
        k = _chunk_lanes_for(x.shape[-1], self.warmup, self.max_lanes,
                             _lanes_of(x))
        if k < 1:
            gain_f, y = FastAGC.__call__(self, state["gain"], x)
            hist = torch.cat([state["hist"], amps], dim=-1)[..., -self.warmup:]
            return {"gain": gain_f, "hist": hist}, y
        gains, hist, gain_f = fast_agc_gains_chunked(
            amps, state["hist"], self.set_point, self.max_gain, self.rate,
            lanes_k=k)
        return {"gain": gain_f, "hist": hist}, x * gains


class CostasChunked(Costas):
    """Costas loop of order 2/4/8 or "meteor" (the QPSK loop with Meteor
    M2-x's "broken modulation" error: the distance to the nearest of the
    four ``METEOR_PHASES``, scaled by amplitude; reference
    meteor_costas.h:36-56), chunk-parallel for long blocks and exact
    otherwise; both run the loop-scan kernel's Costas body. The counterpart
    of the JAX package's ``CostasChunked`` (scans_pallas.py:980) and
    ``MeteorCostas`` (models/digital.py:113) in one block. Orders 2/4/8
    align the lanes' seams by rotation; "meteor" has a unique lock point
    and needs none. State grows ``hist_re`` / ``hist_im``, the last
    ``warmup`` input samples, seeded with a locked constellation point
    (offset 0 for order 2, pi/order for 4 and 8, METEOR_PHASES[0] for
    "meteor") riding the configured (init_phase, init_freq) carrier."""

    def __init__(self, *args, warmup: int = 512, max_lanes: int = 512,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)

    def init_state(self):
        st = super().init_state()
        # synthetic history: a locked constellation point riding the
        # configured (init_phase, init_freq) carrier (zero loop error)
        pi, two_pi = float(FL_PI), float(_TWO_PI)
        t = torch.arange(self.warmup, dtype=torch.float32,
                         device=self.device) - float(self.warmup)
        off = (float(np.float32(METEOR_PHASES[0])) if self.order == "meteor"
               else 0.0 if self.order == 2
               else float(np.float32(FL_PI / self.order)))
        ramp = float(self.init_phase) + float(self.init_freq) * t + off
        ramp = torch.remainder(ramp + pi, two_pi) - pi
        shape = (*self.lead_shape, self.warmup)
        st["hist_re"] = torch.cos(ramp).expand(shape).clone()
        st["hist_im"] = torch.sin(ramp).expand(shape).clone()
        return st

    def __call__(self, state, x):
        k = _chunk_lanes_for(x.shape[-1], self.warmup, self.max_lanes,
                             _lanes_of(x))

        if k < 1:
            out_phases, phase_f, freq_f = costas_phases(
                x.real, x.imag, state["phase"], state["freq"], self.order,
                self.alpha, self.beta, self.min_freq, self.max_freq)
        else:
            s1, s2 = costas_streams(x.real, x.imag, self.order)
            h1, h2 = costas_streams(state["hist_re"], state["hist_im"],
                                    self.order)
            out_phases, _, _, phase_f, freq_f = costas_phases_chunked(
                s1, s2, h1, h2, state["phase"], state["freq"], self.order,
                self.alpha, self.beta, self.min_freq, self.max_freq,
                lanes_k=k)

        def keep(h, s):
            return torch.cat([h, s.float()], dim=-1)[..., -self.warmup:]

        return {"phase": phase_f, "freq": freq_f,
                "hist_re": keep(state["hist_re"], x.real),
                "hist_im": keep(state["hist_im"], x.imag)}, \
            rotate_back(x, out_phases)
