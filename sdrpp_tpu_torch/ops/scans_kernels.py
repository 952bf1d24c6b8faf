"""The loop-scan kernels (PLL, AGC) and the chunk-parallel loops.

The counterpart of ``sdrpp_tpu.ops.scans_pallas``. Two entry points run a
per-sample recurrence ("body") sequentially in time:

- ``lane_scan``   C lanes of time-major [n, C] streams (replaces the
                  Pallas kernel ``_lane_scan_call``, scans_pallas.py:147);
- ``single_scan`` one [n] stream (replaces ``_smem_scan_call``,
                  scans_pallas.py:68); the same CUDA kernel with C = 1.

On a CUDA tensor each launches the hand-written kernel in
``csrc/loop_scan.cu`` (built on first use; a failed build raises) and adds
one to its ``launches`` count. On a CPU tensor each runs its plain PyTorch
version (``lane_scan_plain`` / ``single_scan_plain``): a Python loop over
time on [C] vectors, operation for operation the kernel's body. Any other
device raises.

The chunk-parallel loops (``pll_phases_chunked``, ``agc_gains_chunked``)
cut a long block into K overlapping lanes that each re-acquire over a
W-sample warm-up window and run them through ``lane_scan``; see the JAX
module for the approximation contract. Whether a loop runs chunked or
exact is decided by ``_chunk_lanes_for`` alone, on every device, so the
CPU tests exercise the same glue the card runs.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils import cuda_lib
from .scans import AGC, FL_PI, PLL

__all__ = ["LoopBody", "pll_body", "agc_body", "lane_scan", "single_scan",
           "lane_scan_plain", "single_scan_plain", "pll_phases", "agc_gains",
           "suffix_max", "pll_phases_chunked", "agc_gains_chunked",
           "PLLChunked", "AGCChunked"]

_TWO_PI = np.float32(2.0) * FL_PI


class LoopBody(NamedTuple):
    """One recurrence: ``name`` picks the CUDA entry ``loop_scan_<name>``;
    ``k`` carries, ``nstreams`` input streams; ``params`` are the float32
    scalars the entry takes; ``step(carry, inputs) -> (carry, out)`` is the
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


# ---------------------------------------------------------------------------
# Entry points: kernel on CUDA tensors, plain loop on CPU tensors
# ---------------------------------------------------------------------------

def _check(body: LoopBody, state, streams, ndim: int):
    if len(streams) != body.nstreams:
        raise ValueError(f"{body.name} takes {body.nstreams} streams, "
                         f"got {len(streams)}")
    shape = streams[0].shape
    for s in (state, *streams):
        if s.dtype != torch.float32 or s.device != state.device:
            raise ValueError("loop scans take float32 tensors on one device")
    if len(shape) != ndim or any(s.shape != shape for s in streams):
        raise ValueError(f"streams must share one {ndim}-D shape")
    lanes = shape[1:]
    if tuple(state.shape) != (body.k, *lanes):
        raise ValueError(f"state shape {tuple(state.shape)} != "
                         f"{(body.k, *lanes)}")
    return shape[0]


def _valid(valid, n):
    valid = n if valid is None else int(valid)
    if not 0 <= valid <= n:
        raise ValueError(f"valid {valid} outside [0, {n}]")
    return valid


def lane_scan_plain(body: LoopBody, state, streams, valid=None):
    """Plain PyTorch version of ``lane_scan``: (out [n, C], fin [k, C])."""
    n = _check(body, state, streams, 2)
    valid = _valid(valid, n)
    carry = tuple(state[j] for j in range(body.k))
    rows = [s.unbind(0) for s in streams]
    outs = []
    for t in range(valid):
        carry, o = body.step(carry, tuple(r[t] for r in rows))
        outs.append(o)
    out = torch.zeros_like(streams[0])
    if outs:
        out[:valid] = torch.stack(outs)
    return out, torch.stack(carry)


def single_scan_plain(body: LoopBody, state, streams, valid=None):
    """Plain PyTorch version of ``single_scan``: (out [n], fin [k])."""
    n = _check(body, state, streams, 1)
    out, fin = lane_scan_plain(body, state[:, None],
                               [s[:, None] for s in streams], valid)
    return out[:, 0], fin[:, 0]


def _launch(body: LoopBody, state, streams, valid):
    """Run csrc/loop_scan.cu's entry for ``body`` over time-major [n, C]
    streams on the current CUDA stream."""
    lib = cuda_lib.load("loop_scan")
    n, C = streams[0].shape
    streams = [s.contiguous() for s in streams]
    fin = state.contiguous().clone()
    out = torch.empty((n, C), dtype=torch.float32, device=state.device)
    fn = getattr(lib, f"loop_scan_{body.name}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * len(body.params) + [ctypes.c_void_p])
    s1 = streams[1].data_ptr() if len(streams) > 1 else None
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(streams[0].data_ptr(), s1, out.data_ptr(), fin.data_ptr(),
                n, C, valid, *body.params, stream)
    if rc != 0:
        raise RuntimeError(f"loop_scan_{body.name} launch failed: CUDA error "
                           f"{rc} at n={n}, C={C}")
    return out, fin


def _kernel_device(state):
    if state.device.type == "cpu":
        return False
    if state.device.type != "cuda":
        raise RuntimeError(f"loop scans run on CUDA or CPU tensors, not "
                           f"{state.device}")
    return True


def lane_scan(body: LoopBody, state, streams, valid=None):
    """Run ``body`` over ``streams`` (list of time-major [n, C] float32)
    from the seed carry ``state`` [k, C]. Only rows t < ``valid`` (default
    n) advance the carry; later output rows are 0. Returns (out [n, C],
    fin [k, C])."""
    n = _check(body, state, streams, 2)
    valid = _valid(valid, n)
    if not _kernel_device(state):
        return lane_scan_plain(body, state, streams, valid)
    result = _launch(body, state, streams, valid)
    lane_scan.launches += 1
    return result


lane_scan.launches = 0


def single_scan(body: LoopBody, state, streams, valid=None):
    """``lane_scan`` for one [n] stream: state [k] -> (out [n], fin [k])."""
    n = _check(body, state, streams, 1)
    valid = _valid(valid, n)
    if not _kernel_device(state):
        return single_scan_plain(body, state, streams, valid)
    out, fin = _launch(body, state[:, None], [s[:, None] for s in streams],
                       valid)
    single_scan.launches += 1
    return out[:, 0], fin[:, 0]


single_scan.launches = 0


def _dispatch_scan(body: LoopBody, state, streams):
    """[n] streams -> single_scan; [..., n] streams -> lane_scan with the
    leading axes flattened into lanes (time-major). Returns streams-shaped
    output and a [k, ...] final carry."""
    lead = streams[0].shape[:-1]
    n = streams[0].shape[-1]
    if not lead:
        return single_scan(body, state, streams)
    tm = [s.reshape(-1, n).T.contiguous() for s in streams]
    out, fin = lane_scan(body, state.reshape(body.k, -1).contiguous(), tm)
    return out.T.reshape(*lead, n), fin.reshape(body.k, *lead)


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


# ---------------------------------------------------------------------------
# Chunk-parallel approximate loops (scans_pallas.py:590-727)
# ---------------------------------------------------------------------------

def _lane_slice(ext, K, L, W):
    """[..., W + K*L] extended stream -> [..., K, W+L] overlapping lanes
    (lane j = ext[..., j*L : j*L + W + L]). Needs W <= L."""
    lead = ext.shape[:-1]
    warm = ext[..., :K * L].reshape(*lead, K, L)[..., :W]
    return torch.cat([warm, ext[..., W:].reshape(*lead, K, L)], dim=-1)


def _pad_last(s, pad):
    """Pad the last axis by replicating the last sample (a constant tail
    keeps a locked loop locked)."""
    if not pad:
        return s
    return torch.cat([s, s[..., -1:].expand(*s.shape[:-1], pad)], dim=-1)


def _build_lanes(streams, hists, K):
    """Cut [..., n] streams into K overlapping lanes [..., K, W+L], lane 0's
    warm-up drawn from ``hists`` (the previous block's tail). Returns
    (lanes, L, pad)."""
    W = hists[0].shape[-1]
    n = streams[0].shape[-1]
    L = -(-n // K)
    pad = K * L - n
    if W > L:
        raise ValueError(f"warm-up {W} longer than the lane payload {L}")
    lanes = []
    for s, h in zip(streams, hists):
        ext = torch.cat([h.float(), _pad_last(s.float(), pad)], dim=-1)
        lanes.append(_lane_slice(ext, K, L, W))
    return lanes, L, pad


def _run_lanes(body: LoopBody, state, lanes):
    """Run ``body`` over [..., K, W+L] lanes, leading dims and K flattened
    into the lane axis (time-major). ``state``: [k, ..., K] seeds."""
    shp = lanes[0].shape
    m = int(np.prod(shp[:-1]))
    tm = [l.reshape(m, shp[-1]).T.contiguous() for l in lanes]
    out, fin = lane_scan(body, state.reshape(body.k, m).contiguous(), tm)
    return out.T.reshape(shp), fin.reshape(body.k, *shp[:-1])


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
    lanes, L, _ = _build_lanes([in_phases], [hist], lanes_k)
    lane = lanes[0]  # [..., K, W+L]
    pi, two_pi = float(FL_PI), float(_TWO_PI)
    d = lane[..., 1:W + 1] - lane[..., :W]
    d = torch.where(d > pi, d - two_pi, d)
    d = torch.where(d <= -pi, d + two_pi, d)
    seed_freq = torch.clamp(torch.mean(d, dim=-1), float(np.float32(min_freq)),
                            float(np.float32(max_freq)))
    state = torch.stack([lane[..., 0], seed_freq])
    out, fin = _run_lanes(pll_body(alpha, beta, min_freq, max_freq), state,
                          lanes)
    out = out[..., W:].reshape(*lead, lanes_k * L)[..., :n]
    new_hist = in_phases[..., n - W:].float().clone()
    return out, new_hist, fin[0, ..., -1], fin[1, ..., -1]


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
    L = -(-n // K)
    if W > L:
        raise ValueError(f"warm-up {W} longer than the lane payload {L}")
    ext = torch.cat([hist.float(), _pad_last(amps.float(), K * L - n)], dim=-1)
    lane_a = _lane_slice(ext, K, L, W)
    lane_s = _lane_slice(suffix_max(ext), K, L, W)
    mean_amp = torch.mean(lane_a[..., :W], dim=-1)
    seed_amp = torch.where(mean_amp > 0, mean_amp, 1.0)
    sp = torch.full_like(seed_amp, float(np.float32(set_point)))
    seed_gain = torch.clamp(sp / seed_amp, max=float(np.float32(max_gain)))
    state = torch.stack([seed_amp, seed_gain])
    out, fin = _run_lanes(
        agc_body(set_point, attack, decay, max_gain, max_output_amp), state,
        [lane_a, lane_s])
    out = out[..., W:].reshape(*lead, K * L)[..., :n]
    new_hist = amps[..., n - W:].float().clone()
    return out, new_hist, fin[0, ..., -1], fin[1, ..., -1]


def _chunk_lanes_for(n: int, warmup: int, max_lanes: int,
                     channels: int = 1) -> int:
    """Per-channel lane count K minimizing the JAX package's cost model
    ``ceil(channels*K / 128) * (W + ceil(n/K))``, or 0 (run exact) unless
    the best chunked cost beats half the exact ``ceil(channels/128)*n``.
    Kept as scans_pallas.py:835 has it, so both packages take the same
    branch; re-deriving it for the GPU is the kernel's tuning work."""
    if warmup <= 0:
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
    grows a ``hist`` buffer of the last ``warmup`` input amplitudes)."""

    def __init__(self, *args, warmup: int = 2048, max_lanes: int = 512,
                 **kwargs):
        super().__init__(*args, **kwargs)
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
        if k < 1:
            sub = {"amp": state["amp"], "gain": state["gain"]}
            sub, y = AGC.__call__(self, sub, x)
            hist = torch.cat([state["hist"], amps], dim=-1)[..., -self.warmup:]
            return {**sub, "hist": hist}, y
        gains, hist, amp_f, gain_f = agc_gains_chunked(
            amps, state["hist"], self.set_point, self.attack, self.decay,
            self.max_gain, self.max_output_amp, lanes_k=k)
        return {"amp": amp_f, "gain": gain_f, "hist": hist}, x * gains
