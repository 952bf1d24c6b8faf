"""Recurrent DSP blocks: affine scans and the per-sample loops.

The counterpart of ``sdrpp_tpu.ops.scans``. Linear first-order
recurrences (DC blocker, de-emphasis, the noise blanker's running mean)
run as a blocked two-level scan in plain torch ops: within a block of
``_SCAN_BLOCK`` samples, one matrix product with the lower-triangular
power matrix a^(i-j); across blocks, the same scan again over the block
ends (a^B per step), recursively. The noise blanker's mean, whose
coefficient is 1 - rate on nonzero samples and 1 on zeros, is the same
scan over its nonzero samples, gathered back to every position. The
nonlinear loops (PLL, CarrierTrackingPLL, AGC, FastAGC, Costas) run
through the loop-scan kernel wrappers of
``scans_kernels`` (CUDA kernel on CUDA tensors, plain loop on CPU tensors).
All blocks filter along the LAST axis and broadcast over leading axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.blocks import Block

__all__ = [
    "FL_PI",
    "affine_scan",
    "DCBlocker",
    "Deemphasis",
    "AGC",
    "FastAGC",
    "PLL",
    "CarrierTrackingPLL",
    "Costas",
    "NoiseBlanker",
    "Squelch",
]

FL_PI = np.float32(3.1415926535)

_SCAN_BLOCK = 256


@functools.lru_cache(maxsize=64)
def _scan_tables(a: float, size: int, device: str):
    """(T [size, size] with T[i, j] = a^(i-j) for i >= j, p [size] with
    p[i] = a^(i+1)): float64 on the host, float32 on ``device``."""
    e = np.arange(size)
    d = e[:, None] - e[None, :]
    T = np.where(d >= 0, np.power(a, np.maximum(d, 0), dtype=np.float64), 0.0)
    p = np.power(a, e + 1, dtype=np.float64)
    return (torch.from_numpy(T.astype(np.float32)).to(device),
            torch.from_numpy(p.astype(np.float32)).to(device))


def _affine_scan_real(a: float, b: torch.Tensor, y0: torch.Tensor):
    n = b.shape[-1]
    if n <= _SCAN_BLOCK:
        T, p = _scan_tables(a, n, str(b.device))
        return b @ T.T + y0[..., None] * p
    B = _SCAN_BLOCK
    nb = -(-n // B)
    T, p = _scan_tables(a, B, str(b.device))
    bp = torch.nn.functional.pad(b, (0, nb * B - n))
    local = bp.reshape(*b.shape[:-1], nb, B) @ T.T  # zero-start block scans
    # y at each block's end, carried: y_end[k] = a^B * y_end[k-1] + local_end[k]
    ends = _affine_scan_real(a ** B, local[..., -1], y0)
    carry_in = torch.cat([y0[..., None], ends[..., :-1]], dim=-1)
    y = local + carry_in[..., None] * p
    return y.reshape(*b.shape[:-1], nb * B)[..., :n]


def affine_scan(a: float, b: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """Solve y[i] = a*y[i-1] + b[i] (y[-1] = y0) along the last axis for a
    constant coefficient ``a``; ``b`` real or complex, ``y0`` shaped like
    b's leading axes. Complex data runs as two real planes."""
    a = float(a)
    if not b.is_complex():
        return _affine_scan_real(a, b, y0)
    planes = _affine_scan_real(a, torch.stack([b.real, b.imag]),
                               torch.stack([y0.real, y0.imag]))
    return torch.complex(planes[0], planes[1])


class DCBlocker(Block):
    """Leaky DC tracker: out[i] = in[i] - offset; offset += out[i]*rate
    (reference: core/src/dsp/correction/dc_blocker.h:54-61; rate = 50/fs per
    signal_path/iq_frontend.h:52-54). At 2.4 Msps a = 1 - 2.1e-5: a memory
    of ~10^5 samples, carried exactly by the two-level scan."""

    def __init__(self, rate: float, dtype=torch.complex64, lead_shape=(), *,
                 device):
        self.rate = float(rate)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def init_state(self):
        return torch.zeros(self.lead_shape, dtype=self.dtype, device=self.device)

    def __call__(self, state, x):
        rate = float(np.float32(self.rate))
        a = np.float32(1.0 - self.rate)
        # offs[i] is the offset AFTER absorbing sample i; the offset applied
        # at sample i is offs[i-1] (the carried state at i = 0)
        offs = affine_scan(a, x * rate, state)
        offsets = torch.cat([state[..., None], offs[..., :-1]], dim=-1)
        return offs[..., -1].clone(), x - offsets


class Deemphasis(Block):
    """1-pole de-emphasis IIR: y[i] = a*x[i] + (1-a)*y[i-1], a = dt/(tau+dt)
    (reference: core/src/dsp/filter/deephasis.h:60-83). Mono shape [..., n]
    or stereo [..., n, 2] (pass stereo=True)."""

    def __init__(self, tau: float, samplerate: float, stereo: bool = False,
                 lead_shape=(), *, device):
        dt = 1.0 / float(samplerate)
        self.alpha = np.float32(dt / (float(tau) + dt))
        self.stereo = stereo
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def init_state(self):
        shape = (*self.lead_shape, 2) if self.stereo else self.lead_shape
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def __call__(self, state, x):
        a = self.alpha
        if self.stereo:
            ys = affine_scan(np.float32(1.0 - a), x.transpose(-1, -2) * float(a),
                             state)
            y = ys.transpose(-1, -2)
            return y[..., -1, :].clone(), y
        y = affine_scan(np.float32(1.0 - a), x * float(a), state)
        return y[..., -1].clone(), y


class AGC(Block):
    """Asymmetric attack/decay AGC with look-ahead clip correction
    (reference: core/src/dsp/loop/agc.h:88-147). The look-ahead suffix max
    is a reversed cummax; the amp/gain recurrence runs in the loop-scan
    kernel (``scans_kernels.agc_gains``). ``enabled=False`` is the manual
    gain: the carried gain, clipped to max_output_amp (agc.h:128-143), the
    state passed through."""

    def __init__(self, set_point: float, attack: float, decay: float,
                 max_gain: float, max_output_amp: float, init_gain: float = 1.0,
                 enabled: bool = True, lead_shape=(), *, device):
        self.set_point = np.float32(set_point)
        self.attack = np.float32(attack)
        self.decay = np.float32(decay)
        self.max_gain = np.float32(max_gain)
        self.max_output_amp = np.float32(max_output_amp)
        self.init_gain = np.float32(init_gain)
        self.enabled = bool(enabled)
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def init_state(self):
        amp = torch.full(self.lead_shape, float(self.set_point / self.init_gain),
                         dtype=torch.float32, device=self.device)
        gain = torch.full(self.lead_shape,
                          float(np.minimum(self.init_gain, self.max_gain)),
                          dtype=torch.float32, device=self.device)
        return {"amp": amp, "gain": gain}

    def __call__(self, state, x):
        from .scans_kernels import agc_gains, suffix_max

        in_amp = torch.abs(x)
        if not self.enabled:
            g = state["gain"][..., None]
            safe_amp = torch.where(in_amp == 0.0, 1.0, in_amp)
            # a tensor numerator keeps max_out / amp an IEEE division
            limit = torch.full_like(safe_amp, float(self.max_output_amp))
            return state, torch.where(in_amp * g > float(self.max_output_amp),
                                      x * (limit / safe_amp), x * g)
        gains, amp_f, gain_f = agc_gains(
            in_amp, suffix_max(in_amp), state["amp"], state["gain"],
            self.set_point, self.attack, self.decay, self.max_gain,
            self.max_output_amp)
        return {"amp": amp_f, "gain": gain_f}, x * gains


def _critically_damped(bandwidth: float) -> tuple[np.float32, np.float32]:
    """Alpha/beta from loop bandwidth
    (reference: core/src/dsp/loop/phase_control_loop.h:31-36)."""
    zeta = np.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * zeta * bandwidth + bandwidth * bandwidth
    alpha = (4.0 * zeta * bandwidth) / denom
    beta = (4.0 * bandwidth * bandwidth) / denom
    return np.float32(alpha), np.float32(beta)


class PLL(Block):
    """Carrier-tracking PLL emitting the VCO phasor
    (reference: core/src/dsp/loop/pll.h:64-70): out[i] = phasor(phase);
    advance(normalize(angle(in[i]) - phase)). The recurrence runs in the
    loop-scan kernel (``scans_kernels.pll_phases``)."""

    def __init__(self, bandwidth: float, init_phase: float = 0.0,
                 init_freq: float = 0.0, min_freq: float = -float(FL_PI),
                 max_freq: float = float(FL_PI), lead_shape=(), *, device):
        self.alpha, self.beta = _critically_damped(bandwidth)
        self.init_phase = np.float32(init_phase)
        self.init_freq = np.float32(init_freq)
        self.min_freq = np.float32(min_freq)
        self.max_freq = np.float32(max_freq)
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def init_state(self):
        def full(v):
            return torch.full(self.lead_shape, float(v), dtype=torch.float32,
                              device=self.device)

        return {"phase": full(self.init_phase), "freq": full(self.init_freq)}

    def __call__(self, state, x):
        from .scans_kernels import pll_phases

        in_phase = torch.atan2(x.imag, x.real)
        out_phases, phase_f, freq_f = pll_phases(
            in_phase, state["phase"], state["freq"], self.alpha, self.beta,
            self.min_freq, self.max_freq)
        y = torch.complex(torch.cos(out_phases), torch.sin(out_phases))
        return {"phase": phase_f, "freq": freq_f}, y


class CarrierTrackingPLL(PLL):
    """PLL that outputs the mixed-down signal instead of the VCO
    (reference: core/src/dsp/loop/carrier_tracking_pll.h:14-19), the
    counterpart of the JAX package's (scans.py:447): out[i] = in[i] *
    phasor(-phase); advance(normalize(angle(in[i]) - phase)). The exact
    recurrence runs in the loop-scan kernel's PLL body (single_scan on one
    stream, lane_scan over a lead shape's lanes), which emits the phases
    before each update; the mix is applied here, vectorized."""

    def __call__(self, state, x):
        from .scans_kernels import pll_phases

        in_phase = torch.atan2(x.imag, x.real)
        phases, phase_f, freq_f = pll_phases(
            in_phase, state["phase"], state["freq"], self.alpha, self.beta,
            self.min_freq, self.max_freq)
        out = x * torch.complex(torch.cos(-phases), torch.sin(-phases))
        return {"phase": phase_f, "freq": freq_f}, out


class FastAGC(Block):
    """Per-sample integrating AGC: out = in*gain; gain += (setPoint -
    |out|)*rate, clamped to maxGain (reference:
    core/src/dsp/loop/fast_agc.h:62-88). The state is the gain itself, as
    in the JAX block. The recurrence runs in the loop-scan kernel
    (``scans_kernels.fast_agc_gains``)."""

    def __init__(self, set_point: float, max_gain: float, rate: float,
                 init_gain: float = 1.0, lead_shape=(), *, device):
        self.set_point = np.float32(set_point)
        self.max_gain = np.float32(max_gain)
        self.rate = np.float32(rate)
        self.init_gain = np.float32(init_gain)
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def init_state(self):
        return torch.full(self.lead_shape, float(self.init_gain),
                          dtype=torch.float32, device=self.device)

    def __call__(self, state, x):
        from .scans_kernels import fast_agc_gains

        gains, gain_f = fast_agc_gains(torch.abs(x), state, self.set_point,
                                       self.max_gain, self.rate)
        return gain_f, x * gains


class Costas(Block):
    """Costas loop of order 2/4/8 (reference: core/src/dsp/loop/costas.h:6-46):
    out[i] = in[i]*phasor(-phase); advance(error(out[i])), or "meteor",
    the QPSK loop with Meteor M2-x's broken-modulation error
    (meteor_costas.h:36-56). The recurrence runs in the loop-scan kernel
    (``scans_kernels.costas_phases``), which emits the phases; the
    rotation is applied here, vectorized."""

    def __init__(self, order: int, bandwidth: float, init_phase: float = 0.0,
                 init_freq: float = 0.0, min_freq: float = -float(FL_PI),
                 max_freq: float = float(FL_PI), lead_shape=(), *, device):
        if order not in (2, 4, 8, "meteor"):
            raise ValueError(f"invalid costas order {order}")
        self.order = order
        self.alpha, self.beta = _critically_damped(bandwidth)
        self.init_phase = np.float32(init_phase)
        self.init_freq = np.float32(init_freq)
        self.min_freq = np.float32(min_freq)
        self.max_freq = np.float32(max_freq)
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def init_state(self):
        def full(v):
            return torch.full(self.lead_shape, float(v), dtype=torch.float32,
                              device=self.device)

        return {"phase": full(self.init_phase), "freq": full(self.init_freq)}

    def __call__(self, state, x):
        from .scans_kernels import costas_phases, rotate_back

        out_phases, phase_f, freq_f = costas_phases(
            x.real, x.imag, state["phase"], state["freq"], self.order,
            self.alpha, self.beta, self.min_freq, self.max_freq)
        return {"phase": phase_f, "freq": freq_f}, rotate_back(x, out_phases)


class NoiseBlanker(Block):
    """Running-mean amplitude limiter (reference:
    core/src/dsp/noise_reduction/noise_blanker.h:41-62): amp tracks |x|
    with a 1-pole average, held over zero samples; the gain is 1/excess
    where excess = |x|/amp exceeds ``level``. The average is ``affine_scan``
    over the nonzero samples (a = 1 - rate), scattered to the front of the
    block by their running count, then read back at each sample's count:
    a zero holds the mean of the nonzero sample before it (the state
    before the first). State: the tracked amplitude."""

    def __init__(self, rate: float, level: float, lead_shape=(), *, device):
        self.rate = np.float32(rate)
        self.level = np.float32(level)
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def init_state(self):
        return torch.ones(self.lead_shape, dtype=torch.float32,
                          device=self.device)

    def amps(self, state, in_amp):
        """The tracked amplitude after each sample of ``in_amp`` (|x|)."""
        n = in_amp.shape[-1]
        nonzero = in_amp != 0.0
        k = torch.cumsum(nonzero, dim=-1) - 1  # nonzero samples up to i, - 1
        b = torch.zeros((*in_amp.shape[:-1], n + 1), dtype=torch.float32,
                        device=in_amp.device)
        # the nonzero samples' terms packed in order; zeros write slot n
        b.scatter_(-1, torch.where(nonzero, k, n), in_amp * float(self.rate))
        ys = affine_scan(np.float32(1.0) - self.rate, b[..., :n], state)
        held = torch.gather(ys, -1, k.clamp(min=0))
        return torch.where(k >= 0, held, state[..., None])

    def __call__(self, state, x):
        in_amp = torch.abs(x)
        nonzero = in_amp != 0.0
        amps = self.amps(state, in_amp)
        excess = in_amp / amps
        gain = torch.where(nonzero & (excess > float(self.level)),
                           torch.reciprocal(excess), 1.0)
        return amps[..., -1].clone(), x * gain


class Squelch(Block):
    """Block-mean-power squelch with hysteresis + unmute confirmation
    (reference: core/src/dsp/noise_reduction/squelch.h:32-61): block level =
    20*log10(mean |x|); mute when level < threshold-1dB; unmute only after 10
    consecutive above-threshold blocks. The input block is split into
    ``sub_blocks`` frames and the state machine steps once per frame."""

    def __init__(self, level_db: float, sub_blocks: int = 1, lead_shape=(),
                 *, device):
        self.level = np.float32(level_db)
        self.sub_blocks = int(sub_blocks)
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def init_state(self):
        return {
            "mute": torch.zeros(self.lead_shape, dtype=torch.bool,
                                device=self.device),
            "cnt": torch.zeros(self.lead_shape, dtype=torch.int32,
                               device=self.device),
            "level": torch.full((), float(self.level), dtype=torch.float32,
                                device=self.device),
        }

    def set_level_state(self, state, level_db: float):
        """New state with the threshold changed: a write, not a rebuild
        (the reference's runtime setLevel, squelch.h:63-66)."""
        return dict(state, level=torch.full((), float(np.float32(level_db)),
                                            dtype=torch.float32,
                                            device=state["level"].device))

    def __call__(self, state, x):
        n = x.shape[-1]
        sb = self.sub_blocks
        if n % sb:
            raise ValueError(f"block length {n} must be a multiple of {sb}")
        thresh = state["level"]
        frames = x.reshape(*x.shape[:-1], sb, n // sb)
        mean_amp = torch.mean(torch.abs(frames), dim=-1)  # [..., sb]
        level = 20.0 * torch.log10(torch.clamp(mean_amp, min=1e-20))
        mute, cnt = state["mute"], state["cnt"]
        mutes = []
        for k in range(sb):
            lv = level[..., k]
            below = lv < thresh
            # muted branch (squelch.h:40-47)
            cnt_m = torch.where(below | (cnt <= 0), 10, cnt - 1).to(torch.int32)
            unmute = (~below) & (cnt > 0) & (cnt_m == 0)
            # unmuted branch: hysteresis 1 dB (squelch.h:48-53)
            mute_u = lv < (thresh - 1.0)
            cnt_u = torch.where(mute_u, 0, cnt).to(torch.int32)
            mute, cnt = (torch.where(mute, ~unmute, mute_u),
                         torch.where(mute, cnt_m, cnt_u))
            mutes.append(mute)
        mutes = torch.stack(mutes, dim=-1)  # [..., sb]
        # select, not multiply: the reference memsets muted blocks to +0
        zero = torch.zeros((), dtype=frames.dtype, device=frames.device)
        y = torch.where(mutes[..., None], zero, frames).reshape(x.shape)
        return {"mute": mute, "cnt": cnt, "level": thresh}, y
