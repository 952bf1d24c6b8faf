"""Multirate: power-of-2 decimation cascade + polyphase rational resampling.

The counterpart of ``sdrpp_tpu.ops.resample`` (reference:
core/src/dsp/multirate/power_decimator.h, polyphase_resampler.h:75-92,
rational_resampler.h). Interp/decim are static configuration and block
lengths are a multiple of ``decim``, so the resampler's phase pattern is
the same in every block.

The power-of-2 pre-decimator uses the reference's stage plans and
coefficient tables (``decim_taps.npz``, a copy of the JAX package's). Its
stages with r >= 8 (the JAX package's Pallas decimator's domain) run the
decimating-FIR kernel ``fir_kernels.decimating_fir`` on every device: on a
CUDA tensor the hand-written kernel, on a CPU tensor its plain version.
Stages with r < 8 are one strided ``conv1d``, as the JAX package leaves
them to XLA.

The JAX package picks a zero-stuffed, a grouped or a gathered polyphase
form by backend; the port runs one form on every device: the grouped form
as ONE strided ``conv1d`` whose ``interp`` output channels are the phase
groups (outputs k = m*interp + r share phase bank[(r*decim) % interp] and
advance by exactly ``decim`` input samples), interleaved afterwards.
Complex taps double the channels (the banks' real parts, then their
imaginary parts), combined as re + j im.

``FFTPowerDecimator`` is the cascade's equivalent wideband filter
(``equivalent_decim_taps``) applied in the frequency domain on
``torch.fft`` (cuFFT on the card): overlap-save segments, one batched FFT,
the alias fold to the output rate and the stride-phase ramp baked into
the tap spectrum, as the JAX package's (resample.py:135).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from ..utils.blocks import Block
from .fir import combine_planes, decimating_fir_correlate, fir_init_tail, \
    strided_correlate, tap_weight
from .fir_kernels import decimating_fir
from .taps import low_pass, root_raised_cosine_rate

__all__ = [
    "decim_plan",
    "build_polyphase_bank",
    "equivalent_decim_taps",
    "FFTPowerDecimator",
    "PowerDecimator",
    "PolyphaseResampler",
    "RationalResampler",
    "RRCInterpolator",
    "plan_rational_resampler",
]

_DECIM_NPZ = Path(__file__).parent / "decim_taps.npz"


@functools.lru_cache(maxsize=None)
def _decim_tables():
    with np.load(_DECIM_NPZ, allow_pickle=False) as z:
        return dict(z)


def decim_plan(ratio: int) -> list[tuple[int, np.ndarray]]:
    """Stage plan [(decimation, taps), ...] for a power-of-2 ratio
    (reference: decim/plans.h:37-141)."""
    tables = _decim_tables()
    key = f"plan_{ratio}_decim"
    if key not in tables:
        raise ValueError(f"unsupported power-of-2 decimation ratio {ratio}")
    decims = tables[key]
    names = str(tables[f"plan_{ratio}_names"]).split("|")
    return [(int(d), tables[n]) for d, n in zip(decims, names)]


def max_power_decim_ratio() -> int:
    return 8192  # 2^13 (reference: power_decimator.h:31-33)


class PowerDecimator(Block):
    """Cascaded half/quarter-band FIR power-of-2 decimator
    (reference: core/src/dsp/multirate/power_decimator.h:8-119).

    Input block length must be a multiple of ``ratio``."""

    def __init__(self, ratio: int, dtype=torch.complex64, lead_shape=(), *,
                 device):
        if not (1 <= ratio <= max_power_decim_ratio()
                and (ratio & (ratio - 1)) == 0):
            raise ValueError(f"decimation ratio {ratio} is not a power of 2 "
                             f"in [1, {max_power_decim_ratio()}]")
        self.ratio = int(ratio)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)
        self.stages = decim_plan(ratio) if ratio > 1 else []
        # r >= 8: the taps as an [m] vector for the kernel; else a
        # [1, 1, m] conv1d weight
        self._weights = [tap_weight(t, self.device).reshape(-1) if r >= 8
                         else tap_weight(t, self.device)
                         for r, t in self.stages]

    def init_state(self):
        return tuple(fir_init_tail(taps.shape[0], self.dtype, self.lead_shape,
                                   device=self.device)
                     for _, taps in self.stages)

    def __call__(self, state, x):
        if self.ratio == 1:
            return state, x
        new_states = []
        for (r, taps), w, tail in zip(self.stages, self._weights, state):
            if r >= 8:
                tail, x = decimating_fir(tail, x, w, r)
            else:
                tail, x = decimating_fir_correlate(tail, x, taps, r, w)
            new_states.append(tail)
        return tuple(new_states), x


def equivalent_decim_taps(ratio: int) -> np.ndarray:
    """The cascade of ``decim_plan(ratio)`` as ONE wideband filter: each
    stage is a strided correlation, and composing two convolves their tap
    sequences, the inner stage's taps zero-stuffed by the decimation
    before it, h = t1 (*) t2^(D1) (*) t3^(D1*D2) ... (the /256 plan
    collapses to 9679 taps). Host float64, returned as float32."""
    h = np.ones(1, np.float64)
    cum = 1
    for r, t in decim_plan(ratio):
        up = np.zeros((t.shape[0] - 1) * cum + 1, np.float64)
        up[::cum] = t.astype(np.float64)
        h = np.convolve(h, up)
        cum *= r
    return h.astype(np.float32)


class FFTPowerDecimator(Block):
    """Power-of-2 decimation as one batched FFT (the JAX package's
    FFTPowerDecimator, resample.py:135): the cascade's exact equivalent
    filter (``equivalent_decim_taps``) in the frequency domain. A block is
    cut into overlap-save frames of ``fft_len`` samples (a payload of
    ``fft_len - pad`` new samples, pad the smallest multiple of ratio x
    out_multiple covering the taps' tail), one batched FFT covers them
    all, the spectrum times the taps' spectrum with the stride-phase ramp
    e^{2 pi i f (m - 1) / F} folds onto F / ratio bins, and an inverse FFT
    at the output rate gives y[k] = sum_j h[j] buf[ratio k + j]
    (decimating_fir.h:55-66). Block lengths must be a multiple of
    ``block_multiple`` (the payload). State and output match
    ``PowerDecimator`` to float32 rounding.

    The constructor refuses an ``fft_len`` that is not a multiple of
    ratio x out_multiple, with which the fold's reshape fails (or the
    output alignment is silently lost); the JAX class accepts it and
    fails later with a reshape error."""

    def __init__(self, ratio: int, dtype=torch.complex64, lead_shape=(),
                 fft_len: int = 1 << 20, out_multiple: int = 1, *, device):
        if not (2 <= ratio <= max_power_decim_ratio()
                and (ratio & (ratio - 1)) == 0):
            raise ValueError(f"decimation ratio {ratio} is not a power of 2 "
                             f"in [2, {max_power_decim_ratio()}]")
        self.ratio = int(ratio)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)
        self.taps = equivalent_decim_taps(ratio)
        m = self.taps.shape[0]
        q = self.ratio * int(out_multiple)
        self.fft_len = F = int(fft_len)
        if F % q:
            raise ValueError(f"fft_len {F} must be a multiple of ratio x "
                             f"out_multiple = {q}")
        pad = -(-(m - 1) // q) * q
        if F < pad + q:
            raise ValueError(f"fft_len {F} too small for {m} taps")
        self.payload = F - pad
        self.block_multiple = self.payload
        rev = np.zeros(F, np.complex128)
        rev[:m] = self.taps[::-1].astype(np.float64)
        ramp = np.exp(2j * np.pi * np.arange(F) * (m - 1) / F)
        self._spec = torch.from_numpy(
            (np.fft.fft(rev) * ramp).astype(np.complex64)).to(self.device)

    def init_state(self):
        return fir_init_tail(self.taps.shape[0], self.dtype, self.lead_shape,
                             device=self.device)

    def __call__(self, state, x):
        n = x.shape[-1]
        if n % self.payload:
            raise ValueError(f"block length {n} must be a multiple of "
                             f"{self.payload}")
        segs = n // self.payload
        m = self.taps.shape[0]
        r, F = self.ratio, self.fft_len
        M = F // r
        buf = torch.cat([state, x], dim=-1)  # [..., n + m - 1]
        frames = buf.unfold(-1, self.payload + m - 1, self.payload)
        Z = torch.fft.fft(frames.to(torch.complex64), n=F, dim=-1) \
            * self._spec
        fold = Z.reshape(*Z.shape[:-1], r, M).sum(dim=-2)
        z = torch.fft.ifft(fold, dim=-1) * np.float32(M / F)
        y = z[..., :self.payload // r].reshape(
            *x.shape[:-1], segs * (self.payload // r))
        if not x.is_complex():
            y = y.real
        return buf[..., n:].clone(), y.to(x.dtype)


def build_polyphase_bank(taps: np.ndarray, interp: int) -> np.ndarray:
    """Split taps into interp phases, reference layout
    (core/src/dsp/multirate/polyphase_bank.h:25-45):
    bank[(interp-1) - (i % interp)][i // interp] = taps[i], zero-padded."""
    taps = np.asarray(taps)
    tpp = (taps.shape[0] + interp - 1) // interp
    bank = np.zeros((interp, tpp), dtype=taps.dtype)
    for i in range(interp * tpp):
        v = taps[i] if i < taps.shape[0] else 0
        bank[(interp - 1) - (i % interp), i // interp] = v
    return bank


class PolyphaseResampler(Block):
    """L/M rational resampler (reference: polyphase_resampler.h:8-125).

    Output k reads phase ``(k*decim) % interp`` of the bank at input
    offset ``(k*decim) // interp``. Block length must be a multiple of
    ``decim``. State: the last tpp-1 input samples.
    """

    def __init__(self, interp: int, decim: int, taps: np.ndarray,
                 dtype=torch.complex64, lead_shape=(), *, device):
        self.interp = int(interp)
        self.decim = int(decim)
        self._taps = np.asarray(taps)
        self.bank = build_polyphase_bank(self._taps, self.interp)
        self.tpp = self.bank.shape[1]
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)
        # group r (outputs k = m*interp + r) starts at input offset
        # (r*decim)//interp < decim with phase (r*decim) % interp: its taps
        # sit at that offset inside one [interp, 1, tpp + max offset]
        # kernel; complex taps stack the imaginary parts' kernel after it
        i, d, tpp = self.interp, self.decim, self.tpp
        offs = [(r * d) // i for r in range(i)]
        w = np.zeros((i, 1, tpp + max(offs)), self.bank.dtype)
        for r, off in enumerate(offs):
            w[r, 0, off:off + tpp] = self.bank[(r * d) % i]
        if np.iscomplexobj(w):
            w = np.concatenate([w.real, w.imag])
        self.weight = torch.from_numpy(np.ascontiguousarray(
            w, np.float32)).to(self.device)

    def out_count(self, n: int) -> int:
        if n % self.decim:
            raise ValueError(f"block length {n} must be a multiple of "
                             f"{self.decim}")
        return n * self.interp // self.decim

    def init_state(self):
        return torch.zeros((*self.lead_shape, self.tpp - 1), dtype=self.dtype,
                           device=self.device)

    def __call__(self, state, x):
        n = x.shape[-1]
        out_n = self.out_count(n)
        buf = torch.cat([state, x], dim=-1)
        groups = strided_correlate(buf, self.weight, self.decim,
                                   out_n // self.interp)  # [..., i, m]
        if groups.shape[-2] != self.interp:  # complex taps: [..., 2i, m]
            groups = combine_planes(groups[..., :self.interp, :],
                                    groups[..., self.interp:, :])
        y = groups.transpose(-1, -2).reshape(*buf.shape[:-1], out_n)
        return buf[..., n:].clone(), y


def plan_rational_resampler(in_samplerate: float, out_samplerate: float):
    """Replicates RationalResampler::reconfigure planning math
    (reference: rational_resampler.h:121-167), with the JAX package's
    refinement: the pre-decimator backs off until the intermediate rate is
    integral. Returns a dict plan."""
    pre_power = int(np.floor(np.log2(in_samplerate / out_samplerate))) \
        if in_samplerate > out_samplerate else 0
    pre_power = min(pre_power, max_power_decim_ratio())
    while pre_power > 0 and (in_samplerate / (1 << pre_power)) % 1.0 != 0.0:
        pre_power -= 1
    pre_ratio = min(1 << max(pre_power, 0), max_power_decim_ratio())
    use_decim = in_samplerate > out_samplerate and pre_power > 0
    int_samplerate = in_samplerate / pre_ratio if use_decim else in_samplerate

    int_sr = int(round(int_samplerate))
    out_sr = int(round(out_samplerate))
    g = np.gcd(int_sr, out_sr)
    interp = out_sr // g
    decim = int_sr // g

    actual_out = int_sr * interp / decim
    error = abs((actual_out - out_samplerate) / out_samplerate) * 100.0
    plan = {
        "pre_ratio": pre_ratio if use_decim else 1,
        "interp": interp,
        "decim": decim,
        "error_pct": error,
        "use_resamp": interp != decim,
        "taps": None,
    }
    if interp != decim:
        tap_samplerate = int_samplerate * interp
        tap_bandwidth = min(in_samplerate, out_samplerate) / 2.0
        taps = low_pass(tap_bandwidth, tap_bandwidth * 0.1, tap_samplerate)
        plan["taps"] = (taps * np.float32(interp)).astype(np.float32)
    return plan


class RationalResampler(Block):
    """Arbitrary-rate resampler: power-of-2 pre-decimator + gcd-planned
    polyphase stage (reference: rational_resampler.h:14-175).

    ``block_multiple`` is the required input block-length multiple
    (pre_ratio * decim).
    """

    def __init__(self, in_samplerate: float, out_samplerate: float,
                 dtype=torch.complex64, lead_shape=(), *, device):
        self.in_samplerate = float(in_samplerate)
        self.out_samplerate = float(out_samplerate)
        self.dtype = dtype
        p = plan_rational_resampler(in_samplerate, out_samplerate)
        self.plan = p
        self.pre = PowerDecimator(p["pre_ratio"], dtype=dtype,
                                  lead_shape=lead_shape, device=device)
        self.resamp = (PolyphaseResampler(p["interp"], p["decim"], p["taps"],
                                          dtype=dtype, lead_shape=lead_shape,
                                          device=device)
                       if p["use_resamp"] else None)
        self.block_multiple = p["pre_ratio"] * (p["decim"] if p["use_resamp"] else 1)

    def out_count(self, n: int) -> int:
        if n % self.block_multiple:
            raise ValueError(f"block length {n} must be a multiple of "
                             f"{self.block_multiple}")
        m = n // self.plan["pre_ratio"]
        if self.resamp is not None:
            m = m * self.plan["interp"] // self.plan["decim"]
        return m

    def init_state(self):
        return {
            "pre": self.pre.init_state(),
            "resamp": self.resamp.init_state() if self.resamp else (),
        }

    def __call__(self, state, x):
        if x.shape[-1] % self.block_multiple:
            raise ValueError(
                f"RationalResampler({self.in_samplerate:g}->{self.out_samplerate:g}) "
                f"needs block length a multiple of {self.block_multiple}, got {x.shape[-1]}")
        pre_state, x = self.pre(state["pre"], x)
        if self.resamp is not None:
            resamp_state, x = self.resamp(state["resamp"], x)
        else:
            resamp_state = ()
        return {"pre": pre_state, "resamp": resamp_state}, x


class RRCInterpolator(Block):
    """RRC-filtered symbol interpolator (transmit pulse shaping; M17 uses
    it), the counterpart of the JAX package's (resample.py:465).

    Reference: core/src/dsp/multirate/rrc_interpolator.h:15-90, a
    polyphase resampler whose bank is the root-raised-cosine response
    sampled at interp x the symbol rate (gcd-derived interp/decim). Input:
    a symbol-rate stream; output: the sample-rate RRC-shaped waveform.
    Block length must be a multiple of ``decim``.
    """

    def __init__(self, symbolrate: float, samplerate: float, rrc_beta: float,
                 rrc_tap_count: int, dtype=torch.complex64, lead_shape=(), *,
                 device):
        in_sr = int(round(symbolrate))
        out_sr = int(round(samplerate))
        g = np.gcd(in_sr, out_sr)
        interp = out_sr // g
        decim = in_sr // g
        taps = root_raised_cosine_rate(rrc_tap_count * interp, rrc_beta,
                                       symbolrate, symbolrate * interp)
        self.interp, self.decim = interp, decim
        self.resamp = PolyphaseResampler(interp, decim, taps, dtype=dtype,
                                         lead_shape=lead_shape, device=device)
        self.block_multiple = decim

    def out_count(self, n: int) -> int:
        return self.resamp.out_count(n)

    def init_state(self):
        return self.resamp.init_state()

    def __call__(self, state, x):
        return self.resamp(state, x)
