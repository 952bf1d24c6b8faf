"""Digital demodulators: Meteor LRPT (QPSK/OQPSK).

The counterpart of ``sdrpp_tpu.models.digital`` (reference chain: RRC ->
FastAGC -> MeteorCostas (QPSK with the optional "broken modulation"
4-phase error) -> optional OQPSK Q one-sample delay -> MM complex;
decoder_modules/meteor_demodulator/src/meteor_demod.h:24-45, 150-167,
meteor_costas.h:24-56). Output: (symbols[max_syms], valid[max_syms]), the
valid symbols a prefix. ``PSKDemod`` and ``GFSKDemod`` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import taps as taps_mod
from ..ops.clock_recovery_kernels import MMClockRecoveryChunked
from ..ops.fir import FIR
from ..ops.scans import FL_PI, _critically_damped
from ..ops.scans_kernels import (FastAGCChunked, METEOR_PHASES,
                                 _chunk_lanes_for, costas_phases,
                                 costas_phases_chunked, costas_streams,
                                 rotate_back)
from ..utils.blocks import Block

__all__ = ["MeteorCostas", "MeteorDemod"]


class MeteorCostas(Block):
    """QPSK Costas with the Meteor M2-x "broken modulation" error option
    (reference meteor_costas.h:36-56): error = the distance to the nearest
    of 4 fixed constellation phases, scaled by amplitude; otherwise the
    order-4 Costas error. One [n] stream. Chunk-parallel (K lanes, each
    warming up over ``warmup`` samples) when ``_chunk_lanes_for`` says so,
    exact otherwise; both run the loop-scan kernel's Costas body. State:
    phase, freq and the ``hist_re``/``hist_im`` warm-up history."""

    PHASES = METEOR_PHASES

    def __init__(self, bandwidth: float, broken_modulation: bool = False,
                 init_phase: float = 0.0, init_freq: float = 0.0,
                 min_freq: float = -float(FL_PI),
                 max_freq: float = float(FL_PI), warmup: int = 1024,
                 max_lanes: int = 512, *, device):
        self.alpha, self.beta = _critically_damped(bandwidth)
        self.broken = broken_modulation
        self.init_phase = np.float32(init_phase)
        self.init_freq = np.float32(init_freq)
        self.min_freq = np.float32(min_freq)
        self.max_freq = np.float32(max_freq)
        # default warm-up 1024 ~= 14 loop time constants at the meteor
        # module's 0.005 bandwidth
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)
        self.device = torch.device(device)

    def init_state(self):
        # synthetic chunk-warm-up history: a locked constellation point
        # (PHASES[0] for broken modulation, pi/4 for plain QPSK, both
        # zero-error) riding the configured (init_phase, init_freq)
        pi, two_pi = float(FL_PI), float(np.float32(2.0) * FL_PI)
        t = torch.arange(self.warmup, dtype=torch.float32,
                         device=self.device) - float(self.warmup)
        off = float(np.float32(self.PHASES[0] if self.broken
                               else FL_PI / 4.0))
        ramp = float(self.init_phase) + float(self.init_freq) * t + off
        ramp = torch.remainder(ramp + pi, two_pi) - pi

        def scalar(v):
            return torch.full((), float(v), dtype=torch.float32,
                              device=self.device)

        return {"phase": scalar(self.init_phase),
                "freq": scalar(self.init_freq),
                "hist_re": torch.cos(ramp), "hist_im": torch.sin(ramp)}

    def __call__(self, state, x):
        if x.ndim != 1:
            raise ValueError("MeteorCostas runs on one [n] stream")
        order = "meteor" if self.broken else 4
        k = _chunk_lanes_for(x.shape[-1], self.warmup, self.max_lanes)
        if k >= 1:
            s1, s2 = costas_streams(x.real, x.imag, order)
            h1, h2 = costas_streams(state["hist_re"], state["hist_im"], order)
            out_phases, _, _, ph, fr = costas_phases_chunked(
                s1, s2, h1, h2, state["phase"], state["freq"], order,
                self.alpha, self.beta, self.min_freq, self.max_freq,
                lanes_k=k)
        else:
            out_phases, ph, fr = costas_phases(
                x.real, x.imag, state["phase"], state["freq"], order,
                self.alpha, self.beta, self.min_freq, self.max_freq)

        def hist(h, s):
            return torch.cat([h, s.float()])[-self.warmup:]

        return {"phase": ph, "freq": fr,
                "hist_re": hist(state["hist_re"], x.real),
                "hist_im": hist(state["hist_im"], x.imag)}, \
            rotate_back(x, out_phases)


class MeteorDemod(Block):
    """Meteor M2 LRPT demodulator: RRC -> FastAGC -> MeteorCostas ->
    [OQPSK Q-delay] -> MM complex (reference meteor_demod.h:150-167)."""

    def __init__(self, symbolrate: float = 72000.0,
                 samplerate: float = 150000.0, rrc_tap_count: int = 31,
                 rrc_beta: float = 0.35, agc_rate: float = 0.001,
                 costas_bandwidth: float = 0.005,
                 broken_modulation: bool = False, oqpsk: bool = False,
                 omega_gain: float = 0.001, mu_gain: float = 0.01,
                 omega_rel_limit: float = 0.01, *, device):
        self.device = torch.device(device)
        rrc_taps = taps_mod.root_raised_cosine_rate(rrc_tap_count, rrc_beta,
                                                    symbolrate, samplerate)
        self.rrc = FIR(rrc_taps, dtype=torch.complex64, device=device)
        self.agc = FastAGCChunked(1.0, 10e6, agc_rate, device=device)
        self.costas = MeteorCostas(costas_bandwidth, broken_modulation,
                                   device=device)
        self.oqpsk = oqpsk
        self.recov = MMClockRecoveryChunked(
            samplerate / symbolrate, omega_gain, mu_gain, omega_rel_limit,
            complex_input=True, device=device)

    def max_symbols(self, n: int) -> int:
        return self.recov.max_symbols(n)

    def init_state(self):
        st = {"rrc": self.rrc.init_state(), "agc": self.agc.init_state(),
              "costas": self.costas.init_state(),
              "recov": self.recov.init_state()}
        if self.oqpsk:
            st["last_i"] = torch.zeros((), dtype=torch.float32,
                                       device=self.device)
        return st

    def __call__(self, state, x):
        st = dict(state)
        st["rrc"], y = self.rrc(state["rrc"], x)
        st["agc"], y = self.agc(state["agc"], y)
        st["costas"], y = self.costas(state["costas"], y)
        if self.oqpsk:
            # one-sample delay of Q only (meteor_demod.h:155-162)
            im_prev = torch.cat([state["last_i"][None], y.imag[:-1]])
            st["last_i"] = y.imag[-1].clone()
            y = torch.complex(y.real, im_prev)
        st["recov"], out = self.recov(state["recov"], y)
        return st, out
