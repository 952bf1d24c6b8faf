"""Digital demodulators: PSK, GFSK, Meteor LRPT (QPSK/OQPSK).

The counterpart of ``sdrpp_tpu.models.digital``. Reference chains:

- PSK<N>: RRC FIR -> FastAGC -> Costas<N> -> MM complex
  (core/src/dsp/demod/psk.h:25-44,135-147)
- GFSK: Quadrature -> RRC FIR -> MM float
  (core/src/dsp/demod/gfsk.h:24-41,131-136)
- Meteor: RRC -> FastAGC -> MeteorCostas (the Costas loop with the
  optional "broken modulation" 4-phase error) -> optional OQPSK Q
  one-sample delay -> MM complex
  (decoder_modules/meteor_demodulator/src/meteor_demod.h:24-45, 150-167,
  meteor_costas.h:24-56)

FastAGC, Costas and the MM are the chunk-parallel blocks of
``ops.scans_kernels`` and ``ops.clock_recovery_chunked`` (chunked for long
1-D blocks, exact otherwise or under SDRPP_TPU_LOOPS=exact, as the JAX
package decides on its accelerator). Output: (symbols[max_syms],
valid[max_syms]), ``valid`` a mask over the symbols (a prefix when the MM
ran exact); consumers boolean-index.
"""

from __future__ import annotations

import torch

from ..ops import taps as taps_mod
from ..ops.clock_recovery_chunked import MMClockRecoveryChunked
from ..ops.fir import FIR
from ..ops.fm import Quadrature
from ..ops.scans import FL_PI, _critically_damped
from ..ops.scans_kernels import (METEOR_PHASES, CostasChunked, FastAGCChunked,
                                 loop_time_constant, settled_warmup)
from ..utils.blocks import Block

__all__ = ["PSKDemod", "GFSKDemod", "MeteorCostas", "MeteorDemod"]


class PSKDemod(Block):
    """BPSK/QPSK/8PSK demodulator (reference psk.h). Its chunked loops
    warm up over four of their time constants (``settled_warmup``: the
    FastAGC's 1 / agc_rate, the Costas loop's 2 / alpha), at least the JAX
    package's 1024 and 512 samples, and a loop whose warm-up no lane of a
    block holds runs exact. The JAX package's fixed warm-ups leave HRPT's
    lanes unsettled (its FastAGC's 1 / rate is 50,000 samples, its Costas
    loop's 2 / alpha 394) and lose words in noise."""

    def __init__(self, order: int, symbolrate: float, samplerate: float,
                 rrc_tap_count: int = 31, rrc_beta: float = 0.35,
                 agc_rate: float = 0.001, costas_bandwidth: float = 0.01,
                 omega_gain: float = 0.001, mu_gain: float = 0.01,
                 omega_rel_limit: float = 0.01, *, device):
        self.device = torch.device(device)
        rrc_taps = taps_mod.root_raised_cosine_rate(rrc_tap_count, rrc_beta,
                                                    symbolrate, samplerate)
        self.rrc = FIR(rrc_taps, dtype=torch.complex64, device=device)
        self.agc = FastAGCChunked(
            1.0, 10e6, agc_rate, warmup=settled_warmup(1.0 / agc_rate, 1024),
            device=device)
        alpha = _critically_damped(costas_bandwidth)[0]
        self.costas = CostasChunked(
            order, costas_bandwidth,
            warmup=settled_warmup(loop_time_constant(alpha), 512),
            device=device)
        self.recov = MMClockRecoveryChunked(
            samplerate / symbolrate, omega_gain, mu_gain, omega_rel_limit,
            complex_input=True, device=device)

    def max_symbols(self, n: int) -> int:
        return self.recov.max_symbols(n)

    def init_state(self):
        return {"rrc": self.rrc.init_state(), "agc": self.agc.init_state(),
                "costas": self.costas.init_state(),
                "recov": self.recov.init_state()}

    def __call__(self, state, x):
        rs, y = self.rrc(state["rrc"], x)
        ags, y = self.agc(state["agc"], y)
        cs, y = self.costas(state["costas"], y)
        ms, out = self.recov(state["recov"], y)
        return {"rrc": rs, "agc": ags, "costas": cs, "recov": ms}, out


class GFSKDemod(Block):
    """GFSK demodulator (reference gfsk.h): FM discriminator -> RRC -> MM."""

    def __init__(self, symbolrate: float, samplerate: float, deviation: float,
                 rrc_tap_count: int = 31, rrc_beta: float = 0.35,
                 omega_gain: float = 0.001, mu_gain: float = 0.01,
                 omega_rel_limit: float = 0.01, *, device):
        self.device = torch.device(device)
        self.demod = Quadrature(deviation, samplerate, device=device)
        rrc_taps = taps_mod.root_raised_cosine_rate(rrc_tap_count, rrc_beta,
                                                    symbolrate, samplerate)
        self.rrc = FIR(rrc_taps, dtype=torch.float32, device=device)
        self.recov = MMClockRecoveryChunked(
            samplerate / symbolrate, omega_gain, mu_gain, omega_rel_limit,
            complex_input=False, device=device)

    def max_symbols(self, n: int) -> int:
        return self.recov.max_symbols(n)

    def init_state(self):
        return {"demod": self.demod.init_state(),
                "rrc": self.rrc.init_state(),
                "recov": self.recov.init_state()}

    def __call__(self, state, x):
        ds, y = self.demod(state["demod"], x)
        rs, y = self.rrc(state["rrc"], y)
        ms, out = self.recov(state["recov"], y)
        return {"demod": ds, "rrc": rs, "recov": ms}, out


class MeteorCostas(CostasChunked):
    """The Meteor Costas block (sdrpp_tpu/models/digital.py:108, reference
    meteor_costas.h:24-56): the QPSK loop, or with ``broken_modulation``
    the loop whose error is the distance to the nearest of the four
    ``PHASES`` scaled by amplitude. ``CostasChunked`` of order 4 or
    "meteor" with the JAX block's defaults: a warm-up of 1024 samples,
    about 14 loop time constants at the meteor module's 0.005 bandwidth,
    and at most 512 lanes; chunk-parallel (B1) on long blocks, exact (B2)
    on short ones."""

    PHASES = METEOR_PHASES

    def __init__(self, bandwidth: float, broken_modulation: bool = False,
                 init_phase: float = 0.0, init_freq: float = 0.0,
                 min_freq: float = -float(FL_PI),
                 max_freq: float = float(FL_PI), warmup: int = 1024,
                 max_lanes: int = 512, *, device):
        self.broken = bool(broken_modulation)
        super().__init__("meteor" if self.broken else 4, bandwidth,
                         init_phase, init_freq, min_freq, max_freq,
                         warmup=warmup, max_lanes=max_lanes, device=device)


class MeteorDemod(Block):
    """Meteor M2 LRPT demodulator: RRC -> FastAGC -> MeteorCostas -> [OQPSK
    Q-delay] -> MM complex (reference meteor_demod.h:150-167)."""

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
