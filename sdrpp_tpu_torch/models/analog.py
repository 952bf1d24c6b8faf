"""Analog demodulators: AM, SSB/DSB, CW, NFM, WFM (stereo + RDS tap).

The counterpart of ``sdrpp_tpu.models.analog`` (reference:
core/src/dsp/demod/*.h; radio-module defaults from
decoder_modules/radio/src/demodulators/*.h: WFM 240 kHz IF, NFM/USB/LSB/DSB
48 kHz, AM 24 kHz, CW 3 kHz). Audio is float32 [..., n] mono; WFM emits
[..., n, 2] stereo. The loops are the chunk-parallel classes of
``ops.scans_kernels``: exact for short blocks, chunk-parallel for long
ones, by the same rule as the JAX package. Every setting of the JAX
blocks is here: AM's carrier AGC and AGC off, SSB's and CW's manual gain,
NFM's high-pass, WFM mono and its RDS tap, and ``dynamic_bandwidth``,
which puts each bandwidth-dependent piece (deviation, audio taps,
sideband translation) in the state for ``set_bandwidth_state``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import convert, taps
from ..ops.delay import Delay
from ..ops.fir import FIR, RuntimeFIR
from ..ops.fm import Quadrature
from ..ops.mix import DynamicFrequencyXlator, FrequencyXlator, hz_to_rads
from ..ops.resample import RationalResampler
from ..ops.scans import DCBlocker
from ..ops.scans_kernels import AGCChunked as AGC, PLLChunked as PLL
from ..utils.blocks import Block
from ..utils.tracing import annotate

__all__ = ["AMDemod", "SSBDemod", "CWDemod", "NFMDemod", "WFMDemod"]


def _need_dynamic(block):
    if not block.dynamic_bandwidth:
        raise ValueError(f"{type(block).__name__} built without "
                         f"dynamic_bandwidth")


class AMDemod(Block):
    """AM envelope demodulator (reference: core/src/dsp/demod/am.h:10-172).

    Chain: [carrier AGC] -> magnitude -> DC block -> [audio AGC] -> LPF.
    ``agc_mode``: 'off' | 'carrier' | 'audio' (the carrier AGC runs on the
    complex IF's magnitude). Radio-module defaults: IF 24 kHz, bandwidth
    12 kHz, AGC attack 50/fs, decay 5/fs, DC-block rate 100/fs.
    """

    def __init__(self, bandwidth: float = 12000.0, samplerate: float = 24000.0,
                 agc_mode: str = "audio", agc_attack: float = 50.0,
                 agc_decay: float = 5.0, dc_rate: float = 100.0, lead_shape=(),
                 dynamic_bandwidth: bool = False, max_taps: int = 2049, *,
                 device):
        if agc_mode not in ("off", "carrier", "audio"):
            raise ValueError(f"unknown AGC mode {agc_mode!r}")
        self.agc_mode = agc_mode
        self.samplerate = samplerate
        self.dynamic_bandwidth = bool(dynamic_bandwidth)
        self.max_taps = int(max_taps)
        ls = lead_shape
        agc = dict(set_point=1.0, attack=agc_attack / samplerate,
                   decay=agc_decay / samplerate, max_gain=10e6,
                   max_output_amp=10.0, init_gain=float("inf"),
                   lead_shape=ls, device=device)
        self.carrier_agc = AGC(**agc)
        self.audio_agc = AGC(**agc)
        self.dc_block = DCBlocker(dc_rate / samplerate, dtype=torch.float32,
                                  lead_shape=ls, device=device)
        if dynamic_bandwidth:
            self.lpf = RuntimeFIR(self.max_taps, self._lpf_taps(bandwidth),
                                  dtype=torch.float32, lead_shape=ls,
                                  device=device)
        else:
            fw = bandwidth / 2.0
            self.lpf = FIR(taps.low_pass(fw, fw * 0.1, samplerate),
                           dtype=torch.float32, lead_shape=ls, device=device)

    def _lpf_taps(self, bandwidth: float) -> np.ndarray:
        fw = float(bandwidth) / 2.0
        return taps.budget_low_pass(fw, fw * 0.1, self.samplerate,
                                    self.max_taps)

    def set_bandwidth_state(self, state, bandwidth: float):
        """Retarget the audio low-pass (am.h setBandwidth): a tap write."""
        _need_dynamic(self)
        return dict(state, lpf=dict(
            state["lpf"], taps=self.lpf.taps_state(self._lpf_taps(bandwidth))))

    def init_state(self):
        return {
            "carrier_agc": self.carrier_agc.init_state(),
            "audio_agc": self.audio_agc.init_state(),
            "dc": self.dc_block.init_state(),
            "lpf": self.lpf.init_state(),
        }

    def __call__(self, state, x):
        st = dict(state)
        if self.agc_mode == "carrier":
            st["carrier_agc"], x = self.carrier_agc(state["carrier_agc"], x)
        st["dc"], y = self.dc_block(state["dc"], torch.abs(x))
        if self.agc_mode == "audio":
            st["audio_agc"], y = self.audio_agc(state["audio_agc"], y)
        st["lpf"], y = self.lpf(state["lpf"], y)
        return st, y


class SSBDemod(Block):
    """SSB/DSB product demodulator (reference: core/src/dsp/demod/ssb.h:9-134).

    Translate by +bw/2 (USB) / -bw/2 (LSB) / 0 (DSB), take the real part,
    then AGC (``agc_enabled=False``: the manual gain). Radio-module
    defaults: IF 48 kHz, bandwidth 2.7 kHz, AGC attack 50/fs decay 5/fs.
    With ``dynamic_bandwidth`` the translation is state (a dynamic xlator).
    """

    def __init__(self, mode: str = "usb", bandwidth: float = 2700.0,
                 samplerate: float = 48000.0, agc_enabled: bool = True,
                 agc_attack: float = 50.0, agc_decay: float = 5.0,
                 lead_shape=(), dynamic_bandwidth: bool = False, *, device):
        if mode not in ("usb", "lsb", "dsb"):
            raise ValueError(f"unknown sideband mode {mode!r}")
        self.mode = mode
        self.dynamic_bandwidth = bool(dynamic_bandwidth)
        xlator = (DynamicFrequencyXlator if dynamic_bandwidth
                  else FrequencyXlator)
        self.xlator = xlator(self._translation(bandwidth), samplerate,
                             lead_shape=lead_shape, device=device)
        self.agc = AGC(1.0, agc_attack / samplerate, agc_decay / samplerate,
                       10e6, 10.0, float("inf"), enabled=agc_enabled,
                       lead_shape=lead_shape, device=device)

    def _translation(self, bandwidth: float) -> float:
        return {"usb": bandwidth / 2.0, "lsb": -bandwidth / 2.0,
                "dsb": 0.0}[self.mode]

    def set_bandwidth_state(self, state, bandwidth: float):
        """Move the sideband translation: a write of the (hi, lo) pair."""
        _need_dynamic(self)
        return dict(state, xlator=dict(
            state["xlator"],
            **self.xlator.omega_leaves(self._translation(bandwidth))))

    def init_state(self):
        return {"xlator": self.xlator.init_state(), "agc": self.agc.init_state()}

    def __call__(self, state, x):
        xs, x = self.xlator(state["xlator"], x)
        y = convert.complex_to_real(x)
        ags, y = self.agc(state["agc"], y)
        return {"xlator": xs, "agc": ags}, y


class CWDemod(Block):
    """CW demodulator with BFO tone (reference: core/src/dsp/demod/cw.h:9-105).

    Translate by +tone, real part, AGC with maxOutputAmp/initGain = 1.0
    (``agc_enabled=False``: the manual gain). Radio-module defaults: IF
    3 kHz, tone 800 Hz.
    """

    def __init__(self, tone: float = 800.0, samplerate: float = 3000.0,
                 agc_enabled: bool = True, agc_attack: float = 100.0,
                 agc_decay: float = 5.0, lead_shape=(), *, device):
        self.xlator = FrequencyXlator(tone, samplerate, lead_shape=lead_shape,
                                      device=device)
        self.agc = AGC(1.0, agc_attack / samplerate, agc_decay / samplerate,
                       10e6, 1.0, 1.0, enabled=agc_enabled,
                       lead_shape=lead_shape, device=device)

    def init_state(self):
        return {"xlator": self.xlator.init_state(), "agc": self.agc.init_state()}

    def __call__(self, state, x):
        xs, x = self.xlator(state["xlator"], x)
        y = convert.complex_to_real(x)
        ags, y = self.agc(state["agc"], y)
        return {"xlator": xs, "agc": ags}, y


class NFMDemod(Block):
    """Narrow FM (reference: core/src/dsp/demod/fm.h:11-162): quadrature
    discriminator at deviation bw/2, then the audio filter: low-pass
    (bw/2), high-pass (300 Hz), band-pass (300 Hz .. bw/2) with both, or
    none. Radio-module defaults: IF 48 kHz, bandwidth 12.5 kHz, low-pass.
    """

    def __init__(self, bandwidth: float = 12500.0, samplerate: float = 48000.0,
                 low_pass: bool = True, high_pass: bool = False, lead_shape=(),
                 dynamic_bandwidth: bool = False, max_taps: int = 2049, *,
                 device):
        self.samplerate = samplerate
        self.low_pass_on = bool(low_pass)
        self.high_pass_on = bool(high_pass)
        self.dynamic_bandwidth = bool(dynamic_bandwidth)
        self.max_taps = int(max_taps)
        self.demod = Quadrature(bandwidth / 2.0, samplerate,
                                lead_shape=lead_shape,
                                dynamic_deviation=dynamic_bandwidth,
                                device=device)
        t = self._audio_taps(bandwidth)
        if t is None:
            self.fir = None
        elif dynamic_bandwidth:
            self.fir = RuntimeFIR(self.max_taps, t, dtype=torch.float32,
                                  lead_shape=lead_shape, device=device)
        else:
            self.fir = FIR(t, dtype=torch.float32, lead_shape=lead_shape,
                           device=device)

    def _audio_taps(self, bandwidth: float):
        if self.low_pass_on and self.high_pass_on:
            return taps.band_pass(300.0, bandwidth / 2.0, 100.0,
                                  self.samplerate, complex_taps=False)
        if self.high_pass_on:
            return taps.high_pass(300.0, 100.0, self.samplerate)
        if self.low_pass_on:
            fw = bandwidth / 2.0
            if self.dynamic_bandwidth:
                return taps.budget_low_pass(fw, fw * 0.1, self.samplerate,
                                            self.max_taps)
            return taps.low_pass(fw, fw * 0.1, self.samplerate)
        return None

    def set_bandwidth_state(self, state, bandwidth: float):
        """The deviation leaf and the audio filter's taps (fm.h
        setDeviation + retap); high-pass taps do not depend on bandwidth."""
        _need_dynamic(self)
        st = dict(state, demod=dict(
            state["demod"],
            inv_dev=self.demod.inv_dev_state(float(bandwidth) / 2.0)))
        if self.fir is not None and self.low_pass_on:
            st["fir"] = dict(state["fir"], taps=self.fir.taps_state(
                self._audio_taps(bandwidth)))
        return st

    def init_state(self):
        return {"demod": self.demod.init_state(),
                "fir": self.fir.init_state() if self.fir else ()}

    def __call__(self, state, x):
        ds, y = self.demod(state["demod"], x)
        fs = ()
        if self.fir is not None:
            fs, y = self.fir(state["fir"], y)
        return {"demod": ds, "fir": fs}, y


class WFMDemod(Block):
    """Broadcast FM with pilot-PLL stereo matrix decode and the RDS tap
    (reference: core/src/dsp/demod/broadcast_fm.h:18-258).

    Chain: quadrature(deviation) -> MPX; the stereo path filters the 19 kHz
    pilot (complex band-pass 18750-19250, 3 kHz transition, odd taps), locks
    a PLL (bw 25k/fs, freq limits +-250 Hz around 19 kHz), delay-compensates
    L+R and the complex MPX by (pilotTaps-1)/2+1, multiplies by conj(pll)^2
    to shift the 38 kHz L-R down, forms L/R, and 15 kHz low-passes
    (``low_pass``). ``stereo=False`` outputs the (low-passed) MPX on both
    channels. The RDS tap (``rds_out``) translates the complex MPX by
    -57 kHz and resamples it to 5 kHz. Returns stereo [..., n, 2], with
    ``rds_out`` as (stereo, rds baseband). Spans
    (``utils.tracing.annotate``): ``wfm.pilot`` around the pilot's
    band-pass and loop, ``wfm.stereo`` around the delays, the 38-kHz
    product, the matrix and the audio low-passes.
    """

    def __init__(self, deviation: float = 100000.0, samplerate: float = 240000.0,
                 stereo: bool = True, low_pass: bool = True,
                 rds_out: bool = False, lead_shape=(),
                 dynamic_bandwidth: bool = False, *, device):
        ls = lead_shape
        self.samplerate = samplerate
        self.stereo = stereo
        self.low_pass = low_pass
        self.rds_out = rds_out
        self.dynamic_bandwidth = bool(dynamic_bandwidth)
        self.demod = Quadrature(deviation, samplerate, lead_shape=ls,
                                dynamic_deviation=dynamic_bandwidth,
                                device=device)
        self.pilot_taps = taps.band_pass(18750.0, 19250.0, 3000.0, samplerate,
                                         complex_taps=True, odd_tap_count=True)
        self.pilot_fir = FIR(self.pilot_taps, dtype=torch.complex64,
                             lead_shape=ls, device=device)
        self.pilot_pll = PLL(
            bandwidth=25000.0 / samplerate,
            init_phase=0.0,
            init_freq=hz_to_rads(19000.0, samplerate),
            min_freq=hz_to_rads(18750.0, samplerate),
            max_freq=hz_to_rads(19250.0, samplerate),
            lead_shape=ls,
            # the pilot loop's time constant is ~10 samples; 128 is 13x it
            warmup=128,
            device=device,
        )
        d = (self.pilot_taps.shape[0] - 1) // 2 + 1
        self.lpr_delay = Delay(d, dtype=torch.float32, lead_shape=ls,
                               device=device)
        self.lmr_delay = Delay(d, dtype=torch.complex64, lead_shape=ls,
                               device=device)
        audio_taps = taps.low_pass(15000.0, 4000.0, samplerate)
        self.al_fir = FIR(audio_taps, dtype=torch.float32, lead_shape=ls,
                          device=device)
        self.ar_fir = FIR(audio_taps, dtype=torch.float32, lead_shape=ls,
                          device=device)
        self.rds_xlator = self.rds_resamp = None
        if rds_out:
            self.rds_xlator = FrequencyXlator(-57000.0, samplerate,
                                              lead_shape=ls, device=device)
            self.rds_resamp = RationalResampler(samplerate, 5000.0,
                                                dtype=torch.complex64,
                                                lead_shape=ls, device=device)

    def init_state(self):
        st = {
            "demod": self.demod.init_state(),
            "pilot_fir": self.pilot_fir.init_state(),
            "pilot_pll": self.pilot_pll.init_state(),
            "lpr_delay": self.lpr_delay.init_state(),
            "lmr_delay": self.lmr_delay.init_state(),
            "al_fir": self.al_fir.init_state(),
            "ar_fir": self.ar_fir.init_state(),
        }
        if self.rds_out:
            st["rds_xlator"] = self.rds_xlator.init_state()
            st["rds_resamp"] = self.rds_resamp.init_state()
        return st

    def set_bandwidth_state(self, state, bandwidth: float):
        """deviation = bw/2 (the radio wrapper's, wfm.h): one leaf; the
        pilot and audio filters do not depend on bandwidth."""
        _need_dynamic(self)
        return dict(state, demod=dict(
            state["demod"],
            inv_dev=self.demod.inv_dev_state(float(bandwidth) / 2.0)))

    def _rds(self, st, state, cmpx):
        st["rds_xlator"], bb = self.rds_xlator(state["rds_xlator"], cmpx)
        st["rds_resamp"], rds = self.rds_resamp(state["rds_resamp"], bb)
        return rds

    def __call__(self, state, x):
        st = dict(state)
        st["demod"], mpx = self.demod(state["demod"], x)
        cmpx = convert.real_to_complex(mpx)
        rds = self._rds(st, state, cmpx) if self.rds_out else None
        if self.stereo:
            with annotate("wfm.pilot", device=True):
                st["pilot_fir"], pilot = self.pilot_fir(state["pilot_fir"],
                                                        cmpx)
                st["pilot_pll"], vco = self.pilot_pll(state["pilot_pll"],
                                                      pilot)
            with annotate("wfm.stereo", device=True):
                st["lpr_delay"], lpr = self.lpr_delay(state["lpr_delay"], mpx)
                st["lmr_delay"], lmr_c = self.lmr_delay(state["lmr_delay"],
                                                        cmpx)
                vco_c = torch.conj(vco)
                lmr_c = lmr_c * vco_c * vco_c  # downconvert 38 kHz L-R
                lmr = convert.complex_to_real(lmr_c) * 2.0
                l = lpr + lmr
                r = lpr - lmr
                if self.low_pass:
                    st["al_fir"], l = self.al_fir(state["al_fir"], l)
                    st["ar_fir"], r = self.ar_fir(state["ar_fir"], r)
                out = convert.l_r_to_stereo(l, r)
        else:
            audio = mpx
            if self.low_pass:
                st["al_fir"], audio = self.al_fir(state["al_fir"], audio)
            out = convert.l_r_to_stereo(audio, audio)
        if self.rds_out:
            return st, (out, rds)
        return st, out
