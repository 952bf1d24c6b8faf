"""Analog demodulators: AM, SSB/DSB, CW, NFM, WFM (stereo).

The counterpart of ``sdrpp_tpu.models.analog`` (reference:
core/src/dsp/demod/*.h; radio-module defaults from
decoder_modules/radio/src/demodulators/*.h: WFM 240 kHz IF, NFM/USB/LSB/DSB
48 kHz, AM 24 kHz, CW 3 kHz). Audio is float32 [..., n] mono; WFM emits [..., n, 2]
stereo. The loops are the chunk-parallel classes of ``ops.scans_kernels``:
exact for short blocks, chunk-parallel for long ones, by the same rule as
the JAX package. Each demodulator runs the radio module's settings; the
JAX blocks' alternative settings that no caller selects (carrier AGC,
AGC off, NFM high-pass, WFM mono) are not ported, nor are the WFM RDS
tap and the runtime-bandwidth variants.
"""

from __future__ import annotations

import torch

from ..ops import convert, taps
from ..ops.delay import Delay
from ..ops.fir import FIR
from ..ops.fm import Quadrature
from ..ops.mix import FrequencyXlator, hz_to_rads
from ..ops.scans import DCBlocker
from ..ops.scans_kernels import AGCChunked as AGC, PLLChunked as PLL
from ..utils.blocks import Block

__all__ = ["AMDemod", "SSBDemod", "CWDemod", "NFMDemod", "WFMDemod"]


class AMDemod(Block):
    """AM envelope demodulator (reference: core/src/dsp/demod/am.h:10-172).

    Chain: magnitude -> DC block -> audio AGC -> LPF, with the radio
    module's settings: IF 24 kHz, bandwidth 12 kHz, AGC attack 50/fs,
    decay 5/fs, DC-block rate 100/fs. (The JAX block's carrier-AGC mode,
    which no caller selects, is not ported; its state slot is kept so the
    state trees match.)
    """

    def __init__(self, bandwidth: float = 12000.0, samplerate: float = 24000.0,
                 lead_shape=(), *, device):
        self.samplerate = samplerate
        ls = lead_shape
        self.audio_agc = AGC(1.0, 50.0 / samplerate, 5.0 / samplerate, 10e6,
                             10.0, float("inf"), lead_shape=ls, device=device)
        self.dc_block = DCBlocker(100.0 / samplerate, dtype=torch.float32,
                                  lead_shape=ls, device=device)
        lpf_taps = taps.low_pass(bandwidth / 2.0, (bandwidth / 2.0) * 0.1,
                                 samplerate)
        self.lpf = FIR(lpf_taps, dtype=torch.float32, lead_shape=ls,
                       device=device)

    def init_state(self):
        return {
            "carrier_agc": self.audio_agc.init_state(),
            "audio_agc": self.audio_agc.init_state(),
            "dc": self.dc_block.init_state(),
            "lpf": self.lpf.init_state(),
        }

    def __call__(self, state, x):
        st = dict(state)
        st["dc"], y = self.dc_block(state["dc"], torch.abs(x))
        st["audio_agc"], y = self.audio_agc(state["audio_agc"], y)
        st["lpf"], y = self.lpf(state["lpf"], y)
        return st, y


class SSBDemod(Block):
    """SSB/DSB product demodulator (reference: core/src/dsp/demod/ssb.h:9-134).

    Translate by +bw/2 (USB) / -bw/2 (LSB) / 0 (DSB), take the real part,
    then AGC. Radio-module defaults: IF 48 kHz, bandwidth 2.7 kHz, AGC
    attack 50/fs decay 5/fs.
    """

    def __init__(self, mode: str = "usb", bandwidth: float = 2700.0,
                 samplerate: float = 48000.0, lead_shape=(), *, device):
        translation = {"usb": bandwidth / 2.0, "lsb": -bandwidth / 2.0,
                       "dsb": 0.0}[mode]
        self.mode = mode
        self.xlator = FrequencyXlator(translation, samplerate,
                                      lead_shape=lead_shape, device=device)
        self.agc = AGC(1.0, 50.0 / samplerate, 5.0 / samplerate, 10e6, 10.0,
                       float("inf"), lead_shape=lead_shape, device=device)

    def init_state(self):
        return {"xlator": self.xlator.init_state(), "agc": self.agc.init_state()}

    def __call__(self, state, x):
        xs, x = self.xlator(state["xlator"], x)
        y = convert.complex_to_real(x)
        ags, y = self.agc(state["agc"], y)
        return {"xlator": xs, "agc": ags}, y


class CWDemod(Block):
    """CW demodulator with BFO tone (reference: core/src/dsp/demod/cw.h:9-105).

    Translate by +tone, real part, AGC with maxOutputAmp/initGain = 1.0.
    Radio-module defaults: IF 3 kHz, tone 800 Hz. The AGC runs enabled;
    the JAX block's manual-gain setting (``agc_enabled=False``) is not
    ported and raises.
    """

    def __init__(self, tone: float = 800.0, samplerate: float = 3000.0,
                 agc_enabled: bool = True, agc_attack: float = 100.0,
                 agc_decay: float = 5.0, lead_shape=(), *, device):
        if not agc_enabled:
            raise NotImplementedError("CWDemod with the AGC off is not "
                                      "ported to sdrpp_tpu_torch")
        self.xlator = FrequencyXlator(tone, samplerate, lead_shape=lead_shape,
                                      device=device)
        self.agc = AGC(1.0, agc_attack / samplerate, agc_decay / samplerate,
                       10e6, 1.0, 1.0, lead_shape=lead_shape, device=device)

    def init_state(self):
        return {"xlator": self.xlator.init_state(), "agc": self.agc.init_state()}

    def __call__(self, state, x):
        xs, x = self.xlator(state["xlator"], x)
        y = convert.complex_to_real(x)
        ags, y = self.agc(state["agc"], y)
        return {"xlator": xs, "agc": ags}, y


class NFMDemod(Block):
    """Narrow FM (reference: core/src/dsp/demod/fm.h:11-162): quadrature
    discriminator at deviation bw/2, then the audio low-pass at bw/2.
    Radio-module defaults: IF 48 kHz, bandwidth 12.5 kHz.
    """

    def __init__(self, bandwidth: float = 12500.0, samplerate: float = 48000.0,
                 lead_shape=(), *, device):
        self.samplerate = samplerate
        self.demod = Quadrature(bandwidth / 2.0, samplerate,
                                lead_shape=lead_shape, device=device)
        fw = bandwidth / 2.0
        self.fir = FIR(taps.low_pass(fw, fw * 0.1, samplerate),
                       dtype=torch.float32, lead_shape=lead_shape,
                       device=device)

    def init_state(self):
        return {"demod": self.demod.init_state(),
                "fir": self.fir.init_state()}

    def __call__(self, state, x):
        ds, y = self.demod(state["demod"], x)
        fs, y = self.fir(state["fir"], y)
        return {"demod": ds, "fir": fs}, y


class WFMDemod(Block):
    """Broadcast FM with pilot-PLL stereo matrix decode
    (reference: core/src/dsp/demod/broadcast_fm.h:18-258).

    Chain: quadrature(deviation) -> MPX; the stereo path filters the 19 kHz
    pilot (complex band-pass 18750-19250, 3 kHz transition, odd taps), locks
    a PLL (bw 25k/fs, freq limits +-250 Hz around 19 kHz), delay-compensates
    L+R and the complex MPX by (pilotTaps-1)/2+1, multiplies by conj(pll)^2
    to shift the 38 kHz L-R down, forms L/R, and 15 kHz low-passes.
    Returns stereo [..., n, 2]. The RDS tap is not ported yet.
    """

    def __init__(self, deviation: float = 100000.0, samplerate: float = 240000.0,
                 lead_shape=(), *, device):
        ls = lead_shape
        self.samplerate = samplerate
        self.demod = Quadrature(deviation, samplerate, lead_shape=ls,
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

    def init_state(self):
        return {
            "demod": self.demod.init_state(),
            "pilot_fir": self.pilot_fir.init_state(),
            "pilot_pll": self.pilot_pll.init_state(),
            "lpr_delay": self.lpr_delay.init_state(),
            "lmr_delay": self.lmr_delay.init_state(),
            "al_fir": self.al_fir.init_state(),
            "ar_fir": self.ar_fir.init_state(),
        }

    def __call__(self, state, x):
        st = dict(state)
        st["demod"], mpx = self.demod(state["demod"], x)
        cmpx = convert.real_to_complex(mpx)
        st["pilot_fir"], pilot = self.pilot_fir(state["pilot_fir"], cmpx)
        st["pilot_pll"], vco = self.pilot_pll(state["pilot_pll"], pilot)
        st["lpr_delay"], lpr = self.lpr_delay(state["lpr_delay"], mpx)
        st["lmr_delay"], lmr_c = self.lmr_delay(state["lmr_delay"], cmpx)
        vco_c = torch.conj(vco)
        lmr_c = lmr_c * vco_c * vco_c  # downconvert 38 kHz L-R
        lmr = convert.complex_to_real(lmr_c) * 2.0
        l = lpr + lmr
        r = lpr - lmr
        st["al_fir"], l = self.al_fir(state["al_fir"], l)
        st["ar_fir"], r = self.ar_fir(state["ar_fir"], r)
        return st, convert.l_r_to_stereo(l, r)
