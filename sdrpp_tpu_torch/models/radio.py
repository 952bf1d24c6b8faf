"""RadioChannel: the full receive channel (the radio decoder module's graph).

The counterpart of ``sdrpp_tpu.models.radio`` (reference:
decoder_modules/radio/src/radio_module.h): VFO -> [squelch] -> demodulator
-> AF RationalResampler to the audio rate -> optional Deemphasis
(22/50/75 us). Per-demod IF rates/bandwidths follow the demodulator
wrappers (radio/src/demodulators/*.h).
"""

from __future__ import annotations

import torch

from ..ops.resample import RationalResampler
from ..ops.scans import Deemphasis, Squelch
from ..utils.blocks import Block
from .analog import AMDemod, NFMDemod, SSBDemod, WFMDemod
from .channel import RxVFO

__all__ = ["RadioChannel", "DEMOD_DEFAULTS"]

# Per-demod IF sample rate and default bandwidth (radio/src/demodulators/*.h)
DEMOD_DEFAULTS = {
    "wfm": dict(if_rate=240000.0, bandwidth=200000.0),
    "nfm": dict(if_rate=48000.0, bandwidth=12500.0),
    "am": dict(if_rate=24000.0, bandwidth=12000.0),
    "usb": dict(if_rate=48000.0, bandwidth=2700.0),
    "lsb": dict(if_rate=48000.0, bandwidth=2700.0),
    "dsb": dict(if_rate=48000.0, bandwidth=4600.0),
}

DEEMP_TAUS = {"22us": 22e-6, "50us": 50e-6, "75us": 75e-6, None: None}


def _make_demod(mode: str, bandwidth: float, if_rate: float, lead_shape,
                device):
    if mode == "wfm":
        return WFMDemod(deviation=bandwidth / 2.0, samplerate=if_rate,
                        lead_shape=lead_shape, device=device)
    if mode == "nfm":
        return NFMDemod(bandwidth=bandwidth, samplerate=if_rate,
                        lead_shape=lead_shape, device=device)
    if mode == "am":
        return AMDemod(bandwidth=bandwidth, samplerate=if_rate,
                       lead_shape=lead_shape, device=device)
    return SSBDemod(mode=mode, bandwidth=bandwidth, samplerate=if_rate,
                    lead_shape=lead_shape, device=device)


class RadioChannel(Block):
    """VFO -> [squelch] -> demod -> AF resample -> [deemphasis].

    ``mode``: wfm | nfm | am | usb | lsb | dsb (cw and raw are not ported
    yet). Output: float32 audio at ``audio_rate`` ([..., n] mono;
    [..., n, 2] for WFM). ``block_multiple`` is the required input
    block-length multiple.
    """

    def __init__(self, mode: str, in_samplerate: float, offset: float = 0.0,
                 bandwidth: float | None = None, audio_rate: float = 48000.0,
                 squelch_level: float | None = None,
                 noise_blanker: bool = False, fm_if_nr: bool = False,
                 deemphasis: str | None = None, rds: bool = False,
                 lead_shape=(),
                 dynamic_offset: bool = False,
                 dynamic_bandwidth: bool = False, *, device):
        mode = mode.lower()
        if mode in ("cw", "raw"):
            raise NotImplementedError(f"mode {mode!r} is not ported yet")
        if mode not in DEMOD_DEFAULTS:
            raise ValueError(f"unknown demod mode {mode}")
        for name, on in (("noise_blanker", noise_blanker),
                         ("fm_if_nr", fm_if_nr), ("rds", rds),
                         ("dynamic_offset", dynamic_offset),
                         ("dynamic_bandwidth", dynamic_bandwidth)):
            if on:
                raise NotImplementedError(f"{name} is not ported yet")
        defaults = DEMOD_DEFAULTS[mode]
        self.mode = mode
        if_rate = defaults["if_rate"]
        if bandwidth is None:
            bandwidth = defaults["bandwidth"]
        self.if_rate = if_rate
        self.audio_rate = audio_rate
        self.bandwidth = float(bandwidth)
        self.device = torch.device(device)
        ls = lead_shape

        # VFO: bandwidth != out rate adds the channel filter (rx_vfo.h:30-33)
        self.vfo = RxVFO(in_samplerate, if_rate, min(bandwidth, if_rate),
                         offset, lead_shape=ls, device=device)
        self.squelch = (Squelch(squelch_level, lead_shape=ls, device=device)
                        if squelch_level is not None else None)
        self.demod = _make_demod(mode, bandwidth, if_rate, ls, device)
        self.stereo_out = mode == "wfm"
        # AF chain (radio_module.h:81-88): demod AF rate (= IF rate) ->
        # audio rate; stereo audio resamples as a [..., 2, n] lead axis
        self.af_resamp = (RationalResampler(
            if_rate, audio_rate, dtype=torch.float32,
            lead_shape=(*ls, 2) if self.stereo_out else ls, device=device)
            if if_rate != audio_rate else None)
        tau = DEEMP_TAUS[deemphasis]
        self.deemph = (Deemphasis(tau, audio_rate, stereo=self.stereo_out,
                                  lead_shape=ls, device=device)
                       if tau is not None else None)

        # smallest multiple of the VFO's requirement whose IF block also
        # divides by the AF resampler's
        m = self.vfo.block_multiple
        if self.af_resamp is not None:
            if_bm = self.af_resamp.block_multiple
            cand = m
            for _ in range(100000):
                if self.vfo.out_count(cand) % if_bm == 0:
                    break
                cand += m
            else:
                raise ValueError("no valid block multiple found")
            m = cand
        self.block_multiple = m

    def init_state(self):
        # "nb" and "fm_if" are the JAX tree's slots for the unported noise
        # blanker and FM IF noise reduction, empty when those are off
        return {
            "vfo": self.vfo.init_state(),
            "nb": (),
            "squelch": self.squelch.init_state() if self.squelch else (),
            "fm_if": (),
            "demod": self.demod.init_state(),
            "af_resamp": self.af_resamp.init_state() if self.af_resamp else (),
            "deemph": self.deemph.init_state() if self.deemph else (),
        }

    def __call__(self, state, x):
        st = dict(state)
        st["vfo"], x = self.vfo(state["vfo"], x)
        if self.squelch is not None:
            st["squelch"], x = self.squelch(state["squelch"], x)
        st["demod"], audio = self.demod(state["demod"], x)
        if self.af_resamp is not None:
            if self.stereo_out:
                # [..., n, 2] -> [..., 2, n] for the last-axis resampler
                st["af_resamp"], a = self.af_resamp(
                    state["af_resamp"], audio.transpose(-1, -2))
                audio = a.transpose(-1, -2)
            else:
                st["af_resamp"], audio = self.af_resamp(state["af_resamp"],
                                                        audio)
        if self.deemph is not None:
            st["deemph"], audio = self.deemph(state["deemph"], audio)
        return st, audio
