"""RadioChannel: the full receive channel (the radio decoder module's graph).

The counterpart of ``sdrpp_tpu.models.radio`` (reference:
decoder_modules/radio/src/radio_module.h): VFO -> IF chain (noise blanker
-> squelch -> FM IF noise reduction) -> demodulator -> AF
RationalResampler to the audio rate -> optional Deemphasis (22/50/75 us).
Per-demod IF rates/bandwidths follow the demodulator wrappers
(radio/src/demodulators/*.h). The offset, the bandwidth and the squelch
level can live in the state (``dynamic_offset``, ``dynamic_bandwidth``,
the squelch's ``level`` leaf): ``retune_state``, ``set_bandwidth_state``
and ``set_squelch_state`` write them between blocks.
"""

from __future__ import annotations

import math

import torch

from ..ops.fm_if import FMIFNoiseReduction
from ..ops.resample import RationalResampler
from ..ops.scans import Deemphasis, NoiseBlanker, Squelch
from ..utils.blocks import Block
from .analog import AMDemod, CWDemod, NFMDemod, SSBDemod, WFMDemod
from .channel import RxVFO

__all__ = ["RadioChannel", "DEMOD_DEFAULTS", "BANDWIDTH_RANGES",
           "clamp_bandwidth"]

# Per-demod IF sample rate and default bandwidth (radio/src/demodulators/*.h)
DEMOD_DEFAULTS = {
    "wfm": dict(if_rate=240000.0, bandwidth=200000.0),
    "nfm": dict(if_rate=48000.0, bandwidth=12500.0),
    "am": dict(if_rate=24000.0, bandwidth=12000.0),
    "usb": dict(if_rate=48000.0, bandwidth=2700.0),
    "lsb": dict(if_rate=48000.0, bandwidth=2700.0),
    "dsb": dict(if_rate=48000.0, bandwidth=4600.0),
    "cw": dict(if_rate=3000.0, bandwidth=500.0),
    # RAW: the IF rate follows the audio rate; I/Q out as stereo
    # (decoder_modules/radio/src/demodulators/raw.h:49,66)
    "raw": dict(if_rate=None, bandwidth=None),
}

DEEMP_TAUS = {"22us": 22e-6, "50us": 50e-6, "75us": 75e-6, None: None}

# Runtime-bandwidth clamp range per mode (reference get{Min,Max}Bandwidth,
# decoder_modules/radio/src/demodulators/*.h:105-126; the maximum as a
# fraction of the IF rate)
BANDWIDTH_RANGES = {
    "wfm": (24000.0, 1.0), "nfm": (1000.0, 1.0), "am": (1000.0, 1.0),
    "usb": (500.0, 0.5), "lsb": (500.0, 0.5), "dsb": (1000.0, 0.5),
    "cw": (10.0, 0.5),
}


def clamp_bandwidth(mode: str, bandwidth: float, if_rate: float) -> float:
    """``bandwidth`` clamped to the reference's range for ``mode`` at IF
    rate ``if_rate`` (get{Min,Max}Bandwidth, demodulators/*.h)."""
    lo, hi_frac = BANDWIDTH_RANGES.get(mode, (10.0, 1.0))
    return float(min(max(float(bandwidth), lo), hi_frac * if_rate))


def _make_demod(mode: str, bandwidth: float, if_rate: float, lead_shape,
                stereo_wfm: bool, rds: bool, dynamic_bandwidth: bool, device):
    kw = dict(lead_shape=lead_shape, device=device)
    dyn = dict(kw, dynamic_bandwidth=dynamic_bandwidth)
    if mode == "wfm":
        return WFMDemod(deviation=bandwidth / 2.0, samplerate=if_rate,
                        stereo=stereo_wfm, rds_out=rds, **dyn)
    if mode == "nfm":
        return NFMDemod(bandwidth=bandwidth, samplerate=if_rate, **dyn)
    if mode == "am":
        return AMDemod(bandwidth=bandwidth, samplerate=if_rate, **dyn)
    if mode in ("usb", "lsb", "dsb"):
        return SSBDemod(mode=mode, bandwidth=bandwidth, samplerate=if_rate,
                        **dyn)
    if mode == "cw":
        return CWDemod(samplerate=if_rate, **kw)
    return None  # raw: the VFO's IQ passed through as stereo


class RadioChannel(Block):
    """VFO -> [noise blanker] -> [squelch] -> [FM IF NR] -> demod -> AF
    resample -> [deemphasis].

    ``mode``: wfm | nfm | am | usb | lsb | dsb | cw | raw. Output: float32
    audio at ``audio_rate`` ([..., n] mono; [..., n, 2] for WFM and raw),
    with ``rds`` (WFM) as (audio, 5 kHz complex RDS baseband).
    ``block_multiple`` is the required input block-length multiple.
    """

    def __init__(self, mode: str, in_samplerate: float, offset: float = 0.0,
                 bandwidth: float | None = None, audio_rate: float = 48000.0,
                 squelch_level: float | None = None,
                 noise_blanker: bool = False, fm_if_nr: bool = False,
                 deemphasis: str | None = None, stereo_wfm: bool = True,
                 rds: bool = False, lead_shape=(),
                 dynamic_offset: bool = False,
                 dynamic_bandwidth: bool = False, *, device):
        mode = mode.lower()
        if mode not in DEMOD_DEFAULTS:
            raise ValueError(f"unknown demod mode {mode}")
        defaults = DEMOD_DEFAULTS[mode]
        self.mode = mode
        if_rate = defaults["if_rate"] or audio_rate
        if bandwidth is None:
            bandwidth = defaults["bandwidth"] or if_rate
        self.if_rate = if_rate
        self.audio_rate = audio_rate
        self.rds = bool(rds) and mode == "wfm"
        # raw has no stage that depends on the bandwidth
        self.dynamic_bandwidth = bool(dynamic_bandwidth) and mode != "raw"
        self.bandwidth = float(bandwidth)
        self.device = torch.device(device)
        ls = lead_shape
        dev = dict(lead_shape=ls, device=device)

        # VFO: bandwidth != out rate adds the channel filter (rx_vfo.h:30-33)
        self.vfo = RxVFO(in_samplerate, if_rate, min(bandwidth, if_rate),
                         offset, dynamic_offset=dynamic_offset,
                         dynamic_bandwidth=self.dynamic_bandwidth, **dev)
        # IF chain (radio_module.h:68-79)
        self.noise_blanker = (NoiseBlanker(500.0 / 24000.0, 10.0, **dev)
                              if noise_blanker else None)
        self.squelch = (Squelch(squelch_level, **dev)
                        if squelch_level is not None else None)
        # FM IF noise reduction, 32 bins (radio_module.h:74)
        self.fm_if = FMIFNoiseReduction(32, **dev) if fm_if_nr else None
        self.demod = _make_demod(mode, bandwidth, if_rate, ls, stereo_wfm,
                                 self.rds, self.dynamic_bandwidth, device)
        self.stereo_out = mode in ("wfm", "raw")
        # AF chain (radio_module.h:81-88): every demod's AF rate is its IF
        # rate; stereo audio resamples as a [..., 2, n] lead axis
        self.af_resamp = (RationalResampler(
            if_rate, audio_rate, dtype=torch.float32,
            lead_shape=(*ls, 2) if self.stereo_out else ls, device=device)
            if if_rate != audio_rate else None)
        tau = DEEMP_TAUS[deemphasis]
        self.deemph = (Deemphasis(tau, audio_rate, stereo=self.stereo_out,
                                  **dev)
                       if tau is not None else None)

        # the smallest multiple of the VFO's requirement whose IF block
        # divides by the AF resampler's and the RDS resampler's (which
        # resamples the same IF block inside WFMDemod)
        m = self.vfo.block_multiple
        if_bm = self.af_resamp.block_multiple if self.af_resamp else 1
        if self.rds:
            if_bm = math.lcm(if_bm, int(self.demod.rds_resamp.block_multiple))
        if if_bm > 1:
            cand = m
            for _ in range(100000):
                if self.vfo.out_count(cand) % if_bm == 0:
                    break
                cand += m
            else:
                raise ValueError("no valid block multiple found")
            m = cand
        self.block_multiple = m

    def retune_state(self, state, offset_hz: float):
        """New state with the VFO retuned (dynamic_offset channels only),
        applied between blocks."""
        return dict(state, vfo=self.vfo.retune_state(state["vfo"], offset_hz))

    def clamp_bandwidth(self, bandwidth: float) -> float:
        """Clamp to the reference's per-mode range (get{Min,Max}Bandwidth,
        demodulators/*.h)."""
        return clamp_bandwidth(self.mode, bandwidth, self.if_rate)

    def set_bandwidth_state(self, state, bandwidth: float):
        """New state with the channel retargeted to ``bandwidth`` (clamped):
        the VFO's channel taps and the demod's bandwidth-dependent pieces,
        designed on the host and written into the state between blocks
        (RadioModule::setBandwidth, radio_module.h:461-471).
        dynamic_bandwidth channels only."""
        if not self.dynamic_bandwidth:
            raise ValueError("channel built without dynamic_bandwidth")
        bandwidth = self.clamp_bandwidth(bandwidth)
        st = dict(state, vfo=self.vfo.set_bandwidth_state(
            state["vfo"], min(bandwidth, self.if_rate)))
        if hasattr(self.demod, "set_bandwidth_state"):
            st["demod"] = self.demod.set_bandwidth_state(state["demod"],
                                                         bandwidth)
        self.bandwidth = bandwidth
        return st

    def set_squelch_state(self, state, level_db: float):
        """New state with the squelch threshold changed: a scalar write
        (squelch.h:63-66). Channels built with a squelch only."""
        if self.squelch is None:
            raise ValueError("channel has no squelch block")
        return dict(state, squelch=self.squelch.set_level_state(
            state["squelch"], level_db))

    def init_state(self):
        def init(block):
            return block.init_state() if block is not None else ()

        return {
            "vfo": self.vfo.init_state(),
            "nb": init(self.noise_blanker),
            "squelch": init(self.squelch),
            "fm_if": init(self.fm_if),
            "demod": init(self.demod),
            "af_resamp": init(self.af_resamp),
            "deemph": init(self.deemph),
        }

    def __call__(self, state, x):
        st = dict(state)
        st["vfo"], x = self.vfo(state["vfo"], x)
        if self.noise_blanker is not None:
            st["nb"], x = self.noise_blanker(state["nb"], x)
        if self.squelch is not None:
            st["squelch"], x = self.squelch(state["squelch"], x)
        if self.fm_if is not None:
            st["fm_if"], x = self.fm_if(state["fm_if"], x)
        rds = None
        if self.demod is None:  # raw: I/Q as stereo
            audio = torch.stack([x.real, x.imag], dim=-1)
        elif self.rds:
            st["demod"], (audio, rds) = self.demod(state["demod"], x)
        else:
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
        if self.rds:
            return st, (audio, rds)
        return st, audio
