"""RxVFO: the digital down-converter (channel extraction) unit.

The counterpart of ``sdrpp_tpu.models.channel`` (reference:
core/src/dsp/channel/rx_vfo.h:6-135): frequency xlator (negated offset) ->
rational resampler -> channel low-pass when the bandwidth differs from the
output rate (taps = lowPass(bw/2, 0.1*bw/2, outSamplerate)).

``dynamic_offset`` puts the NCO frequency in the state (a
``DynamicFrequencyXlator``; ``retune_state`` writes it between blocks),
``dynamic_bandwidth`` the channel filter's taps (a ``RuntimeFIR`` of
``max_taps``, always present; ``set_bandwidth_state`` writes them and
keeps the delay line).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import taps as taps_mod
from ..ops.fir import FIR, RuntimeFIR
from ..ops.mix import DynamicFrequencyXlator, FrequencyXlator
from ..ops.resample import RationalResampler
from ..utils.blocks import Block

__all__ = ["RxVFO"]


class RxVFO(Block):
    def __init__(self, in_samplerate: float, out_samplerate: float,
                 bandwidth: float, offset: float, lead_shape=(),
                 dynamic_offset: bool = False, dynamic_bandwidth: bool = False,
                 max_taps: int = 2049, *, device):
        self.in_samplerate = float(in_samplerate)
        self.out_samplerate = float(out_samplerate)
        self.bandwidth = float(bandwidth)
        self.offset = float(offset)
        self.dynamic_offset = bool(dynamic_offset)
        self.dynamic_bandwidth = bool(dynamic_bandwidth)
        self.max_taps = int(max_taps)
        xlator = DynamicFrequencyXlator if dynamic_offset else FrequencyXlator
        self.xlator = xlator(-offset, in_samplerate, lead_shape=lead_shape,
                             device=device)
        self.resamp = RationalResampler(in_samplerate, out_samplerate,
                                        lead_shape=lead_shape, device=device)
        self.block_multiple = self.resamp.block_multiple
        self.filter = None
        if dynamic_bandwidth:
            # present at every bandwidth, so that a change is a state write;
            # bw >= out rate writes a one-tap passthrough
            self.filter = RuntimeFIR(self.max_taps,
                                     self.design_channel_taps(bandwidth),
                                     dtype=torch.complex64,
                                     lead_shape=lead_shape, device=device)
        elif bandwidth != out_samplerate:
            fw = bandwidth / 2.0
            self.filter = FIR(taps_mod.low_pass(fw, fw * 0.1, out_samplerate),
                              dtype=torch.complex64, lead_shape=lead_shape,
                              device=device)

    def design_channel_taps(self, bandwidth: float) -> np.ndarray:
        """Channel filter for a runtime bandwidth: lowPass(bw/2, 0.1*bw/2,
        outSR) (rx_vfo.h:30-33) within the ``max_taps`` budget (the
        transition widened where the reference's would not fit); bw >= the
        output rate is one unit tap (rx_vfo.h skips the FIR)."""
        bandwidth = float(bandwidth)
        if bandwidth >= self.out_samplerate:
            return np.ones(1, np.float32)
        fw = bandwidth / 2.0
        return taps_mod.budget_low_pass(fw, fw * 0.1, self.out_samplerate,
                                        self.max_taps)

    def out_count(self, n: int) -> int:
        return self.resamp.out_count(n)

    def init_state(self):
        return {
            "xlator": self.xlator.init_state(),
            "resamp": self.resamp.init_state(),
            "filter": self.filter.init_state() if self.filter else (),
        }

    def retune_state(self, state, offset_hz: float):
        """New state with the VFO moved to ``offset_hz`` (dynamic_offset
        only), applied between blocks."""
        if not self.dynamic_offset:
            raise ValueError("RxVFO built with a static offset")
        return dict(state, xlator=dict(
            state["xlator"], **self.xlator.omega_leaves(-float(offset_hz))))

    def set_bandwidth_state(self, state, bandwidth: float):
        """New state with the channel filter retargeted to ``bandwidth``
        (dynamic_bandwidth only); the delay line is kept, as the
        reference's setTaps keeps it (fir.h:31-52)."""
        if not self.dynamic_bandwidth:
            raise ValueError("RxVFO built with a static bandwidth")
        return dict(state, filter=dict(
            state["filter"],
            taps=self.filter.taps_state(self.design_channel_taps(bandwidth))))

    def __call__(self, state, x):
        xs, x = self.xlator(state["xlator"], x)
        rs, x = self.resamp(state["resamp"], x)
        fs = ()
        if self.filter is not None:
            fs, x = self.filter(state["filter"], x)
        return {"xlator": xs, "resamp": rs, "filter": fs}, x
