"""RxVFO: the digital down-converter (channel extraction) unit.

The counterpart of ``sdrpp_tpu.models.channel`` (reference:
core/src/dsp/channel/rx_vfo.h:6-135): frequency xlator (negated offset) ->
rational resampler -> channel low-pass when the bandwidth differs from the
output rate (taps = lowPass(bw/2, 0.1*bw/2, outSamplerate)). Static offset
and bandwidth only: the JAX package's dynamic offset/bandwidth (state-held
NCO frequency and taps) are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops import taps as taps_mod
from ..ops.fir import FIR
from ..ops.mix import FrequencyXlator
from ..ops.resample import RationalResampler
from ..utils.blocks import Block

__all__ = ["RxVFO"]


class RxVFO(Block):
    def __init__(self, in_samplerate: float, out_samplerate: float,
                 bandwidth: float, offset: float, lead_shape=(), *, device):
        self.in_samplerate = float(in_samplerate)
        self.out_samplerate = float(out_samplerate)
        self.bandwidth = float(bandwidth)
        self.offset = float(offset)
        self.xlator = FrequencyXlator(-offset, in_samplerate,
                                      lead_shape=lead_shape, device=device)
        self.resamp = RationalResampler(in_samplerate, out_samplerate,
                                        lead_shape=lead_shape, device=device)
        self.block_multiple = self.resamp.block_multiple
        self.filter = None
        if bandwidth != out_samplerate:
            fw = bandwidth / 2.0
            self.filter = FIR(taps_mod.low_pass(fw, fw * 0.1, out_samplerate),
                              dtype=torch.complex64, lead_shape=lead_shape,
                              device=device)

    def out_count(self, n: int) -> int:
        return self.resamp.out_count(n)

    def init_state(self):
        return {
            "xlator": self.xlator.init_state(),
            "resamp": self.resamp.init_state(),
            "filter": self.filter.init_state() if self.filter else (),
        }

    def __call__(self, state, x):
        xs, x = self.xlator(state["xlator"], x)
        rs, x = self.resamp(state["resamp"], x)
        fs = ()
        if self.filter is not None:
            fs, x = self.filter(state["filter"], x)
        return {"xlator": xs, "resamp": rs, "filter": fs}, x
