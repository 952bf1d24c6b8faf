"""RDS demodulation chain: WFM's 57 kHz subcarrier -> bitstream.

The counterpart of ``sdrpp_tpu.models.rds_chain`` (reference:
decoder_modules/radio/src/demodulators/wfm.h:56-76): the 5 kHz complex RDS
baseband of ``WFMDemod(rds_out=True)`` runs through FastAGC(1, 1e6, 0.1)
-> Costas<2>(0.005) -> complex band-pass FIR (0..2375 Hz, 100 Hz
transition) -> a second Costas<2>(0.01) with its VCO limited to baud/2
(1187.5 Hz +-10 %) -> real part -> M&M clock recovery (omega =
5000/1187.5, gains 1e-6 / 0.01) -> binary slicer -> differential decoder
(mod 2) -> ``decoders.rds.RDSDecoder`` on the host.

The FastAGC and both Costas loops are the exact single-stream blocks of
``ops.scans`` (``single_scan`` on a CUDA tensor), as the JAX chain runs
its exact Pallas loops; the M&M is ``mm_symbols``' float variant.
"""

from __future__ import annotations

import numpy as np
import torch

from ..decoders.rds import RDSDecoder
from ..ops import taps as taps_mod
from ..ops.clock_recovery import MMClockRecovery
from ..ops.digital import DifferentialDecoder, binary_slicer
from ..ops.fir import FIR
from ..ops.mix import hz_to_rads
from ..ops.scans import Costas, FastAGC
from ..utils.blocks import Block

__all__ = ["RDSChain", "RDSReceiver", "RDS_BAUD", "RDS_RATE"]

RDS_BAUD = 1187.5
RDS_RATE = 5000.0


class RDSChain(Block):
    """5 kHz complex RDS baseband [n] -> (bits [max_bits] uint8, valid
    count) per block."""

    def __init__(self, *, device):
        dev = dict(device=device)
        self.agc = FastAGC(1.0, 1e6, 0.1, **dev)
        self.costas = Costas(2, 0.005, **dev)
        bp_taps = taps_mod.band_pass(0.0, 2375.0, 100.0, RDS_RATE,
                                     complex_taps=True)
        self.fir = FIR(bp_taps, dtype=torch.complex64, **dev)
        baud_freq = hz_to_rads(RDS_BAUD, RDS_RATE)
        self.costas2 = Costas(2, 0.01, init_freq=baud_freq,
                              min_freq=baud_freq * 0.9,
                              max_freq=baud_freq * 1.1, **dev)
        self.recov = MMClockRecovery(RDS_RATE / RDS_BAUD, omega_gain=1e-6,
                                     mu_gain=0.01, omega_rel_limit=0.01,
                                     complex_input=False, **dev)
        self.diff = DifferentialDecoder(2, **dev)

    def max_bits(self, n: int) -> int:
        return self.recov.max_symbols(n)

    def init_state(self):
        return {
            "agc": self.agc.init_state(),
            "costas": self.costas.init_state(),
            "fir": self.fir.init_state(),
            "costas2": self.costas2.init_state(),
            "recov": self.recov.init_state(),
            "diff": self.diff.init_state(),
        }

    def __call__(self, state, x):
        st = dict(state)
        st["agc"], y = self.agc(state["agc"], x)
        st["costas"], y = self.costas(state["costas"], y)
        st["fir"], y = self.fir(state["fir"], y)
        st["costas2"], y = self.costas2(state["costas2"], y)
        st["recov"], (syms, valid) = self.recov(state["recov"], y.real)
        nvalid = valid.to(torch.int32).sum()
        st["diff"], decoded = self.diff(state["diff"],
                                        (binary_slicer(syms), nvalid))
        return st, (decoded, nvalid)


class RDSReceiver:
    """Host wrapper: ``RDSChain`` on ``device`` and the bit-level group
    decoder on the host. ``process`` takes one block of RDS baseband (a
    tensor, or numpy) and returns the count of new bits."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.chain = RDSChain(device=self.device)
        self.state = self.chain.init_state()
        self.decoder = RDSDecoder()

    def process(self, rds_baseband) -> int:
        x = torch.as_tensor(np.asarray(rds_baseband, np.complex64)
                            if not torch.is_tensor(rds_baseband)
                            else rds_baseband).to(self.device)
        self.state, (bits, nvalid) = self.chain(self.state, x)
        n = int(nvalid)
        self.decoder.process(bits[:n].cpu().numpy())
        return n
