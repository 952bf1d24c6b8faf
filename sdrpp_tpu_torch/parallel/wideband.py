"""The channel-bank chains of ``bench.py``, built from the port's modules.

``bench.py`` (the JAX package's benchmark) times four bank chains, all
64 channels at linspace(+-0.4 * 6.144 MHz), IF 48 kHz, 12.5 kHz
bandwidth, behind a shared-FFT channelizer and a per-channel squelch:

- ``wideband``: the /256 power-of-2 cascade from 1.572864 Gsps in blocks
  of 2^24 samples, then the NFM bank (bench.py:161-228, cascade mode);
- ``aggregate``: the NFM bank alone at 6.144 Msps (bench.py:98-124):
  Squelch(-100 dB, open) -> Quadrature(6250 Hz) -> audio
  FIR(low_pass(6250, 625, 48 kHz)), which is ``NFMDemod``'s chain;
- ``muted``: the NFM bank with the squelch at -50 dB, so channels without
  a carrier are muted (bench.py:319-397);
- ``ssb``: Squelch(-100 dB) -> USB product demod with the radio module's
  AGC (bench.py:127-140).

``make_chain(name)`` returns a ``BankChain``; the port has no command for
these, as the JAX package has none.
"""

from __future__ import annotations

import numpy as np

from ..models.analog import NFMDemod, SSBDemod
from ..ops.channelizer import FFTChannelizerBank
from ..ops.resample import PowerDecimator
from ..ops.scans import Squelch
from ..utils.blocks import Block

__all__ = ["CHANNELS", "IF_RATE", "BANDWIDTH", "FS_MID", "PRE_DECIM",
           "FS_WIDE", "WIDE_BLOCK", "bank_offsets", "BankChain", "make_chain"]

CHANNELS = 64
IF_RATE = 48000.0
BANDWIDTH = 12500.0
FS_MID = 6144000.0            # channelizer input rate (R = 128)
PRE_DECIM = 256               # wideband front decimation
FS_WIDE = FS_MID * PRE_DECIM  # 1.572864 Gsps
WIDE_BLOCK = 1 << 24          # wideband samples per block


def bank_offsets(channels: int = CHANNELS, fs_mid: float = FS_MID):
    return np.linspace(-fs_mid * 0.4, fs_mid * 0.4, channels)


class BankChain(Block):
    """[PowerDecimator(pre_decim)] -> FFTChannelizerBank -> Squelch ->
    NFMDemod or USB SSBDemod (2.7 kHz, behind the bank's 12.5 kHz
    channels, as bench.py has it).

    Input: a wideband [n] complex64 block at ``fs_mid * pre_decim``, n a
    multiple of ``block_multiple``. Output: [C, n / (pre_decim * R)]
    float32 audio at ``if_rate``."""

    def __init__(self, mode: str = "nfm", pre_decim: int = 1,
                 squelch_level: float = -100.0, channels: int = CHANNELS,
                 fs_mid: float = FS_MID, if_rate: float = IF_RATE,
                 bandwidth: float = BANDWIDTH, *, device="cuda"):
        if mode not in ("nfm", "usb"):
            raise ValueError(f"bank chain mode {mode!r}: nfm or usb")
        ls = (channels,)
        self.pre = (PowerDecimator(pre_decim, device=device)
                    if pre_decim > 1 else None)
        self.vfo = FFTChannelizerBank(bank_offsets(channels, fs_mid), fs_mid,
                                      if_rate, bandwidth=bandwidth,
                                      device=device)
        self.squelch = Squelch(squelch_level, sub_blocks=1, lead_shape=ls,
                               device=device)
        if mode == "nfm":
            self.demod = NFMDemod(bandwidth, if_rate, lead_shape=ls,
                                  device=device)
        else:
            self.demod = SSBDemod("usb", bandwidth=2700.0, samplerate=if_rate,
                                  lead_shape=ls, device=device)
        self.block_multiple = pre_decim * self.vfo.block_multiple

    def init_state(self):
        return {"pre": self.pre.init_state() if self.pre else (),
                "vfo": self.vfo.init_state(),
                "squelch": self.squelch.init_state(),
                "demod": self.demod.init_state()}

    def __call__(self, state, x):
        if x.shape[-1] % self.block_multiple:
            raise ValueError(f"block length {x.shape[-1]} must be a multiple "
                             f"of {self.block_multiple}")
        new = {"pre": ()}
        if self.pre is not None:
            new["pre"], x = self.pre(state["pre"], x)
        new["vfo"], y = self.vfo(state["vfo"], x)
        new["squelch"], y = self.squelch(state["squelch"], y)
        new["demod"], y = self.demod(state["demod"], y)
        return new, y


def make_chain(name: str, *, device="cuda") -> BankChain:
    """bench.py's chain by row name: wideband | aggregate | muted | ssb."""
    if name == "wideband":
        return BankChain("nfm", pre_decim=PRE_DECIM, device=device)
    if name == "aggregate":
        return BankChain("nfm", device=device)
    if name == "muted":
        return BankChain("nfm", squelch_level=-50.0, device=device)
    if name == "ssb":
        return BankChain("usb", device=device)
    raise ValueError(f"unknown bank chain {name!r}")
