"""IQ front end: preprocessing + spectrum branch (signal-path L3).

The counterpart of ``sdrpp_tpu.signal_path`` (reference:
core/src/signal_path/iq_frontend.{h,cpp}): power-of-2 decimator, DC
blocker, IQ conjugate, then the display FFT. ``(state, x) -> (state,
(iq, fft_lines))``; the VFOs consume the returned ``iq``.
"""

from __future__ import annotations

import torch

from .ops.resample import PowerDecimator
from .ops.scans import DCBlocker
from .ops.spectrum import SpectrumFFT
from .ops.windows import Window
from .utils.blocks import Block

__all__ = ["IQFrontEnd"]


class IQFrontEnd(Block):
    """Preprocessing front end + display FFT.

    - ``decim_ratio``: power-of-2 pre-decimation (iq_frontend.cpp:30,90-101)
    - ``dc_blocking``: leaky DC blocker at rate 50/fs (iq_frontend.h:52-54)
    - ``invert_iq``: conjugate (core/src/dsp/math/conjugate.h)
    - FFT branch: keep/skip framing at ``fft_rate`` Hz, unity-gain centered
      window, dB power (iq_frontend.cpp:230-296). The frame interval is
      snapped to a divisor of the block length.
    """

    def __init__(self, samplerate: float, decim_ratio: int = 1,
                 dc_blocking: bool = True, invert_iq: bool = False,
                 fft_size: int = 65536, fft_rate: float = 20.0,
                 fft_window: Window = Window.NUTTALL,
                 block_size: int | None = None, *, device):
        self.samplerate = float(samplerate)
        self.decim_ratio = int(decim_ratio)
        self.effective_samplerate = self.samplerate / self.decim_ratio
        self.invert_iq = invert_iq
        self.device = torch.device(device)
        self.decim = (PowerDecimator(self.decim_ratio, device=device)
                      if decim_ratio > 1 else None)
        self.dc_block = (DCBlocker(50.0 / self.effective_samplerate,
                                   device=device) if dc_blocking else None)
        self.spectrum = SpectrumFFT(fft_size, self.effective_samplerate,
                                    fft_rate, fft_window, device=device)
        self.block_size = block_size
        if block_size is not None:
            self._snap_fft_interval(block_size // self.decim_ratio)

    def _snap_fft_interval(self, eff_block: int):
        """Adjust the keep/skip interval so it divides the block length."""
        fl = self.spectrum.frame_len
        if eff_block % fl == 0:
            return
        frames = max(1, int(round(eff_block / fl)))
        while eff_block % frames:
            frames -= 1
        new_fl = eff_block // frames
        self.spectrum.set_framing(new_fl, min(self.spectrum.nz, new_fl))

    def init_state(self):
        return {
            "decim": self.decim.init_state() if self.decim else (),
            "dc": self.dc_block.init_state() if self.dc_block else (),
        }

    def __call__(self, state, x):
        st = dict(state)
        if self.decim is not None:
            st["decim"], x = self.decim(state["decim"], x)
        if self.dc_block is not None:
            st["dc"], x = self.dc_block(state["dc"], x)
        if self.invert_iq:
            x = torch.conj(x).resolve_conj()
        return st, (x, self.spectrum(x))
