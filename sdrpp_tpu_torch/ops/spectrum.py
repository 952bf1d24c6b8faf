"""Windowed FFT power spectrum (the spectrum/waterfall front-end).

The counterpart of ``sdrpp_tpu.ops.spectrum`` (reference pipeline:
core/src/signal_path/iq_frontend.cpp:230-296): keep ``nz`` samples of
every ``nz + skip``, multiply by the unity-gain *centered* window (the
alternating sign flip puts DC mid-spectrum), zero-pad to ``fft_size``, FFT,
10*log10(|X|^2 + 1e-20). A whole block's frames go through one batched
``torch.fft.fft``. ``fft_zoom`` max-decimates a span of a line into
display pixels (reference: core/src/gui/widgets/fft_scaler.h:21-64).
"""

from __future__ import annotations

import numpy as np
import torch

from .windows import Window, create_window

__all__ = ["gen_reshape_params", "SpectrumFFT", "fft_zoom"]


def gen_reshape_params(samplerate: float, size: int, rate: float) -> tuple[int, int]:
    """(skip, nz_count): FFTs fire every fs/rate samples with nz kept samples
    (reference: core/src/signal_path/iq_frontend.h:56-60)."""
    fft_interval = int(round(samplerate / rate))
    nz = min(fft_interval, size)
    skip = fft_interval - nz
    return skip, nz


class SpectrumFFT:
    """Batched spectrum pipeline for one wideband IQ block: a block of
    ``frames*(nz+skip)`` samples yields ``frames`` dB spectra."""

    def __init__(self, fft_size: int, samplerate: float, fft_rate: float,
                 window: Window = Window.NUTTALL, *, device):
        self.fft_size = int(fft_size)
        self.samplerate = float(samplerate)
        self.fft_rate = float(fft_rate)
        self.window_kind = window
        self.device = torch.device(device)
        skip, nz = gen_reshape_params(samplerate, fft_size, fft_rate)
        self.set_framing(nz + skip, nz)

    def set_framing(self, frame_len: int, nz: int):
        """Frames of ``frame_len`` samples, the first ``nz`` of them kept."""
        self.frame_len = int(frame_len)
        self.nz = int(nz)
        self.skip = self.frame_len - self.nz
        self.window = np.asarray(create_window(self.window_kind, self.nz,
                                               centered=True))
        self._window_dev = torch.from_numpy(self.window).to(self.device)

    def frames_per_block(self, n: int) -> int:
        if n % self.frame_len:
            raise ValueError(f"block length {n} must be a multiple of the "
                             f"FFT frame {self.frame_len}")
        return n // self.frame_len

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., n] complex64 -> [..., frames, fft_size] float32 dB."""
        frames = self.frames_per_block(x.shape[-1])
        fr = x.reshape(*x.shape[:-1], frames, self.frame_len)[..., : self.nz]
        spec = torch.fft.fft(fr * self._window_dev, n=self.fft_size, dim=-1)
        power = spec.real * spec.real + spec.imag * spec.imag
        return 10.0 * torch.log10(power + 1e-20)


def fft_zoom(line_db: torch.Tensor, offset: int, width: int,
             out_width: int) -> torch.Tensor:
    """Max-decimation zoom of dB lines [..., n] into ``out_width`` pixels:
    the ``width`` bins from ``offset`` (a negative one counted from the
    end, then moved to fit inside the line, as the JAX package's
    ``dynamic_slice`` takes it; sdrpp_tpu/ops/spectrum.py:80),
    each pixel the max over its bins. An even zoom is a reshape and a max;
    an uneven one a segment max over the pixel map ``bin * out_width //
    width``, computed on the host (a pixel with no bin stays -inf). On
    ``line_db``'s device."""
    n = line_db.shape[-1]
    start = int(offset) + (n if offset < 0 else 0)
    start = min(max(start, 0), n - int(width))
    seg = line_db[..., start:start + width]
    if width % out_width == 0:
        return seg.reshape(*seg.shape[:-1], out_width,
                           width // out_width).amax(dim=-1)
    pixel = torch.from_numpy(np.arange(width, dtype=np.int64) * out_width
                             // width).to(seg.device)
    flat = seg.reshape(-1, width)
    out = torch.full((flat.shape[0], out_width), float("-inf"),
                     dtype=seg.dtype, device=seg.device)
    out.scatter_reduce_(1, pixel.expand(flat.shape[0], width), flat, "amax",
                        include_self=False)
    return out.reshape(*seg.shape[:-1], out_width)
