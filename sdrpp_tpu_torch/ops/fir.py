"""FIR filtering: overlap-save FFT correlation and strided decimation.

The counterpart of ``sdrpp_tpu.ops.fir`` (reference:
core/src/dsp/filter/fir.h:67-84, decimating_fir.h:49-69). The carried
state is the last ``ntaps-1`` input samples; taps are applied by
*correlation* (y[i] = sum_j taps[j] * buf[i+j], buf = [tail | x]), so the
overlap-save form multiplies by the spectrum of the reversed taps.

Taps are designed on the host; each block moves its taps (or their
spectrum, per block length) to its device once and keeps them there.

Decimation keeps the reference's phase semantics (first output at the
carried offset, then every R-th input sample); block lengths must be a
multiple of R. The JAX package picks a strided convolution or an unrolled
polyphase sum by backend; the port runs the strided ``conv1d`` (a
correlation: conv1d does not flip its kernel) on every device, complex
taps as two real channels (their real and imaginary parts) whose outputs
combine as re + j im, and ``DecimatingFIR`` sends real taps at R >= 8 to
the decimating-FIR kernel (``fir_kernels.decimating_fir``), as the
power-of-2 decimator's stages do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.blocks import Block
from .fir_kernels import decimating_fir

__all__ = ["fir_correlate", "FIR", "fir_init_tail", "pad_taps_front",
           "RuntimeFIR", "decimating_fir_correlate", "DecimatingFIR",
           "strided_correlate", "tap_weight", "combine_planes",
           "taps_spectrum"]


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _fft_len(n: int, m: int) -> int:
    return _next_pow2(n + 2 * (m - 1))


def taps_spectrum(taps: np.ndarray, fft_len: int, device) -> torch.Tensor:
    """FFT of the zero-padded reversed taps (host float64, then complex64
    on ``device``)."""
    rev = np.asarray(taps)[::-1]
    padded = np.zeros(fft_len, dtype=np.complex128)
    padded[: rev.shape[0]] = rev
    return torch.from_numpy(np.fft.fft(padded).astype(np.complex64)).to(device)


def fir_init_tail(ntaps: int, dtype=torch.complex64, lead_shape=(), *,
                  device) -> torch.Tensor:
    """Zeroed delay-line tail of ntaps-1 samples (reference fir.h:24-27)."""
    return torch.zeros((*lead_shape, ntaps - 1), dtype=dtype, device=device)


def fir_correlate(tail: torch.Tensor, x: torch.Tensor, taps,
                  spec: torch.Tensor | None = None):
    """Filter one block; returns (new_tail, y) with y.shape == x.shape.

    y[i] = sum_j taps[j] * buf[i + j] with buf = concat([tail, x]) (the
    reference's sliding correlation, fir.h:67-76), over any leading axes.
    ``taps`` is a host array, or a real tensor on x's device (a
    ``RuntimeFIR``'s state leaf). ``spec`` is the spectrum of the reversed
    taps at the block's FFT length (``taps_spectrum``), built here when
    not given: on the host from an array, on the device from a tensor.
    """
    on_device = isinstance(taps, torch.Tensor)
    if not on_device:
        taps = np.asarray(taps)
    m = taps.shape[0]
    n = x.shape[-1]
    if m == 1:
        # degenerate single-tap case (e.g. NFM's dummy filter)
        return tail, x * taps[0].item()
    buf = torch.cat([tail, x], dim=-1)  # [..., n + m - 1]
    fft_len = _fft_len(n, m)
    if spec is None and on_device:
        spec = torch.fft.fft(torch.flip(taps, [0]).to(torch.complex64),
                             n=fft_len)
    elif spec is None:
        spec = taps_spectrum(taps, fft_len, x.device)
    xf = torch.fft.fft(buf.to(torch.complex64), n=fft_len, dim=-1)
    y_full = torch.fft.ifft(xf * spec, dim=-1)
    # full linear convolution index (m-1) is correlation output 0
    y = y_full[..., m - 1: m - 1 + n]
    complex_taps = taps.is_complex() if on_device else np.iscomplexobj(taps)
    if not x.is_complex() and not complex_taps:
        y = y.real.to(x.dtype)
    return buf[..., n:].clone(), y


class FIR(Block):
    """1:1 FIR filter block with carried tail (reference fir.h:6-100)."""

    def __init__(self, taps: np.ndarray, dtype=torch.complex64, lead_shape=(),
                 *, device):
        self.taps = np.asarray(taps)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)
        self._specs: dict[int, torch.Tensor] = {}

    def init_state(self):
        return fir_init_tail(self.taps.shape[0], self.dtype, self.lead_shape,
                             device=self.device)

    def __call__(self, state, x):
        fft_len = _fft_len(x.shape[-1], self.taps.shape[0])
        spec = self._specs.get(fft_len)
        if spec is None and self.taps.shape[0] > 1:
            spec = self._specs[fft_len] = taps_spectrum(self.taps, fft_len,
                                                        self.device)
        return fir_correlate(state, x, self.taps, spec)


def pad_taps_front(taps: np.ndarray, max_taps: int) -> np.ndarray:
    """Zero-pad real taps at the FRONT to ``max_taps`` (float32).

    Front padding keeps the unpadded filter's output alignment: with a
    tail of max_taps - 1 samples, y[i] = sum_j t[j] * buf[i + j + max_taps
    - m], the m-tap correlation of fir.h:67-76, so a ``RuntimeFIR`` at
    bandwidth B is sample for sample the static ``FIR`` at B."""
    taps = np.asarray(taps, np.float32)
    m = taps.shape[0]
    if m > max_taps:
        raise ValueError(f"{m} taps exceed the static budget {max_taps}")
    out = np.zeros(max_taps, np.float32)
    out[max_taps - m:] = taps
    return out


class RuntimeFIR(Block):
    """1:1 FIR whose real taps are STATE: a [max_taps] float32 leaf,
    front-padded (``pad_taps_front``), beside the delay-line tail. A
    bandwidth change is a host tap design and a state write
    (``taps_state``) that keeps the delay line, as the reference's
    setTaps (fir.h:31-52). Each block is ``fir_correlate`` with the
    state's taps, their spectrum taken on the device."""

    def __init__(self, max_taps: int, init_taps: np.ndarray,
                 dtype=torch.complex64, lead_shape=(), *, device):
        self.max_taps = int(max_taps)
        self.init_taps = np.asarray(init_taps, np.float32)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def taps_state(self, taps: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(pad_taps_front(taps, self.max_taps)).to(
            self.device)

    def init_state(self):
        return {"tail": fir_init_tail(self.max_taps, self.dtype,
                                      self.lead_shape, device=self.device),
                "taps": self.taps_state(self.init_taps)}

    def __call__(self, state, x):
        tail, y = fir_correlate(state["tail"], x, state["taps"])
        return {"tail": tail, "taps": state["taps"]}, y


def strided_correlate(buf: torch.Tensor, weight: torch.Tensor, stride: int,
                      out_n: int) -> torch.Tensor:
    """y[..., c, k] = sum_j weight[c, 0, j] * buf[..., stride*k + j] for
    k < out_n: one float32 ``conv1d`` over [..., L] real or complex
    ``buf`` (complex as two real planes) with real ``weight`` [C, 1, K].
    Returns [..., C, out_n], complex when ``buf`` is."""
    lead = buf.shape[:-1]
    L = buf.shape[-1]
    if buf.is_complex():
        planes = torch.view_as_real(buf).movedim(-1, -2).reshape(-1, 1, L)
    else:
        planes = buf.reshape(-1, 1, L)
    out = F.conv1d(planes, weight, stride=stride)[..., :out_n]
    C = weight.shape[0]
    if not buf.is_complex():
        return out.reshape(*lead, C, out_n)
    out = out.reshape(*lead, 2, C, out_n).movedim(-3, -1)
    return torch.view_as_complex(out.contiguous())


def tap_weight(taps: np.ndarray, device) -> torch.Tensor:
    """Taps as a float32 ``conv1d`` weight: real taps [1, 1, m], complex
    taps [2, 1, m] (the real part, then the imaginary part)."""
    taps = np.asarray(taps)
    if np.iscomplexobj(taps):
        w = np.stack([taps.real, taps.imag])[:, None, :]
    else:
        w = taps.reshape(1, 1, -1)
    return torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(device)


def combine_planes(re_part: torch.Tensor, im_part: torch.Tensor
                   ) -> torch.Tensor:
    """re + j im of a complex-tap correlation's two channels: the taps'
    real and imaginary parts against real or complex input."""
    if not re_part.is_complex():
        return torch.complex(re_part, im_part)
    return torch.complex(re_part.real - im_part.imag,
                         re_part.imag + im_part.real)


def decimating_fir_correlate(tail: torch.Tensor, x: torch.Tensor,
                             taps: np.ndarray, decimation: int,
                             weight: torch.Tensor | None = None):
    """FIR + keep-every-R-th-output (reference decimating_fir.h:49-69):
    y[k] = sum_j taps[j] * buf[R*k + j]. The block length must be a
    multiple of ``decimation``. ``taps`` real or complex; the output is
    complex when x or the taps are. ``weight`` is ``tap_weight(taps)`` on
    x's device, built here when not given."""
    taps = np.asarray(taps)
    n = x.shape[-1]
    r = int(decimation)
    if n % r:
        raise ValueError(f"block length {n} must be a multiple of decimation {r}")
    if weight is None:
        weight = tap_weight(taps, x.device)
    buf = torch.cat([tail, x], dim=-1)  # [..., n + m - 1]
    out = strided_correlate(buf, weight, r, n // r)
    y = out[..., 0, :] if out.shape[-2] == 1 else \
        combine_planes(out[..., 0, :], out[..., 1, :])
    return buf[..., n:].clone(), y


class DecimatingFIR(Block):
    """FIR evaluated every R-th sample (reference decimating_fir.h:6-100),
    the counterpart of the JAX package's (fir.py:319). Real taps at R >= 8
    on complex64 or float32 input run the decimating-FIR kernel
    (``fir_kernels.decimating_fir``: csrc/decim_fir.cu on a CUDA tensor,
    its plain version on a CPU tensor); other real taps and complex taps
    are ``decimating_fir_correlate``'s strided ``conv1d``."""

    def __init__(self, taps: np.ndarray, decimation: int,
                 dtype=torch.complex64, lead_shape=(), *, device):
        self.taps = np.asarray(taps)
        self.decimation = int(decimation)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)
        self._weight = tap_weight(self.taps, self.device)
        self._kernel = (self.decimation >= 8
                        and not np.iscomplexobj(self.taps))

    def init_state(self):
        return fir_init_tail(self.taps.shape[0], self.dtype, self.lead_shape,
                             device=self.device)

    def __call__(self, state, x):
        if self._kernel and x.dtype in (torch.complex64, torch.float32):
            return decimating_fir(state, x, self._weight.reshape(-1),
                                  self.decimation)
        return decimating_fir_correlate(state, x, self.taps,
                                        self.decimation, self._weight)
