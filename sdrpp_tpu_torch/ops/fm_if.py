"""FM IF noise reduction: per-sample sliding-DFT max-bin filter.

The counterpart of ``sdrpp_tpu.ops.fm_if`` (reference:
core/src/dsp/noise_reduction/fm_if.h:45-77): for every sample, a
``bins``-point windowed DFT of the trailing window, keep only the bin of
largest magnitude, inverse DFT, take the centre sample. The sliding
windowed DFT of the whole block is one real ``conv1d`` with the packed
[2*bins, 2, bins] kernel (real and imaginary planes as channels); the
bin is the first maximum of |X|^2 (the reference's ``>`` loop), and the
inverse of a single bin k at index bins/2 is X_k * (-1)^k. Window:
nuttall(i, bins - 1) (fm_if.h:112). TF32 is off package-wide, so the
convolution runs in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.blocks import Block
from .windows import nuttall

__all__ = ["FMIFNoiseReduction", "fm_if_kernel"]


def fm_if_kernel(bins: int) -> np.ndarray:
    """The windowed DFT matrix M[j, k] = w[j] e^{-2 pi i jk / bins} packed
    as a real conv1d weight [2*bins, 2, bins]: output channels k are the
    real parts, bins + k the imaginary parts, of bin k."""
    b = int(bins)
    window = nuttall(np.arange(b), float(b - 1)).astype(np.float32)
    j = np.arange(b)
    M = window[:, None] * np.exp(-2j * np.pi * np.outer(j, j) / b)
    kern = np.zeros((2 * b, 2, b), np.float32)
    kern[:b, 0, :] = M.real.T
    kern[:b, 1, :] = -M.imag.T
    kern[b:, 0, :] = M.imag.T
    kern[b:, 1, :] = M.real.T
    return kern


class FMIFNoiseReduction(Block):
    """State: the last ``bins - 1`` complex input samples."""

    def __init__(self, bins: int = 32, lead_shape=(), *, device):
        self.bins = int(bins)
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)
        self.weight = torch.from_numpy(fm_if_kernel(self.bins)).to(self.device)

    def init_state(self):
        return torch.zeros((*self.lead_shape, self.bins - 1),
                           dtype=torch.complex64, device=self.device)

    def __call__(self, state, x):
        n = x.shape[-1]
        b = self.bins
        buf = torch.cat([state, x], dim=-1)  # [..., n + b - 1]
        lead = buf.shape[:-1]
        planes = torch.view_as_real(buf).movedim(-1, -2).reshape(
            -1, 2, n + b - 1)
        spec = F.conv1d(planes, self.weight)  # [B, 2b, n]
        sr, si = spec[:, :b], spec[:, b:]
        k = torch.argmax(sr * sr + si * si, dim=1, keepdim=True)  # [B, 1, n]
        sign = 1.0 - 2.0 * (k % 2).to(torch.float32)
        xr = torch.gather(sr, 1, k) * sign
        xi = torch.gather(si, 1, k) * sign
        y = torch.complex(xr, xi).reshape(*lead, n)
        return buf[..., n:].clone(), y
