"""Quadrature FM discriminator.

The counterpart of ``sdrpp_tpu.ops.fm`` (reference
core/src/dsp/demod/quadrature.h:42-57): out[i] = angle(y[i] * conj(y[i-1]))
/ deviation; carry = last sample of the previous block.
"""

from __future__ import annotations

import torch

from ..utils.blocks import Block
from .mix import hz_to_rads

__all__ = ["quadrature_demod", "Quadrature"]


def quadrature_demod(last: torch.Tensor, x: torch.Tensor,
                     inv_deviation: float):
    """FM-discriminate one block; returns (new_last, audio).

    ``last`` is the final sample of the previous block ([..., 1] complex)."""
    prev = torch.cat([last, x[..., :-1]], dim=-1)
    prod = x * torch.conj(prev)
    y = torch.atan2(prod.imag, prod.real) * inv_deviation
    return x[..., -1:].clone(), y


class Quadrature(Block):
    """FM discriminator block (reference quadrature.h:10-88).

    ``deviation`` in Hz with ``samplerate``, or in rad/sample when
    ``samplerate`` is None."""

    def __init__(self, deviation: float, samplerate: float | None = None,
                 lead_shape=(), *, device):
        dev = hz_to_rads(deviation, samplerate) if samplerate is not None else deviation
        self.inv_deviation = 1.0 / dev
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def init_state(self):
        return torch.zeros((*self.lead_shape, 1), dtype=torch.complex64,
                           device=self.device)

    def __call__(self, state, x):
        return quadrature_demod(state, x, self.inv_deviation)
