"""Quadrature FM discriminator.

The counterpart of ``sdrpp_tpu.ops.fm`` (reference
core/src/dsp/demod/quadrature.h:42-57): out[i] = angle(y[i] * conj(y[i-1]))
/ deviation; carry = last sample of the previous block.
"""

from __future__ import annotations

import numpy as np
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
    ``samplerate`` is None.

    ``dynamic_deviation``: the 1/deviation gain is a float32 state leaf
    (``inv_dev``) instead of a constant, so a bandwidth change (deviation
    = bw/2, reference setDeviation quadrature.h:60-67) is a state write
    between blocks (``inv_dev_state``)."""

    def __init__(self, deviation: float, samplerate: float | None = None,
                 lead_shape=(), dynamic_deviation: bool = False, *, device):
        self.samplerate = samplerate
        self.inv_deviation = 1.0 / self._rads(deviation)
        self.lead_shape = tuple(lead_shape)
        self.dynamic_deviation = bool(dynamic_deviation)
        self.device = torch.device(device)

    def _rads(self, deviation: float) -> float:
        return (hz_to_rads(deviation, self.samplerate)
                if self.samplerate is not None else deviation)

    def inv_dev_state(self, deviation: float) -> torch.Tensor:
        """The ``inv_dev`` leaf for ``deviation`` (Hz when built with a
        samplerate, rad/sample otherwise)."""
        return torch.full((), float(np.float32(1.0 / self._rads(deviation))),
                          dtype=torch.float32, device=self.device)

    def init_state(self):
        last = torch.zeros((*self.lead_shape, 1), dtype=torch.complex64,
                           device=self.device)
        if self.dynamic_deviation:
            return {"last": last, "inv_dev": torch.full(
                (), float(np.float32(self.inv_deviation)),
                dtype=torch.float32, device=self.device)}
        return last

    def __call__(self, state, x):
        if self.dynamic_deviation:
            last, y = quadrature_demod(state["last"], x, 1.0)
            return {"last": last, "inv_dev": state["inv_dev"]}, \
                y * state["inv_dev"]
        return quadrature_demod(state, x, self.inv_deviation)
