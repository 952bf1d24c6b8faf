"""TX modulators (reference core/src/dsp/mod/).

The counterpart of ``sdrpp_tpu.ops.modulators``:

- QuadratureMod: FM modulator — phase += dev*x; out = phasor(phase)
  (mod/quadrature.h:44-49), vectorized as a cumulative sum with carried
  phase (a float32 cumsum: its sums round in another order than the JAX
  package's, so the two agree to a tolerance, not bit for bit).
- PSKMod: RRC-interpolating PSK pulse shaper (mod/psk.h — a typedef of
  multirate::RRCInterpolator<complex_t>), on the port's RRCInterpolator.
- GFSKMod: RRC symbol shaping -> FM modulation (mod/gfsk.h:60-64).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.blocks import Block
from .resample import RRCInterpolator

__all__ = ["QuadratureMod", "PSKMod", "GFSKMod"]


class QuadratureMod(Block):
    """float baseband -> complex FM (mod/quadrature.h).

    deviation in Hz at ``samplerate``: input +-1.0 swings +-deviation.
    Phase is carried across blocks and kept wrapped (the reference
    normalizes per sample; a single wrap of the carry is equivalent and
    keeps the cumsum fully parallel).
    """

    def __init__(self, deviation: float, samplerate: float, lead_shape=(),
                 *, device="cuda"):
        self.dev_rads = 2.0 * np.pi * float(deviation) / float(samplerate)
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def init_state(self):
        return {"phase": torch.zeros(self.lead_shape, dtype=torch.float32,
                                     device=self.device)}

    def __call__(self, state, x):
        phase = state["phase"][..., None] + torch.cumsum(
            x.to(torch.float32) * float(np.float32(self.dev_rads)), dim=-1)
        out = torch.polar(torch.ones_like(phase), phase)
        last = torch.remainder(phase[..., -1] + np.pi, 2.0 * np.pi) - np.pi
        return {"phase": last}, out


class PSKMod(Block):
    """complex symbols -> RRC-shaped baseband (mod/psk.h)."""

    def __init__(self, symbolrate: float, samplerate: float,
                 rrc_beta: float, rrc_tap_count: int, lead_shape=(), *,
                 device="cuda"):
        self.interp = RRCInterpolator(symbolrate, samplerate, rrc_beta,
                                      rrc_tap_count, dtype=torch.complex64,
                                      lead_shape=lead_shape, device=device)
        self.block_multiple = self.interp.block_multiple

    def out_count(self, n: int) -> int:
        return self.interp.out_count(n)

    def init_state(self):
        return self.interp.init_state()

    def __call__(self, state, x):
        return self.interp(state, x)


class GFSKMod(Block):
    """float symbols -> RRC shaping -> FM (mod/gfsk.h)."""

    def __init__(self, symbolrate: float, samplerate: float,
                 rrc_beta: float, rrc_tap_count: int, deviation: float,
                 lead_shape=(), *, device="cuda"):
        self.interp = RRCInterpolator(symbolrate, samplerate, rrc_beta,
                                      rrc_tap_count, dtype=torch.float32,
                                      lead_shape=lead_shape, device=device)
        self.mod = QuadratureMod(deviation, samplerate,
                                 lead_shape=lead_shape, device=device)
        self.block_multiple = self.interp.block_multiple

    def out_count(self, n: int) -> int:
        return self.interp.out_count(n)

    def init_state(self):
        return {"interp": self.interp.init_state(),
                "mod": self.mod.init_state()}

    def __call__(self, state, x):
        is_, y = self.interp(state["interp"], x)
        ms, out = self.mod(state["mod"], y)
        return {"interp": is_, "mod": ms}, out
