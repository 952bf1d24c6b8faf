"""Static sample delay (reference: core/src/dsp/math/delay.h:47-61).

Used by the WFM stereo decoder to time-align the L+R and L-R paths with the
pilot filter's group delay. State = last ``delay`` samples of the previous
block; output = [state, x[:-delay]].
"""

from __future__ import annotations

import torch

from ..utils.blocks import Block

__all__ = ["Delay", "delay_block"]


def delay_block(state, x, delay: int):
    if delay == 0:
        return state, x
    buf = torch.cat([state, x], dim=-1)
    n = x.shape[-1]
    return buf[..., n:], buf[..., :n]


class Delay(Block):
    def __init__(self, delay: int, dtype=torch.float32, lead_shape=(), *,
                 device):
        self.delay = int(delay)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def init_state(self):
        return torch.zeros((*self.lead_shape, self.delay), dtype=self.dtype,
                           device=self.device)

    def __call__(self, state, x):
        return delay_block(state, x, self.delay)
