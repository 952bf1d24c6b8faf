"""Bit-level digital ops (reference: core/src/dsp/digital/*.h).

The counterpart of ``sdrpp_tpu.ops.digital``. These follow the symbol
synchronizer, whose block output is prefix-valid (symbols[0:num_valid]
real, the rest padding): each op takes the whole fixed-shape block and a
valid count, and the padding positions give don't-care values.
"""

from __future__ import annotations

import torch

from ..utils.blocks import Block

__all__ = ["binary_slicer", "DifferentialDecoder", "manchester_decode"]


def binary_slicer(x: torch.Tensor) -> torch.Tensor:
    """bit = x > 0 as uint8 (reference: digital/binary_slicer.h:12-17)."""
    return (x > 0).to(torch.uint8)


class DifferentialDecoder(Block):
    """out[i] = (in[i] - last + mod) % mod
    (reference: digital/differential_decoder.h:41-46).

    Called with (symbols, num_valid): the ``last`` symbol carried across
    blocks is the one at num_valid - 1, or the previous carry when the
    block has none. State: that symbol, int32."""

    def __init__(self, modulus: int, init_sym: int = 0, *, device):
        self.modulus = int(modulus)
        self.init_sym = int(init_sym)
        self.device = torch.device(device)

    def init_state(self):
        return torch.full((), self.init_sym, dtype=torch.int32,
                          device=self.device)

    def __call__(self, state, inputs):
        syms, num_valid = inputs
        s = syms.to(torch.int32)
        prev = torch.cat([state.reshape(1), s[:-1]])
        out = torch.remainder(s - prev + self.modulus, self.modulus)
        num_valid = torch.as_tensor(num_valid, device=s.device)
        at = torch.clamp(num_valid - 1, min=0).to(torch.int64).reshape(1)
        last = torch.where(num_valid > 0, s.gather(0, at)[0], state)
        return last, out.to(torch.uint8)


def manchester_decode(state_offset, bits: torch.Tensor, num_valid):
    """Keep every 2nd symbol from the carried offset's parity (reference:
    digital/manchester_decoder.h:20-27). Returns (new_offset,
    decoded [n // 2 + 1] uint8, out_valid_count)."""
    n = bits.shape[-1]
    dev = bits.device
    state_offset = torch.as_tensor(state_offset, dtype=torch.int32,
                                   device=dev)
    num_valid = torch.as_tensor(num_valid, dtype=torch.int32, device=dev)
    idx = state_offset + 2 * torch.arange(n // 2 + 1, dtype=torch.int32,
                                          device=dev)
    taken = idx < num_valid
    picked = bits.gather(-1, torch.clamp(idx, 0, n - 1).to(torch.int64))
    out = torch.where(taken, picked, torch.zeros_like(picked))
    count = taken.to(torch.int32).sum()
    return (state_offset + 2 * count - num_valid, out.to(torch.uint8),
            count)
