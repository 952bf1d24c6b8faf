"""Keep/skip re-blocking (Reshaper) and fixed-frame packing (Packer).

The counterpart of ``sdrpp_tpu.ops.reshape`` (reference:
core/src/dsp/buffer/reshaper.h:11-137, keep N samples, skip M, emit
N-sample frames, and buffer/packer.h:6-68, accumulate into fixed-size
frames): strided reshapes, and index gathers with a carried partial frame
whose fill count stays on the device.
"""

from __future__ import annotations

import torch

from ..utils.blocks import Block

__all__ = ["KeepSkipReshaper", "Packer"]


class KeepSkipReshaper(Block):
    """Emit ``keep``-sample frames every ``keep+skip`` input samples.

    Block length must be a multiple of keep+skip. Output: [..., frames,
    keep].
    """

    def __init__(self, keep: int, skip: int):
        self.keep = int(keep)
        self.skip = int(skip)
        self.frame_len = self.keep + self.skip

    def frames_per_block(self, n: int) -> int:
        assert n % self.frame_len == 0, (n, self.frame_len)
        return n // self.frame_len

    def __call__(self, state, x):
        n = x.shape[-1]
        frames = self.frames_per_block(n)
        fr = x.reshape(*x.shape[:-1], frames, self.frame_len)
        return state, fr[..., : self.keep]


class Packer(Block):
    """Re-block a stream into exact ``frame_len`` frames with a carried
    partial frame (packer.h). Returns ([frames, frame_len], count): the
    first ``count`` frames are complete (count an int32 tensor)."""

    def __init__(self, frame_len: int, dtype=torch.complex64, *,
                 device="cuda"):
        self.frame_len = int(frame_len)
        self.dtype = dtype
        self.device = torch.device(device)

    def init_state(self):
        # carried partial frame (its `fill` valid samples at its END)
        return {"partial": torch.zeros(self.frame_len, dtype=self.dtype,
                                       device=self.device),
                "fill": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def __call__(self, state, x):
        n = x.shape[-1]
        fl = self.frame_len
        dev = x.device
        max_frames = (n + fl - 1) // fl + 1
        buf = torch.cat([state["partial"], x.to(self.dtype)])
        fill = state["fill"]
        total = fill + n
        nframes = torch.div(total, fl, rounding_mode="floor")
        # valid data = buf[fl - fill : fl + n]; frame k = its [k*fl, (k+1)*fl)
        start = fl - fill
        last = buf.shape[0] - 1
        idx = start + torch.arange(max_frames * fl, device=dev).reshape(
            max_frames, fl)
        frames = buf[idx.clamp(0, last)]
        new_fill = total - nframes * fl
        # the new partial: the last new_fill valid samples, at its end
        tail_idx = start + total - fl + torch.arange(fl, device=dev)
        new_partial_full = buf[tail_idx.clamp(0, last)]
        pos = torch.arange(fl, device=dev)
        new_partial = torch.where(pos >= fl - new_fill, new_partial_full,
                                  torch.zeros((), dtype=self.dtype,
                                              device=dev))
        return {"partial": new_partial,
                "fill": new_fill.to(torch.int32)}, (frames, nframes.to(
                    torch.int32))
