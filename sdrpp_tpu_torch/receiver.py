"""Receiver: the standing graph — source -> front end -> VFOs -> sinks.

The counterpart of ``sdrpp_tpu.receiver`` (reference:
core/src/gui/main_window.cpp:31-226, core/src/signal_path/vfo_manager.h):
a host loop pulls IQ blocks from the selected source, runs the front end
and every radio channel on the device, and routes per-channel audio to
sinks and FFT lines to a bounded ring. Runs eagerly: adding, removing or
retuning a VFO rebuilds the channel table and keeps the other channels'
state. Sources and sinks are the port's own numpy-only ``io.sources`` /
``io.sinks``. The device defaults to ``cuda``: without a card the
receiver raises rather than running on the CPU, which a caller asks for
with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .io.sinks import SinkManager
from .io.sources import SourceManager
from .models.radio import RadioChannel
from .ops.windows import Window
from .signal_path import IQFrontEnd

__all__ = ["Receiver"]


class Receiver:
    def __init__(self, samplerate: float, block_size: int = 262144,
                 decim_ratio: int = 1, dc_blocking: bool = True,
                 invert_iq: bool = False, fft_size: int = 65536,
                 fft_rate: float = 20.0, fft_window: Window = Window.NUTTALL,
                 audio_rate: float = 48000.0, *, device="cuda"):
        self.samplerate = float(samplerate)
        self.block_size = int(block_size)
        self.audio_rate = float(audio_rate)
        self.device = torch.device(device)
        self.frontend = IQFrontEnd(samplerate, decim_ratio, dc_blocking,
                                   invert_iq, fft_size, fft_rate, fft_window,
                                   block_size=block_size, device=device)
        self.sources = SourceManager()
        self.sinks = SinkManager()
        self._channels: dict[str, RadioChannel] = {}
        self._channel_cfg: dict[str, dict] = {}
        self._state = None
        self.fft_lines: list[np.ndarray] = []
        self.max_fft_lines = 2048  # raw-FFT ring bound (waterfall.cpp:883)

    # ---- VFO management (vfo_manager.h:6-67 equivalent) ----

    def create_vfo(self, name: str, mode: str, offset: float,
                   bandwidth: float | None = None, **kwargs):
        chan = RadioChannel(mode, self.frontend.effective_samplerate,
                            offset=offset, bandwidth=bandwidth,
                            audio_rate=self.audio_rate, device=self.device,
                            **kwargs)
        eff_block = self.block_size // self.frontend.decim_ratio
        if eff_block % chan.block_multiple:
            raise ValueError(
                f"block size {eff_block} not a multiple of channel requirement "
                f"{chan.block_multiple} for mode {mode}")
        self._channels[name] = chan
        self._channel_cfg[name] = dict(mode=mode, bandwidth=bandwidth, **kwargs)
        self.sinks.register_stream(name, self.audio_rate)
        self._rebuild()
        return chan

    def delete_vfo(self, name: str):
        self._channels.pop(name, None)
        self._channel_cfg.pop(name, None)
        self.sinks.unregister_stream(name)
        self._rebuild()

    def set_vfo_offset(self, name: str, offset: float):
        """Rebuild the channel at a new offset with its full configuration
        (its carried state is kept, as the JAX Receiver keeps it)."""
        cfg = dict(self._channel_cfg[name])
        self._channels[name] = RadioChannel(
            cfg.pop("mode"), self.frontend.effective_samplerate, offset=offset,
            bandwidth=cfg.pop("bandwidth"), audio_rate=self.audio_rate,
            device=self.device, **cfg)
        self._rebuild()

    def _rebuild(self):
        old = self._state
        self._state = {
            "frontend": old["frontend"] if old else self.frontend.init_state(),
            "channels": {
                name: (old["channels"][name]
                       if old and name in old["channels"]
                       else chan.init_state())
                for name, chan in self._channels.items()
            },
        }

    # ---- run loop ----

    def step(self, state, x: torch.Tensor):
        """One block on the device: (state, iq) -> (state, (audio, fft))."""
        fe_state, (iq, fft) = self.frontend(state["frontend"], x)
        new_state = {"frontend": fe_state, "channels": {}}
        audio = {}
        for name, chan in self._channels.items():
            new_state["channels"][name], audio[name] = chan(
                state["channels"][name], iq)
        return new_state, (audio, fft)

    def process_block(self, iq: np.ndarray):
        """Run one block through the graph and route its outputs. Returns
        (audio dict of device tensors, fft lines as numpy); a channel with
        RDS gives (audio, rds baseband), and its audio goes to the sink."""
        if self._state is None:
            self._rebuild()
        if len(iq) != self.block_size:
            raise ValueError(f"block of {len(iq)} samples, expected "
                             f"{self.block_size}")
        x = torch.from_numpy(np.ascontiguousarray(iq, np.complex64)).to(
            self.device)
        self._state, (audio, fft) = self.step(self._state, x)
        for name, out in audio.items():
            out = out[0] if isinstance(out, tuple) else out
            self.sinks.write(name, out.cpu().numpy())
        fft_np = fft.cpu().numpy()
        self.fft_lines.extend(list(fft_np))
        # bound like the reference's raw-FFT ring (waterfall.cpp:883-895)
        if len(self.fft_lines) > self.max_fft_lines:
            del self.fft_lines[: len(self.fft_lines) - self.max_fft_lines]
        return audio, fft_np

    def run(self, num_blocks: int):
        src = self.sources.source
        if src is None:
            raise RuntimeError("no source selected")
        if abs(src.samplerate - self.samplerate) > 1e-6:
            raise ValueError(f"source rate {src.samplerate} != receiver rate "
                             f"{self.samplerate}")
        for _ in range(num_blocks):
            self.process_block(src.read(self.block_size))
