"""Audio sinks: WAV file, buffer, null; stream registry with volume.

A numpy-only copy of the file sinks of ``sdrpp_tpu.io.sinks`` (reference:
core/src/signal_path/sink.{h,cpp} — named streams, each a volume and a
pluggable provider). ``RecorderSink`` writes WAV; its FLAC and MP3
containers are not copied yet (ROADMAP A9) and raise.
"""

from __future__ import annotations

import numpy as np

from . import wav

__all__ = ["WavSink", "RecorderSink", "BufferSink", "NullSink", "SinkManager"]


class WavSink:
    """Accumulate audio and flush to a WAV file (the recorder's audio path,
    misc_modules/recorder/src/main.cpp)."""

    def __init__(self, path, samplerate: int, sample_format: str = "i16"):
        self.path = path
        self.samplerate = int(samplerate)
        self.sample_format = sample_format
        self._chunks: list[np.ndarray] = []

    def write(self, audio: np.ndarray):
        self._chunks.append(np.asarray(audio, np.float32))

    def close(self):
        data = np.concatenate(self._chunks) if self._chunks else np.zeros(0, np.float32)
        wav.write_wav(self.path, self.samplerate, data, self.sample_format)
        self._chunks = []


class RecorderSink:
    """Container-selectable recording sink (the reference recorder's
    container and sample-depth options, misc_modules/recorder/src/
    main.cpp:48-60). Only the WAV container is ported."""

    def __init__(self, path, samplerate: int, container: str = "wav",
                 channels: int = 1, sample_format: str = "i16"):
        container = container.lower()
        self.container = container
        if container in ("flac", "mp3"):
            raise NotImplementedError(
                f"the {container} container (io/{container}.py) is not "
                f"ported to sdrpp_tpu_torch yet (ROADMAP A9); use wav")
        if container != "wav":
            raise ValueError(f"unknown container {container}")
        self._sink = WavSink(path, samplerate, sample_format)

    def write(self, audio: np.ndarray):
        self._sink.write(np.asarray(audio))

    def close(self):
        self._sink.close()


class BufferSink:
    def __init__(self):
        self._chunks: list[np.ndarray] = []

    def write(self, audio):
        self._chunks.append(np.asarray(audio, np.float32))

    def data(self) -> np.ndarray:
        return (np.concatenate(self._chunks)
                if self._chunks else np.zeros(0, np.float32))

    def close(self):
        pass


class NullSink:
    def write(self, audio):
        pass

    def close(self):
        pass


class SinkManager:
    """Named audio streams with per-stream volume (sink.h:13-134)."""

    def __init__(self):
        self._streams: dict[str, dict] = {}

    def register_stream(self, name: str, samplerate: float, provider=None):
        self._streams[name] = {
            "samplerate": samplerate,
            "provider": provider or NullSink(),
            "volume": 1.0,
            "muted": False,
        }

    def unregister_stream(self, name: str):
        s = self._streams.pop(name, None)
        if s:
            s["provider"].close()

    def set_provider(self, name: str, provider):
        self._streams[name]["provider"] = provider

    def set_volume(self, name: str, volume: float):
        # the reference's Volume block applies gain = volume^2 — a power-law
        # slider curve (dsp/audio/volume.h:14-17) — kept for parity
        self._streams[name]["volume"] = float(volume) ** 2

    def set_muted(self, name: str, muted: bool):
        self._streams[name]["muted"] = bool(muted)

    def write(self, name: str, audio: np.ndarray):
        s = self._streams[name]
        gain = 0.0 if s["muted"] else s["volume"]
        s["provider"].write(np.asarray(audio, np.float32) * np.float32(gain))

    def close(self):
        for s in self._streams.values():
            s["provider"].close()
