"""Audio sinks: WAV file, buffer, null; stream registry with volume.

A numpy-only copy of the file sinks of ``sdrpp_tpu.io.sinks`` (reference:
core/src/signal_path/sink.{h,cpp} — named streams, each a volume and a
pluggable provider). ``RecorderSink`` writes WAV, FLAC (``io.flac``) or
MP3 (``io.mp3``, the system libmp3lame; ImportError without it).
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
    """Container-selectable recording sink: WAV / FLAC / MP3.

    The reference recorder's container + sample-depth options
    (misc_modules/recorder/src/main.cpp:48-60; containers WAV/FLAC/MP3,
    FLAC restricted to integer formats, MP3 ignores the depth). FLAC is
    the pure-Python encoder in io/flac.py; MP3 binds the system
    libmp3lame (io/mp3.py) and raises ImportError when absent.
    """

    def __init__(self, path, samplerate: int, container: str = "wav",
                 channels: int = 1, sample_format: str = "i16"):
        container = container.lower()
        self.container = container
        if container == "wav":
            self._sink = WavSink(path, samplerate, sample_format)
        elif container == "flac":
            if sample_format not in ("u8", "i16", "i24", "i32"):
                # wav.cpp:95 FLAC requires integer sample formats
                raise ValueError(f"FLAC needs an integer format, "
                                 f"got {sample_format}")
            bits = {"u8": 8, "i16": 16, "i24": 24, "i32": 32}[sample_format]
            from .flac import FlacWriter
            self._sink = FlacWriter(path, samplerate, channels=channels,
                                    bits=bits)
        elif container == "mp3":
            from .mp3 import Mp3Writer
            self._sink = Mp3Writer(path, samplerate, channels=channels)
        else:
            raise ValueError(f"unknown container {container}")

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
