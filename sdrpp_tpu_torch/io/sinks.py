"""Audio sinks: WAV file, buffer, null, network; stream registry with
volume.

A numpy copy of the sinks of ``sdrpp_tpu.io.sinks`` (reference:
core/src/signal_path/sink.{h,cpp} — named streams, each a volume and a
pluggable provider). ``RecorderSink`` writes WAV, FLAC (``io.flac``) or
MP3 (``io.mp3``, the system libmp3lame; ImportError without it);
``NetworkSink`` sends PCM16 over UDP or TCP and takes tensors too.
"""

from __future__ import annotations

import numpy as np

from . import wav

__all__ = ["WavSink", "RecorderSink", "BufferSink", "NullSink", "NetworkSink",
           "SinkManager"]


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


class NetworkSink:
    """UDP/TCP PCM16 audio sink (reference:
    sink_modules/network_sink/src/main.cpp:59-246): samples scaled by
    32768 and clipped to int16, mono or interleaved stereo, sent in
    ``packet_samples``-sample packets; a write's remainder is carried to
    the next. ``write`` takes numpy or a tensor (one copy to the host a
    write); the bytes and packets are sdrpp_tpu/io/sinks.py:138's."""

    def __init__(self, host: str, port: int, protocol: str = "udp",
                 stereo: bool = False, packet_samples: int = 512):
        import socket

        self.stereo = stereo
        self.packet_samples = int(packet_samples)
        self._partial = np.zeros((0, 2) if stereo else (0,), np.float32)
        if protocol == "udp":
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._dest = (host, port)
            self._stream = False
        elif protocol == "tcp":
            self._sock = socket.create_connection((host, port))
            self._dest = None
            self._stream = True
        else:
            raise ValueError(protocol)

    def write(self, audio):
        if hasattr(audio, "detach"):  # a tensor, on any device
            audio = audio.detach().float().cpu().numpy()
        audio = np.asarray(audio, np.float32)
        if self.stereo and audio.ndim == 1:
            audio = np.stack([audio, audio], -1)
        if not self.stereo and audio.ndim == 2:
            audio = audio.mean(axis=-1)
        buf = np.concatenate([self._partial, audio])
        ps = self.packet_samples
        n_pkts = len(buf) // ps
        for k in range(n_pkts):
            pkt = buf[k * ps:(k + 1) * ps]
            pcm = np.clip(pkt * 32768.0, -32768, 32767).astype("<i2").tobytes()
            if self._stream:
                self._sock.sendall(pcm)
            else:
                self._sock.sendto(pcm, self._dest)
        self._partial = buf[n_pkts * ps:]

    def close(self):
        try:
            self._sock.close()
        except OSError:
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
