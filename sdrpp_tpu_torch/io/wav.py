"""WAV reader/writer for IQ capture and audio output.

A numpy-only copy of ``sdrpp_tpu.io.wav`` (held byte-exact to it by
tests/test_torch_io.py), so the port reads and writes files without
importing that package. Format matrix per the reference WAV reader
(source_modules/file_source/src/wavreader.h — RIFF + WAVE_FORMAT_EXTENSIBLE,
PCM 8/16/24/32-bit and float 32/64) and writer (core/src/utils/wav.h:41-90).
Conversion conventions follow file_source's tight loops
(source_modules/file_source/src/main.cpp:294-436): PCM8 is unsigned offset-
128/128, PCM16 /32768, PCM24 /8388608, PCM32 /2147483648, floats passthrough;
mono IQ duplicates I into Q. Tolerates trailing-garbage/short data chunks
(the reference reader "tolerates broken headers"). The streaming reader
converts with numpy; the JAX package's native converters are not copied.
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path

import numpy as np

__all__ = ["WavInfo", "read_wav", "read_wav_iq", "write_wav",
           "WavStreamReader"]

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavInfo:
    def __init__(self, samplerate, channels, bits, fmt):
        self.samplerate = samplerate
        self.channels = channels
        self.bits = bits
        self.format = fmt

    def __repr__(self):
        return (f"WavInfo(rate={self.samplerate}, ch={self.channels}, "
                f"bits={self.bits}, fmt={self.format:#x})")


def _decode_samples(raw: bytes, fmt: int, bits: int, channels: int) -> np.ndarray:
    if fmt == WAVE_FORMAT_PCM:
        if bits == 8:
            data = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
            data = (data - 128.0) / 128.0
        elif bits == 16:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            n = len(b) // 3
            b = b[: n * 3].reshape(n, 3)
            vals = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            data = vals.astype(np.float32) / 8388608.0
        elif bits == 32:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif fmt == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            data = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format {fmt:#x}")
    n = len(data) // channels
    return data[: n * channels].reshape(n, channels)


def _chunks(blob):
    """Yield (chunk id, body offset, declared size) over a RIFF/WAVE blob."""
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(blob):
        cid = bytes(blob[pos: pos + 4])
        (size,) = struct.unpack_from("<I", blob, pos + 4)
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)


def _fmt_info(blob, off) -> WavInfo:
    fmt, channels, rate = struct.unpack_from("<HHI", blob, off)
    (bits,) = struct.unpack_from("<H", blob, off + 14)
    if fmt == WAVE_FORMAT_EXTENSIBLE:
        # SubFormat GUID's first u16 is the real format tag
        (fmt,) = struct.unpack_from("<H", blob, off + 24)
    return WavInfo(rate, channels, bits, fmt)


def read_wav(path) -> tuple[WavInfo, np.ndarray]:
    """Parse a RIFF/WAVE file -> (info, float32 [n, channels])."""
    blob = Path(path).read_bytes()
    info = data = None
    for cid, off, size in _chunks(blob):
        if cid == b"fmt ":
            info = _fmt_info(blob, off)
        elif cid == b"data":
            data = blob[off: off + size]
    if info is None or data is None:
        raise ValueError("missing fmt/data chunk")
    return info, _decode_samples(data, info.format, info.bits, info.channels)


def _iq(data: np.ndarray, channels: int) -> np.ndarray:
    if channels == 1:
        i = q = data[:, 0]
    else:
        i, q = data[:, 0], data[:, 1]
    return (i + 1j * q).astype(np.complex64)


def read_wav_iq(path) -> tuple[float, np.ndarray]:
    """Read an IQ capture -> (samplerate, complex64).

    Stereo: L=I, R=Q. Mono: Q := I (reference file_source main.cpp
    mono handling)."""
    info, data = read_wav(path)
    return float(info.samplerate), _iq(data, info.channels)


def write_wav(path, samplerate: int, data: np.ndarray, sample_format: str = "i16"):
    """Write float data [n] or [n, ch] as WAV.

    ``sample_format``: u8 | i16 | i24 | i32 | f32 (the reference recorder's
    depth options, misc_modules/recorder/src/main.cpp:48-60)."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    n, channels = data.shape
    if sample_format == "u8":
        fmt, bits = WAVE_FORMAT_PCM, 8
        payload = np.clip(np.rint(np.clip(data, -1, 1) * 128.0) + 128.0, 0, 255) \
            .astype(np.uint8).tobytes()
    elif sample_format == "i16":
        fmt, bits = WAVE_FORMAT_PCM, 16
        payload = np.rint(np.clip(data, -1, 1) * 32767.0).astype("<i2").tobytes()
    elif sample_format == "i24":
        fmt, bits = WAVE_FORMAT_PCM, 24
        vals = np.rint(np.clip(data, -1, 1) * 8388607.0).astype(np.int32).reshape(-1)
        b = np.zeros((len(vals), 3), np.uint8)
        b[:, 0] = vals & 0xFF
        b[:, 1] = (vals >> 8) & 0xFF
        b[:, 2] = (vals >> 16) & 0xFF
        payload = b.tobytes()
    elif sample_format == "i32":
        fmt, bits = WAVE_FORMAT_PCM, 32
        # float64: 2147483647 is not representable in float32.
        payload = np.rint(np.clip(data.astype(np.float64), -1, 1) * 2147483647.0) \
            .astype("<i4").tobytes()
    elif sample_format == "f32":
        fmt, bits = WAVE_FORMAT_IEEE_FLOAT, 32
        payload = data.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported sample format {sample_format}")

    block_align = channels * bits // 8
    byte_rate = samplerate * block_align
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, int(samplerate),
                                 int(byte_rate), block_align, bits)
    hdr += b"data" + struct.pack("<I", len(payload))
    Path(path).write_bytes(hdr + payload)


class WavStreamReader:
    """Streaming IQ reader over a memory-mapped WAV data chunk: converts
    each read on demand, so long captures are not decoded up front."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.info = None
        self._data_off = self._data_len = None
        for cid, off, size in _chunks(self._mm):
            if cid == b"fmt ":
                self.info = _fmt_info(self._mm, off)
            elif cid == b"data":
                self._data_off = off
                self._data_len = min(size, len(self._mm) - off)
        if self.info is None or self._data_off is None:
            raise ValueError("missing fmt/data chunk")
        self.samplerate = float(self.info.samplerate)
        self._frame_bytes = self.info.channels * self.info.bits // 8
        self.num_frames = self._data_len // self._frame_bytes
        self.pos = 0

    def seek(self, frame: int):
        self.pos = int(frame) % max(self.num_frames, 1)

    def read(self, n: int, loop: bool = True) -> np.ndarray:
        """Read n frames as complex64 IQ (mono duplicates I); past the end
        it wraps when ``loop``, else pads with zeros."""
        out = np.zeros(n, np.complex64)
        got = 0
        while got < n:
            take = min(n - got, self.num_frames - self.pos)
            if take <= 0:
                if not loop:
                    break
                self.pos = 0
                continue
            start = self._data_off + self.pos * self._frame_bytes
            raw = self._mm[start: start + take * self._frame_bytes]
            info = self.info
            out[got: got + take] = _iq(
                _decode_samples(raw, info.format, info.bits, info.channels),
                info.channels)
            got += take
            self.pos += take
            if self.pos >= self.num_frames and loop:
                self.pos = 0
        return out

    def close(self):
        self._mm.close()
        self._f.close()
