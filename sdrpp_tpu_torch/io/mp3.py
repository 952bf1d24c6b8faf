"""MP3 recorder container via ctypes bindings to the system libmp3lame.

The port's own copy of ``sdrpp_tpu.io.mp3``.

The reference encodes MP3 through LAME with VBR default quality 5 and
encoder quality 2 (core/src/utils/wav.cpp:59-92: lame_set_VBR(vbr_default),
lame_set_VBR_q(5), lame_set_quality(2), automatic ID3 tags) and flushes on
close (wav.cpp close(): lame_encode_flush). This module binds the same
library the reference links (libmp3lame) through ctypes — no pybind11 in
this image — and exposes a streaming writer with the WavSink interface.

Gated: raises ImportError at construction when libmp3lame is absent.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

__all__ = ["Mp3Writer", "decode_mp3", "available"]

_VBR_DEFAULT = 4  # vbr_mtrh, lame.h vbr_default


def _load():
    for name in ("libmp3lame.so.0", "libmp3lame.so", "mp3lame"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        raise ImportError("libmp3lame not found")
    lib.lame_init.restype = ctypes.c_void_p
    for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
               "lame_set_VBR", "lame_set_VBR_q", "lame_set_quality",
               "lame_set_write_id3tag_automatic", "lame_init_params"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int] \
            if fn != "lame_init_params" else [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    lib.lame_encode_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int]
    lib.lame_encode_buffer.restype = ctypes.c_int
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int]
    lib.lame_encode_flush.restype = ctypes.c_int
    lib.lame_close.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except ImportError:
        return False


class Mp3Writer:
    """Streaming MP3 file writer. write() takes float [-1,1] [n] or [n,ch]."""

    def __init__(self, path, samplerate: int, channels: int = 2):
        if channels not in (1, 2):
            raise ValueError("MP3 supports 1 or 2 channels")
        self._lib = _load()
        self.path = Path(path)
        self.samplerate = int(samplerate)
        self.channels = channels
        self._gfp = self._lib.lame_init()
        if not self._gfp:
            raise RuntimeError("lame_init failed")
        # reference settings, wav.cpp:69-78
        self._lib.lame_set_write_id3tag_automatic(self._gfp, 1)
        self._lib.lame_set_in_samplerate(self._gfp, self.samplerate)
        self._lib.lame_set_num_channels(self._gfp, channels)
        self._lib.lame_set_VBR(self._gfp, _VBR_DEFAULT)
        self._lib.lame_set_VBR_q(self._gfp, 5)
        self._lib.lame_set_quality(self._gfp, 2)
        if self._lib.lame_init_params(self._gfp) < 0:
            self._lib.lame_close(self._gfp)
            self._gfp = None
            raise RuntimeError("lame_init_params failed")
        self._f = open(self.path, "wb")

    def write(self, samples: np.ndarray):
        samples = np.asarray(samples)
        if samples.ndim == 1:
            samples = samples[:, None]
        if samples.shape[1] != self.channels:
            raise ValueError(f"expected {self.channels} channels")
        if np.issubdtype(samples.dtype, np.floating):
            pcm = np.rint(np.clip(samples, -1, 1) * 32767.0).astype(np.int16)
        else:
            pcm = samples.astype(np.int16)
        n = len(pcm)
        if n == 0:
            return
        left = np.ascontiguousarray(pcm[:, 0])
        right = np.ascontiguousarray(pcm[:, 1] if self.channels == 2
                                     else pcm[:, 0])
        out = np.empty(int(1.25 * n) + 7200, np.uint8)
        written = self._lib.lame_encode_buffer(
            self._gfp, left.ctypes.data, right.ctypes.data, n,
            out.ctypes.data, len(out))
        if written < 0:
            raise RuntimeError(f"lame_encode_buffer failed ({written})")
        self._f.write(out[:written].tobytes())

    def close(self):
        if self._gfp is None:
            return
        out = np.empty(1 << 20, np.uint8)
        written = self._lib.lame_encode_flush(self._gfp, out.ctypes.data,
                                              len(out))
        if written < 0:
            raise RuntimeError(f"lame_encode_flush failed ({written})")
        if written > 0:
            self._f.write(out[:written].tobytes())
        self._lib.lame_close(self._gfp)
        self._gfp = None
        self._f.close()

    __enter__ = lambda self: self
    __exit__ = lambda self, *a: self.close()


_MPEG1_RATES = {0: 44100, 1: 48000, 2: 32000}


def decode_mp3(path, max_samples: int = 1 << 22):
    """Decode an MP3 via LAME's built-in hip decoder -> (rate, float [n, 2]).

    Used by tests to round-trip-verify Mp3Writer output without external
    tools; hip is part of libmp3lame. Uses hip_decode1 with small input
    chunks (the _headers variant returns no samples for sub-second
    streams) and reads the sample rate from the first MPEG frame header.
    """
    lib = _load()
    lib.hip_decode_init.restype = ctypes.c_void_p
    lib.hip_decode1.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.hip_decode1.restype = ctypes.c_int
    lib.hip_decode_exit.argtypes = [ctypes.c_void_p]

    blob = np.frombuffer(Path(path).read_bytes(), np.uint8)
    rate = None
    for i in range(len(blob) - 2):
        if blob[i] == 0xFF and (blob[i + 1] & 0xE0) == 0xE0:
            rate = _MPEG1_RATES.get((blob[i + 2] >> 2) & 0x3)
            break

    hip = lib.hip_decode_init()
    pcm_l = np.empty(65536, np.int16)
    pcm_r = np.empty(65536, np.int16)
    out_l, out_r = [], []
    pos = 0
    chunk = 512
    while pos < len(blob):
        buf = blob[pos: pos + chunk]
        pos += len(buf)
        n = lib.hip_decode1(hip, buf.ctypes.data, len(buf),
                            pcm_l.ctypes.data, pcm_r.ctypes.data)
        while n > 0 and sum(map(len, out_l)) <= max_samples:
            out_l.append(pcm_l[:n].copy())
            out_r.append(pcm_r[:n].copy())
            n = lib.hip_decode1(hip, None, 0, pcm_l.ctypes.data,
                                pcm_r.ctypes.data)
    lib.hip_decode_exit(hip)
    l = np.concatenate(out_l) if out_l else np.zeros(0, np.int16)
    r = np.concatenate(out_r) if out_r else np.zeros(0, np.int16)
    data = np.stack([l, r], -1).astype(np.float32) / 32768.0
    return rate, data
