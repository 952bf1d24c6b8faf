"""Codec2 voice synthesis via ctypes bindings to the system libcodec2.

The counterpart of ``sdrpp_tpu.decoders.codec2``, host code as there.

The reference's m17_decoder links libcodec2 and synthesizes voice with
CODEC2_MODE_3200 — two 8-byte codec2 frames per 16-byte M17 stream-frame
payload, each producing 160 samples of 8 kHz speech, interleaved to
stereo float (decoder_modules/m17_decoder/src/m17dsp.h:438-520). This
module binds the same library through ctypes (no pybind11 in this image)
and reimplements `M17Codec2Decode`'s frame-number gating state machine.

Gated: `Codec2(...)` raises ImportError when libcodec2 is absent; callers
use `available()` to skip.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

__all__ = ["Codec2", "M17VoiceDecoder", "available",
           "MODE_3200", "MODE_2400", "MODE_1600", "MODE_1400",
           "MODE_1300", "MODE_1200", "MODE_700C"]

# codec2.h mode constants
MODE_3200 = 0
MODE_2400 = 1
MODE_1600 = 2
MODE_1400 = 3
MODE_1300 = 4
MODE_1200 = 5
MODE_700C = 8

# m17dsp.h:31-32
M17_END_FN = 0x8000
M17_STREAM_TIMEOUT_S = 0.500

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for name in ("libcodec2.so.1.0", "libcodec2.so.1", "libcodec2.so"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        raise ImportError("libcodec2 not found")
    lib.codec2_create.argtypes = [ctypes.c_int]
    lib.codec2_create.restype = ctypes.c_void_p
    lib.codec2_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("codec2_samples_per_frame", "codec2_bits_per_frame"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    lib.codec2_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.codec2_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except ImportError:
        return False


class Codec2:
    """One codec2 codec instance (stateful, like the reference's)."""

    SAMPLE_RATE = 8000.0

    def __init__(self, mode: int = MODE_3200):
        self._lib = _load()
        self._c = self._lib.codec2_create(mode)
        if not self._c:
            raise RuntimeError(f"codec2_create({mode}) failed")
        self.samples_per_frame = self._lib.codec2_samples_per_frame(self._c)
        self.bits_per_frame = self._lib.codec2_bits_per_frame(self._c)
        self.bytes_per_frame = (self.bits_per_frame + 7) // 8

    def close(self):
        if self._c:
            self._lib.codec2_destroy(self._c)
            self._c = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def decode(self, bits: bytes) -> np.ndarray:
        """Decode whole codec2 frames -> int16 speech (8 kHz)."""
        nframes = len(bits) // self.bytes_per_frame
        out = np.empty(nframes * self.samples_per_frame, np.int16)
        buf = (ctypes.c_ubyte * len(bits)).from_buffer_copy(bits)
        for i in range(nframes):
            self._lib.codec2_decode(
                self._c,
                out[i * self.samples_per_frame:].ctypes.data_as(
                    ctypes.c_void_p),
                ctypes.byref(buf, i * self.bytes_per_frame))
        return out

    def encode(self, speech: np.ndarray) -> bytes:
        """Encode int16 speech (multiple of samples_per_frame) -> bits."""
        speech = np.ascontiguousarray(speech, np.int16)
        nframes = len(speech) // self.samples_per_frame
        out = (ctypes.c_ubyte * (nframes * self.bytes_per_frame))()
        for i in range(nframes):
            self._lib.codec2_encode(
                self._c,
                ctypes.byref(out, i * self.bytes_per_frame),
                speech[i * self.samples_per_frame:].ctypes.data_as(
                    ctypes.c_void_p))
        return bytes(out)


class M17VoiceDecoder:
    """M17 stream-frame payload -> stereo float audio, with the reference's
    consecutive-frame-number receive gating (m17dsp.h:480-510).

    Feed 18-byte payloads ([fn u16 BE][16 codec2 bytes]); returns float32
    [n, 2] stereo at 8 kHz (empty while not receiving). Gating: start on a
    consecutive frame number, keep alive while consecutive frames arrive,
    drop after 500 ms without one.
    """

    SAMPLE_RATE = 8000.0

    def __init__(self, clock=time.monotonic):
        self.codec = Codec2(MODE_3200)
        self._clock = clock
        self._last_fn = -1
        self._receiving = False
        self._last_conseq = clock()

    @property
    def receiving(self) -> bool:
        return self._receiving and not self._timed_out()

    def _timed_out(self) -> bool:
        return (self._clock() - self._last_conseq) > M17_STREAM_TIMEOUT_S

    def process(self, payload: bytes) -> np.ndarray:
        fn = (payload[0] << 8) | payload[1]
        consecutive = ((fn - self._last_fn + M17_END_FN) % M17_END_FN) == 1
        if not self._receiving and consecutive:
            self._receiving = True
            self._last_conseq = self._clock()
        elif self._receiving and consecutive:
            self._last_conseq = self._clock()
        elif self._receiving and not consecutive and self._timed_out():
            self._receiving = False
        self._last_fn = fn
        if not self._receiving:
            return np.empty((0, 2), np.float32)
        pcm = self.codec.decode(payload[2:18]).astype(np.float32) / 32768.0
        return np.stack([pcm, pcm], axis=-1)
