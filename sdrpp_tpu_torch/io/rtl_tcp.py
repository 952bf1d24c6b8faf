"""rtl_tcp network source: client for the rtl_tcp IQ streaming protocol.

The port's own copy of ``sdrpp_tpu.io.rtl_tcp``.

Reference: source_modules/rtl_tcp_source/src/rtl_tcp_client.{h,cpp} — the
de-facto network protocol of RTL-SDR dongles: 5-byte commands
{cmd u8, param u32 big-endian} (1=freq, 2=samplerate, 3=gain mode, 4=gain,
5=ppm, 8=agc mode, 9=direct sampling, 10=offset tuning, 13=gain index,
14=bias tee) and a continuous stream of unsigned-8-bit interleaved IQ
decoded as (v - 128)/128 (rtl_tcp_client.cpp:84-88), in numpy: the
values are exact in float32, so the result equals the JAX module's native
conversion bit for bit.
"""

from __future__ import annotations

import socket
import struct

import numpy as np

__all__ = ["RtlTcpSource"]

_CMD = struct.Struct(">BI")

CMD_SET_FREQ = 1
CMD_SET_SAMPLERATE = 2
CMD_SET_GAIN_MODE = 3
CMD_SET_GAIN = 4
CMD_SET_PPM = 5
CMD_SET_AGC_MODE = 8
CMD_SET_DIRECT_SAMPLING = 9
CMD_SET_OFFSET_TUNING = 10
CMD_SET_GAIN_INDEX = 13
CMD_SET_BIAS_TEE = 14


class RtlTcpSource:
    """Source-protocol client: read(n) complex64 + tune/configure."""

    __test__ = False

    def __init__(self, host: str, port: int = 1234, samplerate: float = 2400000.0,
                 timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        # Dongle info header: magic "RTL0" + tuner type + gain count (12B).
        hdr = self._recv_exact(12)
        self.magic = hdr[:4]
        self.tuner_type, self.tuner_gain_count = struct.unpack(">II", hdr[4:])
        self.samplerate = float(samplerate)
        self.center_freq = 0.0
        self.set_samplerate(samplerate)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("rtl_tcp server closed")
            buf += chunk
        return buf

    def _cmd(self, cmd: int, param: int):
        self._sock.sendall(_CMD.pack(cmd, int(param) & 0xFFFFFFFF))

    # ---- controls (rtl_tcp_client.cpp:29-68) ----

    def tune(self, freq: float):
        self.center_freq = freq
        self._cmd(CMD_SET_FREQ, int(freq))

    def set_samplerate(self, sr: float):
        self.samplerate = float(sr)
        self._cmd(CMD_SET_SAMPLERATE, int(sr))

    def set_gain_mode(self, manual: bool):
        self._cmd(CMD_SET_GAIN_MODE, int(manual))

    def set_gain(self, tenths_db: int):
        self._cmd(CMD_SET_GAIN, tenths_db)

    def set_ppm(self, ppm: int):
        self._cmd(CMD_SET_PPM, ppm)

    def set_agc_mode(self, enabled: bool):
        self._cmd(CMD_SET_AGC_MODE, int(enabled))

    def set_direct_sampling(self, mode: int):
        self._cmd(CMD_SET_DIRECT_SAMPLING, mode)

    def set_offset_tuning(self, enabled: bool):
        self._cmd(CMD_SET_OFFSET_TUNING, int(enabled))

    def set_bias_tee(self, enabled: bool):
        self._cmd(CMD_SET_BIAS_TEE, int(enabled))

    # ---- data ----

    def read(self, n: int) -> np.ndarray:
        raw = np.frombuffer(self._recv_exact(2 * n), np.uint8)
        flat = (raw.astype(np.float32) - 128.0) / 128.0
        return (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)

    def close(self):
        self._sock.close()
