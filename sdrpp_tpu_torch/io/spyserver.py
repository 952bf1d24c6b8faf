"""SpyServer network source: client for Airspy's SPY Server protocol.

The port's own copy of ``sdrpp_tpu.io.spyserver`` (numpy only).

Reference: source_modules/spyserver_source/src/{spyserver_protocol.h,
spyserver_client.cpp} — little-endian structs:
command = {CommandType u32, BodySize u32} + body; HELLO carries
{ProtocolVersion u32} + app name; SET_SETTING carries {Setting u32,
Value u32}. Server messages = {ProtocolID, MessageType, StreamType,
SequenceNumber, BodySize} + body; DEVICE_INFO / CLIENT_SYNC structs and
UINT8/INT16/FLOAT IQ stream payloads (protocol.h:34-160).
"""

from __future__ import annotations

import socket
import struct

import numpy as np

__all__ = ["SpyServerSource"]

PROTOCOL_VERSION = ((2) << 24) | ((0) << 16) | 1700

CMD_HELLO = 0
CMD_SET_SETTING = 2
CMD_PING = 3

SETTING_STREAMING_MODE = 0
SETTING_STREAMING_ENABLED = 1
SETTING_GAIN = 2
SETTING_IQ_FORMAT = 100
SETTING_IQ_FREQUENCY = 101
SETTING_IQ_DECIMATION = 102
SETTING_IQ_DIGITAL_GAIN = 103

STREAM_MODE_IQ_ONLY = 1
FORMAT_UINT8 = 1
FORMAT_INT16 = 2
FORMAT_FLOAT = 4

MSG_DEVICE_INFO = 0
MSG_CLIENT_SYNC = 1
MSG_PONG = 2
MSG_UINT8_IQ = 100
MSG_INT16_IQ = 101
MSG_FLOAT_IQ = 103

_CMD_HDR = struct.Struct("<II")
_MSG_HDR = struct.Struct("<IIIII")
_DEVICE_INFO = struct.Struct("<12I")
_CLIENT_SYNC = struct.Struct("<9I")


class SpyServerSource:
    """read(n) complex64 source + tune/format/decimation controls."""

    __test__ = False

    def __init__(self, host: str, port: int = 5555, app_name: str = "sdrpp_tpu_torch",
                 fmt: int = FORMAT_INT16, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self.format = fmt
        self.device_info = None
        self.sync = None
        self.center_freq = 0.0
        self._iq_buf = np.zeros(0, np.complex64)
        self._send_cmd(CMD_HELLO, struct.pack("<I", PROTOCOL_VERSION)
                       + app_name.encode())
        # Wait for device info + client sync before configuring.
        while self.device_info is None or self.sync is None:
            self._handle_message()
        self.set_setting(SETTING_IQ_FORMAT, fmt)
        self.set_setting(SETTING_STREAMING_MODE, STREAM_MODE_IQ_ONLY)

    @property
    def samplerate(self) -> float:
        if self.device_info is None:
            return 0.0
        return float(self.device_info["MaximumSampleRate"])

    def _send_cmd(self, cmd: int, body: bytes):
        self._sock.sendall(_CMD_HDR.pack(cmd, len(body)) + body)

    def set_setting(self, setting: int, value: int):
        self._send_cmd(CMD_SET_SETTING, struct.pack("<II", setting, value))

    def tune(self, freq: float):
        self.center_freq = freq
        self.set_setting(SETTING_IQ_FREQUENCY, int(freq))

    def set_decimation(self, stage: int):
        self.set_setting(SETTING_IQ_DECIMATION, stage)

    def set_gain(self, gain: int):
        self.set_setting(SETTING_GAIN, gain)

    def start(self):
        self.set_setting(SETTING_STREAMING_ENABLED, 1)

    def stop(self):
        self.set_setting(SETTING_STREAMING_ENABLED, 0)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("spyserver closed")
            buf += chunk
        return buf

    def _handle_message(self):
        hdr = self._recv_exact(_MSG_HDR.size)
        proto, mtype, stype, seq, size = _MSG_HDR.unpack(hdr)
        body = self._recv_exact(size)
        if mtype == MSG_DEVICE_INFO:
            names = ("DeviceType", "DeviceSerial", "MaximumSampleRate",
                     "MaximumBandwidth", "DecimationStageCount",
                     "GainStageCount", "MaximumGainIndex", "MinimumFrequency",
                     "MaximumFrequency", "Resolution", "MinimumIQDecimation",
                     "ForcedIQFormat")
            self.device_info = dict(zip(names, _DEVICE_INFO.unpack(body)))
        elif mtype == MSG_CLIENT_SYNC:
            names = ("CanControl", "Gain", "DeviceCenterFrequency",
                     "IQCenterFrequency", "FFTCenterFrequency",
                     "MinimumIQCenterFrequency", "MaximumIQCenterFrequency",
                     "MinimumFFTCenterFrequency", "MaximumFFTCenterFrequency")
            self.sync = dict(zip(names, _CLIENT_SYNC.unpack(body)))
        elif mtype == MSG_UINT8_IQ:
            flat = (np.frombuffer(body, np.uint8).astype(np.float32)
                    - 128.0) / 128.0
            self._append_iq(flat)
        elif mtype == MSG_INT16_IQ:
            flat = np.frombuffer(body, "<i2").astype(np.float32) / 32768.0
            self._append_iq(flat)
        elif mtype == MSG_FLOAT_IQ:
            self._append_iq(np.frombuffer(body, "<f4").astype(np.float32))
        # PONG / FFT messages are ignored here.

    def _append_iq(self, flat: np.ndarray):
        iq = (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)
        self._iq_buf = np.concatenate([self._iq_buf, iq])

    def read(self, n: int) -> np.ndarray:
        while len(self._iq_buf) < n:
            self._handle_message()
        out, self._iq_buf = self._iq_buf[:n], self._iq_buf[n:]
        return out

    def close(self):
        self._sock.close()
