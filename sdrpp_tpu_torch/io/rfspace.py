"""RFspace (NetSDR / SDR-IP / CloudIQ / CloudSDR) network source.

The port's own copy of ``sdrpp_tpu.io.rfspace`` (numpy only).

Reference: source_modules/rfspace_source/src/rfspace_client.{h,cpp} — the
RFspace control protocol: a TCP control channel carrying "control items"
and a UDP data channel with 16-bit-sample IQ packets.

Wire format (rfspace_client.cpp):
- every message starts with a little-endian u16 header
  ``length | (type << 13)`` where length counts the header itself.
- host->target types: 0 = SET_CTRL_ITEM, 1 = REQ_CTRL_ITEM; target->host:
  0 = SET_CTRL_ITEM_RESP, 4..7 = DATA_ITEM_0..3.
- SET_CTRL_ITEM = header + item u16 LE + payload; the per-channel variant
  inserts a channel-id byte before the payload (rfspace_client.cpp:75-100).
- connect sequence: send a dummy UDP byte (0x5A) so NAT opens the return
  path, request PROD_ID and wait for its response to learn the device id,
  then apply the reference defaults — stop, 1.2288 Msps, 8.83 MHz, gain 0,
  RF port 1 (rfspace_client.cpp:22-46).
- frequency = 5-byte LE value on item 0x0020 with channel 0; gain = i8 on
  0x0038; sample rate = u32 LE on 0x00B8; state = {format, run/idle,
  depth, 0} on 0x0018 (rfspace_client.cpp:122-148).
- a heartbeat REQ of the STATE item goes out every second so the radio
  keeps the session alive (rfspace_client.cpp:211-221).
- UDP data packets: header + 2-byte sequence + interleaved i16 LE IQ,
  scaled by 1/32768 (rfspace_client.cpp:192-206).
"""

from __future__ import annotations

import socket
import struct
import time

import numpy as np

__all__ = ["RFspaceSource", "DEVICE_NAMES", "valid_sample_rates"]

# H2T message types
MSG_SET_CTRL_ITEM = 0
MSG_REQ_CTRL_ITEM = 1
# T2H message types
MSG_SET_CTRL_ITEM_RESP = 0
MSG_DATA_ITEM_0 = 4

# Control items (rfspace_client.h ControlItem)
ITEM_MODEL_NAME = 0x0001
ITEM_SERIAL = 0x0002
ITEM_IFACE_VER = 0x0003
ITEM_VERSION = 0x0004
ITEM_STATUS = 0x0005
ITEM_PROD_ID = 0x0009
ITEM_STATE = 0x0018
ITEM_NCO_FREQUENCY = 0x0020
ITEM_RF_PORT = 0x0030
ITEM_RF_GAIN = 0x0038
ITEM_IQ_SAMP_RATE = 0x00B8
ITEM_UDP_PKT_SIZE = 0x00C4

STATE_IDLE = 1
STATE_RUN = 2

SAMP_FORMAT_REAL = 0x00
SAMP_FORMAT_COMPLEX = 0x80
SAMP_DEPTH_16BIT = 0x00
SAMP_DEPTH_24BIT = 0x80

RF_PORT_AUTO = 0
RF_PORT_1 = 1
RF_PORT_2 = 2

DEV_ID_CLOUD_SDR = 0x44534C43
DEV_ID_CLOUD_IQ = 0x51494C43
DEV_ID_NET_SDR = 0x53445204
DEV_ID_SDR_IP = 0x53445203

DEVICE_NAMES = {DEV_ID_CLOUD_SDR: "CloudSDR", DEV_ID_CLOUD_IQ: "CloudIQ",
                DEV_ID_NET_SDR: "NetSDR", DEV_ID_SDR_IP: "SDR-IP"}

HEARTBEAT_INTERVAL = 1.0
_MAX_SIZE = 8192


def valid_sample_rates(device_id: int) -> list[int]:
    """Divider chain of the device's ADC clock (rfspace_client.cpp:102-120)."""
    adc = 122880000 if device_id in (DEV_ID_CLOUD_SDR, DEV_ID_CLOUD_IQ) \
        else 80000000
    rates = []
    n = adc // (4 * 25)
    while n >= 32000:
        rates.append(n)
        n //= 2
    return rates


class RFspaceSource:
    """Pull-model client: TCP control + UDP IQ data.

    ``read(n)`` -> complex64; tune/set_gain/set_samplerate/set_port mirror
    the reference setters.  The connect sequence and defaults replicate
    RFspaceClientClass's constructor (rfspace_client.cpp:22-46).
    """

    def __init__(self, host: str, port: int = 50000, timeout: float = 10.0,
                 apply_defaults: bool = True):
        self._tcp = socket.create_connection((host, port), timeout=timeout)
        self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._udp.bind(("0.0.0.0", self._tcp.getsockname()[1]))
        self._udp.settimeout(timeout)
        self._udp.connect((host, port))
        self._udp.send(b"\x5A")  # NAT hole punch (sendDummyUDP)
        self._iq = np.zeros(0, np.complex64)
        self._last_heartbeat = time.monotonic()
        self.running = False

        # Identify the device (PROD_ID request, wait for its response).
        self.request_item(ITEM_PROD_ID)
        typ, item, payload = self._read_tcp_response(want_item=ITEM_PROD_ID,
                                                     timeout=timeout)
        self.device_id = struct.unpack("<I", payload[:4])[0]
        self.device_name = DEVICE_NAMES.get(self.device_id, "Unknown")

        self.samplerate = 1228800.0
        self.center_freq = 8830000.0
        if apply_defaults:
            self.stop()
            self.set_samplerate(1228800)
            self.tune(8830000)
            self.set_gain(0)
            self.set_port(RF_PORT_1)

    # ---- control plane ----

    @staticmethod
    def _header(length: int, msg_type: int) -> bytes:
        return struct.pack("<H", (length & 0x1FFF) | (msg_type << 13))

    def set_item(self, item: int, payload: bytes):
        msg = self._header(4 + len(payload), MSG_SET_CTRL_ITEM) \
            + struct.pack("<H", item) + payload
        self._tcp.sendall(msg)

    def set_item_chan(self, item: int, chan_id: int, payload: bytes):
        msg = self._header(5 + len(payload), MSG_SET_CTRL_ITEM) \
            + struct.pack("<HB", item, chan_id) + payload
        self._tcp.sendall(msg)

    def request_item(self, item: int):
        self._tcp.sendall(self._header(4, MSG_REQ_CTRL_ITEM)
                          + struct.pack("<H", item))

    def _read_tcp_response(self, want_item: int | None = None,
                           timeout: float = 3.0):
        """Read TCP messages until one matches want_item (or any, if None)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            hdr = self._recv_tcp_exact(2)
            raw = struct.unpack("<H", hdr)[0]
            typ, size = raw >> 13, raw & 0x1FFF
            body = self._recv_tcp_exact(size - 2) if size > 2 else b""
            if len(body) >= 2:
                item = struct.unpack("<H", body[:2])[0]
                if want_item is None or (typ == MSG_SET_CTRL_ITEM_RESP
                                         and item == want_item):
                    return typ, item, body[2:]
        raise TimeoutError("Could not identify remote device")

    def _recv_tcp_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._tcp.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("RFspace server closed")
            buf += chunk
        return buf

    # ---- setters (rfspace_client.cpp:122-148) ----

    def tune(self, freq: float):
        self.center_freq = float(freq)
        self.set_item_chan(ITEM_NCO_FREQUENCY, 0,
                           struct.pack("<Q", int(freq))[:5])

    def set_port(self, port: int):
        self.set_item_chan(ITEM_RF_PORT, 0, bytes([port]))

    def set_gain(self, gain_db: int):
        self.set_item_chan(ITEM_RF_GAIN, 0,
                           struct.pack("<b", int(gain_db)))

    def set_samplerate(self, sr: float):
        self.samplerate = float(sr)
        self.set_item_chan(ITEM_IQ_SAMP_RATE, 0, struct.pack("<I", int(sr)))

    def start(self, sample_format: int = SAMP_FORMAT_COMPLEX,
              sample_depth: int = SAMP_DEPTH_16BIT):
        self.set_item(ITEM_STATE, bytes([sample_format, STATE_RUN,
                                         sample_depth, 0]))
        self.running = True

    def stop(self):
        self.set_item(ITEM_STATE, bytes([0, STATE_IDLE, 0, 0]))
        self.running = False

    # ---- data plane ----

    def _heartbeat(self):
        now = time.monotonic()
        if now - self._last_heartbeat >= HEARTBEAT_INTERVAL:
            self._last_heartbeat = now
            self.request_item(ITEM_STATE)

    def read(self, n: int) -> np.ndarray:
        """Blocking read of n complex64 samples from the UDP data channel."""
        while len(self._iq) < n:
            self._heartbeat()
            pkt = self._udp.recv(_MAX_SIZE)
            if len(pkt) < 4:
                continue
            raw = struct.unpack("<H", pkt[:2])[0]
            typ, size = raw >> 13, raw & 0x1FFF
            if typ != MSG_DATA_ITEM_0:
                continue
            n_samp = (size - 4) // 4
            flat = np.frombuffer(pkt[4:4 + 4 * n_samp], "<i2") \
                .astype(np.float32) / np.float32(32768.0)
            self._iq = np.concatenate([self._iq, flat.view(np.complex64)])
        out, self._iq = self._iq[:n], self._iq[n:]
        return out

    def close(self):
        try:
            if self.running:
                self.stop()
        except OSError:
            pass
        self._tcp.close()
        self._udp.close()
