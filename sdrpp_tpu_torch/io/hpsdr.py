"""HPSDR (Metis "Protocol 1") network source + Hermes-Lite 2 variant.

The port's own copy of ``sdrpp_tpu.io.hpsdr`` (numpy only).

Reference: source_modules/hpsdr_source/src/hpsdr.{h,cpp} (generic Protocol-1
client: UDP discovery, EP2 control pages, EP6 IQ flow) and
source_modules/hermes_source/src/hermes.{h,cpp} (Hermes-Lite 2: same Metis
framing, register-write control style).  Both radios speak the openHPSDR
"Protocol 1" UDP wire format:

- every packet starts ``0xEFFE`` (big-endian) + a type byte:
  ``0x01`` = USB-emulation data, ``0x02`` = discovery, ``0x04`` = start/stop.
- discovery request = ``0xEFFE 0x02`` + 60 zero bytes (hpsdr.cpp:441-451);
  response carries status, MAC, firmware version and board id
  (hpsdr.cpp:470-476).
- start/stop = 64-byte ``0xEFFE 0x04 <flags>`` with bit0 = IQ stream,
  bit1 = bandscope (hpsdr.cpp:31-43).
- data packets are 1032 bytes: ``0xEFFE 0x01 <ep> <seq u32 BE>`` + two
  512-byte HPSDR-USB frames, each ``0x7F 0x7F 0x7F C0 C1 C2 C3 C4`` + 504
  payload bytes (hpsdr.cpp:153-166).  EP6 = radio->host IQ, EP2 =
  host->radio control/audio.
- host control rides the C0..C4 bytes of EP2 frames as round-robin
  "control pages" addressed by C0>>1 (hpsdr.cpp:194-231): page 0 = sample
  rate id / preamp / dither / randomizer / RX count / duplex, pages 1..9 =
  TX,RX1..RX8 NCO frequency (u32 BE), page 10 = attenuator.
- EP6 frames carry per-RX 24-bit big-endian two's-complement I/Q triplets
  plus a 16-bit mic word per sample group (hpsdr.cpp:233-276): with n
  receivers the group stride is ``6n + 2`` and only a leading
  ``usable_buf_len[n]`` bytes of the 512-byte frame hold samples.  The
  reference converts with ``(s24 + 0.5) / (2^23 - 0.5)`` and maps bytes
  3..5 -> re, bytes 0..2 -> im (hpsdr.cpp:263-264); kept exactly.
- EP2 pacing: one control/audio packet is due every
  ``(fs / 48000) * 63 * 2`` received RX samples (hpsdr.cpp:319-326).

The Hermes-Lite 2 variant (hermes.cpp) drives the same framing through
32-bit register writes: C0 = reg<<1, C1..C4 = value big-endian
(hermes.cpp:129-141), samplerate in reg 0 bits 25:24, RX1 NCO in reg 2,
LNA gain in reg 0x0A with bit6 = "gain format" marker, and decodes IQ as
``s24 / 2^24`` with I/Q swapped (hermes.cpp:186-200).
"""

from __future__ import annotations

import socket
import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["HpsdrSource", "HermesLite2Source", "HpsdrInfo", "discover",
           "SAMPLERATE_IDS", "BOARD_NAMES"]

METIS_SIGNATURE = 0xEFFE
PKT_USB = 0x01
PKT_DISCOVER = 0x02
PKT_CONTROL = 0x04

CTRL_IQ = 1 << 0
CTRL_WIDEBAND = 1 << 1

EP2 = 0x02
EP4 = 0x04  # bandscope
EP6 = 0x06  # IQ flow

SAMPLERATE_IDS = {48000: 0, 96000: 1, 192000: 2, 384000: 3}

BOARD_NAMES = {0: "Metis", 1: "Hermes", 2: "Griffin", 4: "Angelia",
               5: "Orion", 6: "HermesLite"}

# Sample bytes usable in a 512-byte EP6 frame for 1..8 receivers
# (hpsdr.cpp:233-243).
USABLE_BUF_LEN = [0, 512, 512, 508, 502, 488, 502, 492, 508]

_FULL_SCALE_24 = 8388608.0  # 2^23


@dataclass
class HpsdrInfo:
    """One discovery response (hpsdr.h Info)."""
    host: str
    port: int
    status: int          # 2 = idle, 3 = already sending
    mac: bytes
    ver_major: int
    ver_minor: int
    board_id: int

    @property
    def board_name(self) -> str:
        return BOARD_NAMES.get(self.board_id, "Unknown")


def discover(address: str = "255.255.255.255", port: int = 1024,
             timeout: float = 1.0, bind: tuple | None = None) -> list[HpsdrInfo]:
    """Broadcast a Metis discovery packet and collect responses.

    ``<0xEFFE><0x02>`` + 60 zero bytes; responses are >= 11 bytes:
    ``0xEFFE <status u8> <mac 6B> <ver u8> <boardId u8>`` (hpsdr.cpp:438-489).
    """
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    if bind is not None:
        sock.bind(bind)
    sock.settimeout(timeout)
    dgram = struct.pack(">HB", METIS_SIGNATURE, PKT_DISCOVER) + b"\x00" * 60
    found: list[HpsdrInfo] = []
    try:
        sock.sendto(dgram, (address, port))
        while True:
            try:
                resp, addr = sock.recvfrom(1024)
            except socket.timeout:
                break
            if len(resp) < 11 or struct.unpack(">H", resp[:2])[0] != METIS_SIGNATURE:
                continue
            info = HpsdrInfo(host=addr[0], port=addr[1], status=resp[2],
                             mac=resp[3:9], ver_major=resp[9] // 10,
                             ver_minor=resp[9] % 10, board_id=resp[10])
            if not any(f.mac == info.mac and f.host == info.host for f in found):
                found.append(info)
    finally:
        sock.close()
    found.sort(key=lambda f: (f.host, f.port))
    return found


class _MetisBase:
    """Shared Metis UDP framing: socket, start/stop, data-packet reader."""

    def __init__(self, host: str, port: int = 1024, timeout: float = 10.0):
        self._addr = (host, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.settimeout(timeout)
        self._sock.connect(self._addr)
        self._tx_seq = 0
        self._rx_seq_ep6 = None
        self._rx_seq_ep4 = None
        self.seq_losses = 0
        self.sync_losses = 0
        self._iq = np.zeros(0, np.complex64)

    def _send_start_stop(self, iq: bool, bandscope: bool = False):
        flags = (CTRL_IQ if iq else 0) | (CTRL_WIDEBAND if bandscope else 0)
        dgram = struct.pack(">HBB", METIS_SIGNATURE, PKT_CONTROL, flags)
        self._sock.send(dgram.ljust(64, b"\x00"))

    def _send_usb(self, endpoint: int, frame1: bytes, frame2: bytes):
        assert len(frame1) == 512 and len(frame2) == 512
        hdr = struct.pack(">HBBI", METIS_SIGNATURE, PKT_USB, endpoint,
                          self._tx_seq & 0xFFFFFFFF)
        self._tx_seq += 1
        self._sock.send(hdr + frame1 + frame2)

    def _recv_data(self) -> tuple[int, bytes, bytes] | None:
        """Receive one 1032-byte data packet -> (endpoint, frame1, frame2)."""
        pkt = self._sock.recv(2048)
        if len(pkt) < 8 or struct.unpack(">H", pkt[:2])[0] != METIS_SIGNATURE \
                or pkt[2] != PKT_USB:
            return None
        ep = pkt[3]
        seq = struct.unpack(">I", pkt[4:8])[0]
        if ep == EP6:
            if self._rx_seq_ep6 is not None and seq != (self._rx_seq_ep6 + 1) & 0xFFFFFFFF:
                self.seq_losses += 1
            self._rx_seq_ep6 = seq
        elif ep == EP4:
            if self._rx_seq_ep4 is not None and seq != (self._rx_seq_ep4 + 1) & 0xFFFFFFFF:
                self.seq_losses += 1
            self._rx_seq_ep4 = seq
        if len(pkt) != 1032:
            return None
        return ep, pkt[8:520], pkt[520:1032]

    def read(self, n: int) -> np.ndarray:
        """Blocking read of n complex64 RX1 samples."""
        while len(self._iq) < n:
            got = self._recv_data()
            if got is None:
                continue
            ep, f1, f2 = got
            if ep != EP6:
                continue
            for frame in (f1, f2):
                s = self._parse_ep6_frame(frame)
                if s is not None and len(s):
                    self._iq = np.concatenate([self._iq, s])
        out, self._iq = self._iq[:n], self._iq[n:]
        return out

    def _parse_ep6_frame(self, frame: bytes):
        raise NotImplementedError

    def close(self):
        self._sock.close()


class HpsdrSource(_MetisBase):
    """Generic Protocol-1 client (Metis/Hermes/Angelia/Orion boards).

    Pull-model port of hpsdr.cpp's Client: ``read(n)`` -> complex64 and
    setters mirroring setSamplerate/setFrequency/setPreamp/setAtten/
    setDither/setRandomizer.  Control changes rewind the round-robin
    control-page counter exactly like the reference so the dirty page is
    retransmitted with the next EP2 packets (hpsdr.cpp:79-112).
    """

    def __init__(self, host: str, port: int = 1024,
                 samplerate: float = 192000.0, num_rx: int = 1,
                 timeout: float = 10.0):
        super().__init__(host, port, timeout)
        if int(samplerate) not in SAMPLERATE_IDS:
            raise ValueError(f"HPSDR samplerate must be one of "
                             f"{sorted(SAMPLERATE_IDS)}, got {samplerate}")
        if not 1 <= num_rx <= 8:
            raise ValueError("num_rx must be 1..8")
        self.samplerate = float(samplerate)
        self.num_rx = num_rx
        self.center_freq = 0.0
        self._nco = [0] * 9          # TX, RX1..RX8 (hpsdr.h ctrl_NCO)
        self._preamp = False
        self._dither = False
        self._randomizer = False
        self._duplex = True
        self._atten = 0
        self._mox = False
        self._control_page = 0
        self._rx_sample_counter = 0
        self.running = False
        # radio -> host status mirror (processControlFromRadio)
        self.state = {"ADCOVR": 0, "PTT": 0, "IO": 0, "SwVer": 0,
                      "AIN1": 0, "AIN2": 0, "AIN3": 0, "AIN4": 0,
                      "AIN5": 0, "AIN6": 0}

    # ---- controls ----

    def start(self):
        if self.running:
            return
        self._rx_seq_ep6 = self._rx_seq_ep4 = None
        self._tx_seq = 0
        self.running = True
        self._send_start_stop(True)
        # Send all 12 control pages up-front (hpsdr.cpp:60-65): 6 EP2
        # packets x 2 frames, round-robin advancing one page per frame.
        for _ in range(6):
            self._send_ep2()

    def stop(self):
        if not self.running:
            return
        self.running = False
        self._send_start_stop(False)

    def set_samplerate(self, sr: float):
        if int(sr) not in SAMPLERATE_IDS:
            raise ValueError(f"HPSDR samplerate must be one of "
                             f"{sorted(SAMPLERATE_IDS)}, got {sr}")
        self.samplerate = float(sr)
        self._control_page = 0

    def tune(self, freq: float):
        self.center_freq = float(freq)
        # reference sets TX + RX1 NCO together (hpsdr.cpp:86-92)
        self._nco[0] = self._nco[1] = int(freq)
        self._control_page = min(self._control_page, 1)

    def set_preamp(self, enable: bool):
        self._preamp = bool(enable)
        self._control_page = 0

    def set_atten(self, atten_db: int, enable: bool = True):
        v = atten_db & 0x3F
        if enable:
            v |= 1 << 6
        self._atten = v
        self._control_page = min(self._control_page, 10)

    def set_dither(self, enable: bool):
        self._dither = bool(enable)
        self._control_page = 0

    def set_randomizer(self, enable: bool):
        self._randomizer = bool(enable)
        self._control_page = 0

    # ---- EP2 control/audio uplink ----

    def _control_bytes(self, page: int) -> bytes:
        """C0..C4 for one control page (processControlToRadio)."""
        c = bytearray(5)
        c[0] = ((page & 0x7F) << 1) | (1 if self._mox else 0)
        if page == 0:
            c[1] = SAMPLERATE_IDS[int(self.samplerate)] & 3
            c[4] = (((self.num_rx - 1) & 7) << 3) | ((1 if self._duplex else 0) << 2)
            # NOTE: the reference sets these flags in C3 but clears them in
            # C1 (hpsdr.cpp:203-216) — the "set" side is the operative one
            # and is what radios act on; replicated as written.
            if self._preamp:
                c[3] |= 1 << 2
            if self._dither:
                c[3] |= 1 << 3
            if self._randomizer:
                c[3] |= 1 << 4
        elif 1 <= page <= 9:
            c[1:5] = struct.pack(">I", self._nco[page - 1] & 0xFFFFFFFF)
        elif page == 10:
            c[4] = self._atten & 0xFF
        return bytes(c)

    def _ep2_frame(self) -> bytes:
        frame = b"\x7f\x7f\x7f" + self._control_bytes(self._control_page)
        self._control_page = (self._control_page + 1) % 12
        return frame.ljust(512, b"\x00")

    def _send_ep2(self):
        self._send_usb(EP2, self._ep2_frame(), self._ep2_frame())

    # ---- EP6 downlink ----

    def _parse_ep6_frame(self, frame: bytes):
        if frame[:3] != b"\x7f\x7f\x7f":
            self.sync_losses += 1
            return None
        self._parse_control_from_radio(frame[3:8])
        n_rx = self.num_rx
        buf_len = USABLE_BUF_LEN[n_rx]
        step = n_rx * 6 + 2
        data = np.frombuffer(frame, np.uint8)[8:buf_len]
        n_samp = len(data) // step
        groups = data[:n_samp * step].reshape(n_samp, step)
        # RX1 only, like the reference (hpsdr.cpp:255-257).
        im = self._s24_be(groups[:, 0], groups[:, 1], groups[:, 2])
        re = self._s24_be(groups[:, 3], groups[:, 4], groups[:, 5])
        scale = np.float32(1.0 / (_FULL_SCALE_24 - 0.5))
        iq = ((re.astype(np.float32) + np.float32(0.5))
              + 1j * (im.astype(np.float32) + np.float32(0.5))) * scale
        # EP2 pacing: 63 samples x 2 frames of uplink per 48 kHz tick
        # (hpsdr.cpp:318-326).
        self._rx_sample_counter += n_samp
        due = int(self.samplerate) // 48000 * 63 * 2
        if due and self._rx_sample_counter >= due:
            self._rx_sample_counter -= due
            if self.running:
                self._send_ep2()
        return iq.astype(np.complex64)

    @staticmethod
    def _s24_be(b0, b1, b2) -> np.ndarray:
        v = (b0.astype(np.int32) << 16) | (b1.astype(np.int32) << 8) \
            | b2.astype(np.int32)
        return (v << 8) >> 8  # sign extend

    def _parse_control_from_radio(self, c: bytes):
        st = self.state
        st["PTT"] = c[0] & 7
        sel = c[0] >> 3
        if sel == 0:
            st["ADCOVR"] = c[1] & 1
            st["IO"] = (c[1] >> 1) & 0x0F
            st["SwVer"] = c[4]
        elif sel == 1:
            st["AIN5"], st["AIN1"] = struct.unpack(">HH", c[1:5])
        elif sel == 2:
            st["AIN2"], st["AIN3"] = struct.unpack(">HH", c[1:5])
        elif sel == 3:
            st["AIN4"], st["AIN6"] = struct.unpack(">HH", c[1:5])


class HermesLite2Source(_MetisBase):
    """Hermes-Lite 2 client: register-write control over Metis framing.

    Mirrors hermes.cpp's Client: writeReg (C0 = reg<<1, C1..C4 = value BE,
    hermes.cpp:129-141), samplerate in reg 0 bits 25:24, RX1 NCO in reg 2,
    LNA gain (-12..+48 dB) in reg 0x0A with bit6 set, and the HL2 IQ
    decode ``s24 / 2^24`` with I into im / Q into re (hermes.cpp:186-200).
    """

    SAMPLERATES = {48000: 0, 96000: 1, 192000: 2, 384000: 3}
    REG_TX1_NCO = 0x01
    REG_RX1_NCO = 0x02
    REG_RX_LNA = 0x0A

    def __init__(self, host: str, port: int = 1024,
                 samplerate: float = 384000.0, timeout: float = 10.0):
        super().__init__(host, port, timeout)
        if int(samplerate) not in self.SAMPLERATES:
            raise ValueError(f"HL2 samplerate must be one of "
                             f"{sorted(self.SAMPLERATES)}, got {samplerate}")
        self.samplerate = float(samplerate)
        self.center_freq = 0.0
        self.running = False

    def write_reg(self, addr: int, value: int):
        frame = (b"\x7f\x7f\x7f" + bytes([(addr & 0x3F) << 1])
                 + struct.pack(">I", value & 0xFFFFFFFF)).ljust(512, b"\x00")
        self._send_usb(EP2, frame, b"\x00" * 512)

    def start(self):
        if self.running:
            return
        self._rx_seq_ep6 = None
        self._tx_seq = 0
        self.running = True
        self._send_start_stop(True)
        self.write_reg(0, self.SAMPLERATES[int(self.samplerate)] << 24)
        if self.center_freq:
            self.tune(self.center_freq)

    def stop(self):
        if not self.running:
            return
        self.running = False
        self._send_start_stop(False)

    def set_samplerate(self, sr: float):
        if int(sr) not in self.SAMPLERATES:
            raise ValueError(f"HL2 samplerate must be one of "
                             f"{sorted(self.SAMPLERATES)}, got {sr}")
        self.samplerate = float(sr)
        if self.running:
            self.write_reg(0, self.SAMPLERATES[int(sr)] << 24)

    def tune(self, freq: float):
        self.center_freq = float(freq)
        self.write_reg(self.REG_RX1_NCO, int(freq))

    def set_gain(self, gain_db: int):
        """LNA gain -12..+48 dB (hermes.cpp:43-46)."""
        self.write_reg(self.REG_RX_LNA, (int(gain_db) & 0x3F) | (1 << 6))

    def _parse_ep6_frame(self, frame: bytes):
        if frame[:3] != b"\x7f\x7f\x7f":
            self.sync_losses += 1
            return None
        data = np.frombuffer(frame, np.uint8)[8:8 + 63 * 8]
        groups = data.reshape(63, 8)
        si = HpsdrSource._s24_be(groups[:, 0], groups[:, 1], groups[:, 2])
        sq = HpsdrSource._s24_be(groups[:, 3], groups[:, 4], groups[:, 5])
        # "IQ swapped for some reason" (hermes.cpp:196-198): I -> im, Q -> re.
        scale = np.float32(1.0 / 16777216.0)  # / 2^24
        return (sq.astype(np.float32) * scale
                + 1j * (si.astype(np.float32) * scale)).astype(np.complex64)
