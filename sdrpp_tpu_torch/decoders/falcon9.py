"""Falcon 9 telemetry decoder: frame FEC + packet reassembly.

The counterpart of ``sdrpp_tpu.decoders.falcon9``: the FM discriminator,
the M&M clock recovery and the RS decode run on the decoder's device (the
RS decode of every frame a block finds in one batched call), the slicer's
bits come to the host, where the deframer, the dual-basis and randomizer
tables and the packet reassembly run in numpy.

Reimplements the reference's falcon9_decoder module
(decoder_modules/falcon9_decoder/src/):

  FloatFMDemod(6 Msps, 2 MHz dev) -> MM clock recovery (3.5714 MBaud)
  -> threshold slicer -> Deframer(10232 bits, 32-bit sync 0x1ACFFC1D)
  -> FalconRS (falcon_fec.h: dual-basis conversion, 5-way deinterleave,
     5x RS(255,239) ccsds/fcr=120/gap=11/16-root decode, reinterleave +
     CCSDS derandomize)
  -> FalconPacketSync (falcon_packet.h: frame header, packet reassembly)
  -> packet handler (main.cpp:184-202: GPS text packets, video TS packets)

The dual-basis tables are the CCSDS Berlekamp-basis transform constants
(falcon_fec.h:10-44); the randomizer is the CCSDS x^8+x^7+x^5+x^3+1
all-ones-seeded LFSR (generated here, matches falcon_fec.h randVals).
"""

from __future__ import annotations

import numpy as np

import torch

from ..ops.deframing import Deframer
from ..ops.fec import RS_CCSDS, ReedSolomon

__all__ = ["FalconRS", "FalconPacketSync", "Falcon9Decoder",
           "FRAME_BITS", "SYNC_BITS", "TO_DB", "FROM_DB", "RAND_VALS",
           "PKT_GPS_A", "PKT_GPS_B", "PKT_VIDEO"]

FRAME_BITS = 10232           # deframer frame length incl. 32-bit sync
SYNC_WORD = 0x1ACFFC1D       # main.cpp:237 syncWord bits
SYNC_BITS = np.array([(SYNC_WORD >> (31 - i)) & 1 for i in range(32)],
                     np.uint8)
RS_BLOCKS = 5
DATA_LEN = 1191              # payload bytes per frame after 4-byte header

PKT_GPS_A = 0x0117FE0800320303
PKT_GPS_B = 0x0112FA0800320303
PKT_VIDEO = 0x01123201042E1403

# CCSDS conventional <-> dual (Berlekamp) basis transforms
# (falcon_fec.h toDB/fromDB — standard CCSDS constants).
TO_DB = np.array([
    0x00, 0x7b, 0xaf, 0xd4, 0x99, 0xe2, 0x36, 0x4d, 0xfa, 0x81, 0x55, 0x2e,
    0x63, 0x18, 0xcc, 0xb7, 0x86, 0xfd, 0x29, 0x52, 0x1f, 0x64, 0xb0, 0xcb,
    0x7c, 0x07, 0xd3, 0xa8, 0xe5, 0x9e, 0x4a, 0x31, 0xec, 0x97, 0x43, 0x38,
    0x75, 0x0e, 0xda, 0xa1, 0x16, 0x6d, 0xb9, 0xc2, 0x8f, 0xf4, 0x20, 0x5b,
    0x6a, 0x11, 0xc5, 0xbe, 0xf3, 0x88, 0x5c, 0x27, 0x90, 0xeb, 0x3f, 0x44,
    0x09, 0x72, 0xa6, 0xdd, 0xef, 0x94, 0x40, 0x3b, 0x76, 0x0d, 0xd9, 0xa2,
    0x15, 0x6e, 0xba, 0xc1, 0x8c, 0xf7, 0x23, 0x58, 0x69, 0x12, 0xc6, 0xbd,
    0xf0, 0x8b, 0x5f, 0x24, 0x93, 0xe8, 0x3c, 0x47, 0x0a, 0x71, 0xa5, 0xde,
    0x03, 0x78, 0xac, 0xd7, 0x9a, 0xe1, 0x35, 0x4e, 0xf9, 0x82, 0x56, 0x2d,
    0x60, 0x1b, 0xcf, 0xb4, 0x85, 0xfe, 0x2a, 0x51, 0x1c, 0x67, 0xb3, 0xc8,
    0x7f, 0x04, 0xd0, 0xab, 0xe6, 0x9d, 0x49, 0x32, 0x8d, 0xf6, 0x22, 0x59,
    0x14, 0x6f, 0xbb, 0xc0, 0x77, 0x0c, 0xd8, 0xa3, 0xee, 0x95, 0x41, 0x3a,
    0x0b, 0x70, 0xa4, 0xdf, 0x92, 0xe9, 0x3d, 0x46, 0xf1, 0x8a, 0x5e, 0x25,
    0x68, 0x13, 0xc7, 0xbc, 0x61, 0x1a, 0xce, 0xb5, 0xf8, 0x83, 0x57, 0x2c,
    0x9b, 0xe0, 0x34, 0x4f, 0x02, 0x79, 0xad, 0xd6, 0xe7, 0x9c, 0x48, 0x33,
    0x7e, 0x05, 0xd1, 0xaa, 0x1d, 0x66, 0xb2, 0xc9, 0x84, 0xff, 0x2b, 0x50,
    0x62, 0x19, 0xcd, 0xb6, 0xfb, 0x80, 0x54, 0x2f, 0x98, 0xe3, 0x37, 0x4c,
    0x01, 0x7a, 0xae, 0xd5, 0xe4, 0x9f, 0x4b, 0x30, 0x7d, 0x06, 0xd2, 0xa9,
    0x1e, 0x65, 0xb1, 0xca, 0x87, 0xfc, 0x28, 0x53, 0x8e, 0xf5, 0x21, 0x5a,
    0x17, 0x6c, 0xb8, 0xc3, 0x74, 0x0f, 0xdb, 0xa0, 0xed, 0x96, 0x42, 0x39,
    0x08, 0x73, 0xa7, 0xdc, 0x91, 0xea, 0x3e, 0x45, 0xf2, 0x89, 0x5d, 0x26,
    0x6b, 0x10, 0xc4, 0xbf], np.uint8)

FROM_DB = np.zeros(256, np.uint8)
FROM_DB[TO_DB] = np.arange(256, dtype=np.uint8)


def _ccsds_randomizer(n: int = 255) -> np.ndarray:
    """CCSDS pseudo-randomizer: x^8+x^7+x^5+x^3+1 LFSR seeded all-ones
    (== falcon_fec.h randVals)."""
    reg = [1] * 8
    out = np.zeros(n, np.uint8)
    for i in range(n):
        byte = 0
        for _ in range(8):
            byte = (byte << 1) | reg[0]
            fb = reg[0] ^ reg[3] ^ reg[5] ^ reg[7]
            reg = reg[1:] + [fb]
        out[i] = byte
    return out


RAND_VALS = _ccsds_randomizer()


class FalconRS:
    """Frame FEC layer (falcon_fec.h FalconRS::run) on ``device``.

    decode(frame_bytes[1275]) -> 1195 decoded bytes, or None if any of the
    5 interleaved RS(255,239) blocks is uncorrectable; ``decode_frames``
    decodes many frames in one batched call.
    """

    def __init__(self, *, device="cuda"):
        self.rs = ReedSolomon(RS_CCSDS, first_consecutive_root=120,
                              generator_root_gap=11, num_roots=16,
                              device=device)

    def decode_frames(self, data) -> list[np.ndarray | None]:
        """[N, 1275] wire bytes -> each frame's 1195 decoded bytes or None;
        the N * 5 RS blocks go through one ``ReedSolomon.decode``."""
        data = np.asarray(data, np.uint8).reshape(-1, 255 * RS_BLOCKS)
        if not len(data):
            return []
        # deinterleave + dual -> conventional basis (falcon_fec.h:96-99)
        blocks = FROM_DB[data].reshape(-1, 255, RS_BLOCKS).transpose(0, 2, 1)
        msgs, ok = self.rs.decode(torch.from_numpy(
            np.ascontiguousarray(blocks.reshape(-1, 255))))
        msgs = msgs.cpu().numpy().reshape(-1, RS_BLOCKS, self.rs.msg_len)
        ok = ok.cpu().numpy().reshape(-1, RS_BLOCKS).all(axis=1)
        # reinterleave + conventional -> dual + derandomize over the
        # 4 + 1191 bytes the packet layer consumes (falcon_fec.h:129-131)
        i = np.arange(4 + DATA_LEN)
        out = TO_DB[msgs[:, i % RS_BLOCKS, i // RS_BLOCKS]] ^ RAND_VALS[i % 255]
        return [o.astype(np.uint8) if good else None
                for o, good in zip(out, ok)]

    def decode(self, data: np.ndarray) -> np.ndarray | None:
        data = np.asarray(data, np.uint8)
        if len(data) != 255 * RS_BLOCKS:
            raise ValueError(f"a frame is {255 * RS_BLOCKS} bytes")
        return self.decode_frames(data[None])[0]

    def encode(self, payload: np.ndarray) -> np.ndarray:
        """TX oracle (inverse of decode): 1195 bytes -> 1275 wire bytes."""
        payload = np.asarray(payload, np.uint8)
        if len(payload) != 4 + DATA_LEN:
            raise ValueError(f"a payload is {4 + DATA_LEN} bytes")
        i = np.arange(len(payload))
        conv = FROM_DB[payload ^ RAND_VALS[i % 255]]
        msgs = np.zeros((RS_BLOCKS, self.rs.msg_len), np.uint8)
        msgs[i % RS_BLOCKS, i // RS_BLOCKS] = conv
        wire = np.zeros((RS_BLOCKS, 255), np.uint8)
        for b in range(RS_BLOCKS):
            wire[b] = self.rs.encode(msgs[b])
        return TO_DB[wire.T.reshape(-1)]


class FalconPacketSync:
    """Packet reassembly across frames (falcon_packet.h FalconPacketSync).

    process(frame[1195]) -> list of complete packets (bytes). Frame =
    [counter:18|packet_ptr:11 in 4 bytes][1191 data bytes]; packet_ptr is
    the offset of the first packet boundary (2047 = no boundary, pure
    continuation)."""

    def __init__(self):
        self._last_counter = 0
        self._partial = b""
        self._reading = False

    def process(self, frame: np.ndarray) -> list[bytes]:
        frame = np.asarray(frame, np.uint8)
        b0, b1, b2, b3 = (int(frame[0]), int(frame[1]), int(frame[2]),
                          int(frame[3]))
        pkt_ptr = b3 | ((b2 & 0b111) << 8)
        counter = (b2 >> 3) | (b1 << 5) | ((b0 & 0b111111) << 13)
        data = frame[4:4 + DATA_LEN].tobytes()

        out: list[bytes] = []
        if self._last_counter + 1 != counter:
            self._reading = False
            self._partial = b""
        self._last_counter = counter

        if pkt_ptr == 2047:  # continuation-only frame
            if self._reading:
                self._partial += data
            return out

        if self._reading:
            out.append(self._partial + data[:pkt_ptr])
            self._partial = b""
            self._reading = False

        i = pkt_ptr
        while i < DATA_LEN:
            if DATA_LEN - i < 4:
                self._partial = data[i:]
                self._reading = True
                break
            length = (((data[i] & 0b1111) << 8) | data[i + 1]) + 2
            if length <= 2:
                self._reading = False
                break
            if DATA_LEN - i < length:
                self._partial = data[i:]
                self._reading = True
                break
            out.append(data[i:i + length])
            i += length
        return out


def parse_packet(pkt: bytes):
    """Classify a packet like the reference's sinkHandler
    (main.cpp:184-202). Returns (kind, payload): kind in
    {"gps", "video", "other"}."""
    if len(pkt) < 10:
        return "other", pkt
    length = (((pkt[0] & 0b1111) << 8) | pkt[1]) + 2
    pkt_id = int.from_bytes(pkt[2:10], "big")
    if pkt_id in (PKT_GPS_A, PKT_GPS_B):
        return "gps", pkt[25:max(25, length - 2)]
    if pkt_id == PKT_VIDEO:
        return "video", pkt[25:25 + 940]
    return "other", pkt


class Falcon9Decoder:
    """End-to-end Falcon 9 telemetry receiver (main.cpp:52-63): FM
    discriminator -> M&M recovery -> slicer -> deframe -> RS -> packets,
    the first two and the RS on ``device``.

    process(iq @6 Msps) -> list[(kind, payload)]."""

    INPUT_RATE = 6_000_000.0
    BAUDRATE = 3_571_400.0
    DEVIATION = 2_000_000.0

    def __init__(self, samplerate: float = INPUT_RATE, *, device="cuda"):
        from ..ops.clock_recovery import MMClockRecovery
        from ..ops.fm import Quadrature

        self.device = torch.device(device)
        self.demod = Quadrature(self.DEVIATION, samplerate, device=device)
        # main.cpp:53: omega, omegaGain = 0.01^2 / 4, muGain = 0.01,
        # rel = 100e-6
        self.recov = MMClockRecovery(samplerate / self.BAUDRATE,
                                     0.01 ** 2 / 4.0, 0.01, 100e-6,
                                     complex_input=False, device=device)
        self.deframe = Deframer(FRAME_BITS, SYNC_BITS)
        self.rs = FalconRS(device=device)
        self.pkt = FalconPacketSync()
        self._dstate = self.demod.init_state()
        self._rstate = self.recov.init_state()

    def process(self, iq) -> list[tuple[str, bytes]]:
        x = torch.as_tensor(iq).to(self.device, torch.complex64)
        self._dstate, y = self.demod(self._dstate, x)
        self._rstate, (sym, valid) = self.recov(self._rstate, y)
        bits = (sym[valid] > 0.0).to(torch.uint8).cpu().numpy()
        frames = [np.packbits(f)[4:4 + 255 * RS_BLOCKS]
                  for f in self.deframe.process(bits)]
        out: list[tuple[str, bytes]] = []
        for decoded in self.rs.decode_frames(frames):
            if decoded is None:
                continue
            for pkt in self.pkt.process(decoded):
                out.append(parse_packet(pkt))
        return out
