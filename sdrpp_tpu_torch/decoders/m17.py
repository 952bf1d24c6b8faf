"""M17 digital-voice coding layer: Golay(24,12), CRC16, base-40 callsigns,
LSF decode.

The counterpart of ``sdrpp_tpu.decoders.m17``, host code as there.

Reference: decoder_modules/m17_decoder/src/{golay24.h, crc16.h, base40.cpp,
lsf_decode.cpp, m17dsp.h} (Mobilinkd implementations). The RF chain is the
GFSK demodulator (models/digital.GFSKDemod); this module is the bit layer:

- Golay(24,12): generator POLY 0xC75, codeword = checkbits(11)|data(12)
  plus an overall parity bit; decode corrects up to 3 bit errors via a
  syndrome table (golay24.h:93-200).
- CRC16: poly 0x5935 init 0xFFFF (the M17 spec CRC, crc16.h).
- base-40 callsign decode (base40.cpp:3-16).

All host-side bit manipulation (the per-frame data rate is trivial).
"""

from __future__ import annotations

import functools


__all__ = ["golay24_encode", "golay24_decode", "crc16", "decode_callsign_base40",
           "encode_callsign_base40"]

_POLY = 0xC75
_B40 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-/."


def _syndrome(codeword: int) -> int:
    codeword &= 0xFFFFFF
    for _ in range(12):
        if codeword & 1:
            codeword ^= _POLY
        codeword >>= 1
    return codeword << 12


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


def golay24_encode(data: int) -> int:
    """12-bit data -> 24-bit codeword (checkbits|data|parity),
    golay24.h encode24."""
    data &= 0xFFF
    codeword = data
    for _ in range(12):
        if codeword & 1:
            codeword ^= _POLY
        codeword >>= 1
    cw23 = codeword | (data << 11)
    return (cw23 << 1) | _parity(cw23)


@functools.lru_cache(maxsize=1)
def _lut():
    """syndrome -> error pattern for all <=3-bit errors (golay24.h make_lut)."""
    table = {}
    veclen = 23
    table[_syndrome(0)] = 0
    for i in range(veclen):
        v = 1 << i
        table.setdefault(_syndrome(v), v)
    for i in range(veclen - 1):
        for j in range(i + 1, veclen):
            v = (1 << i) | (1 << j)
            table.setdefault(_syndrome(v), v)
    for i in range(veclen - 2):
        for j in range(i + 1, veclen - 1):
            for k in range(j + 1, veclen):
                v = (1 << i) | (1 << j) | (1 << k)
                table.setdefault(_syndrome(v), v)
    return table


def golay24_decode(codeword: int) -> int | None:
    """24-bit codeword -> corrected 12-bit data, or None if uncorrectable."""
    syndrm = _syndrome(codeword >> 1)
    corr = _lut().get(syndrm)
    if corr is None:
        return None
    fixed = codeword ^ (corr << 1)
    # Only test parity for 3-bit errors (golay24.h decode).
    ok = bin(syndrm).count("1") < 3 or not _parity(fixed)
    return ((fixed >> 12) & 0xFFF) if ok else None


def crc16(data: bytes, poly: int = 0x5935, init: int = 0xFFFF) -> int:
    """M17 CRC16 (crc16.h): MSB-first with augmented zero flush."""
    reg = init
    # reset() quirk: the initial register is run through 16 reflected steps.
    for _ in range(16):
        bit = reg & 1
        if bit:
            reg ^= poly
        reg >>= 1
        if bit:
            reg |= 0x8000
    reg &= 0xFFFF
    for byte in data:
        for i in range(8):
            msb = reg & 0x8000
            reg = ((reg << 1) & 0xFFFF) | ((byte >> (7 - i)) & 1)
            if msb:
                reg ^= poly
    for _ in range(16):
        msb = reg & 0x8000
        reg = (reg << 1) & 0xFFFF
        if msb:
            reg ^= poly
    return reg & 0xFFFF


def decode_callsign_base40(encoded: int) -> str:
    """base-40 callsign decode (base40.cpp:3-16)."""
    if encoded >= 40 ** 9:
        return ""
    out = []
    while encoded > 0:
        out.append(_B40[encoded % 40])
        encoded //= 40
    return "".join(out)


def encode_callsign_base40(callsign: str) -> int:
    encoded = 0
    for ch in reversed(callsign):
        idx = _B40.find(ch.upper())
        if idx < 0:
            raise ValueError(f"invalid callsign char {ch!r}")
        encoded = encoded * 40 + idx
    return encoded


# ---------------------------------------------------------------------------
# Link Setup Frame decode (reference: lsf_decode.{h,cpp})
# ---------------------------------------------------------------------------

M17_DATA_TYPES = ("Unknown", "Data", "Voice", "Voice & Data")
M17_ENCRYPTION_TYPES = ("None", "AES", "Scrambler", "Unknown")


class M17LSF:
    """Decoded Link Setup Frame fields (lsf_decode.h M17LSF)."""

    def __init__(self):
        self.valid = False
        self.dst = self.src = ""
        self.raw_dst = self.raw_src = 0
        self.raw_type = self.raw_crc = 0
        self.meta = b""
        self.is_stream = False
        self.data_type = 0
        self.encryption_type = 0
        self.encryption_subtype = 0
        self.channel_access_num = 0


def _bits_be(data: bytes, start_bit: int, nbits: int) -> int:
    v = 0
    for i in range(nbits):
        bit = (data[(start_bit + i) // 8] >> (7 - ((start_bit + i) % 8))) & 1
        v = (v << 1) | bit
    return v


def _decode_address(raw: int) -> str:
    if raw == 0:
        return "Invalid"
    if raw <= 262143999999999:
        return decode_callsign_base40(raw)
    if raw == 0xFFFFFFFFFFFF:
        return "Broadcast"
    return f"{raw:X}"


def decode_lsf(lsf_bytes: bytes) -> M17LSF:
    """Decode a 30-byte M17 LSF (lsf_decode.cpp:27-112): DST(48) SRC(48)
    TYPE(16) META(112) CRC(16); CRC16 over the first 28 bytes."""
    if len(lsf_bytes) < 30:
        raise ValueError("an LSF is 30 bytes")
    lsf = M17LSF()
    lsf.raw_crc = _bits_be(lsf_bytes, 48 + 48 + 16 + 112, 16)
    if crc16(bytes(lsf_bytes[:28])) != lsf.raw_crc:
        return lsf
    lsf.valid = True
    lsf.raw_dst = _bits_be(lsf_bytes, 0, 48)
    lsf.raw_src = _bits_be(lsf_bytes, 48, 48)
    lsf.raw_type = _bits_be(lsf_bytes, 96, 16)
    lsf.meta = bytes(lsf_bytes[14:28])
    lsf.dst = _decode_address(lsf.raw_dst)
    lsf.src = "Invalid" if lsf.raw_src in (0, 0xFFFFFFFFFFFF) \
        else _decode_address(lsf.raw_src)
    t = lsf.raw_type
    lsf.is_stream = bool(t & 1)
    lsf.data_type = (t >> 1) & 0b11
    lsf.encryption_type = (t >> 3) & 0b11
    lsf.encryption_subtype = (t >> 5) & 0b11
    lsf.channel_access_num = (t >> 7) & 0b1111
    return lsf


def encode_lsf(dst: str, src: str, type_word: int, meta: bytes = b"\0" * 14) -> bytes:
    """Build a valid LSF (test/TX helper; inverse of decode_lsf)."""
    raw = bytearray(30)

    def put_bits(start_bit, nbits, value):
        for i in range(nbits):
            bit = (value >> (nbits - 1 - i)) & 1
            raw[(start_bit + i) // 8] |= bit << (7 - ((start_bit + i) % 8))

    put_bits(0, 48, encode_callsign_base40(dst))
    put_bits(48, 48, encode_callsign_base40(src))
    put_bits(96, 16, type_word)
    raw[14:28] = meta.ljust(14, b"\0")[:14]
    put_bits(224, 16, crc16(bytes(raw[:28])))
    return bytes(raw)
