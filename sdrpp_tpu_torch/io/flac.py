"""Pure-Python FLAC encoder/decoder for the recorder's FLAC container.

The port's own numpy-only copy of ``sdrpp_tpu.io.flac``: its encoder
writes the same bytes as that module's for the same input
(tests/test_torch_recording.py).

The reference recorder offers WAV/FLAC/MP3 containers
(misc_modules/recorder/src/main.cpp:48-60) and encodes FLAC through
libFLAC with default settings, integer sample formats only
(core/src/utils/wav.cpp:94-114). libFLAC is not in this image, so this is
a from-scratch spec-compliant implementation:

- stream:     "fLaC" magic + STREAMINFO metadata block (RFC 9639 §8.2)
- frames:     14-bit sync, fixed-blocksize strategy, UTF-8-coded frame
              number, CRC-8 header / CRC-16 frame trailers
- subframes:  CONSTANT / VERBATIM / FIXED order 0-4 / LPC (order 8,
              Levinson-Durbin quantized coefficients on encode; any
              order 1-32 on decode)
- stereo:     left/side, right/side, mid/side decorrelation on encode
              (libFLAC's default; per-frame cost pick, ``stereo_mode``
              overrides) and decode
- residuals:  partitioned Rice (methods 0/1, escape code)

The encoder picks the cheapest of the fixed orders and the LPC candidate
per subframe by estimated Rice bits (libFLAC's heuristic) and writes a
correct MD5 of the unencoded samples into STREAMINFO so `flac -t` style
integrity checks pass.

Not implemented (not needed for the recorder): variable block size on
encode; the decoder reads any fixed-blocksize stream a spec encoder
produces (all subframe types, all four channel assignments, both Rice
methods) and verifies both CRCs + MD5.
"""

from __future__ import annotations

import hashlib
import struct
from pathlib import Path

import numpy as np

__all__ = ["FlacWriter", "read_flac", "FlacInfo"]


# ---------------------------------------------------------------- bit I/O

class _BitWriter:
    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int):
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_signed(self, value: int, nbits: int):
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int):
        # FLAC unary: q zero bits terminated by a one bit (RFC 9639 §9.2.7.1)
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def getvalue(self) -> bytes:
        assert self._nbits == 0
        return bytes(self._buf)


class _BitReader:
    def __init__(self, data: bytes, pos_bits: int = 0):
        self._d = data
        self.pos = pos_bits

    def read(self, nbits: int) -> int:
        v = 0
        p = self.pos
        d = self._d
        for _ in range(nbits):
            v = (v << 1) | ((d[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        if v >= 1 << (nbits - 1):
            v -= 1 << nbits
        return v

    def read_unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def align(self):
        self.pos = (self.pos + 7) & ~7


# ------------------------------------------------------------------ CRCs

def _make_crc8_table():
    t = []
    for b in range(256):
        c = b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        t.append(c)
    return t


def _make_crc16_table():
    t = []
    for b in range(256):
        c = b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        t.append(c)
    return t


_CRC8 = _make_crc8_table()
_CRC16 = _make_crc16_table()


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC16[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF)
    return c


def _utf8_code(n: int) -> bytes:
    """FLAC's extended UTF-8 coding of the frame number (RFC 9639 §9.1.5)."""
    if n < 0x80:
        return bytes([n])
    out = []
    for total in range(2, 8):
        if n < 1 << (total * 5 + 1):
            lead = (0xFF << (8 - total)) & 0xFF
            out.append(lead | (n >> (6 * (total - 1))))
            for i in range(total - 2, -1, -1):
                out.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError("frame number too large")


def _read_utf8_code(br: _BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    nb = 0
    mask = 0x40
    while b0 & mask:
        nb += 1
        mask >>= 1
    v = b0 & (mask - 1)
    for _ in range(nb):
        v = (v << 6) | (br.read(8) & 0x3F)
    return v


_SAMPLE_SIZE_CODE = {8: 0b001, 12: 0b010, 16: 0b100, 20: 0b101,
                     24: 0b110, 32: 0b111}
_SAMPLE_SIZE_FROM_CODE = {v: k for k, v in _SAMPLE_SIZE_CODE.items()}


def _fixed_residuals(x: np.ndarray, max_order: int):
    """Residual series for fixed predictors order 0..max_order.

    Order-k residual = k-th finite difference (the FLAC fixed predictors
    are exactly polynomial predictors; RFC 9639 §9.2.5)."""
    res = [x.astype(np.int64)]
    for _ in range(max_order):
        res.append(np.diff(res[-1]))
    return res


def _rice_param(partition: np.ndarray) -> int:
    """Smallest-cost Rice parameter estimate (libFLAC-style mean log2)."""
    n = len(partition)
    if n == 0:
        return 0
    total = int(np.sum(partition))  # already folded (unsigned)
    k = 0
    while (n << (k + 1)) < total and k < 14:
        k += 1
    return k


def _rice_bits(folded: np.ndarray, k: int) -> int:
    """Exact bit cost of Rice-coding the folded residuals with parameter k."""
    return int(np.sum(folded >> k)) + len(folded) * (k + 1)


def _lpc_coeffs(x: np.ndarray, order: int, precision: int = 14):
    """Window -> autocorrelation -> Levinson-Durbin -> quantized predictor.

    Returns (qcoefs int32[order], shift) or None when the signal is too
    short/degenerate. Mirrors libFLAC's default pipeline (apodize, solve
    normal equations, quantize to `precision` bits with a left shift)."""
    n = len(x)
    if n <= order + 1:
        return None
    w = np.hanning(n)
    xs = x.astype(np.float64) * w
    ac = np.array([np.dot(xs[: n - lag], xs[lag:]) for lag in range(order + 1)])
    if ac[0] == 0.0:
        return None
    # Levinson-Durbin recursion
    err = ac[0]
    a = np.zeros(order, np.float64)
    for i in range(order):
        acc = ac[i + 1] - sum(a[j] * ac[i - j] for j in range(i))
        if err == 0.0:
            return None
        k = acc / err
        a[: i + 1] = np.concatenate([a[:i] - k * a[:i][::-1], [k]])
        err *= (1.0 - k * k)
        if err <= 0.0:
            break
    cmax = np.max(np.abs(a))
    if not np.isfinite(cmax) or cmax == 0.0:
        return None
    shift = min(15, max(0, precision - 1 - int(np.floor(np.log2(cmax))) - 1))
    q = np.clip(np.rint(a * (1 << shift)), -(1 << (precision - 1)),
                (1 << (precision - 1)) - 1).astype(np.int64)
    if not np.any(q):
        return None
    return q, shift


def _lpc_residual(x: np.ndarray, q: np.ndarray, shift: int) -> np.ndarray:
    """r[i] = x[i] - (sum_j q[j]·x[i-1-j]) >> shift for i >= order.

    The prediction sum uses the arithmetic right shift the format
    specifies; vectorized as a stack of lagged slices."""
    order = len(q)
    n = len(x)
    pred = np.zeros(n - order, np.int64)
    for j in range(order):
        pred += q[j] * x[order - 1 - j: n - 1 - j]
    return x[order:] - (pred >> shift)


def _zigzag(r: np.ndarray) -> np.ndarray:
    return np.where(r >= 0, r.astype(np.int64) << 1, (-r.astype(np.int64) << 1) - 1)


class FlacWriter:
    """Streaming FLAC file writer (integer PCM, independent channels).

    write() takes float arrays in [-1, 1] (like WavSink) or integer arrays
    already quantized to ``bits``. STREAMINFO (total samples, MD5,
    min/max frame size) is patched on close().
    """

    def __init__(self, path, samplerate: int, channels: int = 2,
                 bits: int = 16, block_size: int = 4096,
                 lpc: bool = True, lpc_precision: int = 14,
                 stereo_mode: str = "auto"):
        if bits not in _SAMPLE_SIZE_CODE:
            raise ValueError(f"unsupported bit depth {bits}")
        if not 1 <= channels <= 8:
            raise ValueError("1..8 channels")
        if stereo_mode not in ("auto", "independent", "left_side",
                               "right_side", "mid_side"):
            raise ValueError(f"unknown stereo_mode {stereo_mode!r}")
        self.lpc = lpc
        self.lpc_precision = lpc_precision
        self.stereo_mode = stereo_mode
        self.path = Path(path)
        self.samplerate = int(samplerate)
        self.channels = channels
        self.bits = bits
        self.block_size = block_size
        self._f = open(self.path, "wb")
        self._md5 = hashlib.md5()
        self._pending = np.zeros((0, channels), np.int64)
        self._frame_no = 0
        self._total = 0
        self._min_fr = 0xFFFFFF
        self._max_fr = 0
        self._write_header()

    # -- header ----------------------------------------------------------
    def _write_header(self):
        f = self._f
        f.write(b"fLaC")
        # STREAMINFO placeholder; patched in close()
        f.write(bytes([0x80, 0, 0, 34]))  # last-metadata-block, type 0, len 34
        self._streaminfo_pos = f.tell()
        f.write(self._streaminfo(0, b"\x00" * 16))

    def _streaminfo(self, total_samples: int, md5: bytes) -> bytes:
        bw = _BitWriter()
        bw.write(self.block_size, 16)   # min block size
        bw.write(self.block_size, 16)   # max block size
        mn = 0 if self._min_fr == 0xFFFFFF else self._min_fr
        bw.write(mn, 24)
        bw.write(self._max_fr, 24)
        bw.write(self.samplerate, 20)
        bw.write(self.channels - 1, 3)
        bw.write(self.bits - 1, 5)
        bw.write(total_samples, 36)
        bw.align()
        return bw.getvalue() + md5

    # -- encode ----------------------------------------------------------
    def write(self, samples: np.ndarray):
        samples = np.asarray(samples)
        if samples.ndim == 1:
            samples = samples[:, None]
        if samples.shape[1] != self.channels:
            raise ValueError(f"expected {self.channels} channels")
        if np.issubdtype(samples.dtype, np.floating):
            full = float(1 << (self.bits - 1))
            samples = np.clip(np.rint(samples.astype(np.float64) * full),
                              -full, full - 1).astype(np.int64)
        else:
            samples = samples.astype(np.int64)
        self._pending = np.concatenate([self._pending, samples], axis=0)
        while len(self._pending) >= self.block_size:
            blk, self._pending = (self._pending[: self.block_size],
                                  self._pending[self.block_size:])
            self._emit_frame(blk)

    def _emit_frame(self, blk: np.ndarray):
        n = len(blk)
        bw = _BitWriter()
        bw.write(0b11111111111110, 14)  # sync
        bw.write(0, 1)                  # reserved
        bw.write(0, 1)                  # fixed-blocksize strategy
        bs_code = 0b0110 if n <= 256 else 0b0111
        bw.write(bs_code, 4)
        bw.write(0b0000, 4)             # sample rate: from STREAMINFO
        ch_asgn, planes = self._channel_assignment(blk)
        bw.write(ch_asgn, 4)
        bw.write(_SAMPLE_SIZE_CODE[self.bits], 3)
        bw.write(0, 1)                  # reserved
        for b in _utf8_code(self._frame_no):
            bw.write(b, 8)
        if bs_code == 0b0110:
            bw.write(n - 1, 8)
        else:
            bw.write(n - 1, 16)
        bw.align()
        hdr = bw.getvalue()
        bw = _BitWriter()
        for b in hdr:
            bw.write(b, 8)
        bw.write(crc8(hdr), 8)

        for x, xbits in planes:
            self._emit_subframe(bw, x, xbits)

        bw.align()
        body = bw.getvalue()
        frame = body + struct.pack(">H", crc16(body))
        self._f.write(frame)
        self._min_fr = min(self._min_fr, len(frame))
        self._max_fr = max(self._max_fr, len(frame))
        self._frame_no += 1
        self._total += n
        # MD5 over little-endian signed samples, interleaved (RFC 9639 §8.2)
        width = self.bits // 8
        le = blk.reshape(-1).astype(np.int64)
        raw = np.zeros((len(le), width), np.uint8)
        for i in range(width):
            raw[:, i] = (le >> (8 * i)) & 0xFF
        self._md5.update(raw.tobytes())

    def _channel_assignment(self, blk: np.ndarray):
        """Pick the frame's channel assignment (RFC 9639 §9.1.3).

        Stereo frames try the decorrelated forms libFLAC uses by default —
        left/side (8), right/side (9), mid/side (10); the side channel
        codes with bits+1. Estimated cost = Rice bits of the order-2 fixed
        residual per plane (libFLAC's loose estimate). Returns
        (ch_asgn, [(plane, bits), ...]).
        """
        bits = self.bits
        if self.channels != 2 or self.stereo_mode == "independent":
            return (self.channels - 1,
                    [(blk[:, c], bits) for c in range(self.channels)])
        left = blk[:, 0]
        right = blk[:, 1]
        side = left - right
        mid = (left + right) >> 1
        cands = {
            "independent": (1, [(left, bits), (right, bits)]),
            "left_side": (8, [(left, bits), (side, bits + 1)]),
            "right_side": (9, [(side, bits + 1), (right, bits)]),
            "mid_side": (10, [(mid, bits), (side, bits + 1)]),
        }
        if self.stereo_mode != "auto":
            return cands[self.stereo_mode]

        def est(x):
            if len(x) < 3:
                return 8 * len(x)
            r = np.diff(np.diff(x.astype(np.int64)))
            folded = _zigzag(r)
            return _rice_bits(folded, _rice_param(folded))

        el, er, es, em = est(left), est(right), est(side), est(mid)
        costs = {"independent": el + er, "left_side": el + es,
                 "right_side": er + es, "mid_side": em + es}
        return cands[min(costs, key=costs.get)]

    def _emit_subframe(self, bw: _BitWriter, x: np.ndarray, bits=None):
        n = len(x)
        bits = self.bits if bits is None else bits
        if np.all(x == x[0]):
            bw.write(0, 1)
            bw.write(0b000000, 6)  # CONSTANT
            bw.write(0, 1)
            bw.write_signed(int(x[0]), bits)
            return
        max_order = min(4, n - 1)
        res = _fixed_residuals(x, max_order)
        fixed_costs = []
        for o, r in enumerate(res):
            folded = _zigzag(r)
            fixed_costs.append(_rice_bits(folded, _rice_param(folded))
                               + o * bits)
        order = int(np.argmin(fixed_costs))
        r = res[order]

        # LPC candidate (libFLAC's default path; order 8, 14-bit precision)
        lpc = None
        lpc_order = min(8, n - 1)
        if self.lpc and lpc_order >= 1:
            got = _lpc_coeffs(x, lpc_order, self.lpc_precision)
            if got is not None:
                q, shift = got
                lr = _lpc_residual(x, q, shift)
                if len(lr) == 0 or int(np.max(np.abs(lr))) < 1 << 30:
                    lfold = _zigzag(lr)
                    lcost = (_rice_bits(lfold, _rice_param(lfold))
                             + lpc_order * bits
                             + 4 + 5 + lpc_order * self.lpc_precision)
                    if lcost < fixed_costs[order]:
                        lpc = (q, shift, lr)

        if lpc is None and len(r) and int(np.max(np.abs(r))) >= 1 << 30:
            # residuals too hot for Rice folding: VERBATIM escape hatch
            bw.write(0, 1)
            bw.write(0b000001, 6)  # VERBATIM
            bw.write(0, 1)
            for v in x:
                bw.write_signed(int(v), bits)
            return

        bw.write(0, 1)
        if lpc is not None:
            q, shift, r = lpc
            order = lpc_order
            bw.write(0b100000 | (order - 1), 6)  # LPC
            bw.write(0, 1)                       # no wasted bits
            for v in x[:order]:
                bw.write_signed(int(v), bits)
            bw.write(self.lpc_precision - 1, 4)
            bw.write_signed(shift, 5)
            for c in q:
                bw.write_signed(int(c), self.lpc_precision)
        else:
            bw.write(0b001000 | order, 6)  # FIXED
            bw.write(0, 1)                 # no wasted bits
            for v in x[:order]:
                bw.write_signed(int(v), bits)
        folded = _zigzag(r)
        bw.write(0b00, 2)   # residual method: 4-bit Rice
        bw.write(0, 4)      # partition order 0
        k = _rice_param(folded)
        # escape to raw if unary parts would blow up
        max_fold = int(np.max(folded)) if len(folded) else 0
        if k >= 15 or (max_fold >> k) > 1 << 16:
            rawbits = max(1, int(max_fold).bit_length() + 1)
            bw.write(0b1111, 4)
            bw.write(rawbits, 5)
            for v in r:
                bw.write_signed(int(v), rawbits)
        else:
            bw.write(k, 4)
            for u in folded:
                u = int(u)
                bw.write_unary(u >> k)
                bw.write(u, k)

    def close(self):
        if self._f.closed:
            return
        if len(self._pending):
            self._emit_frame(self._pending)  # short last frame (allowed)
            self._pending = self._pending[:0]
        self._f.flush()
        self._f.seek(self._streaminfo_pos)
        self._f.write(self._streaminfo(self._total, self._md5.digest()))
        self._f.close()

    __enter__ = lambda self: self
    __exit__ = lambda self, *a: self.close()


# ---------------------------------------------------------------- decoder

class FlacInfo:
    def __init__(self, samplerate, channels, bits, total_samples, md5):
        self.samplerate = samplerate
        self.channels = channels
        self.bits = bits
        self.total_samples = total_samples
        self.md5 = md5


def read_flac(path, verify: bool = True):
    """Decode a FLAC file -> (FlacInfo, int32 [n, ch]).

    Verifies frame CRC-8/CRC-16 and the STREAMINFO MD5 when ``verify``.
    """
    blob = Path(path).read_bytes()
    if blob[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    info = None
    while True:
        hdr = blob[pos:pos + 4]
        last = hdr[0] & 0x80
        btype = hdr[0] & 0x7F
        (blen,) = struct.unpack(">I", b"\x00" + hdr[1:4])
        body = blob[pos + 4: pos + 4 + blen]
        if btype == 0:
            br = _BitReader(body)
            br.read(16); br.read(16); br.read(24); br.read(24)
            rate = br.read(20)
            ch = br.read(3) + 1
            bits = br.read(5) + 1
            total = br.read(36)
            info = FlacInfo(rate, ch, bits, total, body[18:34])
        pos += 4 + blen
        if last:
            break
    if info is None:
        raise ValueError("missing STREAMINFO")

    out = []
    md5 = hashlib.md5()
    while pos < len(blob):
        frame_start = pos
        br = _BitReader(blob, pos * 8)
        sync = br.read(14)
        if sync != 0b11111111111110:
            raise ValueError(f"bad sync at byte {pos}")
        br.read(1)
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_asgn = br.read(4)
        ss_code = br.read(3)
        br.read(1)
        _read_utf8_code(br)
        if bs_code == 0b0110:
            n = br.read(8) + 1
        elif bs_code == 0b0111:
            n = br.read(16) + 1
        elif bs_code == 0b0001:
            n = 192
        elif 0b0010 <= bs_code <= 0b0101:
            n = 576 << (bs_code - 2)
        elif bs_code >= 0b1000:
            n = 256 << (bs_code - 8)
        else:
            raise ValueError("reserved block size code")
        if sr_code in (0b1100, 0b1101, 0b1110):
            br.read(8 if sr_code == 0b1100 else 16)
        hdr_end = (br.pos + 7) // 8
        if verify and crc8(blob[frame_start:hdr_end]) != blob[hdr_end]:
            raise ValueError("frame header CRC-8 mismatch")
        br = _BitReader(blob, (hdr_end + 1) * 8)
        bits = _SAMPLE_SIZE_FROM_CODE.get(ss_code, info.bits) \
            if ss_code else info.bits
        if ch_asgn > 10:
            raise ValueError(f"reserved channel assignment {ch_asgn}")
        if ch_asgn <= 7:
            channels = ch_asgn + 1
            frame = np.zeros((n, channels), np.int64)
            for c in range(channels):
                frame[:, c] = _decode_subframe(br, n, bits)
        else:
            # stereo decorrelation (RFC 9639 §9.1.3): the side channel
            # carries one extra bit
            if ch_asgn == 8:    # left/side
                left = _decode_subframe(br, n, bits)
                side = _decode_subframe(br, n, bits + 1)
                right = left - side
            elif ch_asgn == 9:  # side/right
                side = _decode_subframe(br, n, bits + 1)
                right = _decode_subframe(br, n, bits)
                left = right + side
            else:               # mid/side
                mid = _decode_subframe(br, n, bits)
                side = _decode_subframe(br, n, bits + 1)
                mid = (mid << 1) | (side & 1)
                left = (mid + side) >> 1
                right = (mid - side) >> 1
            frame = np.stack([left, right], axis=1)
        br.align()
        body_end = br.pos // 8
        if verify:
            (fcrc,) = struct.unpack_from(">H", blob, body_end)
            if crc16(blob[frame_start:body_end]) != fcrc:
                raise ValueError("frame CRC-16 mismatch")
        pos = body_end + 2
        out.append(frame)

    data = (np.concatenate(out, axis=0) if out
            else np.zeros((0, info.channels), np.int64))
    if info.total_samples:
        data = data[: info.total_samples]
    if verify and info.md5 != b"\x00" * 16:
        width = info.bits // 8
        le = data.reshape(-1)
        raw = np.zeros((len(le), width), np.uint8)
        for i in range(width):
            raw[:, i] = (le >> (8 * i)) & 0xFF
        md5.update(raw.tobytes())
        if md5.digest() != info.md5:
            raise ValueError("MD5 mismatch: decoded audio is corrupt")
    return info, data.astype(np.int32)


def _decode_subframe(br: _BitReader, n: int, bits: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("bad subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
    bits -= wasted
    if stype == 0:  # CONSTANT
        x = np.full(n, br.read_signed(bits), np.int64)
    elif stype == 1:  # VERBATIM
        x = np.array([br.read_signed(bits) for _ in range(n)], np.int64)
    elif 8 <= stype <= 12:  # FIXED
        order = stype - 8
        warm = [br.read_signed(bits) for _ in range(order)]
        r = _decode_residual(br, n, order)
        x = _undiff(np.asarray(warm, np.int64), r, order, n)
    elif stype >= 32:  # LPC
        order = stype - 31
        warm = [br.read_signed(bits) for _ in range(order)]
        precision = br.read(4) + 1
        shift = br.read_signed(5)
        q = [br.read_signed(precision) for _ in range(order)]
        r = _decode_residual(br, n, order)
        x = np.empty(n, np.int64)
        x[:order] = warm
        for i in range(order, n):
            pred = 0
            for j in range(order):
                pred += q[j] * x[i - 1 - j]
            x[i] = r[i - order] + (int(pred) >> shift)
    else:
        raise ValueError(f"unsupported subframe type {stype}")
    return x << wasted


def _undiff(warm: np.ndarray, resid: np.ndarray, order: int, n: int) -> np.ndarray:
    """Invert order-k finite differencing given the k warmup samples.

    The o-th difference series d_o satisfies d_{o-1} = cumsum of
    [first element of d_{o-1}] ++ d_o, where that first element is the
    (o-1)-th difference of the warmup prefix."""
    if order == 0:
        return resid[:n]
    seq = resid.astype(np.int64)
    for o in range(order, 0, -1):
        w = warm.astype(np.int64)
        for _ in range(o - 1):
            w = np.diff(w)
        seq = np.concatenate([w[:1], seq]).cumsum()
    return seq[:n]


def _decode_residual(br: _BitReader, n: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method not in (0, 1):
        raise ValueError("reserved residual method")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    porder = br.read(4)
    nparts = 1 << porder
    out = []
    for p in range(nparts):
        cnt = (n >> porder) - (order if p == 0 else 0)
        k = br.read(pbits)
        if k == escape:
            rawbits = br.read(5)
            out.extend(br.read_signed(rawbits) if rawbits else 0
                       for _ in range(cnt))
        else:
            for _ in range(cnt):
                q = br.read_unary()
                u = (q << k) | br.read(k)
                out.append((u >> 1) ^ -(u & 1))
    return np.asarray(out, np.int64)
