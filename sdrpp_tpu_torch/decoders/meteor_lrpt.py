"""Meteor M2 LRPT downlink decoder (BASELINE config #5, full depth).

The counterpart of ``sdrpp_tpu.decoders.meteor_lrpt``:

    IQ @150k -> MeteorDemod (RRC/AGC/Costas/MM) -> soft symbols (s8 x84)
    -> stream Viterbi (rotation-ambiguity search, CCSDS K=7 r=1/2)
    -> CADU sync on the 0x1ACFFC1D attached sync marker
    -> CCSDS derandomize (x^8+x^7+x^5+x^3+1, all-ones seed)
    -> RS(255,223) deinterleave-4 -> 892-byte VCDU payloads

The demodulator and the Viterbi decode run on the decoder's device; the
soft-bit mapping, the sync search and the framing run on the host, and
the RS decode of every CADU a rotation finds is one batched call on the
device. ``encode_cadus`` is the exact inverse (host numpy).
"""

from __future__ import annotations

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from ..models.lrpt import LRPTDecoder, soft_s8_to_u8, symbols_to_soft_bits
from .falcon9 import _ccsds_randomizer

__all__ = ["MeteorLRPTDecoder", "encode_cadus", "ASM", "CADU_BYTES"]

ASM = 0x1ACFFC1D                 # CCSDS attached sync marker
ASM_BYTES = np.frombuffer(ASM.to_bytes(4, "big"), np.uint8)
ASM_BITS = np.unpackbits(ASM_BYTES)
CADU_BYTES = 1024                # ASM (4) + randomized codeblock (1020)
FRAME_DATA = 1020                # 4 interleaved RS(255,223) codewords
VCDU_BYTES = 4 * 223             # payload per CADU


_RAND_1020 = np.resize(_ccsds_randomizer(255), FRAME_DATA)


def encode_cadus(payloads: np.ndarray, lrpt: LRPTDecoder | None = None
                 ) -> np.ndarray:
    """[N, 892] payload bytes -> QPSK symbols (complex64, 72 ksym rate):
    RS-encode each 223-byte quarter, byte-interleave by 4, randomize,
    prepend the ASM, convolutionally encode the whole CADU stream, map
    coded bit pairs to QPSK (I = bit 0, Q = bit 1, unit energy)."""
    lrpt = lrpt or LRPTDecoder(device="cpu")
    payloads = np.asarray(payloads, np.uint8).reshape(-1, VCDU_BYTES)
    stream = []
    for p in payloads:
        inter = np.zeros(FRAME_DATA, np.uint8)
        for j in range(4):
            inter[j::4] = lrpt.rs.encode(p[223 * j:223 * (j + 1)])
        stream.append(np.concatenate([ASM_BYTES, inter ^ _RAND_1020]))
    msg = np.concatenate(stream)
    coded = lrpt.conv.encode(msg)
    nbits = lrpt.conv.encode_len_bits(len(msg))
    bits = np.unpackbits(np.asarray(coded, np.uint8))[:nbits]
    if len(bits) % 2:
        bits = np.append(bits, 0)
    i = bits[0::2] * 2.0 - 1.0
    q = bits[1::2] * 2.0 - 1.0
    return ((i + 1j * q) / np.sqrt(2)).astype(np.complex64)


class MeteorLRPTDecoder:
    """Streaming front (demodulate IQ blocks on the device, keep the valid
    symbols) + one-shot ``finalize`` running the Viterbi/CADU/RS tail over
    the whole pass."""

    def __init__(self, samplerate: float = 150000.0,
                 symbolrate: float = 72000.0, oqpsk: bool = False,
                 broken_modulation: bool = False, *, device="cuda"):
        from ..models.digital import MeteorDemod

        self.device = torch.device(device)
        self.demod = MeteorDemod(symbolrate=symbolrate,
                                 samplerate=samplerate, oqpsk=oqpsk,
                                 broken_modulation=broken_modulation,
                                 device=device)
        self._state = self.demod.init_state()
        self._chunks: list[torch.Tensor] = []
        self.timings = {}

    def process(self, iq) -> int:
        """Demodulate one IQ block (numpy or tensor); returns the number of
        symbols emitted so far."""
        x = torch.as_tensor(iq).to(self.device, torch.complex64)
        self._state, (syms, valid) = self.demod(self._state, x)
        self._chunks.append(syms[valid])
        return sum(len(c) for c in self._chunks)

    @property
    def symbols(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, np.complex64)
        return torch.cat(self._chunks).cpu().numpy()

    def soft_s8(self) -> np.ndarray:
        """The reference module's output surface: s8 x84 soft symbols."""
        return symbols_to_soft_bits(self.symbols * np.sqrt(2))

    def finalize(self):
        """Run the Viterbi -> CADU -> RS tail under each of the 4 QPSK
        rotations until one yields VCDUs. Returns (soft_s8, vcdus, info):
        ``vcdus`` [N, 892] uint8 RS-corrected payloads, ``info`` the
        rotation used and the CADU counts. ``self.timings`` holds the
        seconds spent in the Viterbi decode, the sync search and the RS
        decode (host clock; each ends in a copy to the host)."""
        import time

        lrpt = LRPTDecoder(device=self.device)
        syms = self.symbols
        soft = self.soft_s8()
        t = {"viterbi_s": 0.0, "sync_s": 0.0, "rs_s": 0.0}
        best = (None, -1, 0)  # (vcdus, rotation, cadus_seen)
        for rot in range(4):
            r = syms * np.exp(-1j * np.pi / 2 * rot)
            u8 = soft_s8_to_u8(symbols_to_soft_bits(r * np.sqrt(2)))
            usable = len(u8) - len(u8) % 2
            if usable < 16 * CADU_BYTES:
                continue
            t0 = time.perf_counter()
            bits = lrpt.conv.decode_soft_stream(u8[:usable])
            t1 = time.perf_counter()
            t["viterbi_s"] += t1 - t0
            if len(bits) < 8 * CADU_BYTES + 32:
                continue
            w = sliding_window_view(bits, 32)
            hits = np.nonzero((w == ASM_BITS).all(axis=1))[0]
            frames, last_end = [], -1
            for p in hits:
                if p < last_end or p + 8 * CADU_BYTES > len(bits):
                    continue
                frames.append(np.packbits(bits[p:p + 8 * CADU_BYTES]))
                last_end = p + 8 * CADU_BYTES
            seen = len(frames)
            t2 = time.perf_counter()
            t["sync_s"] += t2 - t1
            vcdus = []
            if frames:
                data = np.stack(frames)[:, 4:] ^ _RAND_1020  # [N, 1020]
                cws = np.stack([data[:, j::4] for j in range(4)], axis=1)
                out, ok = lrpt.rs_decode_blocks(cws.reshape(-1, 255))
                out = out.reshape(seen, 4 * 223)
                ok = ok.reshape(seen, 4).all(axis=1)
                vcdus = list(out[ok])
            t["rs_s"] += time.perf_counter() - t2
            if seen > best[2] or (vcdus and best[0] is None):
                best = (vcdus, rot, seen)
            if vcdus:
                break
        self.timings = t
        vcdus, rot, seen = best
        vcdus = (np.stack(vcdus) if vcdus
                 else np.zeros((0, VCDU_BYTES), np.uint8))
        return soft, vcdus, {"rotation": rot, "cadus_seen": seen,
                             "vcdus_ok": len(vcdus)}
