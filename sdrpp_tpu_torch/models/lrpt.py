"""LRPT downlink decode chain glue (Meteor M2, BASELINE config #5).

The counterpart of ``sdrpp_tpu.models.lrpt``: the symbol -> soft-bit
mapping with the reference's s8 x84 convention
(decoder_modules/meteor_demodulator/src/main.cpp:268-276), the Viterbi +
Reed-Solomon tail (``LRPTDecoder``, CCSDS K = 7 r = 1/2 and RS(255, 223))
and ``MeteorChannel`` (RxVFO to the 150 kHz IF -> MeteorDemod). The
mapping functions are host numpy, as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fec import RS_CCSDS, ConvCode, ReedSolomon, _bytes_from_bits

__all__ = ["CCSDS_CONV_POLYS", "symbols_to_soft_bits", "soft_s8_to_u8",
           "LRPTDecoder", "MeteorChannel"]

# CCSDS rate-1/2 K=7 polynomials (0o171, 0o133) used by LRPT.
CCSDS_CONV_POLYS = (0o171, 0o133)


def symbols_to_soft_bits(symbols: np.ndarray, scale: float = 84.0) -> np.ndarray:
    """QPSK symbols -> interleaved s8 soft bits (I then Q per symbol),
    the meteor module's file format (clamp(v*84, -128..127))."""
    re = np.clip(np.real(symbols) * scale, -128, 127)
    im = np.clip(np.imag(symbols) * scale, -128, 127)
    out = np.empty(2 * len(symbols), np.int8)
    out[0::2] = re.astype(np.int8)
    out[1::2] = im.astype(np.int8)
    return out


def soft_s8_to_u8(soft: np.ndarray) -> np.ndarray:
    """s8 soft symbols (-128 strong 0 ... +127 strong 1) -> the Viterbi
    decoder's u8 convention (0 strong 0 ... 255 strong 1)."""
    return (np.asarray(soft, np.int16) + 128).astype(np.uint8)


class LRPTDecoder:
    """Viterbi + RS tail of the LRPT chain, on ``device``: ``viterbi``
    decodes a coded soft-bit stream, ``rs_decode_blocks`` the 255-byte
    codewords."""

    def __init__(self, *, device):
        self.device = torch.device(device)
        self.conv = ConvCode(2, 7, CCSDS_CONV_POLYS, device=device)
        self.rs = ReedSolomon(RS_CCSDS, 112, 11, 32, device=device)

    def viterbi(self, soft_u8, chunk_bits: int = 4096,
                overlap_bits: int = 96) -> np.ndarray:
        """Viterbi-decode a coded soft-bit stream (uint8, 0 strong 0 ...
        255 strong 1; numpy or a tensor) to packed bytes by the windowed
        stream decode, ``ConvCode.decode_soft_stream`` (chunk_bits-step
        windows with overlap_bits of warm-up and warm-down; B6 and B7),
        as sdrpp_tpu/models/lrpt.py:105 does. The symbols reach the device
        as uint8. A wider overlap makes a seam error at low SNR rarer; a
        stream of one window or less takes the exact decode."""
        bits = self.conv.decode_soft_stream(soft_u8, chunk_bits=chunk_bits,
                                            overlap_bits=overlap_bits)
        return _bytes_from_bits(bits[:len(bits) // 8 * 8])

    def rs_decode_blocks(self, blocks: np.ndarray):
        """[N, 255] uint8 -> ([N, 223] corrected, [N] ok flags), one batched
        decode on the device."""
        out, ok = self.rs.decode(torch.from_numpy(
            np.ascontiguousarray(blocks, np.uint8)))
        return out.cpu().numpy(), ok.cpu().numpy()


class MeteorChannel:
    """Digital receive channel: RxVFO (input rate -> 150 kHz IF) ->
    MeteorDemod (72 ksym QPSK). Output = (symbols, valid), ``valid`` a
    mask over the chunked M&M's lane-major slots (a prefix on blocks the
    M&M runs exact). With ``dynamic_offset`` the VFO's offset is state,
    moved by ``retune_state``."""

    IF_RATE = 150000.0
    SYMBOL_RATE = 72000.0

    def __init__(self, in_samplerate: float, offset: float = 0.0,
                 bandwidth: float | None = None, oqpsk: bool = False,
                 broken_modulation: bool = False,
                 dynamic_offset: bool = False, *, device):
        from .channel import RxVFO
        from .digital import MeteorDemod

        bw = float(bandwidth) if bandwidth else 140000.0
        self.vfo = RxVFO(float(in_samplerate), self.IF_RATE,
                         min(bw, self.IF_RATE), offset,
                         dynamic_offset=dynamic_offset, device=device)
        self.demod = MeteorDemod(symbolrate=self.SYMBOL_RATE,
                                 samplerate=self.IF_RATE, oqpsk=oqpsk,
                                 broken_modulation=broken_modulation,
                                 device=device)
        self.block_multiple = self.vfo.block_multiple

    def max_symbols(self, n: int) -> int:
        return self.demod.max_symbols(self.vfo.out_count(n))

    def retune_state(self, state, offset_hz: float):
        return dict(state, vfo=self.vfo.retune_state(state["vfo"],
                                                     offset_hz))

    def init_state(self):
        return {"vfo": self.vfo.init_state(),
                "demod": self.demod.init_state()}

    def __call__(self, state, x):
        vs, x = self.vfo(state["vfo"], x)
        ds, (syms, valid) = self.demod(state["demod"], x)
        return {"vfo": vs, "demod": ds}, (syms, valid)
