"""NOAA HRPT (High Resolution Picture Transmission) decoder.

The counterpart of ``sdrpp_tpu.decoders.hrpt``: the demodulator runs on
the decoder's device, the slicer's bits come to the host, where the
deframer, the Manchester decode and the word demux run in numpy.

Capability port of the reference's weather_sat_decoder module
(decoder_modules/weather_sat_decoder/src/noaa_hrpt_decoder.h): PSK demod
at 3 Msps -> deframer (11090*10*2 manchester bits, 60-bit sync) ->
Manchester decode -> 10-bit word packer -> minor-frame demux into AVHRR
image channels and TIP frames. The reference module does not build (its
dsp/noaa/{hrpt,tip}.h demux headers no longer exist anywhere in its
tree), so the word-level demux here follows the public NOAA KLM User's
Guide minor-frame layout:

  words 0-5     frame sync (1010000100 0101101111 1101011100
                            0110011101 1000001111 0010010101)
  words 6-7     spacecraft ID + status
  words 8-11    time code
  words 103-622 TIP data: 5 x 104 words, one 8-bit byte in bits 2..9
  words 750-10989  AVHRR earth data: 2048 samples x 5 channels,
                   channel-interleaved 10-bit words
  words 10990-11089 auxiliary sync

Symbol rate 665.4 kbaud data / 1330.8 kbaud on air (Manchester).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.deframing import Deframer

__all__ = ["SYNC_WORDS", "SYNC_BITS", "MANCHESTER_SYNC_BITS",
           "WORDS_PER_FRAME", "FRAME_BITS", "RAW_FRAME_BITS",
           "HRPTFrame", "parse_minor_frame", "manchester_encode",
           "HRPTDeframer", "HRPTDecoder", "VFO_RATE", "SYMBOL_RATE"]

VFO_RATE = 3_000_000.0        # noaa_hrpt_decoder.h:12 NOAA_HRPT_VFO_SR
DATA_RATE = 665_400.0         # bit/s (:23 demod symbol rate /2)
SYMBOL_RATE = 2 * DATA_RATE   # on-air manchester symbol rate

WORDS_PER_FRAME = 11090
FRAME_BITS = WORDS_PER_FRAME * 10
RAW_FRAME_BITS = FRAME_BITS * 2          # manchester (:31 deframe length)

SYNC_WORDS = np.array([0b1010000100, 0b0101101111, 0b1101011100,
                       0b0110011101, 0b1000001111, 0b0010010101], np.int32)
SYNC_BITS = np.unpackbits(
    SYNC_WORDS.astype(">u2").view(np.uint8).reshape(-1, 2),
    axis=1)[:, 6:].reshape(-1).astype(np.uint8)

AVHRR_START, AVHRR_SAMPLES, AVHRR_CHANNELS = 750, 2048, 5
TIP_START, TIP_FRAMES, TIP_WORDS = 103, 5, 104


def manchester_encode(bits: np.ndarray) -> np.ndarray:
    """Data bits -> manchester symbol bits (1 -> 10, 0 -> 01); the
    decoder (ManchesterDecoder invert=False) keeps the first of each
    pair (digital/manchester_decoder.h:20)."""
    bits = np.asarray(bits, np.uint8)
    out = np.empty(bits.size * 2, np.uint8)
    out[0::2] = bits
    out[1::2] = bits ^ 1
    return out


# 60-bit deframer sync in the manchester domain: the reference deframes
# the RAW stream with a 60-bit pattern (noaa_hrpt_decoder.h:31), i.e. the
# manchester encoding of the first 30 data sync bits.
MANCHESTER_SYNC_BITS = manchester_encode(SYNC_BITS[:30])


class HRPTFrame:
    """One parsed minor frame."""

    __slots__ = ("words", "sync_errors", "spacecraft_id", "frame_number",
                 "avhrr", "tip")

    def __init__(self, words, sync_errors, spacecraft_id, frame_number,
                 avhrr, tip):
        self.words = words
        self.sync_errors = sync_errors
        self.spacecraft_id = spacecraft_id
        self.frame_number = frame_number
        self.avhrr = avhrr
        self.tip = tip


def parse_minor_frame(words: np.ndarray) -> HRPTFrame:
    """11090 10-bit words -> HRPTFrame (KLM guide layout)."""
    words = np.asarray(words, np.int32)
    if words.shape != (WORDS_PER_FRAME,):
        raise ValueError(f"a minor frame is {WORDS_PER_FRAME} words")
    sync_errors = int(np.count_nonzero(words[:6] != SYNC_WORDS))
    # word 6: bits 0-1 frame number (1=AVHRR frame of TIP cycle),
    # bits 2-5 spacecraft address per KLM guide section 4.1
    frame_number = int(words[6]) & 0b11
    spacecraft_id = (int(words[6]) >> 2) & 0b1111
    avhrr = words[AVHRR_START:
                  AVHRR_START + AVHRR_SAMPLES * AVHRR_CHANNELS]
    avhrr = avhrr.reshape(AVHRR_SAMPLES, AVHRR_CHANNELS).T  # [5, 2048]
    tip_words = words[TIP_START:TIP_START + TIP_FRAMES * TIP_WORDS]
    # one TIP byte per word in bits 2..9 (KLM guide: 8-bit data followed
    # by a 2-bit parity/fill field in each 10-bit word)
    tip = ((tip_words >> 2) & 0xFF).astype(np.uint8).reshape(
        TIP_FRAMES, TIP_WORDS)
    return HRPTFrame(words, sync_errors, spacecraft_id, frame_number,
                     avhrr, tip)


class HRPTDeframer:
    """Raw Manchester symbol bits -> parsed minor frames.

    Mirrors the reference chain deframe -> ManchesterDecoder -> Packer ->
    demux (noaa_hrpt_decoder.h:31-34) on the host: sync search tolerating
    ``max_sync_errors`` bit errors in the 60-bit raw sync."""

    def __init__(self, max_sync_errors: int = 4):
        self._deframe = Deframer(RAW_FRAME_BITS, MANCHESTER_SYNC_BITS,
                                 max_sync_errors=max_sync_errors)

    def process(self, raw_bits: np.ndarray) -> list[HRPTFrame]:
        frames = []
        for raw in self._deframe.process(raw_bits):
            bits = raw[0::2]                       # Manchester decode
            words = np.packbits(
                bits.reshape(WORDS_PER_FRAME, 10), axis=1, bitorder="big")
            # packbits pads each 10-bit row to 16 bits (2 bytes)
            words = (words[:, 0].astype(np.int32) << 2) | \
                    (words[:, 1].astype(np.int32) >> 6)
            frames.append(parse_minor_frame(words))
        return frames


class HRPTDecoder:
    """End-to-end NOAA HRPT receiver: BPSK demod at 3 Msps
    (noaa_hrpt_decoder.h:23) on ``device`` -> slicer -> deframer -> minor
    frames. process(iq) -> list[HRPTFrame]."""

    def __init__(self, samplerate: float = VFO_RATE, *, device="cuda"):
        from ..models.digital import PSKDemod

        self.device = torch.device(device)
        self.demod = PSKDemod(2, SYMBOL_RATE, samplerate,
                              rrc_tap_count=31, rrc_beta=0.6,
                              agc_rate=0.02e-3,
                              costas_bandwidth=(0.06 ** 2) / 2.0,
                              omega_gain=(0.01 ** 2) / 4.0, mu_gain=0.01,
                              omega_rel_limit=0.005, device=device)
        self._state = self.demod.init_state()
        # BPSK Costas has a 180-degree lock ambiguity: run the deframer on
        # both polarities and take whichever finds frames
        self.deframer = HRPTDeframer()
        self.deframer_inv = HRPTDeframer()

    def process(self, iq) -> list[HRPTFrame]:
        x = torch.as_tensor(iq).to(self.device, torch.complex64)
        self._state, (sym, valid) = self.demod(self._state, x)
        bits = (sym[valid].real > 0.0).to(torch.uint8).cpu().numpy()
        return (self.deframer.process(bits)
                + self.deframer_inv.process(bits ^ 1))
