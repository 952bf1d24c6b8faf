"""End-to-end M17 digital-voice receiver.

The counterpart of ``sdrpp_tpu.models.m17_chain``, mirroring the
reference's M17Decoder hier-block
(decoder_modules/m17_decoder/src/m17dsp.h:642-720):

  GFSK demod (4800 baud, 2400 Hz deviation, RRC alpha 0.5, 31 taps,
  omega 1e-6 / mu 0.01 / rel-limit 0.01, :657)              [device]
  -> M17Slice4FSK -> M17FrameDemux                          [host]
  -> LSF Viterbi + LICH Golay (callsign events)             [device, host]
  -> payload Viterbi -> codec2 3200 voice synthesis         [device, host]

Audio out is 8 kHz stereo float (m17dsp.h:509-517); the soft symbols are
kept for a constellation display (diagOut, :714). Needs the system
libcodec2 (``decoders.codec2``): without it the constructor raises
ImportError.
"""

from __future__ import annotations

import numpy as np
import torch

from ..decoders import m17_frame as mf
from ..decoders.codec2 import M17VoiceDecoder
from ..decoders.m17 import M17LSF
from .digital import GFSKDemod

__all__ = ["M17Decoder"]


class M17Decoder:
    """process(iq) -> (audio [n, 2] f32 @8kHz, lsf_events list[M17LSF]).

    Stateful streaming wrapper: call repeatedly with consecutive IQ blocks
    at ``samplerate`` (narrowband VFO output, e.g. 48 kHz)."""

    AUDIO_RATE = 8000.0

    def __init__(self, samplerate: float, on_lsf=None, *, device="cuda"):
        self.device = torch.device(device)
        self.demod = GFSKDemod(mf.M17_BAUDRATE, samplerate,
                               mf.M17_DEVIATION, rrc_tap_count=31,
                               rrc_beta=mf.M17_RRC_ALPHA,
                               omega_gain=1e-6, mu_gain=0.01,
                               omega_rel_limit=0.01, device=device)
        self._state = self.demod.init_state()
        self.demux = mf.FrameDemux()
        self.lich = mf.LICHAssembler()
        self.voice = M17VoiceDecoder()
        self.on_lsf = on_lsf
        self.last_symbols = np.zeros(0, np.float32)  # constellation tap

    @property
    def receiving(self) -> bool:
        return self.voice.receiving

    def process(self, iq):
        x = torch.as_tensor(iq).to(self.device, torch.complex64)
        self._state, (symbols, valid) = self.demod(self._state, x)
        symbols = symbols[valid].cpu().numpy()
        self.last_symbols = symbols
        events: list[M17LSF] = []
        audio = []
        for ftype, fields in self.demux.process(mf.slice_4fsk(symbols)):
            if ftype == mf.FRAME_LSF:
                lsf = mf.decode_lsf_frame(fields["lsf"], device=self.device)
                if lsf.valid:
                    events.append(lsf)
            elif ftype == mf.FRAME_STREAM:
                lsf = self.lich.process(fields["lich"])
                if lsf is not None:
                    events.append(lsf)
                payload = mf.decode_stream_payload(fields["payload"],
                                                   device=self.device)
                audio.append(self.voice.process(payload))
            # FRAME_PACKET: discarded like the reference (null sink, :668)
        if self.on_lsf:
            for e in events:
                self.on_lsf(e)
        out = (np.concatenate(audio, axis=0) if audio
               else np.empty((0, 2), np.float32))
        return out, events
