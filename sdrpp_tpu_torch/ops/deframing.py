"""Sync-word deframing: carve fixed-length frames out of a bit stream.

The counterpart of ``sdrpp_tpu.ops.deframing``, host numpy as there: the
generic deframer behind the HRPT and Falcon 9 decoders (the reference's
legacy dsp::Deframer, decoder_modules/weather_sat_decoder/src/
noaa_hrpt_decoder.h:31). The sync search correlates the +-1 bit stream
against the +-1 sync pattern (``np.correlate``); a position whose
correlation reaches sync_len - 2 * max_errors starts a frame. Frames may
span blocks: a carried bit buffer holds the unfinished tail.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Deframer"]


class Deframer:
    def __init__(self, frame_len_bits: int, sync_bits,
                 max_sync_errors: int = 0):
        self.frame_len = int(frame_len_bits)
        self.sync = np.asarray(sync_bits, np.int8)
        if not set(np.unique(self.sync)) <= {0, 1}:
            raise ValueError("sync bits must be 0 or 1")
        self.max_errors = int(max_sync_errors)
        self._buf = np.zeros(0, np.uint8)

    def process(self, bits: np.ndarray) -> list[np.ndarray]:
        """Feed bits (uint8 0/1); returns the complete frames (each
        frame_len bits, starting with the sync word). The sync positions
        of the whole buffer come from one correlation; after a frame the
        search goes on from its end, among the same positions (the JAX
        package correlates the rest of the buffer again after each frame,
        with the same positions as the result)."""
        buf = np.concatenate([self._buf, np.asarray(bits, np.uint8)])
        hits = self._sync_hits(buf)
        frames, pos = [], 0
        while True:
            j = np.searchsorted(hits, pos)
            start = int(hits[j]) if j < len(hits) else None
            if start is None or len(buf) - start < self.frame_len:
                # keep at most frame_len + sync trailing bits for reuse
                keep = self.frame_len + len(self.sync)
                if start is not None:
                    self._buf = buf[start:]
                elif len(buf) - pos > keep:
                    self._buf = buf[-keep:]
                else:
                    self._buf = buf[pos:]
                return frames
            frames.append(buf[start:start + self.frame_len].copy())
            pos = start + self.frame_len

    def _sync_hits(self, bits: np.ndarray) -> np.ndarray:
        """Ascending positions where the sync word matches with at most
        max_sync_errors bit errors."""
        m = len(self.sync)
        if len(bits) < m:
            return np.zeros(0, np.int64)
        b = bits.astype(np.int8) * 2 - 1
        s = self.sync * 2 - 1
        corr = np.correlate(b, s, mode="valid")
        return np.nonzero(corr >= m - 2 * self.max_errors)[0]
