"""Scanner: sweep a frequency range, stop on active signals.

A numpy-only copy of ``sdrpp_tpu.misc.scanner``.

Reference: misc_modules/scanner/src/main.cpp:15-305 — a 10 Hz loop that
tunes the selected VFO start->stop by ``interval``, checks the latest FFT
line for energy above ``level`` inside the would-be passband, lingers on
receive until the signal drops for ``linger_time``, and waits
``tuning_time`` after each retune. Here the loop is driven explicitly
(``step(fft_line, now)``) so it composes with the block-based receiver
instead of owning a thread; states: scanning / tuning / receiving.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Scanner"]


class Scanner:
    def __init__(self, start_freq: float, stop_freq: float, interval: float,
                 level_db: float = -50.0, passband_ratio: float = 10.0,
                 tuning_time: float = 0.25, linger_time: float = 1.5):
        assert stop_freq > start_freq
        self.start_freq = float(start_freq)
        self.stop_freq = float(stop_freq)
        self.interval = float(interval)
        self.level = float(level_db)
        self.passband_ratio = float(passband_ratio)
        self.tuning_time = float(tuning_time)
        self.linger_time = float(linger_time)

        self.current = self.start_freq
        self.scan_up = True
        self.reverse_lock = False
        self.receiving = False
        self.tuning = False
        self._last_signal_time = -1e18
        self._last_tune_time = -1e18

    # ---- controls (the <</>> buttons) ----

    def scan_forward(self):
        self.reverse_lock = True
        self.receiving = False
        self.scan_up = True

    def scan_backward(self):
        self.reverse_lock = True
        self.receiving = False
        self.scan_up = False

    # ---- helpers over the centered FFT line ----

    def _max_level(self, line, freq, width, wf_start, wf_width):
        size = line.shape[-1]
        low = int(np.clip((freq - width / 2 - wf_start) / wf_width * size, 0, size))
        high = int(np.clip((freq + width / 2 - wf_start) / wf_width * size, 0, size))
        if high <= low:
            return float("-inf")
        return float(np.max(line[low:high]))

    def _find_signal(self, up, line, vfo_width, wf_start, wf_end, wf_width):
        """Scan candidate frequencies in direction ``up`` for energy >= level
        (main.cpp findSignal equivalent). Returns found frequency or None,
        plus the last frequency probed inside the visible span."""
        freq = self.current
        limit = freq
        step = self.interval if up else -self.interval
        while True:
            freq += step
            if up and (freq > self.stop_freq or freq + vfo_width / 2 > wf_end):
                break
            if not up and (freq < self.start_freq or freq - vfo_width / 2 < wf_start):
                break
            limit = freq
            lvl = self._max_level(line, freq, vfo_width * self.passband_ratio / 100.0
                                  + vfo_width, wf_start, wf_width)
            if lvl >= self.level:
                return freq, limit
        return None, limit

    # ---- the 10 Hz tick ----

    def step(self, fft_line: np.ndarray, vfo_width: float, wf_center: float,
             wf_width: float, now: float) -> float:
        """Advance the scan state machine; returns the frequency to tune."""
        wf_start = wf_center - wf_width / 2.0
        wf_end = wf_center + wf_width / 2.0

        if self.tuning:
            if now - self._last_tune_time > self.tuning_time:
                self.tuning = False
            return self.current

        if self.receiving:
            lvl = self._max_level(fft_line, self.current, vfo_width,
                                  wf_start, wf_width)
            if lvl >= self.level:
                self._last_signal_time = now
            elif now - self._last_signal_time > self.linger_time:
                self.receiving = False
            return self.current

        # Seeking: first in scan direction, then reverse unless locked.
        found, top = self._find_signal(self.scan_up, fft_line, vfo_width,
                                       wf_start, wf_end, wf_width)
        if found is None and not self.reverse_lock:
            found, bottom = self._find_signal(not self.scan_up, fft_line,
                                              vfo_width, wf_start, wf_end,
                                              wf_width)
        else:
            bottom = top
        self.reverse_lock = False

        if found is not None:
            self.current = found
            self.receiving = True
            self._last_signal_time = now
            return self.current

        # Nothing visible: jump past the scanned span and wait for retune.
        if self.scan_up:
            self.current = top + self.interval
            if self.current > self.stop_freq:
                self.current = self.start_freq
        else:
            self.current = bottom - self.interval
            if self.current < self.start_freq:
                self.current = self.stop_freq
        if (self.current - vfo_width / 2 < wf_start
                or self.current + vfo_width / 2 > wf_end):
            self._last_tune_time = now
            self.tuning = True
        return self.current
