"""Signal metering from FFT lines: per-VFO strength + SNR, peak level.

A numpy-only copy of ``sdrpp_tpu.misc.meters``.

Reference: core/src/gui/widgets/waterfall.cpp:563-607
(WaterFall::calculateVFOSignalInfo, called per pushFFT) — strength = max dB
inside the VFO passband, noise = average dB of the side bands (one
bandwidth on each side), SNR = strength - noise. Plus the
bench::PeakLevelMeter equivalent (core/src/dsp/bench/peak_level_meter.h).
"""

from __future__ import annotations

import numpy as np

__all__ = ["vfo_signal_info", "peak_level"]


def vfo_signal_info(fft_line: np.ndarray, center_offset: float, bandwidth: float,
                    whole_bandwidth: float) -> tuple[float, float]:
    """(strength_dB, snr_dB) of a VFO from one centered FFT line.

    Index math mirrors waterfall.cpp:566-575: the line spans
    [-whole_bw/2, +whole_bw/2] over rawFFTSize bins, DC centered.
    """
    line = np.asarray(fft_line)
    size = line.shape[-1]

    def to_bin(freq):
        return int(np.clip((freq / (whole_bandwidth / 2.0)) * (size / 2)
                           + size / 2, 0, size))

    lo_side = to_bin(center_offset - bandwidth)
    lo = to_bin(center_offset - bandwidth / 2.0)
    hi = to_bin(center_offset + bandwidth / 2.0)
    hi_side = to_bin(center_offset + bandwidth)

    noise_bins = np.concatenate([line[lo_side:lo], line[hi + 1: hi_side]])
    noise = float(noise_bins.mean()) if noise_bins.size else float("-inf")
    strength = float(line[lo: hi + 1].max()) if hi >= lo else float("-inf")
    return strength, strength - noise


def peak_level(samples: np.ndarray) -> float:
    """Peak |sample| in dBFS (bench/peak_level_meter.h equivalent)."""
    peak = float(np.max(np.abs(samples))) if len(samples) else 0.0
    return 20.0 * np.log10(max(peak, 1e-20))
