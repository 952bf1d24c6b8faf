"""FIR tap designers (window-method sinc, RRC, RC, band/high-pass).

A NumPy-only copy of ``sdrpp_tpu.ops.taps`` (that package's ``ops``
imports jax), held bit-exact to it by tests/test_torch_taps.py.

Host-side design code reproducing the reference formulas exactly for output
parity (reference: core/src/dsp/taps/*.h). All math in float64, cast to
float32/complex64 at the end (the reference computes in double and stores
float taps).

Sign/orientation convention: the reference FIR applies taps by *correlation*
against a sliding window (y[i] = sum_j taps[j] * x[i + j - (M-1)], see
core/src/dsp/filter/fir.h:67-76 — the dot product runs forward over both the
buffer and the taps). The complex band-pass designer bakes a negative phasor
offset in so correlation yields the intended asymmetric passband
(core/src/dsp/taps/band_pass.h:10-25 "The offset is negative to flip the
taps"). Our FFT-convolution kernels therefore convolve with reversed taps;
see ops/fir.py.
"""

from __future__ import annotations

import numpy as np

from .windows import nuttall

__all__ = [
    "estimate_tap_count",
    "windowed_sinc",
    "low_pass",
    "high_pass",
    "band_pass",
    "root_raised_cosine",
    "raised_cosine",
]


def _sinc(x):
    """sin(x)/x with sinc(0)=1 (reference: core/src/dsp/math/sinc.h)."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(x == 0.0, 1.0, np.sin(np.where(x == 0.0, 1.0, x)) / np.where(x == 0.0, 1.0, x))


def hz_to_rads(freq: float, samplerate: float) -> float:
    """2*pi*f/fs (reference: core/src/dsp/math/hz_to_rads.h)."""
    return 2.0 * np.pi * (freq / samplerate)


def estimate_tap_count(trans_width: float, samplerate: float) -> int:
    """count = 3.8*fs/transWidth (reference: core/src/dsp/taps/estimate_tap_count.h:4-6).

    Note the reference truncates (implicit double->int conversion)."""
    return int(3.8 * samplerate / trans_width)


def windowed_sinc(count: int, omega: float, window=nuttall, norm: float = 1.0,
                  complex_taps: bool = False) -> np.ndarray:
    """Window-method FIR design (reference: core/src/dsp/taps/windowed_sinc.h:8-34).

    taps[i] = sinc(t*omega) * window(t - half, count) * (norm*omega/pi),
    t = i - count/2 + 0.5.
    """
    half = count / 2.0
    corr = norm * omega / np.pi
    i = np.arange(count, dtype=np.float64)
    t = i - half + 0.5
    core = _sinc(t * omega) * window(t - half, float(count)) * corr
    if complex_taps:
        return core.astype(np.complex64)
    return core.astype(np.float32)


def low_pass(cutoff: float, trans_width: float, samplerate: float,
             odd_tap_count: bool = False) -> np.ndarray:
    """Nuttall-windowed sinc low-pass (reference: core/src/dsp/taps/low_pass.h:7-11)."""
    count = estimate_tap_count(trans_width, samplerate)
    if odd_tap_count and count % 2 == 0:
        count += 1
    return windowed_sinc(count, hz_to_rads(cutoff, samplerate))


def budget_low_pass(cutoff: float, trans_width: float, samplerate: float,
                    max_taps: int) -> np.ndarray:
    """low_pass with the transition floored so the design fits a static
    tap budget (RuntimeFIR carries [max_taps] taps in state): the cutoff
    stays exact, only the skirt widens at extreme-narrow settings.
    Shared by the runtime-bandwidth VFO channel filter and the demod
    audio filters so the floor formula lives in ONE place."""
    if estimate_tap_count(trans_width, samplerate) > max_taps:
        trans_width = 3.8 * samplerate / max_taps
    return low_pass(cutoff, trans_width, samplerate)


def high_pass(cutoff: float, trans_width: float, samplerate: float,
              odd_tap_count: bool = False) -> np.ndarray:
    """High-pass by spectral inversion of a low-pass at fs/2-cutoff
    (reference: core/src/dsp/taps/high_pass.h:5-13): windowed sinc whose
    window is multiplied by (-1)^round(n)."""
    count = estimate_tap_count(trans_width, samplerate)
    if odd_tap_count and count % 2 == 0:
        count += 1

    def win(n, N):
        # n = i - count + 0.5: C round() (half away from zero) on these
        # negative half-integers yields i - count, so the sign alternates
        # with the parity of (i - count).
        n = np.asarray(n, dtype=np.float64)
        rounded = np.where(n < 0, np.ceil(n - 0.5), np.floor(n + 0.5)).astype(np.int64)
        sign = np.where(rounded % 2 != 0, -1.0, 1.0)
        return nuttall(n, N) * sign

    return windowed_sinc(count, hz_to_rads((samplerate / 2.0) - cutoff, samplerate), window=win)


def band_pass(band_start: float, band_stop: float, trans_width: float,
              samplerate: float, complex_taps: bool = True,
              odd_tap_count: bool = False) -> np.ndarray:
    """Band-pass design (reference: core/src/dsp/taps/band_pass.h:10-25).

    Real taps: 2*cos(offsetOmega*n) modulated low-pass of width (stop-start)/2.
    Complex taps: phasor(-offsetOmega*n) modulation — the negative sign
    accounts for the reference FIR's correlation orientation (asymmetric
    single-sideband passband).
    """
    assert band_stop > band_start
    offset_omega = np.float32(hz_to_rads((band_start + band_stop) / 2.0, samplerate))
    count = estimate_tap_count(trans_width, samplerate)
    if odd_tap_count and count % 2 == 0:
        count += 1
    omega = hz_to_rads((band_stop - band_start) / 2.0, samplerate)

    half = count / 2.0
    corr = omega / np.pi
    i = np.arange(count, dtype=np.float64)
    t = i - half + 0.5
    n = t - half  # window argument (== i - count + 0.5)
    if complex_taps:
        mod = np.exp(-1j * offset_omega.astype(np.float64) * n)
        taps = _sinc(t * omega) * mod * nuttall(n, float(count)) * corr
        return taps.astype(np.complex64)
    taps = _sinc(t * omega) * 2.0 * np.cos(offset_omega.astype(np.float64) * n) \
        * nuttall(n, float(count)) * corr
    return taps.astype(np.float32)


def root_raised_cosine(count: int, beta: float, Ts: float) -> np.ndarray:
    """RRC taps with singularity handling
    (reference: core/src/dsp/taps/root_raised_cosine.h:7-34)."""
    half = count / 2.0
    limit = Ts / (4.0 * beta)
    i = np.arange(count, dtype=np.float64)
    t = i - half + 0.5
    pi = np.pi
    with np.errstate(divide="ignore", invalid="ignore"):
        general = ((np.sin((1.0 - beta) * pi * t / Ts)
                    + np.cos((1.0 + beta) * pi * t / Ts) * 4.0 * beta * t / Ts)
                   / ((1.0 - (4.0 * beta * t / Ts) ** 2) * pi * t / Ts)) / Ts
    at_zero = (1.0 + beta * (4.0 / pi - 1.0)) / Ts
    at_limit = ((1.0 + 2.0 / pi) * np.sin(pi / (4.0 * beta))
                + (1.0 - 2.0 / pi) * np.cos(pi / (4.0 * beta))) * beta / (Ts * np.sqrt(2.0))
    taps = np.where(t == 0.0, at_zero, np.where(np.abs(t) == limit, at_limit, general))
    return taps.astype(np.float32)


def root_raised_cosine_rate(count: int, beta: float, symbolrate: float,
                            samplerate: float) -> np.ndarray:
    return root_raised_cosine(count, beta, samplerate / symbolrate)


def raised_cosine(count: int, beta: float, Ts: float) -> np.ndarray:
    """Raised-cosine taps (reference: core/src/dsp/taps/raised_cosine.h:7-29)."""
    half = count / 2.0
    limit = Ts / (2.0 * beta)
    i = np.arange(count, dtype=np.float64)
    t = i - half + 0.5
    pi = np.pi
    # NOTE: the reference passes t/Ts to its unscaled sinc (sin(x)/x), not
    # the normalized sinc(pi x) — replicate exactly.
    general = _sinc(t / Ts) * pi / (4.0 * Ts)
    at_limit = _sinc(1.0 / (2.0 * beta)) * pi / (4.0 * Ts)
    taps = np.where(np.abs(t) == limit, at_limit, general)
    return taps.astype(np.float32)
