"""Window functions (generalized cosine-sum family).

A NumPy-only copy of ``sdrpp_tpu.ops.windows``, held bit-exact to it by
tests/test_torch_taps.py.

Host-side filter/window design in float64 NumPy; matches the reference's
coefficient tables and normalization exactly so FFT magnitudes agree
(reference: core/src/dsp/window/*.h, window.h:38-64).

All windows use the alternating-sign cosine sum
    w(n) = sum_i (-1)^i c_i cos(2*pi*i*n / N)
evaluated at n = 0..N-1 (reference: core/src/dsp/window/cosine.h:7-16).

``create_window`` applies the reference's unity-gain normalization
(w *= 1/sum(w)) and, when ``centered``, the alternating sign flip that
shifts the FFT output by fs/2 so DC lands in the middle of the spectrum
without an explicit fftshift (reference: core/src/dsp/window/window.h:38-64;
note the centered branch negates even-indexed samples).
"""

from __future__ import annotations

import enum

import numpy as np

__all__ = [
    "Window",
    "COEFS",
    "cosine_window",
    "rectangular",
    "hann",
    "hamming",
    "blackman",
    "nuttall",
    "blackman_harris4",
    "blackman_harris7",
    "create_window",
]


class Window(enum.Enum):
    """Window types (reference: core/src/dsp/window/window.h:29-37)."""

    RECTANGULAR = "rectangular"
    HAMMING = "hamming"
    HANN = "hann"
    BLACKMAN = "blackman"
    NUTTALL = "nuttall"
    BLACKMAN_HARRIS4 = "blackman_harris4"
    BLACKMAN_HARRIS7 = "blackman_harris7"


# Cosine-sum coefficients per window (reference: core/src/dsp/window/{hann,
# hamming,blackman,nuttall,blackman_harris4,blackman_harris7}.h).
COEFS: dict[Window, tuple[float, ...]] = {
    Window.RECTANGULAR: (1.0,),
    Window.HANN: (0.5, 0.5),
    Window.HAMMING: (0.53836, 0.46164),
    Window.BLACKMAN: (0.42, 0.5, 0.08),
    Window.NUTTALL: (0.355768, 0.487396, 0.144232, 0.012604),
    Window.BLACKMAN_HARRIS4: (0.35875, 0.48829, 0.14128, 0.01168),
    Window.BLACKMAN_HARRIS7: (
        0.27105140069342,
        0.43329793923448,
        0.21812299954311,
        0.06592544638803,
        0.01081174209837,
        0.00077658482522,
        0.00001388721735,
    ),
}


def cosine_window(n, N: float, coefs) -> np.ndarray:
    """Alternating-sign cosine sum window sample(s) at position(s) ``n``."""
    n = np.asarray(n, dtype=np.float64)
    win = np.zeros_like(n)
    sign = 1.0
    for i, c in enumerate(coefs):
        win += sign * c * np.cos(i * 2.0 * np.pi * n / N)
        sign = -sign
    return win


def rectangular(n, N):
    return np.ones_like(np.asarray(n, dtype=np.float64))


def hann(n, N):
    return cosine_window(n, N, COEFS[Window.HANN])


def hamming(n, N):
    return cosine_window(n, N, COEFS[Window.HAMMING])


def blackman(n, N):
    return cosine_window(n, N, COEFS[Window.BLACKMAN])


def nuttall(n, N):
    return cosine_window(n, N, COEFS[Window.NUTTALL])


def blackman_harris4(n, N):
    return cosine_window(n, N, COEFS[Window.BLACKMAN_HARRIS4])


def blackman_harris7(n, N):
    return cosine_window(n, N, COEFS[Window.BLACKMAN_HARRIS7])


def create_window(kind: Window, size: int, centered: bool = False) -> np.ndarray:
    """Build a window buffer with unity-gain normalization.

    Matches reference core/src/dsp/window/window.h:38-64: the window is
    normalized by 1/sum(w) (computed on the float32-rounded samples, as the
    reference accumulates the float buffer), and when ``centered`` the sign of
    every even-indexed sample is flipped (modulation by e^{j*pi*n}: shifts the
    spectrum by fs/2 so the FFT output is naturally centered).
    """
    n = np.arange(size, dtype=np.float64)
    buf = cosine_window(n, float(size), COEFS[kind]).astype(np.float32)
    wscale = 1.0 / np.sum(buf.astype(np.float64))
    if not centered:
        out = buf * np.float32(wscale)
    else:
        sign = np.where(np.arange(size) % 2 == 0, -1.0, 1.0)
        out = buf * (sign * wscale).astype(np.float64)
    return out.astype(np.float32)
