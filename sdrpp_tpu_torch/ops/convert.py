"""Type/layout converters (reference: core/src/dsp/convert/*.h).

Stereo audio is [..., n, 2] float32 (reference stereo_t is an interleaved
{l, r} pair).
"""

from __future__ import annotations

import torch

__all__ = [
    "complex_to_real",
    "complex_to_imag",
    "real_to_complex",
    "mono_to_stereo",
    "stereo_to_mono",
    "l_r_to_stereo",
    "complex_to_stereo",
]


def complex_to_real(x):
    """Take re (reference: convert/complex_to_real.h)."""
    return x.real


def complex_to_imag(x):
    return x.imag


def real_to_complex(x):
    """im := 0 (reference: convert/real_to_complex.h)."""
    return torch.complex(x, torch.zeros_like(x))


def mono_to_stereo(x):
    """Duplicate into L/R (reference: convert/mono_to_stereo.h)."""
    return torch.stack([x, x], dim=-1)


def stereo_to_mono(x):
    """(l+r)/2 (reference: convert/stereo_to_mono.h)."""
    return (x[..., 0] + x[..., 1]) * 0.5


def l_r_to_stereo(l, r):
    """Interleave L/R (reference: convert/l_r_to_stereo.h)."""
    return torch.stack([l, r], dim=-1)


def complex_to_stereo(x):
    """re->l, im->r (reference: convert/complex_to_stereo.h)."""
    return torch.stack([x.real, x.imag], dim=-1)
