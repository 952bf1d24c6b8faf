"""Mueller-Mueller clock recovery as a symbol-rate loop.

The counterpart of ``sdrpp_tpu.ops.clock_recovery`` (reference:
core/src/dsp/clock_recovery/mm.h:100-156): sequential with a
data-dependent input stride. Per symbol: an ``interp_tap_count``-sample
window at the current integer offset, the polyphase-interpolation dot
product at the fractional phase, the M&M timing error, the phase-control
loop advance. The loop runs in the kernel wrapper
``clock_recovery_kernels.mm_symbols`` (CUDA kernel on CUDA tensors, plain
loop on CPU tensors). ``FDClockRecovery`` is the float early-late
synchronizer (reference fd.h), its loop in
``clock_recovery_kernels.fd_symbols``.

Output: (symbols[max_syms], valid[max_syms]) with the valid symbols a
prefix; max_syms = ceil(n / min_freq) + 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.blocks import Block
from .resample import build_polyphase_bank
from .taps import windowed_sinc

__all__ = ["MMClockRecovery", "FDClockRecovery"]


def _interp_bank(phase_count: int, tap_count: int) -> np.ndarray:
    """128-phase x 8-tap windowed-sinc interpolation bank
    (reference mm.h:173-178): lowPass at bw=0.5/phases, gain = phases."""
    bw = 0.5 / phase_count
    lp = windowed_sinc(phase_count * tap_count, 2.0 * np.pi * bw,
                       norm=phase_count)
    return build_polyphase_bank(lp, phase_count)  # [phases, tap_count]


class MMClockRecovery(Block):
    """M&M symbol synchronizer (float or complex), one [n] stream.

    ``omega`` = samples per symbol; gains and limits as the reference
    (phase_control_loop.h CLAMP=false + mm.h advance: offset +=
    floor(phase), phase -= floor(phase)). State: ``tail`` (the last
    tap_count-1 inputs), int32 ``offset`` (into the next block),
    ``phase``, ``freq`` and the error history (complex ``p1 p2 c1 c2``, or
    float ``last``), as the JAX block's.
    """

    def __init__(self, omega: float, omega_gain: float, mu_gain: float,
                 omega_rel_limit: float = 0.01, interp_phase_count: int = 128,
                 interp_tap_count: int = 8, complex_input: bool = True, *,
                 device):
        self.omega = float(omega)
        self.mu_gain = np.float32(mu_gain)        # pcl alpha (phase gain)
        self.omega_gain = np.float32(omega_gain)  # pcl beta (freq gain)
        self.min_freq = np.float32(omega * (1.0 - omega_rel_limit))
        self.max_freq = np.float32(omega * (1.0 + omega_rel_limit))
        self.phase_count = int(interp_phase_count)
        self.tap_count = int(interp_tap_count)
        self.bank = _interp_bank(self.phase_count, self.tap_count)
        self.complex_input = complex_input
        self.dtype = torch.complex64 if complex_input else torch.float32
        self.device = torch.device(device)
        self._bank = torch.from_numpy(
            self.bank.astype(np.float32)).to(self.device)

    def max_symbols(self, n: int) -> int:
        return int(np.ceil(n / float(self.min_freq))) + 1

    def init_state(self):
        dev = self.device

        def zero(dtype):
            return torch.zeros((), dtype=dtype, device=dev)

        st = {
            "tail": torch.zeros(self.tap_count - 1, dtype=self.dtype,
                                device=dev),
            "offset": zero(torch.int32),
            "phase": zero(torch.float32),
            "freq": torch.full((), float(np.float32(self.omega)),
                               dtype=torch.float32, device=dev),
        }
        if self.complex_input:
            st.update({k: zero(torch.complex64)
                       for k in ("p1", "p2", "c1", "c2")})
        else:
            st["last"] = zero(torch.float32)
        return st

    def __call__(self, state, x):
        from .clock_recovery_kernels import mm_symbols

        if x.ndim != 1:
            raise ValueError("MM runs on one [n] stream")
        n = x.shape[-1]
        buf = torch.cat([state["tail"], x.to(self.dtype)])
        if self.complex_input:
            err = [v for k in ("p1", "p2", "c1", "c2")
                   for v in (state[k].real, state[k].imag)]
        else:
            err = [state["last"]]
        fstate = torch.stack([state["phase"], state["freq"], *err]).float()
        syms, valid, off, fst = mm_symbols(
            buf[None], state["offset"].reshape(1), fstate[None], self._bank,
            self.max_symbols(n), self.mu_gain, self.omega_gain,
            self.min_freq, self.max_freq)
        fst = fst[0]
        new_state = {"tail": buf[n:].clone(), "offset": off[0],
                     "phase": fst[0], "freq": fst[1]}
        if self.complex_input:
            for j, k in enumerate(("p1", "p2", "c1", "c2")):
                new_state[k] = torch.complex(fst[2 + 2 * j], fst[3 + 2 * j])
        else:
            new_state["last"] = fst[2]
        return new_state, (syms[0], valid[0])


class FDClockRecovery(Block):
    """Frequency-discriminator (early-late derivative) symbol synchronizer,
    one float [n] stream (the JAX block of the same name,
    clock_recovery.py:162; reference core/src/dsp/clock_recovery/fd.h:
    95-150): the timing error is dfdt * sign(out), dfdt the central
    difference of the neighbouring interpolation phases (one-sided at the
    bank's edges); the loop advance as the M&M's. State: ``tail``, int32
    ``offset``, ``phase``, ``freq``."""

    def __init__(self, omega: float, omega_gain: float, mu_gain: float,
                 omega_rel_limit: float = 0.01, interp_phase_count: int = 128,
                 interp_tap_count: int = 8, *, device):
        self.omega = float(omega)
        self.mu_gain = np.float32(mu_gain)
        self.omega_gain = np.float32(omega_gain)
        self.min_freq = np.float32(omega * (1.0 - omega_rel_limit))
        self.max_freq = np.float32(omega * (1.0 + omega_rel_limit))
        self.phase_count = int(interp_phase_count)
        self.tap_count = int(interp_tap_count)
        self.bank = _interp_bank(self.phase_count, self.tap_count)
        self.device = torch.device(device)
        self._bank = torch.from_numpy(
            self.bank.astype(np.float32)).to(self.device)

    def max_symbols(self, n: int) -> int:
        return int(np.ceil(n / float(self.min_freq))) + 1

    def init_state(self):
        dev = self.device
        return {
            "tail": torch.zeros(self.tap_count - 1, dtype=torch.float32,
                                device=dev),
            "offset": torch.zeros((), dtype=torch.int32, device=dev),
            "phase": torch.zeros((), dtype=torch.float32, device=dev),
            "freq": torch.full((), float(np.float32(self.omega)),
                               dtype=torch.float32, device=dev),
        }

    def __call__(self, state, x):
        from .clock_recovery_kernels import fd_symbols

        if x.ndim != 1:
            raise ValueError("FD runs on one [n] stream")
        n = x.shape[-1]
        buf = torch.cat([state["tail"], x.to(torch.float32)])
        fstate = torch.stack([state["phase"], state["freq"]])
        syms, valid, off, fst = fd_symbols(
            buf[None], state["offset"].reshape(1), fstate[None], self._bank,
            self.max_symbols(n), self.omega_gain, self.mu_gain,
            self.min_freq, self.max_freq)
        return ({"tail": buf[n:].clone(), "offset": off[0],
                 "phase": fst[0, 0], "freq": fst[0, 1]},
                (syms[0], valid[0]))
