"""Shared-FFT channelizer bank: N DDCs from ONE wideband FFT.

The counterpart of ``sdrpp_tpu.ops.channelizer`` (a drop-in alternative to
the time-domain mix -> FIR cascade of ``parallel.vfo_bank.VFOBank``):

- one forward FFT of the wideband block over an overlap-save buffer (the
  last m-1 samples are the shared tail);
- per channel, the NCO mix by its offset factors into an integer-bin
  shift b_c (a gather of the spectrum) plus a sub-bin residual baked into
  that channel's taps on the host, so the decomposition is exact;
- filtering is a multiply by the tap spectrum; decimation by R folds the
  product down to M = F/R bins before one small inverse FFT, with the
  m-1 output alignment folded into the tap spectrum as a phase ramp;
- the per-block NCO phase is a carried [C] phase.

Pruned (the default) each channel touches only the 2M bins around its
offset; full, all F bins. The JAX package cuts the pruned windows with
one static slice per channel (a TPU workaround for its gather); the port
gathers all channels at once through a precomputed [C, 2M] index tensor,
the same bins. The FFTs are ``torch.fft`` (cuFFT on the card), as the JAX
package leaves them to XLA. Inside ``parallel.spmd.channel_shard`` (the
sharded bank's step, ``ScannerBank.sharded_step``) a carried phase of
fewer rows than the bank's channels is this rank's channel shard: the
plan's per-channel rows (``step``, ``corr``, ``idx``, ``H``) for it are
taken from the full plan on the device, as the JAX package's
``shard_map`` branches take them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.spmd import current_channel_axis, local_rows
from ..utils.blocks import Block
from . import taps as taps_mod
from .fir import FIR
from .mix import TWO_PI, _TWO_PI32, hz_to_rads

__all__ = ["FFTChannelizerBank"]


class FFTChannelizerBank(Block):
    """Bank of DDCs sharing one wideband FFT; VFOBank-compatible interface.

    offsets_hz: per-channel offsets (mix by -offset like RxVFO,
    rx_vfo.h:30). out = in_samplerate / R with integer R. ``taps``
    defaults to a Nuttall lowPass at 0.45*out_rate with 0.1*out_rate
    transition (taps.low_pass — the reference design formula).
    ``bandwidth`` below the output rate adds a channel low-pass at the
    output rate (VFOBank's filter).
    """

    def __init__(self, offsets_hz, in_samplerate: float, out_samplerate: float,
                 bandwidth: float | None = None, taps: np.ndarray | None = None,
                 prune: bool = True, *, device):
        offsets_hz = np.asarray(offsets_hz, np.float64)
        self.channels = len(offsets_hz)
        self.fs_in = float(in_samplerate)
        self.fs_out = float(out_samplerate)
        self.device = torch.device(device)
        ratio = in_samplerate / out_samplerate
        self.R = int(round(ratio))
        if abs(ratio - self.R) > 1e-9 or self.R < 1:
            raise ValueError(
                f"FFTChannelizerBank needs an integer decimation ratio, got "
                f"{in_samplerate}/{out_samplerate} = {ratio}")
        # applied rotation per sample: mix by -offset (rx_vfo.h:30)
        self.alphas = np.array([hz_to_rads(-o, in_samplerate)
                                for o in offsets_hz], np.float64)
        if taps is None:
            taps = taps_mod.low_pass(0.45 * out_samplerate,
                                     0.1 * out_samplerate, in_samplerate)
        self.taps = np.asarray(taps, np.float64)
        self.m = len(self.taps)
        self.prune = bool(prune)
        self.block_multiple = self.R
        self.filter = None
        if bandwidth is not None and bandwidth != out_samplerate:
            fw = bandwidth / 2.0
            self.filter = FIR(taps_mod.low_pass(fw, fw * 0.1, out_samplerate),
                              dtype=torch.complex64,
                              lead_shape=(self.channels,), device=device)
        self._plans: dict[int, dict] = {}

    def out_count(self, n: int) -> int:
        return n // self.R

    def init_state(self):
        # shared overlap-save tail + per-channel carried NCO phase
        # phi_c(B) = alpha_c * (B n - (m-1)); start at -alpha (m-1)
        phase0 = np.mod(-self.alphas * (self.m - 1), TWO_PI).astype(np.float32)
        state = {"tail": torch.zeros(self.m - 1, dtype=torch.complex64,
                                     device=self.device),
                 "phase": torch.from_numpy(phase0).to(self.device)}
        if self.filter is not None:
            state["filter"] = self.filter.init_state()
        return state

    def _plan(self, n: int) -> dict:
        """Per-block-length constants, built on the host (float64) and
        kept on the device."""
        if n in self._plans:
            return self._plans[n]
        if n % self.R:
            raise ValueError(f"block length {n} must be a multiple of the "
                             f"decimation ratio {self.R}")
        R, m = self.R, self.m
        T = n + m - 1
        M = 1
        while M * R < T:
            M *= 2
        F = M * R
        b = np.round(self.alphas * F / TWO_PI).astype(np.int64)
        delta = self.alphas - TWO_PI * b / F
        kk = np.arange(m, dtype=np.float64)
        # residual baked into the taps (exact: e^{j d t} pulled out of the
        # conv leaves h~[k] = h[k] e^{-j d k}); the (m-1) alignment is a
        # time-shift ramp on the tap spectrum
        h_tilde = self.taps[None, :] * np.exp(-1j * delta[:, None] * kk)
        kb = np.arange(F, dtype=np.float64)
        shift = np.exp(2j * np.pi * kb * (m - 1) / F)
        H = np.fft.fft(h_tilde, F, axis=-1) * shift  # [C, F]
        j = np.arange(n // R, dtype=np.float64)
        # corr[c, j] = e^{j d_c ((m-1) + R j)} (the block-B part is the
        # carried phase)
        corr = np.exp(1j * delta[:, None] * ((m - 1) + R * j[None, :]))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        plan = {"F": F, "M": M,
                "step": dev(np.mod(self.alphas * n, TWO_PI).astype(np.float32)),
                "corr": dev(corr.astype(np.complex64))}
        if self.prune:
            # channel c's window is bins (w - b_c) mod F, w in [-M, M): the
            # circular slice of 2M bins from (-M - b_c) mod F
            w = np.arange(-M, M)
            starts = (-M - b) % F
            plan["idx"] = dev((starts[:, None] + np.arange(2 * M)[None, :]) % F)
            plan["H"] = dev(H[np.arange(self.channels)[:, None],
                              w[None, :] % F].astype(np.complex64))
        else:
            # roll(X, b_c) per channel == gather at (k - b) mod F
            plan["idx"] = dev((np.arange(F)[None, :] - b[:, None]) % F)
            plan["H"] = dev(H.astype(np.complex64))
        self._plans[n] = plan
        return plan

    def __call__(self, state, x):
        n = x.shape[-1]
        p = self._plan(n)
        R, F, M = self.R, p["F"], p["M"]
        buf = torch.cat([state["tail"], x])
        X = torch.fft.fft(buf, F)
        ph = state["phase"]
        c = ph.shape[0]
        idx, H, corr, step = p["idx"], p["H"], p["corr"], p["step"]
        if c != self.channels and current_channel_axis() is not None:
            # a rank's channel shard (parallel/spmd.py): its rows of the plan
            idx, H, corr, step = (local_rows(t, c)
                                  for t in (idx, H, corr, step))
        S = X[idx] * H
        if self.prune:
            fold = S[:, M:] + S[:, :M]
        else:
            fold = torch.sum(S.reshape(c, R, M), dim=1)
        z = torch.fft.ifft(fold, dim=-1)[:, : n // R] * float(np.float32(M / F))
        carry = torch.complex(torch.cos(ph), torch.sin(ph))
        y = z * carry[:, None] * corr
        new_state = {
            "tail": buf[n:].clone(),
            "phase": torch.remainder(ph + step, _TWO_PI32),
        }
        if self.filter is not None:
            fs, y = self.filter(state["filter"], y)
            new_state["filter"] = fs
        return new_state, y
