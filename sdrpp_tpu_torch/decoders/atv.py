"""Analog TV (ATV) decoding blocks: line sync + chroma PLL.

The counterpart of ``sdrpp_tpu.decoders.atv`` (reference:
decoder_modules/atv_decoder/src/{linesync.h, chroma_pll.h}).

LineSync locks a phase-control loop to the horizontal sync tips: 720
samples per line are emitted through the fractional polyphase interpolator;
at each line boundary the timing error is the difference between the
average levels of the two halves of the sync region (linesync.h:109-135 —
left = samples [703..719]+[0..26], right = [27..70], only when both sit
below the sync level). Within a line the loop error is zero, so a line is
one 720-point interpolation at a uniform step; only the per-line update is
sequential. The JAX package runs that as a ``lax.scan`` over lines; here
it is one kernel launch a block (``ops.sync_walks.line_sync_walk``).

ChromaPLL (chroma_pll.h:22-52) locks to the colour burst window of each
line and free-runs outside it: the burst's phase / frequency carry is one
kernel launch for all the lines (``ops.sync_walks.chroma_burst_walk``),
and the free-run segments are parallel mixes on the phases it records.

``FrameAssembler`` (vertical scan, vsync, rendering) is host code, copied.
``ATVDecoder`` chains the port's ``Quadrature``, ``LineSync``, the 231-tap
complex chroma band-pass (``ops.fir.fir_correlate`` on the reversed taps)
and ``ChromaPLL`` with the per-line PAL phases, on ``device`` (default
``cuda``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..ops.clock_recovery import _interp_bank
from ..ops.scans import FL_PI, _critically_damped
from ..ops.sync_walks import chroma_burst_walk, line_sync_walk
from ..utils.blocks import Block

__all__ = ["LineSync", "ChromaPLL", "FrameAssembler", "ATVDecoder",
           "chroma_taps", "chroma_filter_taps", "LINE_LEN", "FRAME_LINES",
           "SAMPLE_RATE", "CHROMA_SUBCARRIER", "A_PHASE", "B_PHASE", "CHROMA_BANDWIDTH",
           "CHROMA_PULL"]

LINE_LEN = 720
FRAME_LINES = 625                       # PAL (main.cpp:159-166)
SAMPLE_RATE = 625.0 * 720.0 * 25.0      # main.cpp:32 SAMPLE_RATE
CHROMA_SUBCARRIER = 4433618.75          # PAL chroma, main.cpp:48

# PAL colour-burst reference phases alternate per line (chroma_pll.h:9-10).
A_PHASE = (135.0 / 180.0) * float(FL_PI)
B_PHASE = (-135.0 / 180.0) * float(FL_PI)


def chroma_taps() -> np.ndarray:
    """231-tap complex chroma band-pass FIR (chrominance_filter.h; a copy
    of the JAX package's coefficient table), in the table's order."""
    return np.load(Path(__file__).parent / "atv_chroma_taps.npz")["taps"]


def chroma_filter_taps() -> np.ndarray:
    """The taps ATVDecoder gives ``fir_correlate``: the table reversed.
    ``fir_correlate`` is the reference's sliding correlation, y[i] = sum_j
    taps[j] x[i + j], whose gain at w is |sum_j taps[j] exp(i w j)|: on the
    table's order 6.6e-6 at the subcarrier +w0 and 0.9946 at -w0, so the
    burst would reach ChromaPLL (which tracks +w0) as its negative image.
    Reversed, the correlation is the convolution the taps were designed
    for: 0.9946 at +w0, 6.6e-6 at -w0. The table's envelope exp(-i w0 k)
    table[k] is symmetric (to 4.4e-7), so the delay stays
    CHROMA_FIR_DELAY."""
    return np.ascontiguousarray(chroma_taps()[::-1])


CHROMA_FIR_DELAY = (231 - 1) // 2
# TODO note kept from chroma_pll.h:5: "should be 60" but 63 is what ships.
BURST_START = 63 + CHROMA_FIR_DELAY
BURST_END = BURST_START + 28

# ATVDecoder's chroma loop. ChromaPLL corrects over the 28-sample burst and
# free-runs the rest of the 720-sample line, so per line a phase error e
# and a frequency error df map as e' = (1 - 28 alpha - 720 28 beta) e + 720
# df, df' = df - 28 beta e, stable only while 720 28 beta < 4 - 56 alpha.
# The reference's bandwidth 0.01 (alpha 0.0279, beta 3.94e-4) gives 7.95
# against 2.44: an eigenvalue near -6.7, and the loop diverges. At 0.003
# (alpha 0.00845, beta 3.58e-5) it is 0.72 against 3.53: both eigenvalues
# of modulus 0.87, an e-fold in about 8 lines.
CHROMA_BANDWIDTH = 0.003
# A loop that sees the phase once a line cannot tell df from df + 2 pi k /
# 720: every such offset is a lock as stable as the true one (a false
# lock: 0.35 % of the subcarrier apart, with the burst's phase ramped by
# 0.24 rad). The reference's limits, +-10 % of the subcarrier, admit 56 of
# them, and a loop started 0.5 % off locks 0.35 % off. Limits a quarter of
# that spacing either side admit none, and a start outside them is
# clamped nearer the true lock than any false one.
CHROMA_PULL = float(np.pi) / (2 * LINE_LEN)


class LineSync(Block):
    """Horizontal line synchronizer -> (lines[max_lines, 720], valid).

    State: ``head`` (the last ``head_len`` inputs), the next line's
    position in the next block as ``base`` (int64) + ``pos`` (float32, in
    [0, 1]), the frequency as ``freq`` + ``freq_lo`` (float32 each), and
    ``locked``. The valid lines are a prefix.

    JAX carries the position as one float32 counted from the block start:
    at 40-ms blocks it reaches 4.5e5, an ulp of 1/32 sample, and where the
    sync error is 0 (the window in a flat sync tip) nothing corrects the
    rounding, so a block cut in two drew other lines than the block whole
    (up to 0.25 apart). Here the walk rebases the position after every
    line (``ops.sync_walks.rebase``): a sample's position base + (pos + k
    freq) has a float part below 760, and a block cut anywhere draws the
    whole block's lines bit for bit. JAX's float32 frequency also holds
    still under the integrator's steps (omega_gain 1e-6 times a sync error
    of 1e-2 is 1e-8, under half an ulp of 1.0), 0.2 sample off a float64
    loop over a 40-ms block; ``freq_lo`` keeps those steps (a compensated
    sum), within 2e-3 sample of the float64 loop.

    A block ends where the next whole line no longer fits, so that line
    is carried into the next block at a negative position, down to -720
    max_freq. The JAX block carries only a 7-sample ``tail`` (the
    interpolator's taps) and clips the window index at 0, so every sample
    of that line before the block start reads one window: in ATVDecoder
    (omega 1) about 717 of its 720 samples, once a block. Here the head
    holds ceil(720 max_freq) + 7 samples, the whole carried line and the
    taps, and the walk reads its windows back into it: a split run draws
    the same lines as an unsplit one."""

    def __init__(self, omega: float, omega_gain: float = 1e-6,
                 mu_gain: float = 0.01, omega_rel_limit: float = 0.01,
                 sync_level: float = -0.03, sync_bias: float = 0.0,
                 interp_phase_count: int = 128, interp_tap_count: int = 8,
                 *, device="cuda"):
        self.omega = float(omega)  # samples per output sample
        self.mu_gain = np.float32(mu_gain)
        self.omega_gain = np.float32(omega_gain)
        self.min_freq = np.float32(omega * (1.0 - omega_rel_limit))
        self.max_freq = np.float32(omega * (1.0 + omega_rel_limit))
        self.sync_level = np.float32(sync_level)
        self.sync_bias = np.float32(sync_bias)
        self.phase_count = int(interp_phase_count)
        self.tap_count = int(interp_tap_count)
        self.head_len = int(np.ceil(LINE_LEN * float(self.max_freq))) + \
            self.tap_count - 1
        self.device = torch.device(device)
        self.bank = torch.from_numpy(
            _interp_bank(self.phase_count, self.tap_count).astype(
                np.float32)).to(self.device)

    def max_lines(self, n: int) -> int:
        return int(n / (LINE_LEN * float(self.min_freq))) + 2

    def init_state(self):
        d = self.device
        return {
            "head": torch.zeros(self.head_len, dtype=torch.float32,
                                device=d),
            "base": torch.zeros((), dtype=torch.int64, device=d),
            "pos": torch.zeros((), dtype=torch.float32, device=d),
            "freq": torch.full((), self.omega, dtype=torch.float32, device=d),
            "freq_lo": torch.zeros((), dtype=torch.float32, device=d),
            "locked": torch.zeros((), dtype=torch.bool, device=d),
        }

    def __call__(self, state, x):
        n = x.shape[-1]
        max_lines = self.max_lines(n)
        buf = torch.cat([state["head"], x.to(torch.float32)])
        carry = torch.stack([state["pos"], state["freq"], state["freq_lo"]])
        lines, count, carry, base, locked = line_sync_walk(
            buf, self.bank, carry, state["base"].reshape(1),
            state["locked"].reshape(1), max_lines, self.omega_gain,
            self.mu_gain, self.min_freq, self.max_freq, self.sync_level,
            self.sync_bias, self.head_len)
        valid = torch.arange(max_lines, device=x.device) < count
        new_state = {
            "head": buf[n:],
            "base": base - n,
            "pos": carry[0],
            "freq": carry[1],
            "freq_lo": carry[2],
            "locked": locked.reshape(()),
        }
        return new_state, (lines, valid)


def _mix(phase0, freq, seg):
    """Free-run mix of ``seg`` [L, k] from per-line phases: phase0 + k *
    freq, as the JAX block's ``_mix``."""
    k = torch.arange(seg.shape[-1], dtype=torch.float32, device=seg.device)
    ph = phase0[:, None] + k[None, :] * freq[:, None]
    return seg * torch.complex(torch.cos(-ph), torch.sin(-ph))


class ChromaPLL(Block):
    """Color-burst PLL over framed lines.

    Input: complex chroma lines [L, line_len]; the PLL advances freely
    outside the burst window [burst_start, burst_end) and phase-locks to
    the burst with error normalize(angle(v) - ref_phase)
    (chroma_pll.h:22-52). Output: lines mixed down by the tracked phase.
    State: ``phase`` and ``freq``, as the JAX block's.
    """

    def __init__(self, bandwidth: float, line_len: int, burst_start: int,
                 burst_end: int, ref_phase: float = 0.0,
                 init_freq: float = 0.0, min_freq: float = -float(FL_PI),
                 max_freq: float = float(FL_PI), *, device="cuda"):
        self.alpha, self.beta = _critically_damped(bandwidth)
        self.line_len = int(line_len)
        self.burst_start = int(burst_start)
        self.burst_end = int(burst_end)
        self.ref_phase = np.float32(ref_phase)
        self.init_freq = np.float32(init_freq)
        self.min_freq = np.float32(min_freq)
        self.max_freq = np.float32(max_freq)
        self.device = torch.device(device)

    def init_state(self):
        return {"phase": torch.zeros((), dtype=torch.float32,
                                     device=self.device),
                "freq": torch.full((), float(self.init_freq),
                                   dtype=torch.float32, device=self.device)}

    def __call__(self, state, lines, ref_phases=None):
        bs, be = self.burst_start, self.burst_end
        L = lines.shape[0]
        if ref_phases is None:
            ref_phases = torch.full((L,), float(self.ref_phase),
                                    dtype=torch.float32, device=lines.device)
        else:
            ref_phases = torch.as_tensor(ref_phases, dtype=torch.float32,
                                         device=lines.device)
        carry = torch.stack([state["phase"], state["freq"]])
        line_phase, burst, carry = chroma_burst_walk(
            lines[:, bs:be], ref_phases, carry, bs,
            self.line_len - be, self.alpha, self.beta, self.min_freq,
            self.max_freq)
        pre = _mix(line_phase[:, 0], line_phase[:, 1], lines[:, :bs])
        post = _mix(line_phase[:, 2], line_phase[:, 3], lines[:, be:])
        return {"phase": carry[0], "freq": carry[1]}, \
            torch.cat([pre, burst, post], dim=1)


class FrameAssembler:
    """Vertical scan + vsync detection + pixel rendering (host side; a
    copy of the JAX class).

    Mirrors the reference handler's per-line logic (main.cpp:129-196):
    each 720-sample line is rendered as ``clamp((v - min_level) * 255 /
    span_level)`` into a 625-line frame; the vertical position advances
    per line and flips (field toggle + frame emit) on rollover or when
    the 10-bit vsync history over the two half-line sync means matches
    0b0000011111.  ``plan()`` runs the luma-only part first so the
    chroma PLL can be batched with the correct per-line PAL phase flags
    (aphase = (ypos odd) ^ even_frame, main.cpp:139).
    """

    def __init__(self, min_level: float = 0.0, span_level: float = 1.0,
                 sync_level: float = -0.06):
        self.min_level = float(min_level)
        self.span_level = float(span_level)
        self.sync_level = float(sync_level)
        self.ypos = 0
        self.even_frame = False
        self.sync_history = 0
        self._frame = np.zeros((FRAME_LINES, LINE_LEN, 2), np.uint8)
        self.frames: list[np.ndarray] = []

    def plan(self, luma_lines: np.ndarray):
        """Advance the vertical-scan state over luma lines.

        Returns (ypos[L], aphase[L], flip_after[L]): the line positions
        and PAL burst-phase flags to use for this batch, and where frame
        flips happen (rollover or vsync trigger).
        """
        L = len(luma_lines)
        ypos = np.zeros(L, np.int32)
        aphase = np.zeros(L, bool)
        flip_after = np.zeros(L, bool)
        for i, line in enumerate(luma_lines):
            ypos[i] = self.ypos
            aphase[i] = ((self.ypos % 2) == 1) ^ self.even_frame
            self.ypos += 1
            rollover = self.ypos >= FRAME_LINES
            if rollover:
                self.even_frame = not self.even_frame
                self.ypos = 0
                flip_after[i] = True
            # vsync levels: means of the two half-line sync regions
            # (main.cpp:168-177; the reference divides by 305)
            sync0 = float(np.sum(line[:306])) / 305.0
            sync1 = float(np.sum(line[360:666])) / 305.0
            self.sync_history >>= 2
            self.sync_history |= ((int(sync1 < self.sync_level) << 9)
                                  | (int(sync0 < self.sync_level) << 8))
            if not rollover and self.sync_history == 0b0000011111:
                self.even_frame = not self.even_frame
                self.ypos = 0
                flip_after[i] = True
        return ypos, aphase, flip_after

    def commit(self, mixed_lines: np.ndarray, ypos: np.ndarray,
               flip_after: np.ndarray):
        """Render PLL-mixed lines at the planned positions; emit a frame
        copy at every flip (the reference's img.swap())."""
        scale = 255.0 / self.span_level
        re = np.clip((mixed_lines.real - self.min_level) * scale, 0, 255)
        im = np.clip((mixed_lines.imag - self.min_level) * scale, 0, 255)
        for i in range(len(mixed_lines)):
            self._frame[ypos[i], :, 0] = re[i].astype(np.uint8)
            self._frame[ypos[i], :, 1] = im[i].astype(np.uint8)
            if flip_after[i]:
                self.frames.append(self._frame.copy())
        return self.frames

    def take_frames(self) -> list[np.ndarray]:
        out, self.frames = self.frames, []
        return out


class ATVDecoder:
    """Full ATV receive pipeline (decoder_modules/atv_decoder/src/main.cpp):

    quadrature FM (dev = fs/2) -> LineSync(omega=1, 1e-6, mu 1.0, ±5%)
    -> [real->complex -> 231-tap chroma band-pass -> ChromaPLL @ 4.4336
    MHz with per-line PAL phase] -> FrameAssembler. The chroma loop takes
    CHROMA_BANDWIDTH and limits of CHROMA_PULL either side of the
    subcarrier, where the reference's (bandwidth 0.01, +-10 %) never lock
    at 720-sample lines; the band-pass takes the taps reversed
    (``chroma_filter_taps``), so it passes the subcarrier the loop tracks
    where the reference's correlation passes its negative image.

    ``process(iq)`` consumes complex64 baseband at 11.25 Msps (a numpy
    array, or a tensor on ``device``) and returns any completed
    [625, 720, 2] uint8 frames. The chain runs on ``device``; the valid
    lines are read back once a block for the frame planner, which sets the
    chroma PLL's per-line PAL phases, and the mixed lines once for the
    renderer.
    """

    def __init__(self, samplerate: float = SAMPLE_RATE,
                 min_level: float = 0.0, span_level: float = 1.0, *,
                 device="cuda"):
        from ..ops.fm import Quadrature

        self.device = torch.device(device)
        self.samplerate = float(samplerate)
        self.quad = Quadrature(self.samplerate / 2.0, self.samplerate,
                               device=self.device)
        self.sync = LineSync(1.0, omega_gain=1e-6, mu_gain=1.0,
                             omega_rel_limit=0.05, device=self.device)
        w0 = 2.0 * np.pi * CHROMA_SUBCARRIER / self.samplerate
        self.pll = ChromaPLL(CHROMA_BANDWIDTH, LINE_LEN, BURST_START,
                             BURST_END, init_freq=w0,
                             min_freq=w0 - CHROMA_PULL,
                             max_freq=w0 + CHROMA_PULL, device=self.device)
        self.assembler = FrameAssembler(min_level, span_level)
        self._taps = chroma_filter_taps().astype(np.complex64)
        self._fir_state = torch.zeros(len(self._taps) - 1,
                                      dtype=torch.complex64,
                                      device=self.device)
        self._spectra: dict[int, torch.Tensor] = {}  # FFT length -> taps'
        self.state = {"quad": self.quad.init_state(),
                      "sync": self.sync.init_state(),
                      "pll": self.pll.init_state()}

    def _spectrum(self, n: int) -> torch.Tensor:
        """The chroma taps' spectrum at the FFT length of an n-sample
        block, built once per length."""
        from ..ops.fir import _fft_len, taps_spectrum

        fft_len = _fft_len(n, len(self._taps))
        spec = self._spectra.get(fft_len)
        if spec is None:
            spec = self._spectra[fft_len] = taps_spectrum(
                self._taps, fft_len, self.device)
        return spec

    def process(self, iq) -> list[np.ndarray]:
        from ..ops.fir import fir_correlate

        x = torch.as_tensor(iq).to(self.device, torch.complex64)
        self.state["quad"], y = self.quad(self.state["quad"], x)
        self.state["sync"], (lines, valid) = self.sync(self.state["sync"], y)
        count = int(valid.sum().item())
        if not count:
            return []
        luma_dev = lines[:count]
        luma = luma_dev.cpu().numpy()
        ypos, aphase, flip_after = self.assembler.plan(luma)
        ref_phases = np.where(aphase, A_PHASE, B_PHASE).astype(np.float32)
        flat = luma_dev.reshape(-1).to(torch.complex64)
        self._fir_state, chroma = fir_correlate(
            self._fir_state, flat, self._taps, self._spectrum(flat.shape[0]))
        self.state["pll"], mixed = self.pll(
            self.state["pll"], chroma.reshape(luma_dev.shape),
            torch.from_numpy(ref_phases).to(self.device))
        self.assembler.commit(mixed.cpu().numpy(), ypos, flip_after)
        return self.assembler.take_frames()
