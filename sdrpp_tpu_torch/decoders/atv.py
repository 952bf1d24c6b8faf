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
complex chroma FIR (``ops.fir.fir_correlate``) and ``ChromaPLL`` with the
per-line PAL phases, on ``device`` (default ``cuda``).
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
           "chroma_taps", "LINE_LEN", "FRAME_LINES", "SAMPLE_RATE",
           "CHROMA_SUBCARRIER", "A_PHASE", "B_PHASE"]

LINE_LEN = 720
FRAME_LINES = 625                       # PAL (main.cpp:159-166)
SAMPLE_RATE = 625.0 * 720.0 * 25.0      # main.cpp:32 SAMPLE_RATE
CHROMA_SUBCARRIER = 4433618.75          # PAL chroma, main.cpp:48

# PAL colour-burst reference phases alternate per line (chroma_pll.h:9-10).
A_PHASE = (135.0 / 180.0) * float(FL_PI)
B_PHASE = (-135.0 / 180.0) * float(FL_PI)


def chroma_taps() -> np.ndarray:
    """231-tap complex chroma band-pass FIR (chrominance_filter.h; a copy
    of the JAX package's coefficient table)."""
    return np.load(Path(__file__).parent / "atv_chroma_taps.npz")["taps"]


CHROMA_FIR_DELAY = (231 - 1) // 2
# TODO note kept from chroma_pll.h:5: "should be 60" but 63 is what ships.
BURST_START = 63 + CHROMA_FIR_DELAY
BURST_END = BURST_START + 28


class LineSync(Block):
    """Horizontal line synchronizer -> (lines[max_lines, 720], valid).

    State: ``tail`` (the last 7 inputs), ``pos`` (the next line's
    fractional position in the next block), ``freq`` and ``locked``, as
    the JAX block's. The valid lines are a prefix."""

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
        self.device = torch.device(device)
        self.bank = torch.from_numpy(
            _interp_bank(self.phase_count, self.tap_count).astype(
                np.float32)).to(self.device)

    def max_lines(self, n: int) -> int:
        return int(n / (LINE_LEN * float(self.min_freq))) + 2

    def init_state(self):
        d = self.device
        return {
            "tail": torch.zeros(self.tap_count - 1, dtype=torch.float32,
                                device=d),
            "pos": torch.zeros((), dtype=torch.float32, device=d),
            "freq": torch.full((), self.omega, dtype=torch.float32, device=d),
            "locked": torch.zeros((), dtype=torch.bool, device=d),
        }

    def __call__(self, state, x):
        n = x.shape[-1]
        max_lines = self.max_lines(n)
        buf = torch.cat([state["tail"], x.to(torch.float32)])
        carry = torch.stack([state["pos"], state["freq"]])
        lines, count, carry, locked = line_sync_walk(
            buf, self.bank, carry, state["locked"].reshape(1), max_lines,
            self.omega_gain, self.mu_gain, self.min_freq, self.max_freq,
            self.sync_level, self.sync_bias)
        valid = torch.arange(max_lines, device=x.device) < count
        new_state = {
            "tail": buf[n:],
            "pos": carry[0] - n,
            "freq": carry[1],
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
    MHz ±10% with per-line PAL phase] -> FrameAssembler.

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
        self.pll = ChromaPLL(0.01, LINE_LEN, BURST_START, BURST_END,
                             init_freq=w0, min_freq=w0 * 0.9,
                             max_freq=w0 * 1.1, device=self.device)
        self.assembler = FrameAssembler(min_level, span_level)
        self._taps = chroma_taps().astype(np.complex64)
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
