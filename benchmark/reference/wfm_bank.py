"""Plain reference of a broadcast-FM scanner bank, written from SDR++'s
semantics and imported by nothing of the program under test.

The chain, per channel c at offset f_c of a wideband stream at ``fs``
(SDR++'s radio module in WFM mode, one VFO a channel):

    mix by -f_c -> rational resampler fs -> if_rate (power-of-2
    cascade, then the polyphase stage) -> channel low-pass (bandwidth /
    2) -> block squelch -> broadcast-FM stereo demod -> AF rational
    resampler if_rate -> audio_rate -> de-emphasis

SDR++ sources: core/src/dsp/channel/frequency_xlator.h,
multirate/rational_resampler.h (its plan and tap design),
multirate/power_decimator.h with decim/plans.h,
multirate/polyphase_resampler.h and polyphase_bank.h, filter/fir.h,
noise_reduction/squelch.h, demod/broadcast_fm.h (quadrature.h,
taps/band_pass.h, loop/pll.h and loop/phase_control_loop.h,
math/delay.h), filter/deephasis.h, and the radio module's AF chain
(decoder_modules/radio/src/radio_module.h: resampler, then
de-emphasis); taps/low_pass.h, taps/windowed_sinc.h, window/nuttall.h.

The design helpers and the cascade's frozen tables come from
``scanner_bank.py`` beside this file (``low_pass``, ``decim_stages``,
``nco_phases``, ``tf32_round``); the cascade tables are
``decim_plan_64.json`` and ``decim_plan_4.json``, frozen copies of
SDR++'s. Every other tap is designed again here. State is carried from
the initial state through every block the reference runs: FIR and
resampler tails, the squelch's counters, the discriminator's last
sample, the pilot loop's phase and frequency, the stereo delay lines,
the de-emphasis output. The NCO phases at block boundaries come from
``nco_phases`` (the float32 phase stepped once a block, as SDR++ keeps
it); inside a block the phase is ``(i * omega) mod 2 pi`` in float64.

The pilot loop is SDR++'s exact sequential recurrence (pll.h: emit
phasor(phase), then advance by the wrapped error), one step a sample,
vectorised over channels and blocks on the host.

Departures from SDR++ (none changes what the chain computes beyond
rounding): everything runs in float64 (SDR++ in float32), its constants
(pi, alpha, beta, the loop's limits, de-emphasis alpha) too; long
filters without decimation are the same sums taken through the FFT (to
~1e-15 of the block); the L+R and L-R delay lines, which hold the same
real samples (the complex MPX's imaginary part is 0), are one; the
rational resampler's pre-decimation backs off until the intermediate
rate is whole, as this repository's resampler does (no change at the
configuration's rates); the squelch keeps SDR++'s block rule on each
whole block.

Where a channel's pilot band holds no pilot (a mono station), SDR++'s
stereo decoder still demodulates L-R with a loop that then tracks the
pilot band's noise, some 90 dB below the multiplex: float32's rounding
of the multiplex moves that noise by about 1 %, and the loop slips at
other samples (float32 against float64 on one block of a mono station:
L-R parts by up to 0.09 where its RMS is 0.019, and the L-R RMS agrees
to 4e-4). So the comparison holds L+R sample by sample on every
channel, and L-R by its RMS where the reference finds no pilot
(``PILOT_MIN``; ``stereo_gap``). Where it finds one, L-R is held sample
by sample over that channel's own L-R RMS (``pilot_side_err``): without
a stereo programme L-R is there the 23-53 kHz noise brought down by the
loop's doubled phase, some 1e-3 of a programme, and a loop at another
phase (by pi / 4: the other quadrature; by pi / 2: L-R negated) moves it
by its own size, where over a programme's RMS it would read as noise.

``Reference(config, n, device=...)`` is the reference, in float64.
``control=True`` makes it its control: every tensor float32, and every
convolution's operands rounded to TF32's 10-bit mantissa (round to
nearest even) with float32 sums, each filter a direct convolution.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.scanner_bank import (decim_stages, low_pass,
                                              nco_phases, tf32_round)

__all__ = ["channel_offsets", "rate_plan", "resampler_taps",
           "polyphase_bank", "band_pass", "critically_damped", "geometry",
           "Stereo", "stereo_gap", "compare", "Reference", "PILOT_MIN"]

TWO_PI = 2.0 * np.pi
TAUS = {"22us": 22e-6, "50us": 50e-6, "75us": 75e-6}
BUDGET = 1 << 27   # wideband samples a channel group holds (blocks x n)
# a pilot: the pilot band-pass's median output magnitude over the block,
# in units of the deviation, above this (a pilot injected at 200 Hz of
# deviation; stations inject 6-7.5 kHz, a 19-kHz band without one reads
# ~1e-5; the median passes over a start-up transient)
PILOT_MIN = 1e-3

_NUTTALL = (0.355768, 0.487396, 0.144232, 0.012604)


def channel_offsets(config: dict) -> np.ndarray:
    """Channel centres, Hz from the capture's centre: ``channels``
    channels ``spacing_hz`` apart from ``first_hz``."""
    b = config["bank"]
    return (float(b["first_hz"]) + float(b["spacing_hz"])
            * np.arange(int(b["channels"])) - float(b["centre_hz"]))


def rate_plan(in_rate: float, out_rate: float) -> tuple[int, int, int]:
    """rational_resampler.h: (pre-decimation, interp, decim): the largest
    power of two at most in / out (backed off until the intermediate
    rate is whole), then interp / decim of the rest by their gcd."""
    power = int(np.floor(np.log2(in_rate / out_rate))) \
        if in_rate > out_rate else 0
    while power > 0 and (in_rate / (1 << power)) % 1.0:
        power -= 1
    mid = int(round(in_rate / (1 << power)))
    out = int(round(out_rate))
    g = int(np.gcd(mid, out))
    return 1 << power, out // g, mid // g


def resampler_taps(in_rate: float, out_rate: float) -> np.ndarray:
    """rational_resampler.h's polyphase taps: a low-pass at half the
    lower rate (transition a tenth of it) designed at the intermediate
    rate x interp, times interp, as float32."""
    pre, interp, _ = rate_plan(in_rate, out_rate)
    bw = min(in_rate, out_rate) / 2.0
    taps = low_pass(bw, bw * 0.1, in_rate / pre * interp)
    return (taps * np.float32(interp)).astype(np.float32)


def polyphase_bank(taps: np.ndarray, interp: int) -> np.ndarray:
    """polyphase_bank.h: phases[(interp - 1) - (i % interp)][i // interp]
    = taps[i], zero past the last tap."""
    tpp = -(-taps.shape[0] // interp)
    bank = np.zeros((interp, tpp), taps.dtype)
    for i in range(interp * tpp):
        bank[interp - 1 - i % interp, i // interp] = (
            taps[i] if i < taps.shape[0] else 0)
    return bank


def band_pass(start: float, stop: float, trans: float, fs: float
              ) -> np.ndarray:
    """taps/band_pass.h, complex and with an odd tap count: the
    windowed sinc of half the band's width, each tap turned by
    phasor(-w0 n) about the window's centre, w0 the band's centre as a
    float, stored as complex64."""
    count = int(3.8 * fs / trans)
    count += 1 - count % 2
    w0 = float(np.float32(TWO_PI * ((start + stop) / 2.0) / fs))
    omega = TWO_PI * ((stop - start) / 2.0) / fs
    t = np.arange(count, dtype=np.float64) - count / 2.0 + 0.5
    n = t - count / 2.0
    arg = t * omega
    safe = np.where(arg == 0.0, 1.0, arg)
    sinc = np.where(arg == 0.0, 1.0, np.sin(safe) / safe)
    win = np.zeros_like(n)
    for i, c in enumerate(_NUTTALL):
        win += (-1.0) ** i * c * np.cos(i * TWO_PI * n / count)
    return (sinc * win * (omega / np.pi)
            * np.exp(-1j * w0 * n)).astype(np.complex64)


def critically_damped(bandwidth: float) -> tuple[float, float]:
    """phase_control_loop.h: (alpha, beta) at damping sqrt(2) / 2."""
    z = np.sqrt(2.0) / 2.0
    den = 1.0 + 2.0 * z * bandwidth + bandwidth * bandwidth
    return 4.0 * z * bandwidth / den, 4.0 * bandwidth * bandwidth / den


def geometry(config: dict, n: int) -> dict:
    """The sizes a block of ``n`` samples has in the chain: ``channels``,
    the IF block ``n_if``, the audio block ``n_audio``, the VFO
    resampler's power-of-two cascade ``ratio`` (its pre-decimation, the
    key ``scanner_bank.geometry`` gives its cascade) and its polyphase
    ``interp`` / ``decim``."""
    b = config["bank"]
    pre, interp, decim = rate_plan(float(b["samplerate"]),
                                   float(b["if_rate"]))
    n_if = n // pre * interp // decim
    a_pre, a_interp, a_decim = rate_plan(float(b["if_rate"]),
                                         float(b["audio_rate"]))
    return {"channels": int(b["channels"]), "n_if": n_if,
            "n_audio": n_if // a_pre * a_interp // a_decim,
            "ratio": pre, "interp": interp, "decim": decim}


class Stereo(np.ndarray):
    """One block's [C, m, 2] stereo audio from ``Reference.run``, with
    ``pilot`` ([C] bool): the channels whose pilot band the reference
    found holding a pilot."""

    pilot = None


def stereo_gap(got: np.ndarray, want: np.ndarray, pilot=None):
    """(audio gap, pilot side gap, mute mismatches) of one block's [C, m,
    2] stereo audio against the reference's, both planes as L+R and L-R:

    - the audio gap: the widest over channels of the L+R gap, and of the
      L-R RMS gap where ``pilot`` ([C] bool, default none) says the
      channel has no pilot, over that channel's RMS (both planes) in the
      reference's block, or over the median RMS of the block's unmuted
      channels where the channel's own is smaller;
    - the pilot side gap: the widest L-R gap of a channel with a pilot
      over that channel's own L-R RMS in the reference's block (0 where
      no channel has one);
    - the channels one side muted (both planes exactly 0) and the other
      did not."""
    got = got.astype(np.float64)
    want = want.astype(np.float64)
    c = want.shape[0]
    pilot = np.zeros(c, bool) if pilot is None else np.asarray(pilot, bool)
    rms = np.sqrt(np.mean(want * want, axis=(1, 2)))
    live = rms[rms > 0]
    floor = float(np.median(live)) if live.size else 1.0
    mid = np.abs(got.sum(-1) - want.sum(-1)).max(-1) / 2.0
    sg, sw = np.diff(got, axis=-1)[..., 0], np.diff(want, axis=-1)[..., 0]
    side_rms = np.sqrt(np.mean(sw * sw, -1))
    side = np.where(pilot, 0.0,
                    np.abs(np.sqrt(np.mean(sg * sg, -1)) - side_rms)) / 2.0
    gap = np.maximum(mid, side) / np.maximum(rms, floor)
    own = np.abs(sg - sw).max(-1)[pilot] / np.maximum(side_rms[pilot],
                                                      1e-30)
    mute_got = ~np.any(got != 0, axis=(1, 2))
    mute_want = ~np.any(want != 0, axis=(1, 2))
    return (float(np.max(gap)), float(np.max(own, initial=0.0)),
            int(np.sum(mute_got != mute_want)))


def compare(config: dict, got: dict, want: dict):
    """(numbers, failing blocks) of the program's audio ``got`` against
    the reference's ``want``, both {block: [C, m, 2]}:

    - ``audio_err``: the widest ``stereo_gap`` audio gap over the blocks,
      limit the configuration's ``check.audio_err``;
    - ``pilot_side_err``: the widest ``stereo_gap`` pilot side gap over
      the blocks (the pilot loop's phase), limit ``check.pilot_side_err``;
    - ``mute_mismatch``: (block, channel) pairs muted on one side only;
      exact, limit 0;
    - ``bad_shape``: blocks whose audio is not the reference's shape or
      not finite; exact, limit 0."""
    limit = config["check"]["audio_err"]
    p_limit = config["check"]["pilot_side_err"]
    bad, err, p_err, mism, failing = 0, 0.0, 0.0, 0, 0
    for k in sorted(got):
        g = got[k]
        if g.shape != want[k].shape or not np.all(np.isfinite(g)):
            bad += 1
            failing += 1
            continue
        e, p, m = stereo_gap(g, want[k], getattr(want[k], "pilot", None))
        err, p_err, mism = max(err, e), max(p_err, p), mism + m
        failing += int(e > limit or p > p_limit or m > 0)
    return {"audio_err": {"value": err, "limit": limit},
            "pilot_side_err": {"value": p_err, "limit": p_limit},
            "mute_mismatch": {"value": mism, "limit": 0},
            "bad_shape": {"value": bad, "limit": 0}}, failing


class Reference:
    """The chain of one configuration (see the module's docstring).

    ``run(pool, blocks)`` returns, for each block index k in ``blocks``,
    the [C, n_audio, 2] stereo audio (``Stereo``) of block k of the stream that
    replays ``pool`` ([P, n] complex64 on the host, block b = pool[b %
    P]): the chain runs from its initial state over the blocks before k
    that hold the configuration's ``ref_warmup_if_samples`` IF samples
    (from block 0 where there are fewer). Blocks run in lockstep, through
    the wideband part as many channels at a time as ``BUDGET`` allows."""

    def __init__(self, config: dict, n: int, *, device, control=False):
        b = config["bank"]
        self.precision = "tf32" if control else "float64"
        self.real = torch.float32 if control else torch.float64
        self.cplx = torch.complex64 if control else torch.complex128
        self.host = np.float32 if control else np.float64
        self.device = torch.device(device)
        fs, if_rate = float(b["samplerate"]), float(b["if_rate"])
        audio_rate, bw = float(b["audio_rate"]), float(b["bandwidth"])
        self.offsets = channel_offsets(config)
        self.channels = self.offsets.shape[0]
        self.n = int(n)
        self.pre, self.interp, self.decim = rate_plan(fs, if_rate)
        if self.n % (self.pre * self.decim):
            raise ValueError(f"block {n} is not a multiple of "
                             f"{self.pre * self.decim}")
        g = geometry(config, self.n)
        self.n_if, self.n_audio = g["n_if"], g["n_audio"]
        self.warmup = -(-int(config["ref_warmup_if_samples"]) // self.n_if)
        self.stages = decim_stages(self.pre)
        self.bank = polyphase_bank(resampler_taps(fs, if_rate), self.interp)
        chan = min(bw, if_rate) / 2.0
        self.chan_taps = low_pass(chan, chan * 0.1, if_rate)
        self.omegas = TWO_PI * (-self.offsets / fs)
        self.squelch = b.get("squelch_db")
        # broadcast_fm.h: deviation bandwidth / 2 (wfm.h), the pilot's
        # band-pass, loop and delay, the 15-kHz audio low-passes
        self.inv_dev = 1.0 / (TWO_PI * (bw / 2.0) / if_rate)
        self.pilot_taps = band_pass(18750.0, 19250.0, 3000.0, if_rate)
        self.alpha, self.beta = critically_damped(25000.0 / if_rate)
        self.f_lo = TWO_PI * 18750.0 / if_rate
        self.f_hi = TWO_PI * 19250.0 / if_rate
        self.f0 = TWO_PI * 19000.0 / if_rate
        self.delay = (self.pilot_taps.shape[0] - 1) // 2 + 1
        self.audio_taps = low_pass(15000.0, 4000.0, if_rate)
        # the radio's AF chain
        self.a_pre, self.a_interp, self.a_decim = rate_plan(if_rate,
                                                            audio_rate)
        self.a_stages = decim_stages(self.a_pre) if self.a_pre > 1 else []
        self.a_bank = polyphase_bank(resampler_taps(if_rate, audio_rate),
                                     self.a_interp)
        tau, dt = TAUS[b["deemphasis"]], 1.0 / audio_rate
        self.deemph = dt / (tau + dt)

    # ---- pieces -----------------------------------------------------------

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device,
                               dtype=dtype)

    def _corr(self, buf, taps, r=1):
        """y[k] = sum_j taps[j] buf[r k + j] for every k whose taps lie
        in ``buf`` (fir.h, decimating_fir.h); real taps on real or complex
        ``buf``, complex taps on real ``buf``, any leading axes. In
        float64 a long filter without decimation is the same sum taken
        through the FFT; otherwise a direct convolution of real planes,
        whose operands the control rounds to TF32."""
        m, L = taps.shape[0], buf.shape[-1]
        ctaps = np.iscomplexobj(taps)
        if r == 1 and m > 64 and self.precision == "float64":
            nfft = 1 << (L + m - 2).bit_length()
            h = self._t(taps[::-1], self.cplx if ctaps else self.real)
            if buf.is_complex() or ctaps:
                full = torch.fft.ifft(torch.fft.fft(buf, nfft)
                                      * torch.fft.fft(h, nfft))
            else:
                full = torch.fft.irfft(torch.fft.rfft(buf, nfft)
                                       * torch.fft.rfft(h, nfft), nfft)
            return full[..., m - 1:L]
        if buf.is_complex() and ctaps:
            raise ValueError("complex taps take real data here")
        # the real and imaginary parts, of the data or of the taps
        xs = [buf.real, buf.imag] if buf.is_complex() else [buf]
        ws = [taps.real, taps.imag] if ctaps else [taps]
        planes = torch.stack(xs, dim=-2).reshape(-1, 1, L)
        w = self._t(np.stack(ws).astype(np.float64), self.real).view(-1, 1, m)
        if self.precision == "tf32":
            planes, w = tf32_round(planes), tf32_round(w)
        o = F.conv1d(planes, w, stride=r).reshape(*buf.shape[:-1],
                                                  len(xs) * len(ws), -1)
        if o.shape[-2] == 1:
            return o[..., 0, :]
        return torch.complex(o[..., 0, :], o[..., 1, :])

    def _fir(self, tail, x, taps, r=1):
        """(new tail, y): ``_corr`` over [tail | x], the tail the last
        m - 1 samples."""
        buf = torch.cat([tail, x], dim=-1)
        return buf[..., buf.shape[-1] - (taps.shape[0] - 1):], \
            self._corr(buf, taps, r)

    def _polyphase(self, tail, x, bank, interp, decim):
        """polyphase_resampler.h over a block: output k is phase (k decim)
        mod interp of ``bank`` at input offset (k decim) div interp of
        [tail | x], taken here phase group by phase group (each group's
        taps behind as many zeros as its offset)."""
        tpp = bank.shape[1]
        buf = torch.cat([tail, x], dim=-1)
        n = x.shape[-1]
        per = n // decim   # outputs of each of the interp groups
        y = buf.new_empty((*x.shape[:-1], per * interp))
        for r in range(interp):
            off = (r * decim) // interp
            taps = np.concatenate([np.zeros(off, bank.dtype),
                                   bank[(r * decim) % interp]])
            y[..., r::interp] = self._corr(buf, taps, decim)[..., :per]
        return buf[..., n:], y

    def _ramp(self, omegas, n):
        """(i * omega) mod 2 pi, i < n, float64, [len(omegas), n]."""
        i = torch.arange(n, dtype=torch.float64, device=self.device)
        w = torch.as_tensor(omegas, dtype=torch.float64, device=self.device)
        return torch.remainder(i[None, :] * w[:, None], TWO_PI)

    def _squelch(self, state, x):
        """squelch.h on one block: level = 20 log10(mean |x|); unmuted it
        mutes below level - 1 dB, muted it counts blocks at or above the
        level and unmutes on the tenth."""
        mute, cnt = state
        mean = torch.abs(x).mean(dim=-1).double().cpu().numpy()
        lv = 20.0 * np.log10(np.maximum(mean, 1e-20))
        below = lv < self.squelch
        cnt_m = np.where(below | (cnt <= 0), 10, cnt - 1)
        unmute = ~below & (cnt > 0) & (cnt_m == 0)
        mute_u = lv < self.squelch - 1.0
        new_mute = np.where(mute, ~unmute, mute_u)
        new_cnt = np.where(mute, cnt_m, np.where(mute_u, 0, cnt))
        keep = torch.as_tensor(~new_mute, device=self.device)[..., None]
        return (new_mute, new_cnt), torch.where(keep, x, torch.zeros_like(x))

    def _pll(self, state, in_phase):
        """pll.h over a block, [lanes, n] input phases: each step emits
        the loop's phase, then advances it by the error wrapped to (-pi,
        pi] (freq += beta err, clamped; phase += freq + alpha err,
        wrapped to [-pi, pi]). Returns (state, [lanes, n] phases)."""
        x = np.ascontiguousarray(in_phase.cpu().numpy().astype(self.host).T)
        phase, freq = (v.copy() for v in state)
        h = self.host
        pi, two_pi = h(np.pi), h(TWO_PI)
        alpha, beta = h(self.alpha), h(self.beta)
        lo, hi = h(self.f_lo), h(self.f_hi)
        out = np.empty_like(x)
        d = np.empty_like(phase)
        step = np.empty_like(phase)
        for t in range(x.shape[0]):
            out[t] = phase
            # the error wrapped to (-pi, pi]: pi - ((pi - err) mod 2 pi)
            np.subtract(pi, x[t], out=d)
            d += phase
            np.remainder(d, two_pi, out=d)
            np.subtract(pi, d, out=d)
            np.multiply(d, beta, out=step)
            freq += step
            np.clip(freq, lo, hi, out=freq)
            np.multiply(d, alpha, out=step)
            step += freq
            # the phase wrapped to [-pi, pi)
            phase += step + pi
            np.remainder(phase, two_pi, out=phase)
            phase -= pi
        return (phase, freq), self._t(out.T, self.real)

    def _deemphasis(self, state, x):
        """deephasis.h over a block of [lanes, n] audio: y[i] = alpha x[i]
        + (1 - alpha) y[i - 1]. Returns (last outputs, y)."""
        z = np.ascontiguousarray(x.cpu().numpy().astype(self.host).T)
        a = self.host(self.deemph)
        b = self.host(1.0) - a
        y = state.copy()
        for t in range(z.shape[0]):
            y *= b
            y += a * z[t]
            z[t] = y
        return y, self._t(z.T, self.real)

    # ---- the chain --------------------------------------------------------

    def run(self, pool: np.ndarray, blocks) -> dict:
        """{k: [C, n_audio, 2] float64 (float32 for the control)
        ``Stereo``}."""
        warmup = self.warmup
        blocks = sorted(set(int(k) for k in blocks))
        out = {}
        full = [k for k in blocks if k >= warmup]
        if full:
            out.update(self._run_lockstep(pool, full, warmup))
        for k in blocks:
            if k < warmup:
                out.update(self._run_lockstep(pool, [k], k))
        return out

    def _run_lockstep(self, pool, ks, warmup):
        C, J = self.channels, len(ks)
        P = pool.shape[0]
        starts = [k - warmup for k in ks]
        phases = nco_phases(self.omegas, self.n, max(starts) + warmup + 1)

        def zeros(*shape, dtype=None):
            return torch.zeros((J, C, *shape), dtype=dtype or self.cplx,
                               device=self.device)

        tails = [zeros(t.shape[0] - 1) for _, t in self.stages]
        poly_tail = zeros(self.bank.shape[1] - 1)
        chan_tail = zeros(self.chan_taps.shape[0] - 1)
        sq = (np.zeros((J, C), bool), np.zeros((J, C), np.int64))
        last = zeros(1)
        pilot_tail = zeros(self.pilot_taps.shape[0] - 1, dtype=self.real)
        delay = zeros(self.delay, dtype=self.real)
        lpf_tail = zeros(2, self.audio_taps.shape[0] - 1, dtype=self.real)
        pll = (np.zeros(J * C, self.host), np.full(J * C, self.f0, self.host))
        a_tails = [zeros(2, t.shape[0] - 1, dtype=self.real)
                   for _, t in self.a_stages]
        a_poly_tail = zeros(2, self.a_bank.shape[1] - 1, dtype=self.real)
        de = np.zeros(J * C * 2, self.host)
        audio = None
        for s in range(warmup + 1):
            bidx = [st + s for st in starts]
            x = torch.as_tensor(np.stack([pool[b % P] for b in bidx]),
                                device=self.device).to(self.cplx)
            ifs = []
            group = max(1, min(C, BUDGET // (J * self.n)))
            for c0 in range(0, C, group):
                cs = slice(c0, min(C, c0 + group))
                ph = torch.as_tensor(np.stack([phases[b, cs] for b in bidx]),
                                     dtype=torch.float64,
                                     device=self.device)[..., None]
                ph = (ph + self._ramp(self.omegas[cs], self.n)).to(self.real)
                y = x[:, None, :] * torch.polar(torch.ones_like(ph), ph)
                for i, (r, taps) in enumerate(self.stages):
                    tails[i][:, cs], y = self._fir(tails[i][:, cs], y, taps,
                                                   r)
                ifs.append(y)
            poly_tail, y = self._polyphase(poly_tail, torch.cat(ifs, dim=1),
                                           self.bank, self.interp,
                                           self.decim)  # [J, C, n_if]
            chan_tail, y = self._fir(chan_tail, y, self.chan_taps)
            if self.squelch is not None:
                sq, y = self._squelch(sq, y)
            # broadcast_fm.h: quadrature, pilot, stereo matrix
            prev = torch.cat([last, y[..., :-1]], dim=-1)
            last = y[..., -1:]
            prod = y * torch.conj(prev)
            mpx = torch.atan2(prod.imag, prod.real) * self.inv_dev
            pilot_tail, pilot = self._fir(pilot_tail, mpx, self.pilot_taps)
            pll, vco_ph = self._pll(
                pll, torch.atan2(pilot.imag, pilot.real).reshape(J * C, -1))
            vco = torch.polar(torch.ones_like(vco_ph), vco_ph).reshape(
                J, C, -1)
            both = torch.cat([delay, mpx], dim=-1)
            delay, d = both[..., self.n_if:], both[..., :self.n_if]
            lmr = 2.0 * (d * torch.conj(vco) * torch.conj(vco)).real
            lr = torch.stack([d + lmr, d - lmr], dim=2)  # [J, C, 2, n_if]
            lpf_tail, lr = self._fir(lpf_tail, lr, self.audio_taps)
            # the AF chain: resampler, then de-emphasis
            for i, (r, taps) in enumerate(self.a_stages):
                a_tails[i], lr = self._fir(a_tails[i], lr, taps, r)
            a_poly_tail, lr = self._polyphase(a_poly_tail, lr, self.a_bank,
                                              self.a_interp, self.a_decim)
            de, lr = self._deemphasis(de, lr.reshape(J * C * 2, -1))
            audio = lr.reshape(J, C, 2, -1).transpose(-1, -2)
        pilot = (torch.median(torch.abs(pilot), dim=-1).values
                 > PILOT_MIN).cpu().numpy()
        audio = audio.cpu().numpy()
        out = {}
        for j, k in enumerate(ks):
            out[k] = audio[j].view(Stereo)
            out[k].pilot = pilot[j]
        return out
