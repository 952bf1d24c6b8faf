"""Plain reference of a time-domain scanner bank, written from SDR++'s
semantics and imported by nothing of the program under test.

The chain, per channel c at offset f_c of a wideband stream at ``fs``:

    mix by -f_c -> power-of-2 decimation cascade (fs -> if_rate) ->
    channel low-pass (bandwidth / 2) -> block squelch -> demod

with the demods NFM (quadrature discriminator at deviation bandwidth / 2,
then an audio low-pass) and USB (shift by +bandwidth / 2, real part,
then the AGC). SDR++ sources: core/src/dsp/channel/frequency_xlator.h,
multirate/power_decimator.h with decim/plans.h, filter/fir.h,
noise_reduction/squelch.h, demod/quadrature.h, demod/ssb.h, loop/agc.h,
taps/low_pass.h, taps/windowed_sinc.h, window/nuttall.h.

The taps are designed again here (the frozen design formulas below); the
cascade's stage taps come from ``decim_plan_<ratio>.json`` beside this
file, a frozen copy of SDR++'s tables. State is carried from the initial
state through every block it is asked to run: FIR tails, the squelch's
counters, the discriminator's last sample, the AGC's amplitude and gain.
The one carry taken from a closed form is each NCO's phase at a block
boundary: SDR++ and the configuration keep it as a float32 value stepped
by the float32 step ``(n * omega) mod 2 pi`` once a block, so
``nco_phases`` steps it the same way from zero, in float32; inside a
block the phase is ``(i * omega) mod 2 pi`` in float64.

``Reference(config, n, device=...)`` is the reference, in float64.
``control=True`` makes it its control: every tensor float32, and every
convolution's operands rounded to TF32's 10-bit mantissa (round to
nearest even) with float32 sums, which is what a float32 convolution on
the tensor cores computes.

A reference module gives the output check (``check.compare``) and the
per-layer readers what they read: ``Reference`` with ``run(recording,
blocks)``; ``compare(config, got, want)``, the numbers compared with
their limits; and ``geometry(config, n)``, the sizes the readers take
their least bytes from.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["low_pass", "decim_stages", "pre_ratio", "nco_phases",
           "tf32_round", "geometry", "audio_gap", "compare", "Reference"]

TWO_PI = 2.0 * np.pi
TWO_PI32 = np.float32(TWO_PI)
_HERE = Path(__file__).resolve().parent

# the wideband part runs as many channels at a time as keep a tensor of
# (blocks x channels x n) samples within this many
BUDGET = 1 << 27

# window/nuttall.h: the four cosine-sum coefficients
_NUTTALL = (0.355768, 0.487396, 0.144232, 0.012604)


def _nuttall(n, size):
    w = np.zeros_like(n)
    sign = 1.0
    for i, c in enumerate(_NUTTALL):
        w += sign * c * np.cos(i * TWO_PI * n / size)
        sign = -sign
    return w


def low_pass(cutoff: float, trans_width: float, samplerate: float
             ) -> np.ndarray:
    """taps/low_pass.h: a Nuttall-windowed sinc of int(3.8 fs / trans)
    taps (estimate_tap_count.h truncates), designed in float64 and stored
    as float32 (windowed_sinc.h)."""
    count = int(3.8 * samplerate / trans_width)
    omega = TWO_PI * (cutoff / samplerate)
    t = np.arange(count, dtype=np.float64) - count / 2.0 + 0.5
    arg = t * omega
    safe = np.where(arg == 0.0, 1.0, arg)
    sinc = np.where(arg == 0.0, 1.0, np.sin(safe) / safe)
    return (sinc * _nuttall(t - count / 2.0, float(count))
            * (omega / np.pi)).astype(np.float32)


def decim_stages(ratio: int) -> list[tuple[int, np.ndarray]]:
    """[(decimation, float32 taps), ...] of the /ratio cascade."""
    plan = json.loads((_HERE / f"decim_plan_{ratio}.json").read_text())
    return [(int(s["decimation"]), np.asarray(s["taps"], np.float32))
            for s in plan["stages"]]


def pre_ratio(in_rate: float, out_rate: float) -> int:
    """rational_resampler.h's power-of-2 pre-decimation, backed off until
    the intermediate rate is whole; a bank whose rates then still differ
    needs the polyphase stage, which this reference does not have."""
    power = int(np.floor(np.log2(in_rate / out_rate)))
    while power > 0 and (in_rate / (1 << power)) % 1.0:
        power -= 1
    if in_rate / (1 << power) != out_rate:
        raise NotImplementedError(
            f"{in_rate:g} -> {out_rate:g} needs a polyphase stage")
    return 1 << power


def nco_phases(omegas: np.ndarray, n: int, blocks: int) -> np.ndarray:
    """[blocks + 1, C] float32: each NCO's phase at the start of blocks
    0 .. blocks, stepped once a block as SDR++'s float phase is."""
    omegas = np.asarray(omegas, np.float64)
    step = np.mod(n * omegas, TWO_PI).astype(np.float32)
    out = np.zeros((blocks + 1, omegas.shape[0]), np.float32)
    for b in range(blocks):
        out[b + 1] = np.fmod(out[b] + step, TWO_PI32)
    return out


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


def geometry(config: dict, n: int) -> dict:
    """The sizes a block of ``n`` samples has in the chain: ``channels``,
    the cascade's ``ratio`` and the IF block ``n_if``."""
    bank = config["bank"]
    ratio = pre_ratio(float(bank["samplerate"]), float(bank["if_rate"]))
    return {"channels": int(bank["channels"]), "ratio": ratio,
            "n_if": n // ratio}


def audio_gap(got: np.ndarray, want: np.ndarray):
    """(widest relative gap, mute mismatches) of one block's [C, m]
    audio against the reference's: the widest gap over each channel's
    RMS in the reference's block, or over the median RMS of the block's
    unmuted channels where the channel's own is smaller (a muted
    channel's is 0); and the channels one side muted (all its audio
    exactly 0) and the other did not."""
    got = got.astype(np.float64)
    want = want.astype(np.float64)
    rms = np.sqrt(np.mean(want * want, axis=-1))
    live = rms[rms > 0]
    floor = float(np.median(live)) if live.size else 1.0
    gap = np.max(np.abs(got - want), axis=-1) / np.maximum(rms, floor)
    mute_got = ~np.any(got != 0, axis=-1)
    mute_want = ~np.any(want != 0, axis=-1)
    return float(np.max(gap)), int(np.sum(mute_got != mute_want))


def compare(config: dict, got: dict, want: dict):
    """(numbers, failing blocks) of the program's audio ``got`` against
    the reference's ``want``, both {block: [C, m]}:

    - ``audio_err``: the widest ``audio_gap`` over the blocks, limit the
      configuration's ``check.audio_err``;
    - ``mute_mismatch``: (block, channel) pairs muted on one side only;
      exact, limit 0;
    - ``bad_shape``: blocks whose audio is not the reference's shape or
      not finite; exact, limit 0."""
    limit = config["check"]["audio_err"]
    bad, err, mism, failing = 0, 0.0, 0, 0
    for k in sorted(got):
        g = got[k]
        if g.shape != want[k].shape or not np.all(np.isfinite(g)):
            bad += 1
            failing += 1
            continue
        e, m = audio_gap(g, want[k])
        err, mism = max(err, e), mism + m
        failing += int(e > limit or m > 0)
    return {"audio_err": {"value": err, "limit": limit},
            "mute_mismatch": {"value": mism, "limit": 0},
            "bad_shape": {"value": bad, "limit": 0}}, failing


class Reference:
    """The chain of one configuration (see the module's docstring).

    ``run(pool, blocks)`` returns, for each block index k in ``blocks``,
    the [C, n / ratio] audio of block k of the stream that replays
    ``pool`` ([P, n] complex64 on the host, block b = pool[b % P]): the
    chain is run from its initial state over the blocks before k that
    hold the configuration's ``ref_warmup_if_samples`` IF samples (from
    block 0 where there are fewer), the NCO phases at its first block
    taken from ``nco_phases``. Blocks run in lockstep, through the
    wideband part as many channels at a time as ``BUDGET`` allows."""

    def __init__(self, config: dict, n: int, *, device, control=False):
        cfg = config["bank"]
        self.precision = "tf32" if control else "float64"
        self.real = torch.float32 if control else torch.float64
        self.cplx = torch.complex64 if control else torch.complex128
        self.device = torch.device(device)
        self.mode = cfg["mode"]
        fs, if_rate = float(cfg["samplerate"]), float(cfg["if_rate"])
        self.offsets = (np.linspace(-cfg["span"] / 2, cfg["span"] / 2,
                                    cfg["channels"]) * fs)
        self.channels = self.offsets.shape[0]
        self.n = int(n)
        self.ratio = pre_ratio(fs, if_rate)
        if self.n % self.ratio:
            raise ValueError(f"block {n} is not a multiple of {self.ratio}")
        self.n_if = self.n // self.ratio
        self.warmup = -(-int(config["ref_warmup_if_samples"]) // self.n_if)
        self.stages = decim_stages(self.ratio)
        bw = min(float(cfg["bandwidth"]), if_rate)
        self.chan_taps = low_pass(bw / 2, bw / 2 * 0.1, if_rate)
        # the bank mixes by -offset (the VFO centres its channel)
        self.omegas = TWO_PI * (-self.offsets / fs)
        self.squelch = cfg.get("squelch_db")
        band = float(cfg["bandwidth"])
        if self.mode == "nfm":
            self.inv_dev = 1.0 / (TWO_PI * (band / 2 / if_rate))
            self.audio_taps = low_pass(band / 2, band / 2 * 0.1, if_rate)
        elif self.mode == "usb":
            self.shift = TWO_PI * (band / 2 / if_rate)
            agc = cfg["agc"]
            self.agc = dict(set_point=1.0, attack=agc["attack"] / if_rate,
                            decay=agc["decay"] / if_rate,
                            max_gain=agc["max_gain"],
                            max_output_amp=agc["max_output_amp"])
        else:
            raise NotImplementedError(f"mode {self.mode!r}")

    # ---- pieces -----------------------------------------------------------

    def _fir(self, tail, x, taps, r):
        """y[k] = sum_j taps[j] buf[r k + j], buf = [tail | x] (fir.h,
        decimating_fir.h); real or complex x over any leading axes, real
        taps. Returns (new tail, y). In float64 a long filter without
        decimation is the same sum taken through the FFT (to ~1e-15 of
        the block); in TF32 every filter is a direct convolution, whose
        products are what TF32 rounds."""
        m = taps.shape[0]
        buf = torch.cat([tail, x], dim=-1)
        lead, length = buf.shape[:-1], buf.shape[-1]
        if r == 1 and m > 64 and self.precision == "float64":
            nfft = 1 << (length + m - 2).bit_length()
            h = torch.as_tensor(taps[::-1].copy(), dtype=self.real,
                                device=self.device)
            if buf.is_complex():
                full = torch.fft.ifft(torch.fft.fft(buf, nfft)
                                      * torch.fft.fft(h, nfft))
            else:
                full = torch.fft.irfft(torch.fft.rfft(buf, nfft)
                                       * torch.fft.rfft(h, nfft), nfft)
            return buf[..., length - (m - 1):], full[..., m - 1:length]
        if buf.is_complex():
            planes = torch.view_as_real(buf).movedim(-1, -2)
        else:
            planes = buf[..., None, :]
        planes = planes.reshape(-1, 1, length)
        w = torch.as_tensor(taps, dtype=self.real,
                            device=self.device).view(1, 1, m)
        if self.precision == "tf32":
            planes, w = tf32_round(planes), tf32_round(w)
        out = F.conv1d(planes, w, stride=r)
        if buf.is_complex():
            out = out.reshape(*lead, 2, -1).movedim(-2, -1)
            y = torch.view_as_complex(out.contiguous())
        else:
            y = out.reshape(*lead, -1)
        return buf[..., buf.shape[-1] - (m - 1):], y

    def _ramp(self, omegas, n):
        """(i * omega) mod 2 pi, i < n, float64, [len(omegas), n]."""
        i = torch.arange(n, dtype=torch.float64, device=self.device)
        w = torch.as_tensor(omegas, dtype=torch.float64, device=self.device)
        return torch.remainder(i[None, :] * w[:, None], TWO_PI)

    def _mix(self, x, phase0, ramp):
        ph = (torch.as_tensor(phase0, dtype=torch.float64,
                              device=self.device)[..., None] + ramp)
        ph = ph.to(self.real)
        return x * torch.polar(torch.ones_like(ph), ph)

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

    def _agc_consts(self):
        """agc.h's constants, floats as there, its 1 - rate too (at decay
        5 / 48000 that float is 3e-4 off 1 - decay in the rate itself)."""
        f = {k: np.float32(v) for k, v in self.agc.items()}
        dt = np.float64 if self.precision == "float64" else np.float32
        c = {k: dt(f[k]) for k in ("set_point", "attack", "decay",
                                   "max_gain", "max_output_amp")}
        c["inv_attack"] = dt(np.float32(1.0) - f["attack"])
        c["inv_decay"] = dt(np.float32(1.0) - f["decay"])
        return c

    @staticmethod
    def _amp_run(a, amp, c):
        """The amplitude recurrence without the clip branch over a [t,
        lanes]: attack where a > amp, else decay; a zero input leaves amp
        as it is."""
        c1 = np.array([c["inv_decay"], c["inv_attack"]])
        c2 = np.array([c["decay"], c["attack"]])
        out = np.empty_like(a)
        zeros = not a.all()
        for t in range(a.shape[0]):
            x = a[t]
            up = (x > amp).view(np.int8)
            new = amp * c1[up] + x * c2[up]
            amp = np.where(x != 0, new, amp) if zeros else new
            out[t] = amp
        return out

    def _agc(self, state, y):
        """agc.h over one block of real audio [lanes, n], on the host:
        amplitude tracking with attack / decay, gain set_point / amp
        capped at max_gain, and where an output would exceed
        max_output_amp the amplitude jumps to the rest of the block's
        peak (the look-ahead). The steps run 4,096 at a time as
        ``_amp_run``; from a step that clips, the whole body runs it and
        the run starts again after it."""
        c = self._agc_consts()
        sp, mg, mo = c["set_point"], c["max_gain"], c["max_output_amp"]
        yy = y.cpu().numpy().astype(type(sp))  # [lanes, n], scaled in place
        amp, gain = state
        t, n = 0, yy.shape[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            while t < n:
                a = np.abs(yy[:, t:t + 4096]).T.copy()  # [steps, lanes]
                amps = self._amp_run(a, amp, c)
                g = np.where(a != 0, np.minimum(sp / amps, mg), 1.0)
                hit = np.flatnonzero((a * g > mo).any(axis=1))
                m = int(hit[0]) if hit.size else a.shape[0]
                yy[:, t:t + m] *= g[:m].T
                if m:
                    amp, gain = amps[m - 1], g[m - 1]
                t += m
                if not hit.size:
                    continue
                x = a[m]
                nz = x != 0
                upd = np.where(x > amp,
                               amp * c["inv_attack"] + x * c["attack"],
                               amp * c["inv_decay"] + x * c["decay"])
                amp1 = np.where(nz, upd, amp)
                g1 = np.where(nz, np.minimum(sp / amp1, mg), 1.0)
                clip = x * g1 > mo
                amp = np.where(clip, np.abs(yy[:, t:]).max(axis=1), amp1)
                gain = np.where(clip, np.minimum(sp / amp, mg), g1)
                yy[:, t] *= gain
                t += 1
        return (amp, gain), torch.as_tensor(yy, device=self.device)

    # ---- the chain --------------------------------------------------------

    def run(self, pool: np.ndarray, blocks) -> dict:
        """{k: [C, n_if] float64 (float32 for the control) numpy audio}."""
        warmup = self.warmup
        blocks = sorted(set(int(k) for k in blocks))
        out = {}
        # lockstep groups: every block with the full warm-up together,
        # those nearer the stream's start each on its own
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
        # per-stage and channel-filter tails [J, C, m - 1]
        zeros = lambda m: torch.zeros((J, C, m - 1), dtype=self.cplx,
                                      device=self.device)
        tails = [zeros(t.shape[0]) for _, t in self.stages]
        chan_tail = zeros(self.chan_taps.shape[0])
        sq = (np.zeros((J, C), bool), np.zeros((J, C), np.int64))
        if self.mode == "nfm":
            last = torch.zeros((J, C, 1), dtype=self.cplx, device=self.device)
            a_tail = torch.zeros((J, C, self.audio_taps.shape[0] - 1),
                                 dtype=self.real, device=self.device)
        else:
            shift_ph = nco_phases(np.array([self.shift]), self.n_if,
                                  max(starts) + warmup + 1)[:, 0]
            shift_ramp = self._ramp(np.array([self.shift]), self.n_if)[0]
            c = self._agc_consts()
            agc = (np.zeros(J * C, type(c["set_point"])),
                   np.full(J * C, c["max_gain"]))
        audio = None
        for s in range(warmup + 1):
            bidx = [st + s for st in starts]
            x = torch.as_tensor(np.stack([pool[b % P] for b in bidx]),
                                device=self.device).to(self.cplx)
            ifs = []
            group = max(1, min(C, BUDGET // (J * self.n)))
            for c0 in range(0, C, group):
                cs = slice(c0, min(C, c0 + group))
                ph0 = np.stack([phases[b, cs] for b in bidx])  # [J, G]
                y = self._mix(x[:, None, :], ph0,
                              self._ramp(self.omegas[cs], self.n))
                for i, (r, taps) in enumerate(self.stages):
                    tails[i][:, cs], y = self._fir(tails[i][:, cs], y, taps,
                                                   r)
                ifs.append(y)
            y = torch.cat(ifs, dim=1)  # [J, C, n_if]
            chan_tail, y = self._fir(chan_tail, y, self.chan_taps, 1)
            if self.squelch is not None:
                sq, y = self._squelch(sq, y)
            if self.mode == "nfm":
                prev = torch.cat([last, y[..., :-1]], dim=-1)
                last = y[..., -1:]
                prod = y * torch.conj(prev)
                d = torch.atan2(prod.imag, prod.real) * self.inv_dev
                a_tail, audio = self._fir(a_tail, d.to(self.real),
                                          self.audio_taps, 1)
            else:
                ph0 = np.array([shift_ph[b] for b in bidx])  # [J]
                z = self._mix(y, ph0[:, None], shift_ramp[None, :])
                agc, a = self._agc(agc, z.real.reshape(J * C, -1))
                audio = a.reshape(J, C, -1)
        audio = audio.cpu().numpy()
        return {k: audio[j] for j, k in enumerate(ks)}
