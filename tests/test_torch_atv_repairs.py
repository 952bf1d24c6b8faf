"""ATVDecoder's chroma band-pass at the subcarrier: the port passes +w0,
where the reference's correlation (and the JAX package's) passes -w0.

The reference's 231 complex chroma taps go to ``fir_correlate``, the
sliding correlation y[i] = sum_j taps[j] x[i + j], whose gain at w is
|sum_j taps[j] exp(i w j)|: 6.6e-6 at the PAL subcarrier w0 = 2 pi
4433618.75 / 11.25e6 and 0.9946 at -w0, so a real burst reaches ChromaPLL
as its negative image, which the loop (tracking +w0) never locks on. The
port gives the correlation the taps reversed (``chroma_filter_taps``), the
convolution they were designed for. The JAX package keeps the table's
order, and its decoder's route is run here as it is, to document the
fault.

Signals: ``pal_composite``, PAL-like lines at 11.25 Msps (720 samples a
line) FM modulated at the decoder's deviation fs / 2, made from a numpy
seed: a 4.7-us sync tip (53 samples), the colour burst on the back porch
over the samples ChromaPLL's window reads (the FIR's delay before it) at
+-135 degrees by line, active video with a chroma carrier, or colour bars
of known (U, V) with the PAL V-switch. chip_smoke.py's ``atv_composite``
is the same signal.

Tolerances, each with its reason:
- FILTER_PASS = 0.99, FILTER_STOP = 1e-4: the taps' gains at +-w0 (0.9946
  and 6.6e-6), measured on tones through the decoder's own filter call.
- LOCK_TOL = 0.05 rad: the mean over the last 100 lines of |a line's
  burst error|, the angle of the line's mixed burst samples summed,
  against the line's PAL reference (chip_smoke's ATV_LOCK_TOL). The burst
  is 28 samples through a filter whose envelope is ~70 samples wide, so
  single samples at the window's edges sit on its rise and fall (their
  own angles off by up to ~0.25 rad); the sum weighs them by their
  amplitude, as the loop's phase does. UNLOCKED = 1 rad: a loop that
  never meets its burst spreads this error uniformly (mean pi / 2).
- HUE_TOL = 0.1 rad: each bar's decoded chroma against the first bar's,
  after the V-switch is undone, against the encoded angle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdrpp_tpu.decoders import atv as jatv
from sdrpp_tpu_torch.decoders import atv as tatv
from sdrpp_tpu_torch.ops.fir import fir_correlate

torch.set_num_threads(1)

FILTER_PASS = 0.99
FILTER_STOP = 1e-4
LOCK_TOL = 0.05
UNLOCKED = 1.0
HUE_TOL = 0.1
L = tatv.LINE_LEN
BLOCK = tatv.FRAME_LINES * L          # one PAL frame, 40 ms
W0 = 2 * np.pi * tatv.CHROMA_SUBCARRIER / tatv.SAMPLE_RATE
SYNC_TIP = 53                          # 4.7 us
ACTIVE = (128, 703)                    # active video, after the back porch
# 75 % colour bars (U, V) = (0.493 (B - Y), 0.877 (R - Y)): yellow, cyan,
# green, magenta, scaled to a chroma amplitude of ~0.1
BARS_UV = 0.25 * np.array([(-0.328, 0.075), (0.110, -0.461),
                           (-0.217, -0.386), (0.217, 0.386)])
BAR_EDGES = (130, 240, 350, 460, 570)  # each bar's video samples
BAR_MARGIN = 35                        # the filter's half width


def pal_composite(n_lines: int, bars: bool = False, seed: int = 8):
    """PAL-like composite video at 11.25 Msps, FM modulated with a
    deviation of fs / 2: each line a sync tip (samples [0, 53) at -0.3),
    blanking (0) on the porches, the colour burst (0.15, at the
    subcarrier) over the samples ChromaPLL's window reads, its phase
    A_PHASE on odd lines and B_PHASE on even ones, and active video in
    [128, 703): a grey ramp with a chroma carrier of 0.1, or (``bars``)
    luma 0.3 under four colour bars of BARS_UV, their V negated on the
    B_PHASE lines (the PAL V-switch: the burst at +135 degrees marks +V);
    then seeded noise of 0.005."""
    k = np.arange(L)
    line = np.where(k < SYNC_TIP, -0.3, 0.0)
    a0, a1 = ACTIVE
    act = (k >= a0) & (k < a1)
    line[act] = 0.3 if bars else 0.1 + 0.3 * (k[act] - a0) / (a1 - a0)
    t = np.arange(n_lines * L)
    kk, ll = t % L, t // L
    a_line = ll % 2 == 1
    theta = np.where(a_line, tatv.A_PHASE, tatv.B_PHASE)
    delay = tatv.CHROMA_FIR_DELAY
    burst = (kk >= tatv.BURST_START - delay) & (kk < tatv.BURST_END - delay)
    video = line[kk] + 0.15 * np.cos(W0 * t + theta) * burst
    if bars:
        for (u, v), b0, b1 in zip(BARS_UV, BAR_EDGES, BAR_EDGES[1:]):
            on = (kk >= b0) & (kk < b1)
            c = u + 1j * np.where(a_line, v, -v)
            video = video + np.real(c * np.exp(1j * W0 * t)) * on
    else:
        video = video + 0.1 * np.cos(W0 * t) * act[kk]
    video += 0.005 * np.random.default_rng(seed).standard_normal(len(t))
    return np.exp(1j * np.cumsum(np.pi * video)).astype(np.complex64)


class _Chroma:
    """Wraps a ChromaPLL: calls it and keeps each call's mixed lines and
    reference phases (numpy)."""

    def __init__(self, pll):
        self.pll, self.calls = pll, []

    def __getattr__(self, name):
        return getattr(self.pll, name)

    def __call__(self, state, lines, refs):
        st, mixed = self.pll(state, lines, refs)
        self.calls.append((mixed.cpu().numpy(), refs.cpu().numpy()))
        return st, mixed


def burst_errors(mixed, refs):
    """Each line's burst error (rad): the angle of its mixed burst samples
    summed, against the line's reference phase."""
    b = mixed[:, tatv.BURST_START:tatv.BURST_END].sum(axis=1)
    return np.angle(b * np.exp(-1j * refs))


def port_mixed(iq, blocks):
    """The port's ATVDecoder (CPU) over ``blocks`` 40-ms blocks of ``iq``:
    the last block's mixed lines and reference phases."""
    dec = tatv.ATVDecoder(device="cpu")
    dec.pll = tap = _Chroma(dec.pll)
    for b in range(blocks):
        dec.process(iq[b * BLOCK:(b + 1) * BLOCK])
    return tap.calls[-1]


def jax_mixed(iq, blocks, port_loop):
    """The JAX ATVDecoder's own route (its taps in the table's order) over
    the same blocks, process() step by step: the last block's mixed lines
    and reference phases. ``port_loop``: its ChromaPLL at the port's
    bandwidth and limits, so that only the filter differs."""
    dec = jatv.ATVDecoder()
    if port_loop:
        dec.pll = jatv.ChromaPLL(tatv.CHROMA_BANDWIDTH, L, jatv.BURST_START,
                                 jatv.BURST_END, init_freq=W0,
                                 min_freq=W0 - tatv.CHROMA_PULL,
                                 max_freq=W0 + tatv.CHROMA_PULL)
        dec.state["pll"] = dec.pll.init_state()
    for b in range(blocks):
        dec.state["quad"], dec.state["sync"], lines, valid = dec._front(
            dec.state["quad"], dec.state["sync"],
            jnp.asarray(iq[b * BLOCK:(b + 1) * BLOCK]))
        luma = np.asarray(lines)[np.asarray(valid)]
        _, aphase, _ = dec.assembler.plan(luma)
        refs = np.where(aphase, jatv.A_PHASE, jatv.B_PHASE).astype(
            np.float32)
        dec._fir_state, dec.state["pll"], mixed = dec._chroma(
            dec._fir_state, dec.state["pll"], jnp.asarray(luma),
            jnp.asarray(refs))
    return np.asarray(mixed), refs


def _tone_gain(sign: int) -> float:
    """The decoder's chroma filter (its own fir_correlate call) on a unit
    tone at sign * w0: the output's magnitude past the filter's length."""
    dec = tatv.ATVDecoder(device="cpu")
    n = 4096
    x = torch.from_numpy(np.exp(1j * sign * W0 * np.arange(n)).astype(
        np.complex64))
    _, y = fir_correlate(dec._fir_state, x, dec._taps, dec._spectrum(n))
    return float(np.abs(y.numpy()[len(dec._taps):]).mean())


@pytest.mark.parametrize("sign", [1, -1])
def test_chroma_filter_passes_the_subcarrier(sign):
    """The decoder's chroma band-pass passes +w0 (gain > FILTER_PASS) and
    stops -w0 (< FILTER_STOP); the table's order, which the JAX decoder
    feeds to the same correlation, does the opposite."""
    gain = _tone_gain(sign)
    k = np.arange(231)
    table = jatv.chroma_taps().astype(np.complex128)
    jax_gain = abs(np.sum(table * np.exp(1j * sign * W0 * k)))
    if sign > 0:
        assert gain > FILTER_PASS and jax_gain < FILTER_STOP
    else:
        assert gain < FILTER_STOP and jax_gain > FILTER_PASS


def test_chroma_filter_keeps_its_delay():
    """The filter's impulse response (the correlation on reversed taps
    convolves with the table) has a symmetric envelope exp(-i w0 k)
    table[k], so the delay stays CHROMA_FIR_DELAY: a burst sent at
    [BURST_START, BURST_END) less the delay leaves the filter with its
    energy centred in the window ChromaPLL reads, and most of it inside."""
    np.testing.assert_array_equal(tatv.chroma_filter_taps(),
                                  tatv.chroma_taps()[::-1])
    table = tatv.chroma_taps().astype(np.complex128)
    env = table * np.exp(-1j * W0 * np.arange(231))
    assert np.abs(env - env[::-1]).max() < 1e-6
    dec = tatv.ATVDecoder(device="cpu")
    k = np.arange(4 * L)
    d = tatv.CHROMA_FIR_DELAY
    on = (k >= L + tatv.BURST_START - d) & (k < L + tatv.BURST_END - d)
    mid = (tatv.BURST_START + tatv.BURST_END - 1) / 2
    # the analytic burst's energy centred on the window; the real burst's
    # image at -w0 (stopped to 6.6e-6 in steady state) leaks at its edges
    for tone, off in ((np.exp(1j * W0 * k), 0.01), (np.cos(W0 * k), 1.0)):
        x = torch.from_numpy((tone * on).astype(np.complex64))
        _, y = fir_correlate(dec._fir_state, x, dec._taps,
                             dec._spectrum(len(k)))
        e = np.abs(y.numpy()[L:2 * L]) ** 2
        assert e[tatv.BURST_START:tatv.BURST_END].sum() > 0.95 * e.sum()
        assert abs(np.sum(e * np.arange(L)) / e.sum() - mid) < off


@pytest.mark.parametrize("route", ["port", "jax_own", "jax_port_loop"])
def test_atv_decoder_locks_on_pal_composite(route):
    """Two PAL frames (two 40-ms blocks) through ATVDecoder: the port's
    loop locks through its own FIR, the mean |burst error| over the last
    100 lines below LOCK_TOL. The JAX decoder's own route on the same
    input stays unlocked (above UNLOCKED), with its own loop or with the
    port's (then only the filter differs)."""
    iq = pal_composite(2 * tatv.FRAME_LINES)
    if route == "port":
        mixed, refs = port_mixed(iq, 2)
    else:
        mixed, refs = jax_mixed(iq, 2, port_loop=route == "jax_port_loop")
    err = float(np.abs(burst_errors(mixed[-100:], refs[-100:])).mean())
    if route == "port":
        assert err < LOCK_TOL
    else:
        assert err > UNLOCKED


def bar_hues(mixed, refs):
    """Each colour bar's decoded chroma against the first bar's (rad), from
    the loop's mixed lines: each bar's interior (the filter's half width
    in from its edges, the filter's delay on) averaged over a line, the
    V-switch undone on the B_PHASE lines (conjugated), then averaged over
    the lines."""
    d = tatv.CHROMA_FIR_DELAY
    a_line = refs == np.float32(tatv.A_PHASE)
    m = np.stack([mixed[:, b0 + d + BAR_MARGIN:b1 + d - BAR_MARGIN].mean(
        axis=1) for b0, b1 in zip(BAR_EDGES, BAR_EDGES[1:])], axis=1)
    m = np.where(a_line[:, None], m, np.conj(m)).mean(axis=0)
    return np.angle(m * np.conj(m[0]))


def test_atv_decoder_keeps_colour_bar_hues():
    """Colour bars of known (U, V) with the PAL V-switch, two frames
    through the port's decoder: over the last 100 lines, each bar's hue
    against the first bar's equals the encoded angle within HUE_TOL, so
    A_PHASE and B_PHASE keep the burst and the active chroma in step."""
    mixed, refs = port_mixed(pal_composite(2 * tatv.FRAME_LINES, bars=True),
                             2)
    got = bar_hues(mixed[-100:], refs[-100:])
    uv = BARS_UV[:, 0] + 1j * BARS_UV[:, 1]
    want = np.angle(uv * np.conj(uv[0]))
    assert np.abs(np.angle(np.exp(1j * (got - want)))).max() < HUE_TOL
    assert float(np.abs(burst_errors(mixed[-100:], refs[-100:])).mean()) \
        < LOCK_TOL
