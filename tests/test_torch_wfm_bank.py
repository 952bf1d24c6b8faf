"""The port's ScannerBank in WFM mode with de-emphasis against the
benchmark's plain reference (benchmark/reference/wfm_bank.py: float64,
SDR++'s semantics, the pilot loop run as the exact sequential
recurrence), on seeded random recordings at a small size on the CPU: six
channels at 2.5 Msps, /8 to 312.5 kHz and the wfm-band-20m cell's 96/125
stage to 240 kHz, its AF plan (/4 and 4/5 to 48 kHz) and 75-us
de-emphasis, four blocks with state carried. Channels 0 and 4 carry a
mono programme (75 kHz deviation, no pilot), channel 2 a 19-kHz pilot,
1, 3 and 5 nothing (muted).

Tolerances, each over the RMS of the mono programme's audio (~0.45):

- ``TOL_MID`` 1e-5, L+R on every unmuted channel: float32 through the
  cascade, the polyphase stage, the FFT filters and the discriminator
  (measured up to 6e-7 over four seeds; taps rounded to float16 read
  9e-5);
- ``TOL_PILOT`` 2e-3, L-R on the pilot channel sample by sample, over
  that channel's own L-R RMS (~5e-4 of the scale: the 23-53 kHz noise
  brought down by the loop's doubled phase, there being no stereo
  programme): both loops lock on the pilot, so their phases agree to
  float32 rounding; at this size the port runs the loop chunk-parallel,
  and its lanes re-acquire within the loop's ~10-sample time constant
  inside their 128-sample warm-ups (measured 1.5e-4 to 2.3e-4 over four
  seeds; a loop whose phase is off by 1e-3 rad reads 6e-3 to 8e-3, by
  1e-2 rad 0.06 to 0.08);
- ``TOL_SIDE_RMS`` 2e-4, L-R on a channel without a pilot, by its RMS
  over the block: the loop tracks the pilot band's noise there, which
  float32's rounding moves by ~1 %, so its slips land on other samples
  than float64's and L-R is not comparable sample by sample (up to 0.09
  apart on a 20-Msps block), while its RMS is (measured up to 2.3e-5;
  the reference's ``stereo_gap`` compares it the same way);
- muted channels exactly 0 on both sides;
- block 0's first ``SKIP`` audio samples are left out: from zero state
  the channel filter's leading edge turns rounding differences into
  full-scale ones in the start-up transient (~200 samples).

A reference with its taps rounded to float16 fails ``TOL_MID``, and the
port with its pilot loop's output turned by 1e-3 rad fails ``TOL_PILOT``.
"""

import math

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import traffic  # noqa: E402
from benchmark.reference import wfm_bank as ref  # noqa: E402
from sdrpp_tpu_torch import cli  # noqa: E402
from sdrpp_tpu_torch.ops.scans import Deemphasis  # noqa: E402
from sdrpp_tpu_torch.parallel.vfo_bank import ScannerBank  # noqa: E402

FS = 2.5e6
N = 125_000            # 25 of the bank's 5,000-sample multiple
BLOCKS = 4
SKIP = 400
TOL_MID = 1e-5
TOL_PILOT = 2e-3
TOL_SIDE_RMS = 2e-4
CONFIG = {"bank": {"mode": "wfm", "channels": 6, "samplerate": FS,
                   "centre_hz": 98.0e6, "first_hz": 97.5e6,
                   "spacing_hz": 200e3, "if_rate": 240e3,
                   "bandwidth": 200e3, "audio_rate": 48e3,
                   "deemphasis": "75us", "squelch_db": -50.0,
                   "channelizer": "time"},
          "ref_warmup_if_samples": 10 ** 9,   # every block from block 0
          "check": {"audio_err": 1e-4}}
TRAFFIC = {"noise": 1e-3, "signals": [
    {"kind": "fm", "every": 4, "first": 0, "amplitude": 0.1,
     "index": 75.0, "tone_hz": 1000.0},
    {"kind": "fm", "every": 4, "first": 2, "amplitude": 0.1,
     "index": 0.355, "tone_hz": 19000.0}]}
KINDS = {"pilot": [2], "no_pilot": [0, 4], "muted": [1, 3, 5]}


def _bank(**kw):
    b = CONFIG["bank"]
    return ScannerBank(ref.channel_offsets(CONFIG), FS, mode="wfm",
                       if_rate=b["if_rate"], bandwidth=b["bandwidth"],
                       squelch_level=b["squelch_db"], device="cpu", **kw)


def _recording(seed):
    return traffic.make_recording(TRAFFIC, FS, ref.channel_offsets(CONFIG),
                                  seed, "cpu", block=N, pool_blocks=BLOCKS)


@pytest.fixture(scope="module", params=[20241019, 2 ** 33 + 7])
def run(request):
    """(port's audio, reference's audio), {block: [6, 2400, 2]} each."""
    pool = _recording(request.param)
    bank = _bank(deemphasis="75us")
    st, got = bank.init_state(), {}
    for k in range(BLOCKS):
        st, y = bank(st, torch.from_numpy(pool[k]))
        got[k] = y.numpy()
    want = ref.Reference(CONFIG, N, device="cpu").run(pool, range(BLOCKS))
    return got, want, pool


def _scale(want):
    return float(np.sqrt(np.mean(want[KINDS["no_pilot"]] ** 2)))


def _mid_side(a):
    return (a[..., 0] + a[..., 1]) / 2.0, (a[..., 0] - a[..., 1]) / 2.0


def _pilot_side_gap(gs, ws):
    """The widest L-R gap over the reference's own L-R RMS."""
    return float(np.abs(gs - ws).max() / _rms(ws))


def _rms(v):
    return np.sqrt(np.mean(v * v))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_wfm_bank_agrees_with_the_reference(run, kind):
    got, want, _ = run
    for k in range(BLOCKS):
        s = SKIP if k == 0 else 0
        g, w = got[k][:, s:], np.asarray(want[k])[:, s:]
        assert g.shape == w.shape == (6, 2400 - s, 2)
        scale = _scale(w)
        assert scale > 0.3   # the programme: 0.75 of the deviation
        for c in KINDS[kind]:
            assert bool(want[k].pilot[c]) == (kind == "pilot")
            if kind == "muted":
                assert not g[c].any() and not w[c].any()
                continue
            gm, gs = _mid_side(g[c].astype(np.float64))
            wm, ws = _mid_side(w[c])
            assert np.abs(gm - wm).max() <= TOL_MID * scale, (k, c)
            if kind == "pilot":
                assert _pilot_side_gap(gs, ws) <= TOL_PILOT, (k, c)
                assert _rms(ws) > 1e-4 * scale   # the noise L-R is there
            else:
                assert abs(_rms(gs) - _rms(ws)) <= TOL_SIDE_RMS * scale
                assert _rms(ws) > 1e-3 * scale   # there is an L-R to hold


def test_float16_taps_fail_the_tolerance(run):
    """The reference with every tap rounded to float16 (2^-11 of each
    tap) parts from the float64 one by more than ``TOL_MID``."""
    _, want, pool = run
    r = ref.Reference(CONFIG, N, device="cpu")

    def half(t):
        if np.iscomplexobj(t):
            return (half(t.real) + 1j * half(t.imag)).astype(t.dtype)
        return t.astype(np.float16).astype(t.dtype)

    for name in ("chan_taps", "audio_taps", "pilot_taps", "bank", "a_bank"):
        setattr(r, name, half(getattr(r, name)))
    r.stages = [(d, half(t)) for d, t in r.stages]
    r.a_stages = [(d, half(t)) for d, t in r.a_stages]
    k = BLOCKS - 1
    low = r.run(pool, [k])[k]
    w = np.asarray(want[k])
    err = max(np.abs(_mid_side(low[c])[0] - _mid_side(w[c])[0]).max()
              for c in KINDS["no_pilot"])
    assert err > TOL_MID * _scale(w)
    assert ref.stereo_gap(low, w, want[k].pilot)[0] > \
        ref.stereo_gap(np.asarray(want[k]), w, want[k].pilot)[0]


class _Turned:
    """A pilot loop whose output phasor is turned by ``angle`` rad."""

    def __init__(self, pll, angle):
        self.pll, self.turn = pll, complex(math.cos(angle), math.sin(angle))

    def init_state(self):
        return self.pll.init_state()

    def __call__(self, state, x):
        state, y = self.pll(state, x)
        return state, y * self.turn


def test_a_loop_off_phase_fails_the_pilot_tolerance(run):
    """The port with its pilot loop's phase off by 1e-3 rad: L-R on the
    pilot channel parts from the reference's by more than
    ``TOL_PILOT`` of its RMS, and the benchmark's pilot side gap reads
    above the program's, while L+R still agrees."""
    got, want, pool = run
    bank = _bank(deemphasis="75us")
    bank.demod.pilot_pll = _Turned(bank.demod.pilot_pll, 1e-3)
    st, c = bank.init_state(), KINDS["pilot"][0]
    for k in range(BLOCKS):
        st, y = bank(st, torch.from_numpy(pool[k]))
    k = BLOCKS - 1
    g, w = y.numpy(), np.asarray(want[k])
    gm, gs = _mid_side(g[c].astype(np.float64))
    wm, ws = _mid_side(w[c])
    assert np.abs(gm - wm).max() <= TOL_MID * _scale(w)
    assert _pilot_side_gap(gs, ws) > TOL_PILOT
    assert ref.stereo_gap(g, w, want[k].pilot)[1] > \
        ref.stereo_gap(got[k], w, want[k].pilot)[1]


def test_deemphasis_is_the_radio_af_stage_after_the_resampler(run):
    """The bank with de-emphasis is the bank without it, then
    ``Deemphasis`` over its stereo audio, bit for bit, its state carried
    under ``deemph``."""
    _, _, pool = run
    with_, without = _bank(deemphasis="75us"), _bank()
    de = Deemphasis(75e-6, 48000.0, stereo=True, lead_shape=(6,),
                    device="cpu")
    sa, sb, sd = with_.init_state(), without.init_state(), de.init_state()
    assert set(sa) == set(sb) | {"deemph"} and "deemph" not in sb
    for k in range(2):
        x = torch.from_numpy(pool[k])
        sa, ya = with_(sa, x)
        sb, yb = without(sb, x)
        sd, yd = de(sd, yb)
        assert torch.equal(ya, yd)
        assert torch.equal(sa["deemph"], sd)


BANK_KW = {"nfm": dict(bandwidth=12500.0, squelch_level=-50.0),
           "usb": dict(bandwidth=2700.0, squelch_level=-100.0)}


@pytest.mark.parametrize("mode", sorted(BANK_KW))
def test_no_deemphasis_leaves_nfm_and_usb_banks_as_they_were(mode):
    """Without the keyword, or with None, an NFM or USB bank is its
    stages composed as before it (VFO bank, squelch, demod), bit for
    bit, with the state tree it had; asked for de-emphasis it refuses."""
    offs, fs = np.array([-100e3, 0.0, 100e3]), 768e3
    kw = dict(mode=mode, if_rate=48000.0, device="cpu", **BANK_KW[mode])
    a, b = ScannerBank(offs, fs, **kw), ScannerBank(offs, fs, deemphasis=None,
                                                    **kw)
    assert a.deemph is None and b.deemph is None
    sa, sb = a.init_state(), b.init_state()
    assert set(sa) == set(sb) == {"vfo", "squelch", "demod", "af"}
    vs, qs, ds = sa["vfo"], sa["squelch"], sa["demod"]
    rng = np.random.default_rng(5)
    n = 16 * a.block_multiple
    for k in range(2):
        t = (k * n + np.arange(n)) / fs
        x = torch.from_numpy((0.3 * np.exp(1j * (2 * np.pi * 1e3 * t))
                              + 1e-3 * (rng.standard_normal(n) + 1j
                                        * rng.standard_normal(n))
                              ).astype(np.complex64))
        sa, ya = a(sa, x)
        sb, yb = b(sb, x)
        vs, y = a.vfo(vs, x)
        qs, y = a.squelch(qs, y)
        ds, y = a.demod(ds, y)
        assert torch.equal(ya, yb) and torch.equal(ya, y)
    with pytest.raises(ValueError, match="de-emphasis"):
        ScannerBank(offs, fs, deemphasis="75us", **kw)


def test_cli_bank_deemphasis(tmp_path):
    """``cli bank --mode wfm --deemphasis 75us`` writes one stereo
    recording a channel."""
    out = tmp_path / "bank"
    assert cli.main(["bank", "--source", "test:2500000",
                     "--offsets=-300e3,300e3", "--mode", "wfm",
                     "--if-rate", "240000", "--bandwidth", "200000",
                     "--deemphasis", "75us", "--blocks", "2",
                     "--block-size", "50000", "--device", "cpu",
                     "--out-dir", str(out)]) == 0
    assert len(list(out.glob("*.wav"))) == 2
