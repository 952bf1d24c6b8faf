"""Port parity for RadioChannel in all eight modes with every option of the
JAX constructor, the demodulators' other settings, and the IF-chain blocks
(NoiseBlanker, FMIFNoiseReduction, the manual-gain AGC).

The JAX pilot PLLs run with ``.interpret = True`` so both sides take the
same chunked-or-exact branch; the JAX full AGCs run their exact loop,
which the port's AGCs take at these blocks (their warm-up spans four
decay times; JAX's chunked branch is short of one, ROADMAP C).
Tolerances, with their reasons:

- RadioChannel audio (ROADMAP: audio within 0.1 dB): from zero state, over
  two blocks after the first quarter (the start-up transient, in which the
  AGCs lift ulp-level differences), the RMS difference is below -40 dB of
  the audio (so the levels agree within 0.1 dB); with JAX's state after
  block 2 carried in (``state_from_numpy``), block 3 below -60 dB;
- the state trees: the same keys, shapes and dtypes as JAX's, but the
  full AGCs' ``hist``, as long as the port's warm-up;
- ``BANDWIDTH_RANGES`` and ``clamp_bandwidth``: bit-exact;
- NoiseBlanker: the tracked amplitude within 1e-5 relative of a float64
  recurrence, and at least as close to it as JAX's associative scan;
- FMIFNoiseReduction: samples off near-ties (top two bins within 1e-4
  relative in |X|^2) within 1e-5 relative of JAX; a near-tie may pick the
  other bin on either side, and such flips stay below 0.1 % of samples on
  noise;
- the demodulators' settings: as RadioChannel, -40 dB settled.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.models import analog as janalog
from sdrpp_tpu.models.radio import BANDWIDTH_RANGES as JAX_RANGES
from sdrpp_tpu.models.radio import RadioChannel as JaxRadioChannel
from sdrpp_tpu.ops import resample as jresample
from sdrpp_tpu.ops.fm_if import FMIFNoiseReduction as JaxFMIF
from sdrpp_tpu.ops.scans import NoiseBlanker as JaxNoiseBlanker
from sdrpp_tpu.ops.scans import affine_scan as jax_affine_scan
from sdrpp_tpu_torch.models import analog
from sdrpp_tpu_torch.models.radio import (BANDWIDTH_RANGES, DEMOD_DEFAULTS,
                                          RadioChannel)
from sdrpp_tpu_torch.ops.fm_if import FMIFNoiseReduction
from sdrpp_tpu_torch.ops.scans import NoiseBlanker
from sdrpp_tpu_torch.utils.blocks import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

FS = 960000.0
OFFSET = 30000.0


@pytest.fixture(autouse=True)
def _zero_stuff(monkeypatch):
    # the JAX rational resamplers' CPU default unrolls thousands of slices
    monkeypatch.setattr(jresample, "POLYPHASE_MODE", "zero_stuff")


def _rms_db(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref = np.sqrt(np.mean(want ** 2)) + 1e-30
    return 20 * np.log10(np.sqrt(np.mean((got - want) ** 2)) / ref + 1e-30)


def _signal(n, seed=0):
    """An FM carrier (1 kHz tone, 3 kHz deviation) at OFFSET, an AM carrier
    (700 Hz) 20 kHz above it, seeded noise."""
    t = np.arange(n) / FS
    rng = np.random.default_rng(seed)
    tone = np.sin(2 * np.pi * 1000.0 * t)
    x = 0.3 * np.exp(1j * (2 * np.pi * OFFSET * t
                           + np.cumsum(2 * np.pi * 3000.0 * tone / FS)))
    x = x + 0.2 * (1 + 0.5 * np.sin(2 * np.pi * 700.0 * t)) \
        * np.exp(2j * np.pi * (OFFSET + 20000.0) * t)
    x = x + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _interpret(block):
    """Put the pilot PLL of a JAX demodulator in interpret mode, so both
    sides take the same chunked-or-exact branch. The full AGCs stay on
    JAX's exact loop: the port's warm-up spans four decay times and runs
    exact at these blocks, where JAX's chunked branch (a 2048-sample
    warm-up, shorter than 1 / decay) would chunk (ROADMAP C)."""
    for name in ("pilot_pll",):
        loop = getattr(block, name, None)
        if loop is not None and hasattr(loop, "interpret"):
            loop.interpret = True


def _audio(y):
    return y[0] if isinstance(y, tuple) else y


def _run_jax(block, x, nb, blocks=3):
    step = jax.jit(block)
    st = block.init_state()
    outs, states = [], []
    for k in range(blocks):
        st, y = step(st, jnp.asarray(x[k * nb:(k + 1) * nb]))
        outs.append(jax.tree_util.tree_map(np.asarray, y))
        states.append(jax.tree_util.tree_map(np.asarray, st))
    return outs, states


def _leaves_match(jtree, ttree):
    """Two state trees: the same structure, and each leaf the same dtype
    and shape, but a full AGC's ``hist`` (the last input amplitudes its
    chunked lanes warm up on), which is longer in the port: its warm-up
    spans four decay times (``scans_kernels.AGCChunked``), JAX's 2048
    samples (ROADMAP C)."""
    jl, jd = jax.tree_util.tree_flatten_with_path(jtree)
    tl, td = jax.tree_util.tree_flatten_with_path(ttree)
    assert jd == td
    for (path, a), (_, b) in zip(jl, tl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        if a.shape != b.shape:
            assert getattr(path[-1], "key", None) == "hist", path
            assert a.shape[:-1] == b.shape[:-1], path
            assert a.shape[-1] == 2048 < b.shape[-1], path


def _hold(port, jblock, x, nb):
    """The parity contract above, for a block of either package."""
    jout, jstates = _run_jax(jblock, x, nb)
    st = port.init_state()
    got = []
    for k in range(2):
        st, y = port(st, torch.from_numpy(x[k * nb:(k + 1) * nb]))
        got.append(_audio(y).numpy())
    _leaves_match(jstates[0], state_to_numpy(st))
    want = np.concatenate([_audio(y) for y in jout[:2]])
    got = np.concatenate(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    s = len(want) // 4
    assert _rms_db(got[s:], want[s:]) < -40.0
    _, y3 = port(state_from_numpy(jstates[1], "cpu"),
                 torch.from_numpy(x[2 * nb:3 * nb]))
    assert _rms_db(_audio(y3).numpy(), _audio(jout[2])) < -60.0
    return jout, y3


CHANNELS = [(mode, {}) for mode in DEMOD_DEFAULTS] + [
    ("nfm", dict(noise_blanker=True, fm_if_nr=True)),
    ("am", dict(noise_blanker=True, squelch_level=-80.0)),
    ("wfm", dict(rds=True, deemphasis="75us")),
    ("wfm", dict(stereo_wfm=False, deemphasis="50us")),
    ("raw", dict(audio_rate=32000.0, deemphasis="22us")),
    ("cw", dict(noise_blanker=True)),
    ("nfm", dict(dynamic_offset=True, dynamic_bandwidth=True)),
    ("usb", dict(dynamic_bandwidth=True)),
    ("am", dict(dynamic_offset=True, dynamic_bandwidth=True)),
    ("wfm", dict(dynamic_bandwidth=True, rds=True)),
    ("raw", dict(dynamic_offset=True, dynamic_bandwidth=True)),
]


@pytest.mark.parametrize("mode,opts", CHANNELS,
                         ids=[f"{m}-{'-'.join(o) or 'default'}"
                              for m, o in CHANNELS])
def test_radio_channel_matches_jax(mode, opts):
    jchan = JaxRadioChannel(mode, FS, offset=OFFSET, **opts)
    _interpret(jchan.demod)
    chan = RadioChannel(mode, FS, offset=OFFSET, device="cpu", **opts)
    assert chan.block_multiple == jchan.block_multiple
    assert (chan.if_rate, chan.bandwidth, chan.stereo_out) == \
        (jchan.if_rate, jchan.bandwidth, jchan.stereo_out)
    nb = chan.block_multiple * max(1, 48000 // chan.block_multiple)
    jout, y3 = _hold(chan, jchan, _signal(3 * nb), nb)
    if chan.rds:
        want = jout[2][1]
        assert y3[1].shape == want.shape and y3[1].dtype == torch.complex64
        assert _rms_db(torch.view_as_real(y3[1]).numpy(),
                       want.view(np.float32).reshape(-1, 2)) < -60.0


def test_block_multiples_at_the_slice_rate():
    """The multiples the 2.4 Msps radio-options block (652,800 = 34 x
    19,200) is built from, as JAX has them."""
    want = {("wfm", True): 4800, ("cw", False): 6400, ("am", False): 1600,
            ("raw", False): 800, ("nfm", False): 800, ("wfm", False): 200}
    for (mode, rds), m in want.items():
        chan = RadioChannel(mode, 2.4e6, rds=rds, device="cpu")
        assert chan.block_multiple == m == JaxRadioChannel(
            mode, 2.4e6, rds=rds).block_multiple
        assert 652800 % m == 0


def test_bandwidth_ranges_and_clamp():
    assert BANDWIDTH_RANGES == JAX_RANGES
    for mode in BANDWIDTH_RANGES:
        chan = RadioChannel(mode, FS, dynamic_bandwidth=True, device="cpu")
        jchan = JaxRadioChannel(mode, FS, dynamic_bandwidth=True)
        for bw in (1.0, 9.9, 500.0, 2700.0, 12345.6, 1e5, 1e9):
            assert chan.clamp_bandwidth(bw) == jchan.clamp_bandwidth(bw)


DEMODS = [
    ("am", dict(agc_mode="off"), 24000.0),
    ("am", dict(agc_mode="carrier"), 24000.0),
    ("ssb", dict(mode="usb", agc_enabled=False), 48000.0),
    ("ssb", dict(mode="lsb", agc_enabled=False), 48000.0),
    ("cw", dict(agc_enabled=False), 3000.0),
    ("nfm", dict(low_pass=False, high_pass=True), 48000.0),
    ("nfm", dict(low_pass=True, high_pass=True), 48000.0),
    ("nfm", dict(low_pass=False, high_pass=False), 48000.0),
    ("nfm", dict(high_pass=True, dynamic_bandwidth=True), 48000.0),
    ("wfm", dict(stereo=False, low_pass=False), 240000.0),
    ("wfm", dict(stereo=True, low_pass=False, rds_out=True), 240000.0),
]
_CLASSES = {"am": "AMDemod", "ssb": "SSBDemod", "cw": "CWDemod",
            "nfm": "NFMDemod", "wfm": "WFMDemod"}


@pytest.mark.parametrize("kind,opts,fs", DEMODS,
                         ids=[f"{k}-{'-'.join(f'{a}={b}' for a, b in o.items())}"
                              for k, o, _ in DEMODS])
def test_demod_settings_match_jax(kind, opts, fs):
    """The settings RadioChannel does not select, on the demodulators."""
    jd = getattr(janalog, _CLASSES[kind])(samplerate=fs, **opts)
    _interpret(jd)
    d = getattr(analog, _CLASSES[kind])(samplerate=fs, device="cpu", **opts)
    nb = 9600 if fs > 10000.0 else 1500
    t = np.arange(3 * nb) / fs
    rng = np.random.default_rng(4)
    # a carrier 200 Hz off centre, FM by a 400 Hz tone, with AM and noise
    x = ((0.5 + 0.2 * np.sin(2 * np.pi * 300.0 * t))
         * np.exp(1j * (2 * np.pi * 200.0 * t
                        + 3.0 * np.sin(2 * np.pi * 400.0 * t)))
         + 0.01 * (rng.standard_normal(3 * nb)
                   + 1j * rng.standard_normal(3 * nb))).astype(np.complex64)
    _hold(d, jd, x, nb)


def _blanker_input(n, seed):
    rng = np.random.default_rng(seed)
    x = 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x[rng.integers(0, n, n // 200)] *= 40.0  # impulses
    x[rng.integers(0, n, n // 50)] = 0.0     # zeros hold the average
    return x.astype(np.complex64)


def _amps_f64(amp0, a):
    rate = np.float32(500.0 / 24000.0)
    out = np.empty(len(a))
    amp = float(amp0)
    for i, v in enumerate(np.asarray(a, np.float64)):
        if v != 0.0:
            amp = (1.0 - float(rate)) * amp + float(rate) * v
        out[i] = amp
    return out


def test_noise_blanker_matches_float64_and_jax():
    n = 20000  # 79 scan blocks: three levels of the blocked scan
    x = _blanker_input(2 * n, 5)
    nb, jnb = (NoiseBlanker(500.0 / 24000.0, 10.0, device="cpu"),
               JaxNoiseBlanker(500.0 / 24000.0, 10.0))
    rate = np.float32(500.0 / 24000.0)
    st, jst = nb.init_state(), jnb.init_state()
    amp0 = 1.0
    for k in range(2):
        blk = x[k * n:(k + 1) * n]
        a = np.abs(blk).astype(np.float32)
        want = _amps_f64(amp0, a)
        nz = a != 0
        got = nb.amps(st, torch.from_numpy(a)).numpy()
        jgot = np.asarray(jax_affine_scan(
            jnp.where(nz, np.float32(1.0) - rate, np.float32(1.0)),
            jnp.where(nz, rate * a, np.float32(0.0)), jst))
        err = np.abs(got - want).max() / np.abs(want).max()
        jerr = np.abs(jgot - want).max() / np.abs(want).max()
        assert err < 1e-5 and err <= jerr, (err, jerr)
        st, y = nb(st, torch.from_numpy(blk))
        jst, jy = jnb(jst, jnp.asarray(blk))
        np.testing.assert_allclose(float(st), want[-1], rtol=1e-5)
        jy = np.asarray(jy)
        assert np.abs(y.numpy() - jy).max() <= 1e-4 * np.abs(jy).max()
        # the impulses are cut to level * the running mean
        assert np.abs(y.numpy()).max() < 0.5 * np.abs(blk).max()
        amp0 = want[-1]


def test_noise_blanker_amps_short_and_batched():
    """Rows shorter than one scan block, batched, with zeros leading (the
    state held), trailing and everywhere (a row of zeros)."""
    rng = np.random.default_rng(6)
    a = np.abs(rng.standard_normal((4, 300))).astype(np.float32)
    a[rng.random((4, 300)) < 0.3] = 0.0
    a[0, :5] = 0.0
    a[1, -7:] = 0.0
    a[3] = 0.0
    y0 = (1.0 + rng.random(4)).astype(np.float32)
    nb = NoiseBlanker(0.1, 10.0, lead_shape=(4,), device="cpu")
    got = nb.amps(torch.from_numpy(y0), torch.from_numpy(a)).numpy()
    rate = float(np.float32(0.1))
    want = np.empty((4, 300))
    y = y0.astype(np.float64)
    for i in range(300):
        y = np.where(a[:, i] != 0, (1.0 - rate) * y + rate * a[:, i], y)
        want[:, i] = y
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[0, :5], y0[0])
    np.testing.assert_array_equal(got[3], y0[3])


def test_fm_if_matches_jax_off_near_ties():
    rng = np.random.default_rng(7)
    n = 8192
    fm, jfm = FMIFNoiseReduction(32, device="cpu"), JaxFMIF(32)
    np.testing.assert_array_equal(fm.weight.numpy(), jfm._kernel)
    st, jst = fm.init_state(), jfm.init_state()
    t = np.arange(2 * n) / 48000.0
    # an FM carrier in noise: the kept bin follows the carrier
    x = (np.exp(1j * (2 * np.pi * 3000.0 * t
                      + 2.0 * np.sin(2 * np.pi * 500.0 * t)))
         + 0.3 * (rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n))
         ).astype(np.complex64)
    step = jax.jit(jfm)
    for k in range(2):
        blk = x[k * n:(k + 1) * n]
        buf = np.concatenate([state_to_numpy(st), blk])
        st, y = fm(st, torch.from_numpy(blk))
        jst, jy = step(jst, jnp.asarray(blk))
        jy, y = np.asarray(jy), y.numpy()
        # |X|^2 of every bin, float64, to find the near-ties
        win = np.lib.stride_tricks.sliding_window_view(buf, 32)[:n]
        w = fm.weight.numpy()
        spec = (win @ (w[:32, 0] - 1j * w[:32, 1]).T.astype(np.complex128))
        p = np.sort(np.abs(spec) ** 2, axis=1)
        tie = p[:, -1] - p[:, -2] <= 1e-4 * p[:, -1]
        close = np.abs(y - jy) <= 1e-5 * np.abs(jy).max()
        assert close[~tie].all(), np.flatnonzero(~close & ~tie)[:10]
        assert (~close).mean() <= 1e-3
    np.testing.assert_array_equal(state_to_numpy(st), np.asarray(jst))


def test_fm_if_flips_on_noise():
    """On noise alone the near-ties are common; the samples whose bin
    differs from JAX's stay under 0.1 %."""
    rng = np.random.default_rng(8)
    n = 16384
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    fm, jfm = FMIFNoiseReduction(32, device="cpu"), JaxFMIF(32)
    _, y = fm(fm.init_state(), torch.from_numpy(x))
    _, jy = jax.jit(jfm)(jfm.init_state(), jnp.asarray(x))
    jy = np.asarray(jy)
    flips = np.abs(y.numpy() - jy) > 1e-5 * np.abs(jy).max()
    assert flips.mean() <= 1e-3


@pytest.mark.parametrize("complex_in", [False, True])
def test_manual_gain_agc_matches_jax(complex_in):
    from sdrpp_tpu.ops.scans import AGC as JaxAGC
    from sdrpp_tpu_torch.ops.scans import AGC

    rng = np.random.default_rng(9)
    x = rng.standard_normal(4096).astype(np.float32) * 3.0
    if complex_in:
        x = (x + 1j * rng.standard_normal(4096) * 3.0).astype(np.complex64)
    x[::97] = 0.0
    kw = dict(set_point=1.0, attack=0.01, decay=0.001, max_gain=10e6,
              max_output_amp=4.0, init_gain=2.0, enabled=False)
    agc, jagc = AGC(device="cpu", **kw), JaxAGC(**kw)
    st, y = agc(agc.init_state(), torch.from_numpy(x))
    jst, jy = jagc(jagc.init_state(), jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    assert np.abs(y.numpy()).max() <= 4.0 * (1 + 1e-6)
    assert float(st["gain"]) == float(jst["gain"]) == 2.0


def test_invalid_settings_raise():
    with pytest.raises(ValueError, match="demod mode"):
        RadioChannel("fm", FS, device="cpu")
    with pytest.raises(ValueError, match="AGC mode"):
        analog.AMDemod(agc_mode="fast", device="cpu")
    chan = RadioChannel("nfm", FS, device="cpu")
    st = chan.init_state()
    for call in (lambda: chan.retune_state(st, 1000.0),
                 lambda: chan.set_bandwidth_state(st, 9000.0),
                 lambda: chan.set_squelch_state(st, -50.0)):
        with pytest.raises(ValueError):
            call()
