"""Port parity for the scanner-bank and wideband paths: the decimating-FIR
kernel's plain version, the power-of-2 decimator, the NCO bank, the
shared-FFT channelizer, VFOBank/ScannerBank in every mode, bench.py's
bank chains and ``cli bank``.

The same numpy-seeded inputs go through the JAX block (on the CPU; the
Pallas kernels in interpret mode, as the JAX package's own tests run
them) and the port's, over two or more blocks with state carried.
Tolerances, with their reasons:

- decimating FIR: the port sums the m taps in order (as its CUDA kernel
  does); the Pallas kernel and XLA's polyphase form sum phase by phase
  and then over the r lanes -> within 2e-5 of the output's peak, float32
  rounding of a 143-tap sum in another order;
- NCO bank and channelizer: cos/sin, FFTs (pocketfft vs XLA's) and
  complex products rounding differently -> within 5e-5 of the peak, the
  bound tests/test_channelizer.py holds the JAX channelizer to against
  its time-domain oracle;
- the banks: from zero state the channel filters fill for the first
  ~300 IF samples, where the NFM/WFM discriminators take the phase of
  near-zero samples and the AGCs lift rounding noise (up to full scale,
  in both packages alike); block 1 is compared from IF sample SETTLE on
  (WFM: audio sample WFM_SETTLE), later blocks whole. The AGCs and the
  pilot PLL carry ulp-level differences for a while after (up to 3e-4 of
  a channel's peak where an AGC is still settling), so the audio is held
  at an RMS difference below -60 dB, the bound test_torch_slice.py holds
  the receiver's audio to; with the JAX state carried into the port, the
  NFM and USB banks agree within 2e-5 of the peak;
- the NFM-bank golden: below -40 dB from IF sample SETTLE on, the bound
  of tests/test_golden.py (the golden itself starts from zero state);
- bench.py's chains: the NFM banks' audio within 1e-4 of the peak;
- the state trees: the same structure, dtypes and shapes, but a full
  AGC's ``hist``, as long as the port's warm-up (four decay times, where
  JAX's is 2048 samples, ROADMAP C).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.ops import channelizer as jch
from sdrpp_tpu.ops import fir as jfir
from sdrpp_tpu.ops import fm as jfm
from sdrpp_tpu.ops import mix as jmix
from sdrpp_tpu.ops import resample as jresample
from sdrpp_tpu.ops import scans as jscans
from sdrpp_tpu.ops import taps as jtaps
from sdrpp_tpu.parallel import vfo_bank as jvb
from sdrpp_tpu_torch.ops import channelizer as tch
from sdrpp_tpu_torch.ops import fir_kernels as FK
from sdrpp_tpu_torch.ops import mix as tmix
from sdrpp_tpu_torch.ops import resample as tresample
from sdrpp_tpu_torch.parallel import vfo_bank as tvb
from sdrpp_tpu_torch.parallel import wideband as twb
from sdrpp_tpu_torch.utils.blocks import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "golden_chains.npz"
FIR_TOL = 2e-5
CHAN_TOL = 5e-5
BANK_TOL = 1e-4
CARRIED_TOL = 2e-5
SETTLE = 400          # IF samples of the zero-state start-up transient
WFM_SETTLE = 150      # WFM audio samples (IF / 5) of the same
OFFS = np.array([-100e3, 3e3, 150e3])


def _signal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _close(want, got, tol, skip=0):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    err = float(np.abs(want[..., skip:] - got[..., skip:]).max())
    assert err <= tol * scale, (err, scale)


def _rms_db(want, got):
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    ref = np.sqrt(np.mean(np.asarray(want, np.float64) ** 2)) + 1e-30
    return 20 * np.log10(np.sqrt(np.mean(d ** 2)) / ref + 1e-30)


def _trees_match(jstate, tstate):
    _leaves_match(jstate, state_to_numpy(tstate))


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


def _interpret(block):
    """Pallas loops of a JAX block tree in interpret mode, so both sides
    take the same chunked-or-exact branch."""
    for v in vars(block).values():
        if hasattr(v, "interpret"):
            v.interpret = True
        elif hasattr(v, "__dict__") and type(v).__module__.startswith(
                "sdrpp_tpu."):
            _interpret(v)


# ---- the decimating-FIR kernel's plain version --------------------------

def test_decimating_fir_plain_matches_pallas(monkeypatch):
    """The /256 front end's /32, 143-tap stage at the Pallas kernel's own
    block (32 * 4096 samples), two blocks."""
    monkeypatch.setenv("SDRPP_TPU_PALLAS_INTERPRET", "1")
    from sdrpp_tpu.ops.fir_pallas import ROWS, decimating_fir_pallas

    r, taps = jresample.decim_plan(256)[0]
    assert (r, taps.shape[0]) == (32, 143)
    n = r * ROWS
    jt = jfir.fir_init_tail(taps.shape[0])
    tt = torch.zeros(taps.shape[0] - 1, dtype=torch.complex64)
    w = torch.from_numpy(taps.astype(np.float32))
    for k in range(2):
        x = _signal(n, k)
        jt, jy = decimating_fir_pallas(jt, jnp.asarray(x), taps, r)
        tt, ty = FK.decimating_fir_plain(tt, torch.from_numpy(x), w, r)
        _close(jy, ty.numpy(), FIR_TOL)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


@pytest.mark.parametrize("lead,n,ratio,dtype", [
    ((2,), 32 * 300, 256, np.complex64),   # rows; n the Pallas kernel refuses
    ((), 256, 8192, np.complex64),         # /128, 726 taps: n < m - 1
    ((3,), 16 * 64, 128, np.float32),      # float rows, /16
])
def test_decimating_fir_plain_matches_correlate(lead, n, ratio, dtype):
    from sdrpp_tpu.ops.fir_pallas import pallas_decim_supported

    r, taps = jresample.decim_plan(ratio)[0]
    assert not pallas_decim_supported(n, len(lead) + 1, r)
    m = taps.shape[0]
    jt = jfir.fir_init_tail(m, dtype, lead)
    tt = torch.zeros((*lead, m - 1), dtype=torch.from_numpy(
        np.zeros(0, dtype)).dtype)
    w = torch.from_numpy(taps.astype(np.float32))
    for k in range(3):
        x = _signal((*lead, n), 10 + k)
        if dtype == np.float32:
            x = x.real.copy()
        jt, jy = jfir.decimating_fir_correlate(jt, jnp.asarray(x), taps, r)
        tt, ty = FK.decimating_fir(tt, torch.from_numpy(x), w, r)
        _close(jy, ty.numpy(), FIR_TOL)
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


def test_decimating_fir_wrapper_takes_the_plain_version_only_on_the_cpu():
    r, taps = jresample.decim_plan(64)[0]
    w = torch.from_numpy(taps.astype(np.float32))
    x = torch.from_numpy(_signal(r * 50, 3))
    tail = torch.zeros(taps.shape[0] - 1, dtype=torch.complex64)
    before = FK.decimating_fir.launches
    a = FK.decimating_fir(tail, x, w, r)
    b = FK.decimating_fir_plain(tail, x, w, r)
    assert FK.decimating_fir.launches == before  # no kernel on the CPU
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        FK.decimating_fir(tail.to("meta"), x.to("meta"), w.to("meta"), r)
    with pytest.raises(ValueError, match="multiple"):
        FK.decimating_fir(tail, x[:-1], w, r)
    with pytest.raises(ValueError, match="tail"):
        FK.decimating_fir(tail[:-1], x, w, r)


def test_power_decimator_256_matches_jax_pallas(monkeypatch):
    """The whole /256 cascade against the JAX decimator with its Pallas
    stage engaged (SDRPP_TPU_DECIM_PALLAS=1, interpreted)."""
    monkeypatch.setenv("SDRPP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jresample, "DECIM_PALLAS", "1")
    j = jresample.PowerDecimator(256)
    t = tresample.PowerDecimator(256, device="cpu")
    js, ts = j.init_state(), t.init_state()
    for k in range(2):
        x = _signal(1 << 17, 20 + k)
        js, jy = j(js, jnp.asarray(x))
        ts, ty = t(ts, torch.from_numpy(x))
        _close(jy, ty.numpy(), FIR_TOL)
    # stage 1's tail is raw input; the later stages' hold filtered samples
    np.testing.assert_array_equal(np.asarray(js[0]), ts[0].numpy())
    for a, b in zip(js[1:], ts[1:]):
        _close(a, b.numpy(), FIR_TOL)


# ---- NCO bank and channelizer -------------------------------------------

@pytest.mark.parametrize("shared", [True, False])
def test_frequency_xlator_bank(shared):
    j = jmix.FrequencyXlatorBank(-OFFS, 768e3)
    t = tmix.FrequencyXlatorBank(-OFFS, 768e3, device="cpu")
    js, ts = j.init_state(), t.init_state()
    step = jax.jit(j)
    for k in range(2):
        x = _signal(6000 if shared else (3, 6000), 30 + k)
        js, jy = step(js, jnp.asarray(x))
        ts, ty = t(ts, torch.from_numpy(x))
        _close(jy, ty.numpy(), CHAN_TOL)
    _close(js, ts.numpy(), CHAN_TOL)


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("bandwidth", [12500.0, None])
def test_fft_channelizer(prune, bandwidth):
    j = jch.FFTChannelizerBank(OFFS, 768e3, 48e3, bandwidth=bandwidth,
                               prune=prune)
    t = tch.FFTChannelizerBank(OFFS, 768e3, 48e3, bandwidth=bandwidth,
                               prune=prune, device="cpu")
    js, ts = j.init_state(), t.init_state()
    step = jax.jit(j)
    for k in range(3):
        x = _signal(16 * 600, 40 + k)
        js, jy = step(js, jnp.asarray(x))
        ts, ty = t(ts, torch.from_numpy(x))
        _close(jy, ty.numpy(), CHAN_TOL)
    _trees_match(js, ts)
    _close(js["phase"], ts["phase"].numpy(), CHAN_TOL)


# ---- VFOBank / ScannerBank ----------------------------------------------

def _banks(mode, channelizer, squelch):
    wfm = mode == "wfm"
    kw = dict(mode=mode, if_rate=240e3 if wfm else 48e3,
              bandwidth=200e3 if wfm else 12500.0, squelch_level=squelch,
              channelizer=channelizer)
    fs = 960e3 if wfm else 768e3
    j = jvb.ScannerBank(OFFS, fs, **kw)
    _interpret(j.demod)
    t = tvb.ScannerBank(OFFS, fs, device="cpu", **kw)
    return j, t


def _bank_input(n, k):
    """Noise plus an NFM carrier on channel 0 (700 Hz tone) and an
    800 Hz-offset CW/SSB tone on channel 2."""
    t = (k * n + np.arange(n)) / 768e3
    x = _signal(n, 50 + k, 0.01)
    x += 0.3 * np.exp(1j * (2 * np.pi * OFFS[0] * t
                            + 1.2 * np.sin(2 * np.pi * 700.0 * t)))
    x += 0.2 * np.exp(2j * np.pi * (OFFS[2] + 800.0) * t)
    return x.astype(np.complex64)


@pytest.mark.parametrize("mode", ["nfm", "usb", "am", "cw", "wfm"])
@pytest.mark.parametrize("channelizer", ["time", "fft"])
def test_scanner_bank(mode, channelizer, monkeypatch):
    # the JAX package's zero-stuffed polyphase form compiles in a fraction
    # of the CPU default's time (see test_torch_linear.py)
    monkeypatch.setattr(jresample, "POLYPHASE_MODE", "zero_stuff")
    squelch = -30.0 if channelizer == "time" else None
    j, t = _banks(mode, channelizer, squelch)
    assert t.block_multiple == j.block_multiple
    n = t.block_multiple * max(1, 24576 // t.block_multiple)
    step = jax.jit(j)
    js, ts = j.init_state(), t.init_state()
    skip = WFM_SETTLE if mode == "wfm" else SETTLE
    for k in range(2):
        x = _bank_input(n, k)
        js, jy = step(js, jnp.asarray(x))
        ts, ty = t(ts, torch.from_numpy(x))
        want, got = np.asarray(jy), ty.numpy()
        assert want.shape == got.shape and np.isfinite(got).all()
        if k == 0:
            want, got = want[:, skip:], got[:, skip:]
        assert _rms_db(want, got) < -60.0, k
    _trees_match(js, ts)
    if squelch is not None:
        mute = ts["squelch"]["mute"].tolist()
        assert np.asarray(js["squelch"]["mute"]).tolist() == mute
        if mode != "wfm":  # channel 1 has no carrier: muted
            assert mute == [False, True, False]


@pytest.mark.parametrize("mode", ["nfm", "usb"])
def test_jax_bank_state_carried_into_port(mode, monkeypatch):
    monkeypatch.setattr(jresample, "POLYPHASE_MODE", "zero_stuff")
    j, t = _banks(mode, "time", -30.0)
    n = t.block_multiple * (24576 // t.block_multiple)
    step = jax.jit(j)
    js = j.init_state()
    for k in range(2):
        js, jy = step(js, jnp.asarray(_bank_input(n, k)))
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    x = _bank_input(n, 2)
    _, jy = step(js, jnp.asarray(x))
    _, ty = t(ts, torch.from_numpy(x))
    _close(jy, ty.numpy(), CARRIED_TOL)


def test_nfm_bank_golden():
    """tests/test_golden.py's NFM bank through the port."""
    fs = 512000.0
    offs = np.array([-128000.0, 64000.0])
    bank = tvb.ScannerBank(offs, fs, mode="nfm", if_rate=32000.0,
                           bandwidth=12500.0, device="cpu")
    n = bank.block_multiple * (65536 // bank.block_multiple)
    t = np.arange(n) / fs
    iq = (0.4 * np.exp(1j * (2 * np.pi * 64000.0 * t
                             + np.cumsum(2 * np.pi * 5000.0
                                         * np.sin(2 * np.pi * 700.0 * t) / fs)))
          ).astype(np.complex64)
    _, audio = bank(bank.init_state(), torch.from_numpy(iq))
    want = np.load(GOLDEN)["nfm_bank"]
    assert audio.shape == want.shape
    assert _rms_db(want[:, SETTLE:], audio.numpy()[:, SETTLE:]) < -40.0


def test_unported_bank_settings_raise():
    """The CW manual gain is ported now (tests/test_torch_radio.py holds it
    to JAX): CWDemod builds with it; a bank setting the JAX package refuses
    still raises, and a CUDA default without a card does not fall back."""
    from sdrpp_tpu_torch.models.analog import CWDemod

    assert not CWDemod(agc_enabled=False, device="cpu").agc.enabled
    with pytest.raises(ValueError, match="channelizer"):
        tvb.ScannerBank(OFFS, 768e3, channelizer="polyphase", device="cpu")
    if not torch.cuda.is_available():  # no fallback hides the device
        with pytest.raises((RuntimeError, AssertionError)):
            tvb.ScannerBank(OFFS, 768e3, mode="nfm")


# ---- bench.py's bank chains ---------------------------------------------

def _jax_chain(pre_decim, squelch_level):
    """bench.py's _make_bank (with the /256 front end when pre_decim)."""
    offsets = twb.bank_offsets()
    vfo = jch.FFTChannelizerBank(offsets, twb.FS_MID, twb.IF_RATE,
                                 bandwidth=twb.BANDWIDTH)
    ls = (twb.CHANNELS,)
    blocks = [jresample.PowerDecimator(pre_decim)] if pre_decim > 1 else []
    blocks += [vfo, jscans.Squelch(squelch_level, sub_blocks=1, lead_shape=ls),
               jfm.Quadrature(twb.BANDWIDTH / 2.0, twb.IF_RATE, lead_shape=ls),
               jfir.FIR(jtaps.low_pass(twb.BANDWIDTH / 2.0,
                                       twb.BANDWIDTH * 0.05, twb.IF_RATE),
                        dtype=jnp.float32, lead_shape=ls)]

    def step(state, x):
        new = []
        for b, s in zip(blocks, state):
            s, x = b(s, x)
            new.append(s)
        return tuple(new), x

    return jax.jit(step), tuple(b.init_state() for b in blocks)


def _carriers(n, k, fs, channels, amp=0.25, dev=1.2):
    t = (k * n + np.arange(n)) / fs
    x = _signal(n, 60 + k, 1e-4)
    for ch in channels:
        x += amp * np.exp(1j * (2 * np.pi * twb.bank_offsets()[ch] * t
                                + dev * np.sin(2 * np.pi * 700.0 * t)))
    return x.astype(np.complex64)


def test_wideband_chain_matches_jax():
    """The /256 front end + 64-channel NFM bank in blocks of 2^20 wideband
    samples (4096 at 6.144 Msps, 32 audio samples per channel), 20 blocks,
    carriers on channels 5 and 40. The squelch (-100 dB) mutes the first
    two blocks, which hold only the channel filters' start, and opens
    after its 10-block count, at block 12; the audio FIR behind it then
    fills over ~5 blocks."""
    chain = twb.make_chain("wideband", device="cpu")
    jstep, js = _jax_chain(twb.PRE_DECIM, -100.0)
    ts = chain.init_state()
    n = 1 << 20
    got, want = [], []
    for k in range(20):
        x = _carriers(n, k, twb.FS_WIDE, (5, 40))
        js, jy = jstep(js, jnp.asarray(x))
        ts, ty = chain(ts, torch.from_numpy(x))
        want.append(np.asarray(jy))
        got.append(ty.numpy())
    want, got = np.concatenate(want, -1), np.concatenate(got, -1)
    assert got.shape == (twb.CHANNELS, 20 * n // (twb.PRE_DECIM * 128))
    assert np.abs(got[[5, 40], -32:]).max() > 0.05  # open, with audio
    _close(want, got, BANK_TOL)


def test_muted_bank_zeros_are_exact():
    """bench.py's muted bank: carriers on the even channels, the noise
    floor on the odd ones, squelch at -50 dB: the odd channels' audio is
    exactly 0 from the first block, in the port and in JAX. (A block of
    2^16 samples gives 512 audio samples, so the first block's level is
    past the channel filters' start.)"""
    chain = twb.make_chain("muted", device="cpu")
    jstep, js = _jax_chain(1, -50.0)
    ts = chain.init_state()
    n = 1 << 16
    for k in range(2):
        x = _carriers(n, k, twb.FS_MID, range(0, twb.CHANNELS, 2), dev=0.5)
        js, jy = jstep(js, jnp.asarray(x))
        ts, ty = chain(ts, torch.from_numpy(x))
        got, want = ty.numpy(), np.asarray(jy)
        assert (got[1::2] == 0.0).all() and (want[1::2] == 0.0).all()
        assert (np.abs(got[0::2]).sum(-1) > 0).all()
        # the discriminator's start on the filters' leading edge, as above
        _close(want[0::2], got[0::2], BANK_TOL, skip=SETTLE if k == 0 else 0)


# ---- the entry point ----------------------------------------------------

def test_cli_bank_on_cpu_writes_channel_wavs(tmp_path):
    from sdrpp_tpu_torch.cli import main
    from sdrpp_tpu_torch.io.wav import read_wav

    out = tmp_path / "bank"
    rc = main(["bank", "--source", "test:768000", "--offsets=-100e3,0,100e3",
               "--mode", "nfm", "--blocks", "2", "--block-size", "32768",
               "--squelch", "-80", "--out-dir", str(out), "--device", "cpu"])
    assert rc == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == ["ch0_-100000Hz.wav", "ch1_+0Hz.wav", "ch2_+100000Hz.wav"]
    for name in names:
        info, data = read_wav(out / name)
        assert info.samplerate == 48000 and info.channels == 1
        assert data.shape == (2 * 32768 // 16, 1)
