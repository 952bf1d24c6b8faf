"""Port parity for the receive slice: Receiver -> RadioChannel (WFM stereo,
AM) against the JAX Receiver, the golden chains, and the port's CLI.

The JAX loop objects run with ``.interpret = True`` (Pallas in interpret
mode), so both sides take the same chunked-or-exact branch, which both
decide by ``_chunk_lanes_for``. Tolerances, with their reasons:

- a receiver started from zero state has a start-up transient (the pilot
  filter filling while the PLL lanes acquire; the audio AGC's first
  look-ahead clip) in which ulp-level differences between XLA's and
  torch's float32 kernels are amplified: up to 0.6 of full scale in the
  first ~460 audio samples (10 ms), then 4e-6. Block 1 is compared from
  audio sample 1000 on, block 2 whole, at an RMS difference below -60 dB;
- with the JAX state after block 1 carried into the port
  (``state_from_numpy``), block 2 agrees below -80 dB;
- the golden chains: below -40 dB, the bound of tests/test_golden.py,
  the AM chain at its own loop policy too (its AGC's warm-up spans four
  decay times, or the loop runs exact; JAX's chunked branch, a 2048-sample
  warm-up, misses the golden by 11 dB, ROADMAP C); the chunked AGC
  against the exact loop at -40 dB on a carried block, and the USB tone's
  SNR within 3 dB of the exact loop's;
- the state trees: the same keys, shapes and dtypes, but the full AGCs'
  ``hist``, as long as the port's warm-up.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.receiver import Receiver as JaxReceiver
from sdrpp_tpu_torch.models.analog import WFMDemod
from sdrpp_tpu_torch.models.radio import RadioChannel
from sdrpp_tpu_torch.ops.scans_kernels import _chunk_lanes_for
from sdrpp_tpu_torch.receiver import Receiver
from sdrpp_tpu_torch.utils.blocks import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "golden_chains.npz"

FS = 960000.0
BLOCK = 104320       # WFM IF block 26080: chunked PLL, K = 128 lanes
VFOS = {"wfm": dict(mode="wfm", offset=200000.0, deemphasis="50us"),
        "am": dict(mode="am", offset=-300000.0)}   # AM IF 2608: exact AGC
SETTLE = 1000        # audio samples of the zero-state start-up transient


def _rms_db(got, want):
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    ref = np.sqrt(np.mean(np.asarray(want, np.float64) ** 2)) + 1e-30
    return 20 * np.log10(np.sqrt(np.mean(d ** 2)) / ref + 1e-30)


def _snr_db(audio, fs, f0, halfwidth=20.0):
    """A tone's SNR in dB: its power within +-halfwidth of f0 against the
    rest of 100 Hz ... 15 kHz (Hann-windowed spectrum; chip_smoke.py's
    snr_db)."""
    p = np.abs(np.fft.rfft(audio * np.hanning(len(audio)))) ** 2
    f = np.fft.rfftfreq(len(audio), 1.0 / fs)
    near = np.abs(f - f0) <= halfwidth
    band = (f >= 100.0) & (f <= 15000.0)
    return 10 * np.log10(p[near].sum() / max(p[band & ~near].sum(), 1e-30))


def _composite(n):
    """WFM stereo (L 1 kHz, R 3 kHz, 19 kHz pilot, 75 kHz deviation) at
    +200 kHz and AM (1 kHz, 50%) at -300 kHz, plus seeded noise."""
    t = np.arange(n) / FS
    l = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    r = 0.5 * np.sin(2 * np.pi * 3000.0 * t)
    mpx = (0.45 * (l + r) + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.45 * (l - r) * np.sin(2 * np.pi * 38000.0 * t))
    wfm = 0.5 * np.exp(1j * (2 * np.pi * 200000.0 * t
                             + np.cumsum(2 * np.pi * 75000.0 * mpx / FS)))
    am = 0.3 * (1 + 0.5 * np.sin(2 * np.pi * 1000.0 * t)) \
        * np.exp(-2j * np.pi * 300000.0 * t)
    rng = np.random.default_rng(11)
    noise = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (wfm + am + noise).astype(np.complex64)


def _receiver(cls, **kw):
    rx = cls(FS, block_size=BLOCK, fft_size=4096, **kw)
    for name, cfg in VFOS.items():
        rx.create_vfo(name, **cfg)
    return rx


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Receiver over three blocks: audio, FFT lines and the state
    after each block (as numpy)."""
    rx = _receiver(JaxReceiver)
    for chan in rx._channels.values():
        d = chan.demod
        for loop in (getattr(d, "pilot_pll", None),
                     getattr(d, "audio_agc", None)):
            if loop is not None:
                loop.interpret = True
    rx._rebuild()
    iq = _composite(3 * BLOCK)
    out = []
    for k in range(3):
        audio, fft = rx.process_block(iq[k * BLOCK:(k + 1) * BLOCK])
        out.append(({n: np.asarray(a) for n, a in audio.items()}, fft,
                    jax.tree_util.tree_map(np.asarray, rx._state)))
    return iq, out


def test_receiver_matches_jax_over_blocks(jax_run):
    iq, want = jax_run
    rx = _receiver(Receiver, device="cpu")
    for k in range(2):
        audio, fft = rx.process_block(iq[k * BLOCK:(k + 1) * BLOCK])
        jaudio, jfft, _ = want[k]
        skip = SETTLE if k == 0 else 0
        for name in VFOS:
            got = audio[name].numpy()
            assert got.shape == jaudio[name].shape
            assert np.isfinite(got).all()
            assert _rms_db(got[skip:], jaudio[name][skip:]) < -60.0, name
        pj, pt = 10 ** (jfft / 10), 10 ** (fft / 10)
        assert np.abs(pj - pt).max() <= 1e-4 * pj.max()


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


def test_state_tree_matches_jax(jax_run):
    _, want = jax_run
    rx = _receiver(Receiver, device="cpu")
    rx.process_block(jax_run[0][:BLOCK])
    _leaves_match(want[0][2], state_to_numpy(rx._state))


def test_jax_state_carried_into_port(jax_run):
    """Weights and state carried across: the JAX state after block 2 seeds
    the port, which then produces JAX's block 3."""
    iq, want = jax_run
    rx = _receiver(Receiver, device="cpu")
    rx._state = state_from_numpy(want[1][2], "cpu")
    audio, _ = rx.process_block(iq[2 * BLOCK:])
    for name in VFOS:
        assert _rms_db(audio[name].numpy(), want[2][0][name]) < -80.0, name


def _golden_am_input(seconds: int = 1):
    fs, f_ch, f_aud = 96000.0, 20000.0, 1000.0
    chan = RadioChannel("am", fs, offset=f_ch, audio_rate=48000.0,
                        device="cpu")
    n = chan.block_multiple * (seconds * 96000 // chan.block_multiple)
    t = np.arange(n) / fs
    iq = (0.5 * (1 + 0.5 * np.sin(2 * np.pi * f_aud * t))
          * np.exp(2j * np.pi * f_ch * t)).astype(np.complex64)
    return chan, iq


def test_golden_am():
    """tests/test_golden.py's AM chain with its audio AGC held exact
    (``max_lanes = 1``), as the golden was made: the JAX package on the
    CPU, where every loop runs exact.

    The chain starts from zero state: its first output samples are the
    FIR's float32 rounding noise (1e-15), which the AGC (max gain 1e7)
    lifts to full scale, so XLA's and torch's different rounding noise
    gives different audio for the first 390 samples (8 ms; -20 dB over the
    whole block). From sample 1000 on the chain is held to the -40 dB
    bound."""
    chan, iq = _golden_am_input()
    chan.demod.audio_agc.max_lanes = 1
    _, audio = chan(chan.init_state(), torch.from_numpy(iq))
    want = np.load(GOLDEN)["am"]
    assert audio.shape == want.shape
    assert _rms_db(audio.numpy()[SETTLE:], want[SETTLE:]) < -40.0


def test_golden_am_chunked():
    """The AM chain at its own loop policy against the golden (the exact
    loop's output), from SETTLE on at -40 dB. The JAX package's chunked
    AGC would take K = 11 lanes here over a 2048-sample warm-up, shorter
    than the AGC's decay time (1 / decay = 4800 samples at the 24 kHz
    IF), and misses the golden by 11 dB (ROADMAP C); the port's warm-up
    spans four decay times (19,200 samples), which no lane of this
    24,000-sample IF block holds, so the loop runs exact."""
    chan, iq = _golden_am_input()
    agc = chan.demod.audio_agc
    assert agc.warmup == 19200
    assert _chunk_lanes_for(24000, agc.warmup, agc.max_lanes) == 0
    _, audio = chan(chan.init_state(), torch.from_numpy(iq))
    want = np.load(GOLDEN)["am"]
    assert _rms_db(audio.numpy()[SETTLE:], want[SETTLE:]) < -40.0


def test_am_chunked_agc_matches_exact_loop():
    """The golden's AM signal in two 4-s blocks (IF blocks of 96,000
    samples): the audio AGC's warm-up of four decay times fits in K = 5
    lanes of 19,200, and the chunked chain's second block agrees with the
    exact loop's (``max_lanes = 1``) at -40 dB, each chain carrying its
    own state. (The first block starts from zero state, where lane 0's
    warm-up is the all-zero initial history: it seeds at amplitude 1, as
    the JAX package's lanes do, where the exact loop starts at 0 and gain
    1e7; that start-up decays at the decay rate, over about 1 s.)"""
    chan, iq = _golden_am_input(8)
    half = len(iq) // 2
    agc = chan.demod.audio_agc
    assert _chunk_lanes_for(96000, agc.warmup, agc.max_lanes) == 5
    exact, _ = _golden_am_input(8)
    exact.demod.audio_agc.max_lanes = 1
    st, xt = chan.init_state(), exact.init_state()
    for blk in (iq[:half], iq[half:]):
        st, audio = chan(st, torch.from_numpy(blk))
        xt, want = exact(xt, torch.from_numpy(blk))
    assert _rms_db(audio.numpy(), want.numpy()) < -40.0


def _usb_input(if_samples: int):
    """A USB channel at 96 kHz (its IF at 48 kHz, the audio rate) on a tone
    150 Hz above its VFO (a 1.5 kHz audio tone, the slice's) with noise
    at -34 dB (the tone's SNR about 46 dB): (channel, iq of if_samples IF
    samples)."""
    fs = 96000.0
    chan = RadioChannel("usb", fs, audio_rate=48000.0, device="cpu")
    n = 2 * if_samples
    assert n % chan.block_multiple == 0
    t = np.arange(n) / fs
    rng = np.random.default_rng(6)
    iq = 0.05 * np.exp(2j * np.pi * 150.0 * t) + 1e-3 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return chan, iq.astype(np.complex64)


@pytest.mark.parametrize("if_samples,lanes", [(13088, 0), (192000, 5)])
def test_usb_tone_snr_within_3db_of_exact_loop(if_samples, lanes):
    """The USB tone's SNR at the AGC's own policy within 3 dB of the
    exact loop's (``max_lanes = 1``). At the slice's 13,088-sample IF
    block the JAX package chunks the AGC (K = 6, a 2048-sample warm-up)
    and the SNR falls from 59 to 34 dB (ROADMAP C); the port's warm-up of
    four decay times (38,400 samples at 48 kHz) fits in no lane there, so
    it runs exact, and in K = 5 lanes of a 4-s block."""
    chan, iq = _usb_input(if_samples)
    agc = chan.demod.agc
    assert _chunk_lanes_for(if_samples, agc.warmup, agc.max_lanes) == lanes
    _, audio = chan(chan.init_state(), torch.from_numpy(iq))
    exact, _ = _usb_input(if_samples)
    exact.demod.agc.max_lanes = 1
    _, want = exact(exact.init_state(), torch.from_numpy(iq))
    got_db = _snr_db(audio.numpy()[SETTLE:], 48000.0, 1500.0)
    want_db = _snr_db(want.numpy()[SETTLE:], 48000.0, 1500.0)
    assert want_db > 40.0 and abs(got_db - want_db) <= 3.0


def test_golden_wfm_stereo():
    """tests/test_golden.py's WFM stereo chain; the port's pilot PLL runs
    chunked (K = 128) against the golden's exact loop."""
    fs, n, dev = 240000.0, 96000, 75000.0
    t = np.arange(n) / fs
    l = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    r = 0.5 * np.sin(2 * np.pi * 3000.0 * t)
    mpx = (0.45 * (l + r) + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.45 * (l - r) * np.sin(2 * np.pi * 38000.0 * t))
    iq = np.exp(1j * np.cumsum(2 * np.pi * dev * mpx / fs)).astype(np.complex64)
    d = WFMDemod(deviation=dev, samplerate=fs, device="cpu")
    _, y = d(d.init_state(), torch.from_numpy(iq))
    want = np.load(GOLDEN)["wfm_stereo"]
    assert y.shape == want.shape
    assert _rms_db(y.numpy(), want) < -40.0


def test_cli_run_on_cpu_imports_no_jax(tmp_path):
    out = tmp_path / "audio.wav"
    code = (
        "import sys\n"
        "from sdrpp_tpu_torch.cli import main\n"
        f"rc = main(['run', '--source', 'test:480000', '--mode', 'wfm',"
        f" '--blocks', '2', '--block-size', '96000', '--device', 'cpu',"
        f" '--out', {str(out)!r}])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'sdrpp_tpu' not in sys.modules, 'sdrpp_tpu was imported'\n"
        "print('JAX-FREE')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX-FREE" in proc.stdout
    from sdrpp_tpu.io.wav import read_wav

    info, data = read_wav(out)
    assert info.samplerate == 48000 and info.channels == 2
    assert data.shape == (2 * 96000 // 10, 2)


@pytest.mark.parametrize("opts", [dict(decim_ratio=4),
                                  dict(dc_blocking=False, invert_iq=True)])
def test_iq_frontend_options(opts):
    from sdrpp_tpu.signal_path import IQFrontEnd as JaxIQFrontEnd
    from sdrpp_tpu_torch.signal_path import IQFrontEnd

    kw = dict(fft_size=1024, fft_rate=FS / 16384, block_size=65536, **opts)
    j, t = JaxIQFrontEnd(FS, **kw), IQFrontEnd(FS, device="cpu", **kw)
    assert (t.spectrum.frame_len, t.spectrum.nz) == \
        (j.spectrum.frame_len, j.spectrum.nz)
    iq = _composite(2 * 65536)
    js, ts = j.init_state(), t.init_state()
    jstep = jax.jit(j)
    for k in range(2):
        blk = iq[k * 65536:(k + 1) * 65536]
        js, (jx, jfft) = jstep(js, jnp.asarray(blk))
        ts, (tx, tfft) = t(ts, torch.from_numpy(blk))
        jx = np.asarray(jx)
        assert np.abs(jx - tx.numpy()).max() <= 1e-5 * np.abs(jx).max()
        pj, pt = 10 ** (np.asarray(jfft) / 10), 10 ** (tfft.numpy() / 10)
        assert np.abs(pj - pt).max() <= 1e-4 * pj.max()


def test_receiver_run_and_vfo_management():
    from sdrpp_tpu.io.sinks import BufferSink
    from sdrpp_tpu.io.sources import TestSource

    fs, block = 240000.0, 48000
    rx = Receiver(fs, block_size=block, fft_size=1024, device="cpu")
    rx.create_vfo("a", "nfm", 20000.0)
    rx.create_vfo("b", "am", -30000.0)
    sink = BufferSink()
    rx.sinks.set_provider("a", sink)
    rx.sources.register("test", TestSource(fs, tones=[(20000.0, -20.0)]))
    rx.sources.select("test")
    rx.run(2)
    assert sink.data().shape == (2 * block // 5,)
    kept = rx._state["channels"]["a"]
    rx.set_vfo_offset("a", 25000.0)
    assert rx._channels["a"].vfo.offset == 25000.0
    assert rx._state["channels"]["a"] is kept  # carried state survives
    rx.delete_vfo("b")
    assert list(rx._state["channels"]) == ["a"]
    odd = Receiver(fs, block_size=block + 10, fft_size=1024, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        odd.create_vfo("c", "nfm", 0.0)


def test_unported_options_raise():
    """Every mode and option of the JAX constructor is ported: each builds;
    what is still refused is what the JAX package refuses too."""
    for kw in (dict(rds=True), dict(noise_blanker=True),
               dict(dynamic_bandwidth=True)):
        assert RadioChannel("wfm", FS, device="cpu", **kw).block_multiple
    assert RadioChannel("cw", FS, device="cpu").if_rate == 3000.0
    with pytest.raises(ValueError, match="demod mode"):
        RadioChannel("fm", FS, device="cpu")
