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
- the golden chains: below -40 dB, the bound of tests/test_golden.py.
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


def test_state_tree_matches_jax(jax_run):
    _, want = jax_run
    rx = _receiver(Receiver, device="cpu")
    rx.process_block(jax_run[0][:BLOCK])
    jleaves, jdef = jax.tree_util.tree_flatten(want[0][2])
    tleaves, tdef = jax.tree_util.tree_flatten(state_to_numpy(rx._state))
    assert jdef == tdef
    for a, b in zip(jleaves, tleaves):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_jax_state_carried_into_port(jax_run):
    """Weights and state carried across: the JAX state after block 2 seeds
    the port, which then produces JAX's block 3."""
    iq, want = jax_run
    rx = _receiver(Receiver, device="cpu")
    rx._state = state_from_numpy(want[1][2], "cpu")
    audio, _ = rx.process_block(iq[2 * BLOCK:])
    for name in VFOS:
        assert _rms_db(audio[name].numpy(), want[2][0][name]) < -80.0, name


def _golden_am_input():
    fs, f_ch, f_aud = 96000.0, 20000.0, 1000.0
    chan = RadioChannel("am", fs, offset=f_ch, audio_rate=48000.0,
                        device="cpu")
    n = chan.block_multiple * (96000 // chan.block_multiple)
    t = np.arange(n) / fs
    iq = (0.5 * (1 + 0.5 * np.sin(2 * np.pi * f_aud * t))
          * np.exp(2j * np.pi * f_ch * t)).astype(np.complex64)
    return chan, iq


def test_golden_am():
    """tests/test_golden.py's AM chain. The golden was made by the JAX
    package on the CPU, where every loop runs exact; its 24000-sample IF
    block would take the chunk-parallel AGC (K = 11, warm-up 2048), whose
    lanes do not settle within a warm-up shorter than the AGC's decay time
    (1/decay = 4800 samples) and miss the golden by 11 dB, in the JAX
    package (its TPU path) and the port alike. So the loop is held exact
    here (``max_lanes = 1``) to check the chain; the chunked branch is
    held to the JAX package's chunked branch in the next test.

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


def test_golden_am_chunked_matches_jax_chunked():
    from sdrpp_tpu.models.radio import RadioChannel as JaxRadioChannel

    chan, iq = _golden_am_input()
    jchan = JaxRadioChannel("am", 96000.0, offset=20000.0, audio_rate=48000.0)
    jchan.demod.audio_agc.interpret = True
    _, want = jax.jit(jchan)(jchan.init_state(), jnp.asarray(iq))
    _, audio = chan(chan.init_state(), torch.from_numpy(iq))
    assert _rms_db(audio.numpy(), np.asarray(want)) < -80.0


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
