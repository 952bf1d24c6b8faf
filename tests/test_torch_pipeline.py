"""The port's host pipeline (utils/pipeline.py) against the contract of the
JAX package's (tests/test_pipeline.py), and the pipelined CLI loops.

Held exactly: the prefetched block sequence, the writer's order, and the
bytes of every file ``cli run`` and ``cli bank`` write, against the same
loop run without the pipeline (a block read, the step, ``.cpu()``, the
sink) on ``--device cpu``. The new commands (``run`` in cw and raw modes
with ``--audio-rate`` / ``--sample-format``, ``spectrum --framebuffer`` and
``scan``) are held to their JAX counterparts' outputs where those are
deterministic (raw, spectrum) and otherwise to their shapes and carriers.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from sdrpp_tpu.io.sources import TestSource as JaxTestSource
from sdrpp_tpu.utils.pipeline import Prefetcher as JaxPrefetcher
from sdrpp_tpu_torch import cli
from sdrpp_tpu_torch.io import wav
from sdrpp_tpu_torch.io.sinks import RecorderSink
from sdrpp_tpu_torch.io.sources import FileSource, TestSource
from sdrpp_tpu_torch.utils.pipeline import DEPTH, DeferredWriter, Prefetcher

torch.set_num_threads(1)


def test_prefetcher_preserves_stream():
    a = TestSource(1000000.0, tones=[(100000.0, -20.0)], noise_dbfs=-60.0)
    b = TestSource(1000000.0, tones=[(100000.0, -20.0)], noise_dbfs=-60.0)
    c = JaxTestSource(1000000.0, tones=[(100000.0, -20.0)], noise_dbfs=-60.0)
    pre = Prefetcher(b, 4096, device="cpu")
    jpre = JaxPrefetcher(c, 4096, depth=DEPTH)
    try:
        for _ in range(16):
            got = pre.read(4096)
            assert got.dtype == torch.complex64 and got.device.type == "cpu"
            np.testing.assert_array_equal(a.read(4096), got.numpy())
            np.testing.assert_array_equal(got.numpy(), jpre.read(4096))
    finally:
        pre.close()
        jpre.close()


def test_prefetcher_eof_turns_to_zeros(tmp_path):
    rng = np.random.default_rng(0)
    iq = rng.standard_normal((10000, 2)).astype(np.float32) * 0.1
    p = tmp_path / "short.wav"
    wav.write_wav(p, 48000, iq, "f32")
    pre = Prefetcher(FileSource(p, loop=False), 4096, device="cpu")
    try:
        blocks = [pre.read(4096).numpy() for _ in range(5)]
    finally:
        pre.close()
    got = np.concatenate(blocks)
    want = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    np.testing.assert_array_equal(got[:10000], want)
    assert len(got) >= 3 * 4096 and not got[12288:].any()


class _Failing:
    samplerate = 1000.0

    def __init__(self):
        self.calls = 0

    def read(self, n):
        self.calls += 1
        if self.calls > 2:
            raise OSError("device unplugged")
        return np.full(n, self.calls, np.complex64)


def test_prefetcher_error_is_sticky():
    pre = Prefetcher(_Failing(), 16, device="cpu")
    try:
        assert pre.read(16).numpy()[0] == 1
        assert pre.read(16).numpy()[0] == 2
        for _ in range(2):
            with pytest.raises(OSError, match="unplugged"):
                pre.read(16)
        with pytest.raises(ValueError):
            pre.read(8)
    finally:
        pre.close()


class _Counting:
    """Block k (from 1) is k everywhere, so a lost, repeated or reordered
    block shows."""
    samplerate = 1000.0

    def __init__(self):
        self.calls = 0

    def read(self, n):
        self.calls += 1
        return np.full(n, self.calls, np.complex64)


def test_prefetchers_under_thread_stress():
    """More consumer threads than cores, each with its own Prefetcher (so
    twice as many threads), under a short switch interval: every consumer
    sees blocks 1..N in order, and every reader thread ends on close."""
    import os
    import sys
    import threading

    workers = 2 * (os.cpu_count() or 2)
    nblocks = 200
    seen, readers = {}, []

    def consume(i):
        pre = Prefetcher(_Counting(), 8, device="cpu")
        readers.append(pre._thread)
        try:
            seen[i] = [int(pre.read(8)[0].real) for _ in range(nblocks)]
        finally:
            pre.close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not any(t.is_alive() for t in readers)
    want = list(range(1, nblocks + 1))
    assert sorted(seen) == list(range(workers))
    assert all(got == want for got in seen.values())


def test_deferred_writer_order_and_flush():
    written = []
    w = DeferredWriter(lambda a: written.append(a.copy()))
    blocks = [torch.full((4,), float(i)) for i in range(5)]
    for b in blocks:
        w.push(b)
    assert len(written) == 4  # the last one still pending
    w.flush()
    assert len(written) == 5
    for i, b in enumerate(written):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(b, blocks[i].numpy())
    w.flush()  # idempotent
    assert len(written) == 5


def _unpipelined_run(tmp_path, mode, block, blocks, **kw):
    """``cli run``'s loop without the pipeline."""
    from sdrpp_tpu_torch.models.radio import RadioChannel

    src = cli._make_source("test:2400000")
    chan = RadioChannel(mode, src.samplerate, device="cpu", **kw)
    out = tmp_path / f"plain_{mode}.wav"
    sink = RecorderSink(out, int(chan.audio_rate),
                        channels=2 if chan.stereo_out else 1)
    st = chan.init_state()
    for _ in range(blocks):
        st, audio = chan(st, torch.from_numpy(src.read(block)))
        sink.write(audio.cpu().numpy())
    sink.close()
    return out


@pytest.mark.parametrize("mode,block", [("wfm", 96000), ("cw", 96000)])
def test_cli_run_pipelined_equals_unpipelined(tmp_path, mode, block):
    out = tmp_path / f"{mode}.wav"
    assert cli.main(["run", "--source", "test:2400000", "--mode", mode,
                     "--blocks", "3", "--block-size", str(block),
                     "--device", "cpu", "--out", str(out)]) == 0
    want = _unpipelined_run(tmp_path, mode, block, 3)
    assert out.read_bytes() == want.read_bytes()


def test_cli_bank_pipelined_equals_unpipelined(tmp_path):
    from sdrpp_tpu_torch.parallel.vfo_bank import ScannerBank

    out = tmp_path / "bank"
    assert cli.main(["bank", "--source", "test:768000",
                     "--offsets=-100e3,0,100e3", "--mode", "nfm",
                     "--blocks", "3", "--block-size", "16384", "--device",
                     "cpu", "--out-dir", str(out)]) == 0
    src = cli._make_source("test:768000")
    offsets = np.array([-100e3, 0.0, 100e3])
    bank = ScannerBank(offsets, src.samplerate, mode="nfm", if_rate=48000.0,
                       bandwidth=12500.0, device="cpu")
    sinks = [RecorderSink(tmp_path / f"plain{i}.wav", 48000)
             for i in range(3)]
    st = bank.init_state()
    for _ in range(3):
        st, audio = bank(st, torch.from_numpy(src.read(16384)))
        audio = audio.cpu().numpy()
        for i, sink in enumerate(sinks):
            sink.write(audio[i])
    for sink in sinks:
        sink.close()
    files = sorted(out.glob("ch*.wav"))
    assert [f.name for f in files] == sorted(
        f"ch{i}_{int(o):+d}Hz.wav" for i, o in enumerate(offsets))
    for i, o in enumerate(offsets):
        got = (out / f"ch{i}_{int(o):+d}Hz.wav").read_bytes()
        assert got == (tmp_path / f"plain{i}.wav").read_bytes()


def test_cli_run_cw_audio_rate_and_sample_format(tmp_path):
    out = tmp_path / "cw.wav"
    assert cli.main(["run", "--source", "test:2400000", "--mode", "cw",
                     "--offset", "99900", "--audio-rate", "44100",
                     "--sample-format", "i24", "--blocks", "2",
                     "--block-size", "960000", "--device", "cpu", "--out",
                     str(out)]) == 0
    info, data = wav.read_wav(out)
    assert (info.samplerate, info.channels, info.bits) == (44100, 1, 24)
    # 2 x 960000 samples at 2.4 Msps = 0.8 s of audio
    assert data.shape == (2 * 960000 * 44100 // 2400000, 1)
    data = data[:, 0]
    # the test tone sits 100 Hz above the VFO: the 800 Hz BFO puts it at
    # 900 Hz (the second half: past the 250 Hz channel filter's transient)
    spec = np.abs(np.fft.rfft(data[len(data) // 2:]))
    f = np.fft.rfftfreq(len(data) - len(data) // 2, 1 / 44100)
    assert abs(f[np.argmax(spec)] - 900.0) < 5.0


@pytest.fixture
def jax_cli(monkeypatch):
    """The JAX package's CLI, without its persistent compilation cache."""
    from sdrpp_tpu import cli as jcli

    monkeypatch.setenv("SDRPP_TPU_NO_CACHE", "1")
    return jcli


def test_cli_run_raw_matches_jax(tmp_path, jax_cli):
    jcli = jax_cli

    a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
    argv = ["run", "--source", "test:240000", "--mode", "raw",
            "--sample-format", "i24", "--blocks", "3", "--block-size",
            "24000"]
    assert cli.main(argv + ["--device", "cpu", "--out", str(a)]) == 0
    jcli.main(argv + ["--cpu", "--out", str(b)])
    assert a.read_bytes() == b.read_bytes()
    info, data = wav.read_wav(a)
    assert (info.samplerate, info.channels, info.bits) == (240000, 2, 24)
    assert data.shape == (72000, 2)


def test_cli_spectrum_matches_jax(tmp_path, jax_cli):
    jcli = jax_cli

    argv = ["spectrum", "--source", "test:2400000", "--fft-size", "1024",
            "--fft-rate", "1000", "--blocks", "2", "--block-size", "48000",
            "--fb-width", "256"]
    ports = [str(tmp_path / n) for n in ("wf.npy", "fb.npy")]
    jaxs = [str(tmp_path / n) for n in ("jwf.npy", "jfb.npy")]
    assert cli.main(argv + ["--device", "cpu", "--out", ports[0],
                            "--framebuffer", ports[1]]) == 0
    jcli.main(argv + ["--cpu", "--out", jaxs[0], "--framebuffer", jaxs[1]])
    wf, jwf = np.load(ports[0]), np.load(jaxs[0])
    assert wf.shape == jwf.shape == (2 * 48000 // 2400, 1024)
    pw, pj = 10 ** (wf / 10), 10 ** (jwf / 10)
    assert np.abs(pw - pj).max() <= 1e-4 * pj.max()
    fb, jfb = np.load(ports[1]), np.load(jaxs[1])
    assert fb.shape == jfb.shape and fb.dtype == jfb.dtype == np.uint32
    # the framebuffer is the JAX package's display of the port's lines
    # (auto_range reads the last line, so a 1e-4 difference in dB may move
    # a pixel across a palette step between the two packages' lines)
    from sdrpp_tpu.misc.waterfall import WaterfallDisplay

    disp = WaterfallDisplay(raw_fft_size=1024, data_width=256,
                            waterfall_height=len(wf), whole_bandwidth=2.4e6)
    for line in wf:
        disp.push_fft(line)
    disp.auto_range()
    for line in wf:
        disp.push_fft(line)
    np.testing.assert_array_equal(fb, disp.framebuffer)


def test_cli_scan_reports_the_carrier(tmp_path):
    fs = 2400000.0
    n = 131072 * 6
    t = np.arange(n) / fs
    rng = np.random.default_rng(12)
    x = 0.1 * np.exp(2j * np.pi * -250000.0 * t) + 1e-4 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    path = tmp_path / "band.wav"
    wav.write_wav(path, int(fs), np.stack([x.real, x.imag], -1)
                  .astype(np.float32), "f32")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["scan", "--source", str(path), "--start=-400e3",
                         "--stop=-100e3", "--interval", "25000", "--blocks",
                         "6", "--device", "cpu"]) == 0
    hits = [float(line.split()[0]) for line in buf.getvalue().splitlines()
            if line.strip().endswith("dB")]
    assert hits and all(abs(f + 250000.0) <= 12500.0 for f in hits)
