"""The port's own host I/O (sdrpp_tpu_torch.io) against the JAX package's
originals, and the port's independence from both JAX and that package.

The copies are the same numpy code, so everything is held exactly: the
bytes of every WAV the writers produce, the samples every reader returns
and the blocks of the seeded test source.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sdrpp_tpu.io import sinks as jsinks
from sdrpp_tpu.io import sources as jsources
from sdrpp_tpu.io import wav as jwav
from sdrpp_tpu_torch.io import sinks as tsinks
from sdrpp_tpu_torch.io import sources as tsources
from sdrpp_tpu_torch.io import wav as twav

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "sdrpp_tpu_torch"
FORMATS = ["u8", "i16", "i24", "i32", "f32"]


def _audio(shape, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(0.4 * rng.standard_normal(shape), -1.2, 1.2).astype(np.float32)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_writer_bytes_and_readers_match(tmp_path, fmt, channels):
    data = _audio((1000, channels) if channels > 1 else 1000)
    a, b = tmp_path / "jax.wav", tmp_path / "port.wav"
    jwav.write_wav(a, 48000, data, fmt)
    twav.write_wav(b, 48000, data, fmt)
    assert a.read_bytes() == b.read_bytes()
    (ji, jd), (ti, td) = jwav.read_wav(a), twav.read_wav(a)
    assert (ji.samplerate, ji.channels, ji.bits, ji.format) == \
        (ti.samplerate, ti.channels, ti.bits, ti.format)
    np.testing.assert_array_equal(jd, td)
    (jr, jiq), (tr, tiq) = jwav.read_wav_iq(a), twav.read_wav_iq(a)
    assert jr == tr
    np.testing.assert_array_equal(jiq, tiq)


@pytest.mark.parametrize("loop", [True, False])
def test_file_source_matches(tmp_path, loop):
    path = tmp_path / "capture_145800000Hz.wav"
    jwav.write_wav(path, 250000, _audio((3000, 2), 1), "i16")
    j, t = jsources.FileSource(path, loop=loop), tsources.FileSource(path,
                                                                     loop=loop)
    assert (j.samplerate, j.num_frames, j.center_freq) == \
        (t.samplerate, t.num_frames, t.center_freq) == (250000.0, 3000,
                                                        145800000.0)
    for n in (1000, 1500, 900, 700):
        np.testing.assert_array_equal(j.read(n), t.read(n))
        assert j.pos == t.pos
    j.seek(2990)
    t.seek(2990)
    np.testing.assert_array_equal(j.read(20), t.read(20))


def test_test_source_blocks_match():
    kw = dict(tones=[(100000.0, -20.0), (-35000.0, -40.0)], noise_dbfs=-90.0)
    j = jsources.TestSource(2400000.0, **kw)
    t = tsources.TestSource(2400000.0, **kw)
    for n in (65536, 1000, 4097):
        np.testing.assert_array_equal(j.read(n), t.read(n))


def test_source_manager():
    m = tsources.SourceManager()
    src = tsources.TestSource(48000.0)
    m.register("test", src)
    assert m.names() == ["test"] and m.source is None
    assert m.select("test") is src
    m.tune(1e6)
    assert src.center_freq == 1e6
    with pytest.raises(KeyError):
        m.select("missing")
    m.unregister("test")
    assert m.source is None


def test_sinks_match(tmp_path):
    data = _audio(4800, 2)
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    for mod, path in ((jsinks, a), (tsinks, b)):
        rec = mod.RecorderSink(path, 48000, container="wav")
        sm = mod.SinkManager()
        buf = mod.BufferSink()
        sm.register_stream("x", 48000.0, rec)
        sm.register_stream("y", 48000.0, buf)
        sm.set_volume("x", 0.5)
        for k in range(3):
            sm.write("x", data[k * 1600:(k + 1) * 1600])
            sm.write("y", data[k * 1600:(k + 1) * 1600])
        sm.set_muted("y", True)
        sm.write("y", data[:100])
        sm.close()
        assert buf.data().shape == (4900,) and (buf.data()[-100:] == 0).all()
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("container", ["flac", "mp3"])
def test_unported_containers_raise(tmp_path, container):
    """The FLAC and MP3 containers, once refused, are ported: the recorder
    and ``cli bank`` write them; what still raises is what the JAX sink
    refuses (FLAC with a float format, ValueError), and MP3 without
    libmp3lame (ImportError)."""
    from sdrpp_tpu_torch.cli import main
    from sdrpp_tpu_torch.io import mp3

    if container == "flac":
        for mod in (jsinks, tsinks):
            with pytest.raises(ValueError, match="integer format"):
                mod.RecorderSink(tmp_path / "a.flac", 48000,
                                 container="flac", sample_format="f32")
    elif not mp3.available():
        with pytest.raises(ImportError):
            tsinks.RecorderSink(tmp_path / "a.mp3", 48000, container="mp3")
        return
    assert main(["bank", "--source", "test:768000", "--offsets", "0",
                 "--blocks", "1", "--device", "cpu", "--container", container,
                 "--out-dir", str(tmp_path / "bank")]) == 0
    assert len(list((tmp_path / "bank").glob(f"*.{container}"))) == 1


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    """``cli run`` (nfm, and with FLAC, a checkpoint and a trace; cw, raw),
    ``cli decode meteor``, ``cli bank``,
    ``cli spectrum``, ``cli scan``, ``cli serve --blocks 2`` to a client,
    a two-block ``ReceiverEngine`` and ``cli preheat --modes nfm,meteor
    --no-variants`` on the CPU, then an import of every module of the port
    (but ``__main__``, which runs the CLI) and of chip_smoke.py with its
    kernel wrappers, in a fresh interpreter where
    websockets and zstandard cannot be imported: every step works, and no
    module named jax, jax.*, sdrpp_tpu or sdrpp_tpu.* is loaded."""
    modules = sorted(
        ".".join(("sdrpp_tpu_torch",) + p.relative_to(PACKAGE).with_suffix("")
                 .parts).removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py") if p.name != "__main__.py")
    code = f"""
import importlib, socket, sys, threading, time
for blocked in ('websockets', 'zstandard'):
    sys.modules[blocked] = None  # an import of either raises ImportError
from sdrpp_tpu_torch.cli import main
tmp = {str(tmp_path)!r}
assert main(['run', '--source', 'test:480000', '--mode', 'nfm', '--blocks',
             '1', '--block-size', '48000', '--device', 'cpu', '--out',
             tmp + '/run.wav']) == 0
assert main(['run', '--source', 'test:480000', '--mode', 'nfm', '--blocks',
             '1', '--block-size', '48000', '--device', 'cpu', '--container',
             'flac', '--checkpoint', tmp + '/c.npz', '--checkpoint-every',
             '1', '--trace', tmp + '/trace', '--out', tmp + '/run.flac']) == 0
assert main(['decode', 'meteor', '--source', 'test:300000', '--blocks', '1',
             '--block-size', '32768', '--device', 'cpu', '--out',
             tmp + '/m.s']) == 0
assert main(['bank', '--source', 'test:768000', '--offsets=-100e3,100e3',
             '--mode', 'usb', '--channelizer', 'fft', '--blocks', '1',
             '--block-size', '16384', '--device', 'cpu', '--out-dir',
             tmp + '/bank']) == 0
for mode in ('cw', 'raw'):
    assert main(['run', '--source', 'test:480000', '--mode', mode,
                 '--blocks', '1', '--block-size', '96000', '--device', 'cpu',
                 '--out', tmp + '/' + mode + '.wav']) == 0
assert main(['spectrum', '--source', 'test:480000', '--fft-size', '1024',
             '--blocks', '1', '--block-size', '48000', '--device', 'cpu',
             '--out', tmp + '/wf.npy', '--framebuffer', tmp + '/fb.npy']) == 0
assert main(['scan', '--source', 'test:480000', '--start=50e3',
             '--stop=150e3', '--blocks', '2', '--block-size', '48000',
             '--device', 'cpu']) == 0
s = socket.socket(); s.bind(('127.0.0.1', 0)); port = s.getsockname()[1]
s.close()
served = []
t = threading.Thread(target=lambda: served.append(main(
    ['serve', '--source', 'test:240000', '--blocks', '2', '--block-size',
     '4096', '--port', str(port), '--device', 'cpu'])))
t.start()
from sdrpp_tpu_torch.io.wire import BasebandClient
deadline = time.monotonic() + 60
while True:
    try:
        client = BasebandClient('127.0.0.1', port)
        break
    except OSError:
        assert time.monotonic() < deadline
        time.sleep(0.05)
client.start()
frames = [client.read_packet() for _ in range(2)]
assert [f[0] for f in frames] == ['baseband'] * 2
assert all(f[1].shape == (4096,) for f in frames)
client.close()
t.join(60)
assert served == [0]
from sdrpp_tpu_torch.io.sources import TestSource
from sdrpp_tpu_torch.misc.webui import ReceiverEngine

class Two:
    samplerate = 1000000.0
    def __init__(self):
        self.src, self.left = TestSource(1000000.0), 2 * 64000
    def read(self, n):
        n = min(n, self.left)
        self.left -= n
        return self.src.read(n)

eng = ReceiverEngine(Two(), mode='nfm', offset=100000.0, fft_size=4096,
                     base_block=65536, realtime=False, device='cpu')
eng.start()
eng._thread.join(120)
assert eng.blocks == 2 and eng.error is None, (eng.blocks, eng.error)
assert eng.audio_written('vfo0') > 0
assert main(['preheat', '--modes', 'nfm,meteor', '--no-variants',
             '--samplerate', '250000', '--block-size', '65536',
             '--fft-size', '4096', '--device', 'cpu']) == 0
for name in {modules!r}:
    importlib.import_module(name)
import chip_smoke
assert set(chip_smoke.kernel_fns()) | set(chip_smoke.GENERAL) == set(chip_smoke.SOURCES)
bad = sorted(m for m in sys.modules
             if m in ('jax', 'sdrpp_tpu') or m.startswith(('jax.',
                                                           'sdrpp_tpu.')))
assert not bad, bad
print('IMPORTED', len({modules!r}))
"""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"IMPORTED {len(modules)}" in proc.stdout
    assert len(list((tmp_path / "bank").iterdir())) == 2
    assert "sdrpp_tpu_torch.io.wav" in modules


def test_entry_points_default_to_the_card(tmp_path):
    """With no device named, the top-level objects and every command run
    on CUDA; where torch has no card they raise instead of falling back
    to the CPU."""
    import torch

    from sdrpp_tpu_torch.cli import main
    from sdrpp_tpu_torch.decoders.atv import ATVDecoder
    from sdrpp_tpu_torch.decoders.meteor_lrpt import MeteorLRPTDecoder
    from sdrpp_tpu_torch.ops.ofdm import CyclicSync
    from sdrpp_tpu_torch.parallel.vfo_bank import ScannerBank
    from sdrpp_tpu_torch.receiver import Receiver
    from sdrpp_tpu_torch.utils.pipeline import Prefetcher

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: Receiver(240000.0, block_size=48000, fft_size=1024),
                 lambda: MeteorLRPTDecoder(),
                 lambda: ScannerBank([0.0], 768000.0, mode="nfm"),
                 lambda: Prefetcher(tsources.TestSource(48000.0), 1000),
                 lambda: ATVDecoder(),
                 lambda: CyclicSync(2048, 504, 1.0).init_state()):
        with pytest.raises((RuntimeError, AssertionError)):
            make()
    for argv in (["run", "--source", "test:240000", "--blocks", "1",
                  "--out", str(tmp_path / "a.wav")],
                 ["run", "--source", "test:240000", "--blocks", "1",
                  "--checkpoint", str(tmp_path / "c.npz"),
                  "--out", str(tmp_path / "c.wav")],
                 ["bank", "--source", "test:768000", "--offsets", "0",
                  "--blocks", "1", "--out-dir", str(tmp_path / "bank")],
                 ["decode", "meteor", "--source", "test:150000", "--blocks",
                  "1", "--out", str(tmp_path / "m.s")],
                 ["spectrum", "--source", "test:240000", "--blocks", "1",
                  "--block-size", "48000", "--out", str(tmp_path / "w.npy")],
                 ["scan", "--source", "test:240000", "--start=-1e4",
                  "--stop=1e4", "--blocks", "1"],
                 ["serve", "--source", "test:240000", "--blocks", "1",
                  "--port", "0"],
                 ["ui", "--source", "test:1000000", "--no-realtime",
                  "--port", "0"],
                 ["preheat", "--modes", "nfm", "--no-variants"]):
        with pytest.raises((RuntimeError, AssertionError)):
            main(argv)
