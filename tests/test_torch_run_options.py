"""``cli run``'s and ``cli bank``'s options on the port: the watchdog
(utils.watchdog), checkpoint / resume (utils.checkpoint), tracing and the
stream monitor (utils.tracing), against the JAX package's.

- the cases of tests/test_watchdog.py and tests/test_tracing.py on the
  port, and the watchdog's CUDA points checked through stand-ins: a step
  whose device work is not done by the deadline times out, and a
  poisoned device raises at once instead of retrying;
- checkpoint parity: a WFM ``RadioChannel`` run two blocks in JAX and
  saved with JAX's ``save_state`` loads in the port's ``load_state``, and
  the port's third block matches JAX's third block; the same in the other
  direction. Tolerance: tests/test_torch_radio.py's for a block run from
  JAX's carried state, the RMS difference below -60 dB of the audio;
- resume: ``cli run --container flac`` through four blocks of a WAV
  source decodes to exactly the samples of two blocks with
  ``--checkpoint`` and two with ``--resume`` (the state round-trips
  through the .npz exactly, and the CPU loop is deterministic);
- ``--trace`` writes a Chrome trace that names the run's region;
- the argument lists of ``run`` and ``bank`` equal JAX's, but for
  ``--device`` in place of ``--cpu``.
"""

import argparse
import json
import logging
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.models.radio import RadioChannel as JaxRadioChannel
from sdrpp_tpu.ops import resample as jresample
from sdrpp_tpu.utils import checkpoint as jckpt
from sdrpp_tpu_torch.models.radio import RadioChannel
from sdrpp_tpu_torch.utils import checkpoint as tckpt
from sdrpp_tpu_torch.utils import watchdog as twd
from sdrpp_tpu_torch.utils.tracing import StreamMonitor, annotate, trace
from sdrpp_tpu_torch.utils.watchdog import StepTimeout, StepWatchdog

torch.set_num_threads(1)

FS = 960000.0
OFFSET = 30000.0
RESUMED_DB = -60.0


# ---------------------------------------------- tests/test_watchdog.py's cases

def test_passthrough_success():
    wd = StepWatchdog(lambda: (lambda s, x: (s + 1, x * 2)))
    s, y = wd(0, 21)
    assert (s, y) == (1, 42)
    assert wd.steps == 1 and wd.total_failures == 0


def test_retries_then_succeeds():
    calls = {"n": 0}

    def make_step():
        def step(s, x):
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("transient backend flake")
            return s, x
        return step

    events = []
    wd = StepWatchdog(make_step, max_retries=5, backoff_s=0.0,
                      on_event=lambda kind, **kw: events.append(kind))
    s, y = wd(0, 7)
    assert y == 7
    assert wd.total_failures == 2
    assert "failure" in events and "rejit" in events


def test_gives_up_after_max_retries():
    def make_step():
        def step(s, x):
            raise RuntimeError("permanent")
        return step

    wd = StepWatchdog(make_step, max_retries=2, backoff_s=0.0)
    with pytest.raises(RuntimeError):
        wd(0, 1)
    assert wd.total_failures == 3


def test_timeout_fires():
    def make_step():
        def step(s, x):
            time.sleep(5.0)
            return s, x
        return step

    wd = StepWatchdog(make_step, timeout_s=0.2, max_retries=0)
    with pytest.raises(StepTimeout):
        wd(0, 1)


def test_checkpoint_and_restore(tmp_path):
    ckpt = tmp_path / "wd.ckpt"
    wd = StepWatchdog(lambda: (lambda s, x: (s + x, x)),
                      checkpoint_path=str(ckpt), checkpoint_every=1)
    state = torch.zeros(())
    for i in range(3):
        state = wd(state, torch.tensor(1.0), offset=i + 1)[0]
    assert ckpt.exists()
    wd2 = StepWatchdog(lambda: (lambda s, x: (s + x, x)),
                       checkpoint_path=str(ckpt))
    restored, offset = wd2.restore(torch.zeros(()))
    assert float(restored) == 3.0 and offset == 3


def test_checkpoint_extensionless_path_roundtrip(tmp_path):
    p = tmp_path / "foo.ckpt"
    state = {"a": torch.arange(4.0), "b": torch.zeros((2, 2))}
    tckpt.save_state(str(p), state, stream_offset=77)
    assert p.exists()
    restored, off = tckpt.load_state(str(p), state)
    assert off == 77
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  np.arange(4.0, dtype=np.float32))


# ---------------------------------------------- the watchdog's CUDA points

class _Device:
    type = "cuda"


class _PendingEvent:
    """A CUDA event whose work never completes."""

    def record(self, stream=None):
        pass

    def query(self):
        return False


def test_device_work_past_the_deadline_times_out(monkeypatch):
    """A step that returns at once (its kernels only queued) but whose
    device work is not done by the deadline raises StepTimeout: the
    watchdog polls an event recorded after the step, not the call."""
    monkeypatch.setattr(twd, "_cuda_device", lambda tree: _Device())
    monkeypatch.setattr(torch.cuda, "Event", _PendingEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    wd = StepWatchdog(lambda: (lambda s, x: (s, x)), timeout_s=0.1,
                      max_retries=0)
    t0 = time.perf_counter()
    with pytest.raises(StepTimeout):
        wd(0, 1)
    assert 0.1 <= time.perf_counter() - t0 < 2.0
    # without a timeout nothing waits on the device
    assert StepWatchdog(lambda: (lambda s, x: (s, x)))(0, 1) == (0, 1)


@pytest.mark.parametrize("poisoned", [True, False])
def test_poisoned_device_raises_at_once(monkeypatch, poisoned):
    """At rejit_after consecutive failures on a CUDA step, a poisoned
    context (the probe's tiny launch fails) raises at once; otherwise the
    step is rebuilt and retried, as the JAX package re-traces it."""
    monkeypatch.setattr(twd, "_cuda_device", lambda tree: _Device())
    monkeypatch.setattr(twd, "device_poisoned", lambda d: poisoned)
    built, events = [], []

    def make_step():
        built.append(1)

        def step(s, x):
            if len(built) < 3:
                raise RuntimeError("an illegal memory access")
            return s, x
        return step

    wd = StepWatchdog(make_step, max_retries=5, rejit_after=2,
                      backoff_s=0.0,
                      on_event=lambda kind, **kw: events.append(kind))
    if poisoned:
        with pytest.raises(RuntimeError):
            wd(0, 1)
        assert wd.total_failures == 2 and len(built) == 1
        assert events == ["failure", "failure", "poisoned"]
    else:
        assert wd(0, 1) == (0, 1)
        assert len(built) == 3 and events.count("rejit") == 2


def test_device_poisoned_probe_on_the_cpu():
    assert twd.device_poisoned("cpu") is False


# --------------------------------------------- tests/test_tracing.py's cases

def test_stream_monitor_counters():
    mon = StreamMonitor(samplerate=1e6)
    for _ in range(5):
        with mon.block(1000):
            time.sleep(0.001)
    r = mon.report()
    assert r["blocks"] == 5 and r["samples"] == 5000
    assert r["samples_per_sec"] > 0 and r["ema_block_ms"] >= 1.0
    assert r["realtime_factor"] == r["samples_per_sec"] / 1e6
    assert "Msamp/s" in str(mon)


def test_stream_monitor_reset():
    mon = StreamMonitor()
    with mon.block(10):
        pass
    mon.reset()
    assert mon.blocks == 0 and mon.samples == 0
    assert mon.realtime_factor is None


def test_annotate_and_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        with annotate("test_region"):
            float(torch.sum(torch.arange(128.0) * 2))
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "test_region" in names


def test_cli_run_reports_throughput(tmp_path, caplog):
    from sdrpp_tpu_torch.cli import main

    with caplog.at_level(logging.INFO, logger="sdrpp_tpu_torch"):
        assert main(["run", "--source", "test:1024000", "--mode", "am",
                     "--tone", "0", "--out", str(tmp_path / "a.wav"),
                     "--blocks", "2", "--block-size", "131072",
                     "--device", "cpu"]) == 0
    assert any("Msamp/s" in r.getMessage() for r in caplog.records)


def test_cli_bank_multichannel(tmp_path, caplog):
    """tests/test_tracing.py::test_cli_bank_multichannel on the port, and
    the monitor's line."""
    from sdrpp_tpu_torch.cli import main
    from sdrpp_tpu_torch.io.wav import read_wav

    out = tmp_path / "bank"
    with caplog.at_level(logging.INFO, logger="sdrpp_tpu_torch"):
        assert main(["bank", "--source", "test:1024000", "--tone", "150000",
                     "--offsets=-200e3,150e3", "--mode", "nfm", "--blocks",
                     "2", "--block-size", "131072", "--out-dir", str(out),
                     "--device", "cpu"]) == 0
    assert any("Maggsamp/s" in r.getMessage() for r in caplog.records)
    files = sorted(out.glob("*.wav"))
    assert len(files) == 2
    rms = []
    for f in files:
        info, d = read_wav(f)
        assert info.samplerate == 48000
        rms.append(float(np.sqrt(np.mean(d ** 2))))
    assert rms[1] < 0.3 < rms[0]


# ------------------------------------------------------- checkpoint parity

def _rms_db(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref = np.sqrt(np.mean(want ** 2)) + 1e-30
    return 20 * np.log10(np.sqrt(np.mean((got - want) ** 2)) / ref + 1e-30)


def _signal(n, seed=0):
    """tests/test_torch_radio.py's FM carrier (1 kHz, 3 kHz deviation) at
    OFFSET with an AM carrier beside it and seeded noise."""
    t = np.arange(n) / FS
    rng = np.random.default_rng(seed)
    tone = np.sin(2 * np.pi * 1000.0 * t)
    x = 0.3 * np.exp(1j * (2 * np.pi * OFFSET * t
                           + np.cumsum(2 * np.pi * 3000.0 * tone / FS)))
    x = x + 0.2 * (1 + 0.5 * np.sin(2 * np.pi * 700.0 * t)) \
        * np.exp(2j * np.pi * (OFFSET + 20000.0) * t)
    x = x + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _audio(y):
    return np.asarray(y[0] if isinstance(y, tuple) else y)


@pytest.fixture
def wfm_pair(monkeypatch):
    monkeypatch.setattr(jresample, "POLYPHASE_MODE", "zero_stuff")
    jchan = JaxRadioChannel("wfm", FS, offset=OFFSET)
    for name in ("pilot_pll", "audio_agc", "carrier_agc", "agc"):
        loop = getattr(jchan.demod, name, None)
        if loop is not None and hasattr(loop, "interpret"):
            loop.interpret = True
    chan = RadioChannel("wfm", FS, offset=OFFSET, device="cpu")
    nb = chan.block_multiple * max(1, 48000 // chan.block_multiple)
    return jchan, chan, nb, _signal(3 * nb)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, wfm_pair):
    jchan, chan, nb, x = wfm_pair
    step = jax.jit(jchan)
    st = jchan.init_state()
    for k in range(2):
        st, _ = step(st, jnp.asarray(x[k * nb:(k + 1) * nb]))
    path = tmp_path / "jax.npz"
    jckpt.save_state(path, st, stream_offset=2 * nb, metadata={"mode": "wfm"})
    _, jy3 = step(st, jnp.asarray(x[2 * nb:]))
    ts, off = tckpt.load_state(path, chan.init_state())
    assert off == 2 * nb
    _, ty3 = chan(ts, torch.from_numpy(x[2 * nb:]))
    assert _rms_db(_audio(ty3), _audio(jy3)) < RESUMED_DB


def test_port_checkpoint_resumes_in_jax(tmp_path, wfm_pair):
    jchan, chan, nb, x = wfm_pair
    ts = chan.init_state()
    for k in range(2):
        ts, _ = chan(ts, torch.from_numpy(x[k * nb:(k + 1) * nb]))
    path = tmp_path / "port.npz"
    tckpt.save_state(path, ts, stream_offset=2 * nb)
    _, ty3 = chan(ts, torch.from_numpy(x[2 * nb:]))
    js, off = jckpt.load_state(path, jchan.init_state())
    assert off == 2 * nb
    _, jy3 = jax.jit(jchan)(js, jnp.asarray(x[2 * nb:]))
    assert _rms_db(_audio(ty3), _audio(jy3)) < RESUMED_DB


def test_checkpoint_files_have_jax_keys(tmp_path, wfm_pair):
    """Both packages write the same keys, shapes and dtypes for one chain;
    a graph mismatch raises ValueError."""
    jchan, chan, _, _ = wfm_pair
    a, b = tmp_path / "j.npz", tmp_path / "t.npz"
    jckpt.save_state(a, jchan.init_state(), stream_offset=5)
    tckpt.save_state(b, chan.init_state(), stream_offset=5)
    ja, tb = dict(np.load(a)), dict(np.load(b))
    assert set(ja) == set(tb)
    for k in ja:
        assert ja[k].shape == tb[k].shape and ja[k].dtype == tb[k].dtype, k
    other = RadioChannel("nfm", FS, offset=OFFSET, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.load_state(b, other.init_state())


# -------------------------------------------------------- cli run resume

def _wav_source(path, n, fs=FS):
    from sdrpp_tpu_torch.io import wav

    x = _signal(n)
    wav.write_wav(path, int(fs), np.stack([x.real, x.imag], -1), "f32")


def test_cli_run_resume_is_exact(tmp_path):
    from sdrpp_tpu_torch.cli import main
    from sdrpp_tpu_torch.io.flac import read_flac

    block = 96000
    src = tmp_path / "iq.wav"
    _wav_source(src, 4 * block)
    common = ["run", "--source", str(src), "--mode", "wfm", "--offset",
              str(OFFSET), "--container", "flac", "--block-size",
              str(block), "--device", "cpu"]
    ck = tmp_path / "c.npz"
    assert main([*common, "--blocks", "4", "--out",
                 str(tmp_path / "all.flac")]) == 0
    assert main([*common, "--blocks", "2", "--checkpoint", str(ck),
                 "--checkpoint-every", "1", "--out",
                 str(tmp_path / "a.flac")]) == 0
    assert int(np.load(ck)["__stream_offset__"]) == 2 * block
    assert main([*common, "--blocks", "2", "--checkpoint", str(ck),
                 "--resume", "--out", str(tmp_path / "b.flac")]) == 0
    assert int(np.load(ck)["__stream_offset__"]) == 4 * block
    _, whole = read_flac(tmp_path / "all.flac")
    _, a = read_flac(tmp_path / "a.flac")
    _, b = read_flac(tmp_path / "b.flac")
    assert len(a) == len(b) == len(whole) // 2 > 0
    np.testing.assert_array_equal(np.concatenate([a, b]), whole)
    # a checkpoint of another chain: an error, exit code 2
    assert main(["run", "--source", str(src), "--mode", "nfm",
                 "--block-size", str(block), "--device", "cpu",
                 "--checkpoint", str(ck), "--resume", "--out",
                 str(tmp_path / "x.wav")]) == 2


def test_cli_run_trace_writes_a_trace(tmp_path):
    from sdrpp_tpu_torch.cli import main

    logdir = tmp_path / "trace"
    assert main(["run", "--source", "test:480000", "--mode", "nfm",
                 "--blocks", "1", "--block-size", "48000", "--device", "cpu",
                 "--trace", str(logdir), "--out",
                 str(tmp_path / "a.wav")]) == 0
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "run:nfm" in names


# ------------------------------------------------------------- arguments

def _options(mod, cmd):
    seen = {}

    class Stop(Exception):
        pass

    def parse(self, argv=None, namespace=None):
        seen.update({tuple(a.option_strings) or a.dest:
                     (a.dest, a.default, tuple(a.choices or ()))
                     for a in self._actions})
        raise Stop

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse
    try:
        getattr(mod, f"cmd_{cmd}")([])
    except Stop:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen


@pytest.mark.parametrize("cmd", ["run", "bank"])
def test_run_and_bank_arguments_match_jax(cmd):
    from sdrpp_tpu import cli as jcli
    from sdrpp_tpu_torch import cli as tcli

    j, t = _options(jcli, cmd), _options(tcli, cmd)
    assert t.pop(("--device",))[1] == "cuda"
    j.pop(("--cpu",))
    assert t == j
