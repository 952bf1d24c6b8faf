"""``cli decode kgsstv|m17`` of the port (``--device cpu``) against the JAX
package's CLI on the same IQ WAV, both through their ``RxVFO``: KG-STV's
test signal at +1 kHz at its own 12 kHz, and an M17 call (LSF, then voice
stream frames) at +5 kHz in a 96 kHz capture, which the VFO decimates to
48 kHz. Held exactly: the KG-STV frame file (with each frame's last two
bits, which the reference decodes out of erasures, masked against what was
sent) and, where the system libcodec2 is present, the M17 voice WAV byte
for byte. Each M17 CLI runs in a process of its own: libcodec2 draws its
synthesis phases from one generator a process.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sdrpp_tpu_torch import cli
from sdrpp_tpu_torch.decoders import codec2 as tcodec2

from test_torch_decode_cli import jax_cli, offset_wav  # noqa: F401
from test_torch_decode_paths import LSF, _mask, _shaped_fm, kgsstv_signal

REPO = Path(__file__).resolve().parent.parent


def test_cli_decode_kgsstv_matches_jax(tmp_path, jax_cli):  # noqa: F811
    frames, iq = kgsstv_signal()
    src = tmp_path / "kgsstv.wav"
    offset_wav(src, iq, 12000.0, 1000.0)
    a, b = tmp_path / "port.bin", tmp_path / "jax.bin"
    argv = ["decode", "kgsstv", "--source", str(src), "--offset", "1000"]
    assert cli.main(argv + ["--device", "cpu", "--out", str(a)]) == 0
    jax_cli.main(argv + ["--cpu", "--out", str(b)])
    got = a.read_bytes()
    assert got == b.read_bytes()
    assert _mask([got[i:i + 7] for i in range(0, len(got), 7)]) == \
        _mask(frames)


def _run_cli(package, argv, extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", SDRPP_TPU_NO_CACHE="1",
               PYTHONPATH=str(REPO))
    code = (f"import sys; from {package}.cli import main; "
            f"sys.exit(main({argv + extra!r}) or 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stderr


def test_cli_decode_m17_matches_jax(tmp_path):
    if not tcodec2.available():
        pytest.skip("libcodec2 not present")
    from sdrpp_tpu.decoders import codec2 as jcodec2
    from sdrpp_tpu.decoders import m17_frame as jmf

    nframes = 10
    t = np.arange(nframes * 2 * 160) / 8000.0
    bits = jcodec2.Codec2().encode(
        (np.sin(2 * np.pi * 440.0 * t) * 8000).astype(np.int16))
    blocks = [jmf.encode_lsf_frame(LSF)] + [
        jmf.encode_stream_frame(LSF, fn, bits[fn * 16:(fn + 1) * 16])
        for fn in range(nframes)]
    prng = np.random.default_rng(99)
    sym = np.concatenate(
        [(prng.integers(0, 2, 1200) * 2.0 - 1.0).astype(np.float32)]
        + [jmf.symbols_from_bits(b) for b in blocks]
        + [np.zeros(100, np.float32)])
    iq = _shaped_fm(sym, jmf.M17_BAUDRATE, 96000.0, jmf.M17_RRC_ALPHA,
                    jmf.M17_DEVIATION, np.random.default_rng(5), 0.02)
    src = tmp_path / "m17.wav"
    offset_wav(src, iq, 96000.0, 5000.0)
    a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
    argv = ["decode", "m17", "--source", str(src), "--offset", "5000"]
    log = _run_cli("sdrpp_tpu_torch", argv, ["--device", "cpu", "--out",
                                             str(a)])
    assert "M17 LSF: dst=SP5WWP src=N0CALL" in log
    _run_cli("sdrpp_tpu", argv, ["--cpu", "--out", str(b)])
    assert a.read_bytes() == b.read_bytes()
    from sdrpp_tpu_torch.io import wav

    info, data = wav.read_wav(a)
    assert (info.samplerate, info.channels) == (8000, 2)
    assert data.shape[0] >= (nframes - 2) * 320
