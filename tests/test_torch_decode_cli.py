"""``cli decode hrpt|falcon9`` of the port (``--device cpu``) against the
JAX package's CLI on the same IQ WAV: the decode paths' test signals
(test_torch_decode_paths.py) moved off the centre, so both run through
their ``RxVFO`` (an offset at the decoder's own rate). Held exactly: the
HRPT AVHRR lines (.npy) and the Falcon 9 video TS file, byte for byte, and
the frames they carry against what was sent.
"""

import numpy as np
import pytest

from sdrpp_tpu_torch import cli
from sdrpp_tpu_torch.io import wav

from test_torch_decode_paths import _fframe, _fpacket, hrpt_signal

HRPT_OFFSET = 100e3
FALCON9_OFFSET = 50e3


@pytest.fixture
def jax_cli(monkeypatch):
    """The JAX package's CLI, without its persistent compilation cache."""
    from sdrpp_tpu import cli as jcli

    monkeypatch.setenv("SDRPP_TPU_NO_CACHE", "1")
    return jcli


def offset_wav(path, iq, fs, offset):
    """``iq`` moved to +offset Hz, as a float32 stereo WAV."""
    x = iq * np.exp(2j * np.pi * offset * np.arange(len(iq)) / fs)
    wav.write_wav(path, int(fs), np.stack([x.real, x.imag], -1), "f32")


def _decode_both(jcli, mode, src, offset, tmp_path, suffix):
    a, b = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    argv = ["decode", mode, "--source", str(src), "--offset", str(offset)]
    assert cli.main(argv + ["--device", "cpu", "--out", str(a)]) == 0
    jcli.main(argv + ["--cpu", "--out", str(b)])
    return a, b


def test_cli_decode_hrpt_matches_jax(tmp_path, jax_cli):
    """The HRPT frame padded to three 262,144-sample blocks (the CLI's
    block at 3 Msps): one minor frame, its AVHRR lines equal."""
    words, iq = hrpt_signal()
    iq = np.concatenate([iq, np.zeros(3 * 262144 - len(iq), np.complex64)])
    src = tmp_path / "hrpt.wav"
    offset_wav(src, iq, 3e6, HRPT_OFFSET)
    a, b = _decode_both(jax_cli, "hrpt", src, HRPT_OFFSET, tmp_path, ".npy")
    assert a.read_bytes() == b.read_bytes()
    lines = np.load(a)
    assert lines.shape == (1, 5, 2048)
    np.testing.assert_array_equal(
        lines[0], words[750:750 + 10240].reshape(2048, 5).T)


def test_cli_decode_falcon9_matches_jax(tmp_path, jax_cli):
    """Two frames at 6 Msps: a video packet split across them and a GPS
    packet; the video TS bytes equal and the video payload whole."""
    from sdrpp_tpu.decoders import falcon9 as jf9

    rng = np.random.default_rng(4)
    video = bytes(rng.integers(0, 256, 940).astype(np.uint8))
    pkts = _fpacket(jf9.PKT_VIDEO, video) * 2 + _fpacket(
        jf9.PKT_GPS_A, b"GPS: T+00:00:09 OK\n")
    rs = jf9.FalconRS()
    frames = [_fframe(1, 0, pkts[:jf9.DATA_LEN]),
              _fframe(2, len(pkts) - jf9.DATA_LEN, pkts[jf9.DATA_LEN:])]
    bits = [rng.integers(0, 2, 4000).astype(np.uint8)]
    for f in frames:
        bits += [jf9.SYNC_BITS, np.unpackbits(rs.encode(f))]
    bits.append(rng.integers(0, 2, 500).astype(np.uint8))
    sym = np.concatenate(bits).astype(np.float64) * 2.0 - 1.0
    fs = jf9.Falcon9Decoder.INPUT_RATE
    sps = fs / jf9.Falcon9Decoder.BAUDRATE
    n = int(len(sym) * sps)
    idx = np.minimum((np.arange(n) / sps).astype(np.int64), len(sym) - 1)
    iq = np.exp(1j * np.cumsum(2 * np.pi * jf9.Falcon9Decoder.DEVIATION
                               * sym[idx] / fs)).astype(np.complex64)
    src = tmp_path / "falcon9.wav"
    offset_wav(src, iq, fs, FALCON9_OFFSET)
    a, b = _decode_both(jax_cli, "falcon9", src, FALCON9_OFFSET, tmp_path,
                        ".ts")
    assert a.read_bytes() == b.read_bytes() == video * 2


def test_decoders_and_decode_commands_default_to_the_card(tmp_path):
    """With no device named, the four decoders and their ``decode``
    commands run on CUDA; where torch has no card they raise instead of
    falling back to the CPU."""
    import torch

    from sdrpp_tpu_torch.decoders.falcon9 import Falcon9Decoder
    from sdrpp_tpu_torch.decoders.hrpt import HRPTDecoder
    from sdrpp_tpu_torch.decoders.kg_sstv import KGSSTVDecoder
    from sdrpp_tpu_torch.models.m17_chain import M17Decoder

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (HRPTDecoder, Falcon9Decoder, lambda: KGSSTVDecoder(12000.0),
                 lambda: M17Decoder(48000.0)):
        with pytest.raises((RuntimeError, AssertionError)):
            make()
    for mode, rate in (("hrpt", 3000000), ("falcon9", 6000000),
                       ("kgsstv", 12000), ("m17", 48000)):
        with pytest.raises((RuntimeError, AssertionError)):
            cli.main(["decode", mode, "--source", f"test:{rate}",
                      "--blocks", "1", "--out", str(tmp_path / mode)])
