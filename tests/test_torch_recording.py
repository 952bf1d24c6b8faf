"""The port's recorder containers (sdrpp_tpu_torch.io.flac, io.mp3 and
RecorderSink) against the JAX package's: every case of
tests/test_flac_mp3.py on the port, the port's FLAC encoder writing the
same bytes as JAX's on the same input, and ``cli run`` / ``cli bank``
recording FLAC and MP3 on the CPU.

Tolerances: FLAC is lossless and both encoders are the same numpy code, so
files are compared byte for byte and decoded samples exactly; MP3 is lossy,
so (as in the JAX test) a decoded tone is held by its correlation with the
input (> 0.98) and the port's MP3 bytes against JAX's exactly (the same
libmp3lame calls on the same int16 samples). MP3 cases skip only where
``io.mp3.available()`` is false (no libmp3lame), as the JAX test's do.
"""

import numpy as np
import pytest

from sdrpp_tpu.io import flac as jflac
from sdrpp_tpu.io import mp3 as jmp3
from sdrpp_tpu_torch.io import flac as tflac
from sdrpp_tpu_torch.io import mp3 as tmp3
from sdrpp_tpu_torch.io.flac import FlacWriter, crc8, crc16, read_flac
from sdrpp_tpu_torch.io.sinks import RecorderSink



@pytest.fixture
def lame():
    """Skips a test where libmp3lame is absent (decided when it runs)."""
    if not tmp3.available():
        pytest.skip("libmp3lame not present")


def _tonal(n, ch=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 997 * t)
    x = np.stack([sig * (0.5 + 0.5 * c) for c in range(ch)], -1)
    return x + 0.01 * rng.standard_normal((n, ch))


def _quant(x, bits):
    full = float(1 << (bits - 1))
    return np.clip(np.rint(x.astype(np.float64) * full), -full, full - 1) \
        .astype(np.int32)


# ------------------------------------------- the JAX test's cases, on the port

class TestFlac:
    def test_roundtrip_stereo_i16(self, tmp_path):
        x = _tonal(10000)
        p = tmp_path / "a.flac"
        with FlacWriter(p, 48000, channels=2, bits=16, block_size=4096) as w:
            w.write(x[:3000])
            w.write(x[3000:])
        info, dec = read_flac(p)
        assert (info.samplerate, info.channels, info.bits) == (48000, 2, 16)
        assert info.total_samples == 10000
        np.testing.assert_array_equal(dec, _quant(x, 16))

    def test_roundtrip_mono_24bit_noise(self, tmp_path):
        rng = np.random.default_rng(7)
        y = rng.integers(-(1 << 23), 1 << 23, size=5000).astype(np.int64)
        p = tmp_path / "n.flac"
        with FlacWriter(p, 44100, channels=1, bits=24, block_size=1024) as w:
            w.write(y)
        _, dec = read_flac(p)
        np.testing.assert_array_equal(dec[:, 0], y.astype(np.int32))

    def test_constant_and_short_final_frame(self, tmp_path):
        y = np.full(3001, 123, np.int64)
        p = tmp_path / "c.flac"
        with FlacWriter(p, 8000, channels=1, bits=16, block_size=1024) as w:
            w.write(y)
        info, dec = read_flac(p)
        assert info.total_samples == 3001
        np.testing.assert_array_equal(dec[:, 0], y.astype(np.int32))

    def test_compresses_tonal_audio(self, tmp_path):
        x = _tonal(16384)
        p = tmp_path / "z.flac"
        with FlacWriter(p, 48000, channels=2, bits=16) as w:
            w.write(x)
        assert p.stat().st_size < 16384 * 2 * 2 * 0.9

    def test_stream_structure(self, tmp_path):
        p = tmp_path / "s.flac"
        with FlacWriter(p, 48000, channels=1, bits=16, block_size=256) as w:
            w.write(_tonal(256, ch=1))
        blob = p.read_bytes()
        assert blob[:4] == b"fLaC"
        assert blob[4] == 0x80 and blob[5:8] == b"\x00\x00\x22"
        assert blob[42] == 0xFF and blob[43] == 0xF8
        assert blob[26:42] != b"\x00" * 16

    def test_crc_detects_corruption(self, tmp_path):
        p = tmp_path / "bad.flac"
        with FlacWriter(p, 48000, channels=1, bits=16, block_size=1024) as w:
            w.write(_tonal(2048, ch=1))
        blob = bytearray(p.read_bytes())
        blob[-3] ^= 0x40
        p.write_bytes(bytes(blob))
        with pytest.raises(ValueError):
            read_flac(p)

    def test_lpc_roundtrip_and_smaller(self, tmp_path):
        n = 16384
        t = np.arange(n) / 48000.0
        x = (0.5 * np.sin(2 * np.pi * 440.5 * t))[:, None]
        sizes = {}
        for lpc in (False, True):
            p = tmp_path / f"lpc{lpc}.flac"
            with FlacWriter(p, 48000, channels=1, bits=16, lpc=lpc) as w:
                w.write(x)
            info, dec = read_flac(p)
            np.testing.assert_array_equal(dec, _quant(x, 16))
            sizes[lpc] = p.stat().st_size
        assert sizes[True] < sizes[False]

    def test_crc_vectors(self):
        assert crc8(b"123456789") == 0xF4
        assert crc16(b"123456789") == 0xFEE8


class TestMp3:
    def test_roundtrip_correlation(self, tmp_path, lame):
        n = 48000
        t = np.arange(n) / 48000.0
        sig = 0.5 * np.sin(2 * np.pi * 440 * t)
        x = np.stack([sig, sig], -1)
        p = tmp_path / "a.mp3"
        with tmp3.Mp3Writer(p, 48000, channels=2) as w:
            w.write(x)
        assert p.stat().st_size > 1000
        rate, dec = tmp3.decode_mp3(p)
        assert rate == 48000
        best = max(
            np.corrcoef(dec[lag:lag + 8000, 0], sig[:8000])[0, 1]
            for lag in range(0, 3000, 24)
            if len(dec) - lag >= 8000)
        assert best > 0.98


class TestRecorderSink:
    def test_dispatch_flac(self, tmp_path):
        p = tmp_path / "r.flac"
        s = RecorderSink(p, 48000, container="flac", channels=1)
        s.write(_tonal(4096, ch=1)[:, 0])
        s.close()
        info, dec = read_flac(p)
        assert info.total_samples == 4096

    def test_flac_rejects_float_format(self, tmp_path):
        with pytest.raises(ValueError):
            RecorderSink(tmp_path / "x.flac", 48000, container="flac",
                         sample_format="f32")

    def test_dispatch_wav(self, tmp_path):
        from sdrpp_tpu_torch.io.wav import read_wav
        p = tmp_path / "r.wav"
        s = RecorderSink(p, 48000, container="wav")
        s.write(_tonal(1000, ch=1)[:, 0])
        s.close()
        info, _ = read_wav(p)
        assert info.samplerate == 48000

    def test_dispatch_mp3(self, tmp_path, lame):
        p = tmp_path / "r.mp3"
        s = RecorderSink(p, 48000, container="mp3", channels=1)
        s.write(_tonal(48000, ch=1)[:, 0])
        s.close()
        rate, dec = tmp3.decode_mp3(p)
        assert rate == 48000 and len(dec) > 40000


def test_flac_stereo_decorrelation_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    n = 9000
    t = np.arange(n)
    base = (3000 * np.sin(2 * np.pi * 440 * t / 48000)).astype(np.int64)
    noise = rng.integers(-40, 40, n)
    left = base + noise
    right = base + noise + rng.integers(-4, 4, n)
    blk = np.stack([left, right], 1).astype(np.int64)
    for mode in ("auto", "independent", "left_side", "right_side",
                 "mid_side"):
        p = tmp_path / f"st_{mode}.flac"
        with FlacWriter(p, 48000, channels=2, bits=16, stereo_mode=mode) as w:
            w.write(blk)
        info, got = read_flac(p)
        assert info.channels == 2 and info.total_samples == n
        np.testing.assert_array_equal(got, blk.astype(np.int32))
    auto = tmp_path / "st_auto.flac"
    indep = tmp_path / "st_independent.flac"
    assert auto.stat().st_size < indep.stat().st_size


def test_flac_mid_side_odd_sum_exact(tmp_path):
    rng = np.random.default_rng(1)
    blk = rng.integers(-(1 << 14), 1 << 14, (5000, 2)).astype(np.int64)
    blk[::2, 0] += 1
    p = tmp_path / "ms.flac"
    with FlacWriter(p, 48000, channels=2, bits=16,
                    stereo_mode="mid_side") as w:
        w.write(blk)
    _, got = read_flac(p)
    np.testing.assert_array_equal(got, blk.astype(np.int32))


# --------------------------------------------------- the same bytes as JAX's

BYTE_CASES = {
    "stereo_i16": dict(kw=dict(samplerate=48000, channels=2, bits=16,
                               block_size=4096),
                       data=lambda: [_tonal(3000), _tonal(7000, seed=1)]),
    "mono_i24": dict(kw=dict(samplerate=44100, channels=1, bits=24,
                             block_size=1024),
                     data=lambda: [np.random.default_rng(7).integers(
                         -(1 << 23), 1 << 23, size=5000).astype(np.int64)]),
    "short_final_frame": dict(kw=dict(samplerate=8000, channels=1, bits=16,
                                      block_size=1024),
                              data=lambda: [_tonal(3001, ch=1, seed=2)]),
    "mid_side_lpc": dict(kw=dict(samplerate=48000, channels=2, bits=16,
                                 stereo_mode="mid_side", lpc=True),
                         data=lambda: [_tonal(9000, seed=3)]),
}


@pytest.mark.parametrize("case", sorted(BYTE_CASES))
def test_flac_bytes_equal_jax(tmp_path, case):
    c = BYTE_CASES[case]
    blobs = []
    for mod in (jflac, tflac):
        p = tmp_path / f"{mod.__name__}.flac"
        with mod.FlacWriter(p, **c["kw"]) as w:
            for chunk in c["data"]():
                w.write(chunk)
        blobs.append(p.read_bytes())
    assert blobs[0] == blobs[1]
    (ji, jd), (ti, td) = jflac.read_flac(tmp_path / f"{jflac.__name__}.flac"), \
        tflac.read_flac(tmp_path / f"{jflac.__name__}.flac")
    assert (ji.samplerate, ji.channels, ji.bits, ji.total_samples) == \
        (ti.samplerate, ti.channels, ti.bits, ti.total_samples)
    np.testing.assert_array_equal(jd, td)


def test_mp3_bytes_equal_jax(tmp_path, lame):
    x = _tonal(24000)
    blobs = []
    for mod in (jmp3, tmp3):
        p = tmp_path / f"{mod.__name__}.mp3"
        with mod.Mp3Writer(p, 48000, channels=2) as w:
            w.write(x[:10000])
            w.write(x[10000:])
        blobs.append(p.read_bytes())
    assert blobs[0] == blobs[1]


# ------------------------------------------------------------- the commands

def test_cli_run_flac_container(tmp_path):
    """tests/test_flac_mp3.py::test_cli_run_flac_container on the port."""
    from sdrpp_tpu_torch.cli import main

    out = tmp_path / "audio.flac"
    assert main(["run", "--source", "test:1024000", "--mode", "nfm",
                 "--tone", "0", "--out", str(out), "--container", "flac",
                 "--blocks", "2", "--block-size", "131072",
                 "--device", "cpu"]) == 0
    info, dec = read_flac(out)
    assert info.samplerate == 48000
    assert info.total_samples > 0


@pytest.mark.parametrize("container", ["flac", "mp3"])
def test_cli_bank_container(tmp_path, container, request):
    if container == "mp3":
        request.getfixturevalue("lame")
    from sdrpp_tpu_torch.cli import main

    out = tmp_path / "bank"
    assert main(["bank", "--source", "test:768000", "--tone", "100000",
                 "--offsets=-100e3,100e3", "--mode", "nfm", "--blocks", "2",
                 "--block-size", "65536", "--device", "cpu", "--container",
                 container, "--out-dir", str(out)]) == 0
    files = sorted(out.glob(f"*.{container}"))
    assert len(files) == 2
    for f in files:
        if container == "flac":
            info, dec = read_flac(f)
            assert info.samplerate == 48000 and info.total_samples > 0
        else:
            rate, dec = tmp3.decode_mp3(f)
            assert rate == 48000 and len(dec) > 0


def test_cli_run_mp3_container(tmp_path, lame):
    from sdrpp_tpu_torch.cli import main

    out = tmp_path / "a.mp3"
    assert main(["run", "--source", "test:1024000", "--mode", "am",
                 "--tone", "1000", "--container", "mp3", "--blocks", "2",
                 "--block-size", "131072", "--out", str(out),
                 "--device", "cpu"]) == 0
    rate, dec = tmp3.decode_mp3(out)
    assert rate == 48000 and len(dec) > 0
