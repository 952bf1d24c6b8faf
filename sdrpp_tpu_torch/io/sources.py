"""IQ sources: WAV file playback, synthetic test source, registry.

A numpy-only copy of the file and test sources of ``sdrpp_tpu.io.sources``
(reference: core/src/signal_path/source.h:9-56). A source is a host-side
object with ``read(n) -> np.complex64``, ``samplerate`` and ``tune(freq)``:

- FileSource: WAV IQ playback with looping and seek
  (source_modules/file_source/src/main.cpp — format matrix in io/wav.py,
  filename center-frequency detection, loop & seek)
- TestSource: tones at given dBFS over seeded white noise (reference
  test_source, source_modules/test_source/src/main.cpp:84-130); its blocks
  are the JAX package's, sample for sample.
- TableSource: the reference test source's fixed-point AES17 / SFDR
  tables (``TEST_TABLES_14BIT``, decoded by ``decode_test_table``) played
  cyclically.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from . import wav

__all__ = ["FileSource", "TestSource", "TableSource", "SourceManager",
           "TEST_TABLES_14BIT", "decode_test_table", "detect_center_freq"]

_FREQ_RE = re.compile(r"(\d{4,12})\s*Hz", re.IGNORECASE)
_FREQ_RE2 = re.compile(r"_(\d{4,12})(?:_|\.)")


def detect_center_freq(filename: str) -> float | None:
    """Center-frequency detection from the file name (file_source feature:
    a regex over the name, main.cpp filename parsing)."""
    name = Path(filename).name
    m = _FREQ_RE.search(name) or _FREQ_RE2.search(name)
    return float(m.group(1)) if m else None


class FileSource:
    """WAV IQ playback with loop + seek (reference file_source), over the
    memory-mapped streaming reader."""

    def __init__(self, path, loop: bool = True):
        self.path = str(path)
        self._reader = wav.WavStreamReader(path)
        self.samplerate = self._reader.samplerate
        self.num_frames = self._reader.num_frames
        self.loop = loop
        self.center_freq = detect_center_freq(self.path) or 0.0

    @property
    def pos(self):
        return self._reader.pos

    def seek(self, sample: int):
        self._reader.seek(sample)

    def tune(self, freq: float):
        self.center_freq = freq

    def read(self, n: int) -> np.ndarray:
        return self._reader.read(n, loop=self.loop)


class TestSource:
    """Synthetic IQ: tone(s) at configurable dBFS + white noise floor
    (reference test_source oscillator + xorshift noise, main.cpp:84-130)."""

    __test__ = False  # not a pytest class

    def __init__(self, samplerate: float = 1000000.0, tones=((100000.0, 0.0),),
                 noise_dbfs: float = -100.0, seed: int = 0xACE1):
        self.samplerate = float(samplerate)
        self.tones = [(float(f), float(db)) for f, db in tones]
        self.noise_amp = 10.0 ** (noise_dbfs / 20.0)
        self._rng = np.random.default_rng(seed)
        self._n = 0
        self.center_freq = 0.0

    def tune(self, freq: float):
        self.center_freq = freq

    def read(self, n: int) -> np.ndarray:
        t = (self._n + np.arange(n)) / self.samplerate
        out = np.zeros(n, np.complex128)
        for f, db in self.tones:
            out += 10.0 ** (db / 20.0) * np.exp(2j * np.pi * f * t)
        out += self.noise_amp * (self._rng.standard_normal(n)
                                 + 1j * self._rng.standard_normal(n)) / np.sqrt(2)
        self._n += n
        return out.astype(np.complex64)


class SourceManager:
    """Named source registry + selection (reference source.h:9-56)."""

    def __init__(self):
        self._sources: dict[str, object] = {}
        self.selected: str | None = None

    def register(self, name: str, source) -> None:
        self._sources[name] = source

    def unregister(self, name: str) -> None:
        self._sources.pop(name, None)
        if self.selected == name:
            self.selected = None

    def names(self):
        return list(self._sources)

    def select(self, name: str):
        if name not in self._sources:
            raise KeyError(name)
        self.selected = name
        return self._sources[name]

    @property
    def source(self):
        return self._sources[self.selected] if self.selected else None

    def tune(self, freq: float):
        if self.source is not None:
            self.source.tune(freq)


# Fixed-point AES17-style test vectors (pure data from the reference
# test source, source_modules/test_source/src/main.cpp:41-48; 14-bit
# two's-complement values, decoded as in TableSource::init main.cpp:84-96:
# sign-extend to `bits`, scale by 1/((1<<bits)/2 - 1)).
TEST_TABLES_14BIT = {
    "aes17_0dB": (0x3fff, 0x0c3e, 0x16a0, 0x1d8f, 0x1fff, 0x1d8f, 0x16a0,
                  0x0c3e, 0x0000, 0x33c1, 0x295f, 0x2270, 0x2000, 0x2270,
                  0x295f, 0x33c1),
    "aes17_m20dB": (0x3fff, 0x0139, 0x0243, 0x02f4, 0x0333, 0x02f4, 0x0243,
                    0x0139, 0x0000, 0x3ec6, 0x3dbc, 0x3d0b, 0x3ccc, 0x3d0b,
                    0x3dbc, 0x3ec6),
    "aes17_m40dB": (0x3fff, 0x001f, 0x0039, 0x004b, 0x0051, 0x004b, 0x0039,
                    0x001f, 0x0000, 0x3fe0, 0x3fc6, 0x3fb4, 0x3fae, 0x3fb4,
                    0x3fc6, 0x3fe0),
    "aes17_m60dB": (0x3fff, 0x0003, 0x0005, 0x0007, 0x0008, 0x0007, 0x0005,
                    0x0003, 0x0000, 0x3ffc, 0x3ffa, 0x3ff8, 0x3ff7, 0x3ff8,
                    0x3ffa, 0x3ffc),
    "sfdr119_56dB": (0, 3107, 5741, 7501, 8119, 7501, 5741, 3107, 0, -3107,
                     -5741, -7501, -8119, -7501, -5741, -3107),
    "sine_hamster_nz4": (422, 3520, 6082, 7718, 8179, 7395, 5485, 2740,
                         -422, -3520, -6082, -7718, -8179, -7395, -5485,
                         -2740),
    "sine_hamster_overflow": (1236, 4249, 6615, 7974, 8119, 7028, 4867, 1965,
                              -1236, -4249, -6615, -7974, -8119, -7028,
                              -4867, -1965),
}


def decode_test_table(name: str, bits: int = 14) -> np.ndarray:
    """Decode a fixed-point table exactly as TableSource::init
    (main.cpp:84-96): sign-extend to ``bits`` and scale by
    1/((1<<bits)/2 - 1)."""
    vals = np.asarray(TEST_TABLES_14BIT[name], np.int64)
    shift = 64 - bits
    vals = (vals << shift) >> shift  # arithmetic sign extension
    scale = 1.0 / ((1 << bits) // 2 - 1)
    return (vals * scale).astype(np.float32)


class TableSource:
    """Cyclic fixed-point table playback (the reference test source's table
    modes for AES17 level/SFDR validation, main.cpp:51-107). The table is
    the I channel; Q = 0 (reference TableSource.next: I=table, Q stays)."""

    __test__ = False

    def __init__(self, samplerate: float, table: str = "aes17_0dB"):
        self.samplerate = float(samplerate)
        self.table = decode_test_table(table)
        self._phase = 0
        self.center_freq = 0.0

    def tune(self, freq: float):
        self.center_freq = freq

    def read(self, n: int) -> np.ndarray:
        idx = (self._phase + np.arange(n)) % len(self.table)
        self._phase = (self._phase + n) % len(self.table)
        return (self.table[idx] + 0j).astype(np.complex64)
