"""The one traffic generator: a recording made from a traffic file and the
seed, on the card, then held in host memory; and the two inputs that hand
it out, ``Replay`` from host memory and ``CardRing`` from the card.

A traffic file (``workloads/<traffic>.json``) gives the block size, how
many blocks the recording holds (``pool_blocks``; the stream replays
them in a loop, block b being recording block b % pool_blocks), the
complex Gaussian noise's standard deviation on each of I and Q
(``noise``), and ``signals``: carriers placed on the channel centres
that the system's ``band(config)`` gives, every ``every``-th channel from
``first``:

- ``fm``: ``amplitude * exp(j (2 pi f t + index sin(2 pi tone_hz t) + p))``
  at the channel's centre f;
- ``tone``: ``amplitude * exp(j (2 pi (f + offset_hz) t + p))``.

``input`` says where the window's blocks come from: ``"host"`` (the
default), the recording in host memory through the program's
``Prefetcher`` (a staging copy into pinned memory, an H2D copy), as a
recording replayed from a file; ``"card"``, the recording resident on
the card, each block a view of it, as a capture ring that lands on the
device (bench.py's wideband ring).

Every frequency is moved to the nearest whole number of cycles over the
recording (at most fs / (2 N), 0.18 Hz at 16,777,216 samples of 6.144
Msps), so the loop point joins without a jump. The seed draws the noise
and each carrier's phase p (and the tone's): every seed gives the same
carriers, levels and sizes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_recording", "Replay", "CardRing"]


def _cycles(freq: float, fs: float, total: int) -> int:
    return int(round(freq / fs * total))


def make_recording(traffic: dict, samplerate: float, offsets, seed: int,
                   device, block: int | None = None,
                   pool_blocks: int | None = None) -> np.ndarray:
    """[pool_blocks, block] complex64 host recording of a band sampled at
    ``samplerate`` whose channels are centred at ``offsets`` (Hz).
    ``block`` and ``pool_blocks`` override the traffic file's (tests at a
    small size)."""
    n = int(block or traffic["block"])
    P = int(pool_blocks or traffic["pool_blocks"])
    total = n * P
    fs = float(samplerate)
    offsets = np.asarray(offsets, np.float64)
    rng = np.random.default_rng([seed, 1])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    iq = torch.randn((total, 2), generator=gen, device=device,
                     dtype=torch.float32) * float(traffic["noise"])
    x = torch.view_as_complex(iq).to(torch.complex128)
    i = torch.arange(total, dtype=torch.int64, device=device)

    def phasor(cycles: int, phase: float) -> torch.Tensor:
        # exact whole-cycle phase: 2 pi ((cycles * i) mod total) / total
        k = torch.remainder(i * (cycles % total), total).to(torch.float64)
        return k * (2.0 * np.pi / total) + phase

    for sig in traffic["signals"]:
        chans = range(int(sig.get("first", 0)), offsets.shape[0],
                      int(sig["every"]))
        for c in chans:
            p = rng.uniform(0.0, 2.0 * np.pi)
            if sig["kind"] == "fm":
                ph = (phasor(_cycles(offsets[c], fs, total), p)
                      + sig["index"] * torch.sin(phasor(
                          _cycles(sig["tone_hz"], fs, total),
                          rng.uniform(0.0, 2.0 * np.pi))))
            elif sig["kind"] == "tone":
                ph = phasor(_cycles(offsets[c] + sig["offset_hz"], fs,
                                    total), p)
            else:
                raise ValueError(f"unknown signal kind {sig['kind']!r}")
            x += sig["amplitude"] * torch.polar(torch.ones_like(ph), ph)
    return x.to(torch.complex64).reshape(P, n).cpu().numpy()


class Replay:
    """Hands out a recording's blocks in order, replaying it in a loop,
    each a complex64 view (no copy): a driver's capture ring in host
    memory."""

    def __init__(self, pool: np.ndarray, samplerate: float):
        self.pool = pool
        self.samplerate = samplerate
        self.next = 0

    def read(self, n: int) -> np.ndarray:
        if n != self.pool.shape[1]:
            raise ValueError(f"reads of {n}, blocks of {self.pool.shape[1]}")
        block = self.pool[self.next % self.pool.shape[0]]
        self.next += 1
        return block


class CardRing:
    """The recording resident on the card ([P, n]), handing out its blocks
    in order, replaying it in a loop, each a view (no copy)."""

    def __init__(self, ring: torch.Tensor):
        self.ring = ring
        self.next = 0

    def read(self, n: int) -> torch.Tensor:
        if n != self.ring.shape[1]:
            raise ValueError(f"reads of {n}, blocks of {self.ring.shape[1]}")
        block = self.ring[self.next % self.ring.shape[0]]
        self.next += 1
        return block

    def close(self):
        pass
