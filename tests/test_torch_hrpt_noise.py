"""HRPT in noise through the port's own loop policy, on the CPU.

``HRPTDecoder`` runs its loops as the card does (``_chunk_lanes_for``
decides on every device): the FastAGC exact, since its warm-up of four
time constants (4 / rate = 200,000 samples) fits in no lane of a
262,144-sample block, and the Costas loop chunk-parallel (K = 128) over a
warm-up of four of its 2 / alpha (1,576 samples). The JAX package's
warm-ups (1,024 and 512 samples, fractions of those time constants) leave
each lane unsettled, and at Es/N0 ~ 26.5 dB the chunked route loses words
(ROADMAP C). The frames are held to ground truth: every word exact, with
no sync error; and, on one of the signals, to the JAX decoder, whose loops
run exact on the CPU.

The signal is chip_smoke.py's ``hrpt_pass`` with one minor frame:
Manchester BPSK at 3 Msps after 6,000 random symbols, a carrier phase of
0.3 rad 100 Hz off, complex noise of 0.05 a component, in two blocks. The
seeds are ones whose frame the JAX warm-ups decode with wrong words.
"""

import numpy as np
import pytest
import torch

from sdrpp_tpu_torch.decoders import hrpt as thrpt
from sdrpp_tpu_torch.ops.scans_kernels import _chunk_lanes_for

torch.set_num_threads(1)

BLOCK = 262144
FS = 3e6
NOISE = 0.05
SEEDS = [3, 7, 12, 25]


def _hrpt_pass(seed):
    """One seeded minor frame as chip_smoke.hrpt_pass makes it: (words,
    iq complex64 padded to whole blocks)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1024, (1, thrpt.WORDS_PER_FRAME)).astype(np.int32)
    words[:, :6] = thrpt.SYNC_WORDS
    words[:, 6] = 13 << 2
    bits = np.unpackbits(words.astype(">u2").view(np.uint8).reshape(-1, 2),
                         axis=1)[:, 6:].reshape(-1)
    raw = np.concatenate([rng.integers(0, 2, 6000),
                          thrpt.manchester_encode(bits),
                          rng.integers(0, 2, 2000)]).astype(np.uint8)
    sps = FS / thrpt.SYMBOL_RATE
    n = -(-int(len(raw) * sps) // BLOCK) * BLOCK
    t = np.arange(n)
    idx = np.minimum((t / sps).astype(np.int64), len(raw) - 1)
    x = (2.0 * raw[idx] - 1.0) * np.exp(1j * (0.3 + 2 * np.pi * 100.0 / FS
                                              * t))
    x += NOISE * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return words[0], x.astype(np.complex64)


def _decode(dec, iq):
    frames = []
    for k in range(len(iq) // BLOCK):
        frames += dec.process(iq[k * BLOCK:(k + 1) * BLOCK])
    return frames


def test_hrpt_loop_policy():
    """The FastAGC runs exact and the Costas loop chunked at K = 128 on a
    decode block."""
    d = thrpt.HRPTDecoder(FS, device="cpu")
    agc, costas = d.demod.agc, d.demod.costas
    assert _chunk_lanes_for(BLOCK, agc.warmup, agc.max_lanes) == 0
    assert _chunk_lanes_for(BLOCK, costas.warmup, costas.max_lanes) == 128
    assert (agc.warmup, costas.warmup) == (200000, 1576)


@pytest.mark.parametrize("seed", SEEDS)
def test_hrpt_noisy_frame_exact(seed):
    words, iq = _hrpt_pass(seed)
    frames = _decode(thrpt.HRPTDecoder(FS, device="cpu"), iq)
    assert len(frames) == 1
    f = frames[0]
    assert f.sync_errors == 0 and f.spacecraft_id == 13
    np.testing.assert_array_equal(f.words, words)


def test_hrpt_noisy_frame_matches_jax_exact():
    """The JAX decoder (its loops exact on the CPU) on the same signal
    returns the same frame as the port."""
    from sdrpp_tpu.decoders import hrpt as jhrpt

    words, iq = _hrpt_pass(SEEDS[0])
    jframes = _decode(jhrpt.HRPTDecoder(jhrpt.VFO_RATE), iq)
    tframes = _decode(thrpt.HRPTDecoder(FS, device="cpu"), iq)
    assert len(jframes) == len(tframes) == 1
    np.testing.assert_array_equal(jframes[0].words, words)
    np.testing.assert_array_equal(tframes[0].words, jframes[0].words)
    assert tframes[0].sync_errors == jframes[0].sync_errors == 0
