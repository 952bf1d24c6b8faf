"""Port parity for the RDS path: the bit-level digital ops, the RDS group
decoder (a copy of the JAX package's pure-Python module), the RDS DSP
chain, and WFM's RDS tap from RF to PI and PS name.

Tolerances, with their reasons:

- ``binary_slicer``, ``DifferentialDecoder``, ``manchester_decode``,
  ``RDSDecoder``, ``encode_group``, ``calc_syndrome``, ``correct_errors``:
  bit-exact (integer logic);
- ``RDSChain`` against JAX's: the same bit count each block and the same
  decoded bits once both loops have locked (the M&M takes the sign of each
  interpolated sample, so before the lock an ulp may flip a bit);
- WFM from RF through the port: the PI code and the PS name exact, with at
  least 10 groups (tests/test_rds.py:116).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.decoders import rds as jrds
from sdrpp_tpu.models.rds_chain import RDSChain as JaxRDSChain
from sdrpp_tpu.ops import digital as jdigital
from sdrpp_tpu.ops import resample as jresample
from sdrpp_tpu_torch.decoders import rds
from sdrpp_tpu_torch.models.analog import WFMDemod
from sdrpp_tpu_torch.models.rds_chain import (RDS_BAUD, RDS_RATE, RDSChain,
                                              RDSReceiver)
from sdrpp_tpu_torch.ops import digital

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _zero_stuff(monkeypatch):
    monkeypatch.setattr(jresample, "POLYPHASE_MODE", "zero_stuff")


def test_binary_slicer_bit_exact():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    x[::7] = 0.0
    got = digital.binary_slicer(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdigital.binary_slicer(x)))


@pytest.mark.parametrize("modulus", [2, 4])
def test_differential_decoder_bit_exact(modulus):
    rng = np.random.default_rng(modulus)
    d, jd = (digital.DifferentialDecoder(modulus, device="cpu"),
             jdigital.DifferentialDecoder(modulus))
    st, jst = d.init_state(), jd.init_state()
    for nvalid in (300, 0, 17, 512):
        syms = rng.integers(0, modulus, 512).astype(np.uint8)
        st, out = d(st, (torch.from_numpy(syms), torch.tensor(nvalid)))
        jst, jout = jd(jst, (jnp.asarray(syms), jnp.int32(nvalid)))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        assert int(st) == int(jst) and st.dtype == torch.int32


def test_manchester_decode_bit_exact():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 101).astype(np.uint8)
    for offset in (0, 1, 2):
        for nvalid in (0, 1, 50, 101):
            got = digital.manchester_decode(offset, torch.from_numpy(bits),
                                            nvalid)
            want = jdigital.manchester_decode(jnp.int32(offset),
                                              jnp.asarray(bits), nvalid)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _groups(pi, name, pty=9, reps=3):
    bits = []
    for _ in range(reps):
        for seg in range(4):
            block_b = (0 << 12) | (pty << 5) | seg
            bits += rds.encode_group([pi, block_b, 0xE0E0,
                                      (name[seg * 2] << 8) | name[seg * 2 + 1]])
    return bits


def test_block_code_bit_exact():
    rng = np.random.default_rng(4)
    for block in rng.integers(0, 1 << 26, 2000):
        block = int(block)
        assert rds.calc_syndrome(block) == jrds.calc_syndrome(block)
        for btype in range(5):
            assert rds.correct_errors(block, btype) == \
                jrds.correct_errors(block, btype)
    for data in rng.integers(0, 1 << 16, (50, 4)):
        data = [int(v) for v in data]
        assert rds.encode_group(data) == jrds.encode_group(data)


def test_decoder_matches_jax():
    """PS name, RadioText, PTY, callsign and error correction: the same
    bits give the same fields."""
    rng = np.random.default_rng(5)
    bits = _groups(0x54A8, b"TPU SDR ", pty=7)
    text = b"HELLO FROM THE PORT "
    for seg in range(5):
        chunk = text[seg * 4: seg * 4 + 4]
        bits += rds.encode_group([0x54A8, (2 << 12) | (7 << 5) | seg,
                                  (chunk[0] << 8) | chunk[1],
                                  (chunk[2] << 8) | chunk[3]])
    bits += _groups(4096, b"KAAA  AB", reps=2)
    bits = np.array(bits, np.uint8)
    bits[26 * 12 + 4: 26 * 12 + 7] ^= 1  # a burst in one block
    noisy = bits.copy()
    noisy[rng.integers(0, len(bits), 20)] ^= 1
    for stream in (bits, noisy, rng.integers(0, 2, 3000).astype(np.uint8)):
        dec, jdec = rds.RDSDecoder(), jrds.RDSDecoder()
        for part in np.array_split(stream, 7):
            dec.process(part)
            jdec.process(part)
        for field in ("pi_code", "program_type", "ps_name", "radio_text_str",
                      "callsign", "groups_decoded"):
            assert getattr(dec, field) == getattr(jdec, field), field
    assert dec.groups_decoded == jdec.groups_decoded


def _biphase(bits, fs, smooth):
    """Differentially encoded biphase RDS baseband at ``fs``, smoothed over
    ``smooth`` samples (tests/test_rds.py:132-143)."""
    diff = np.cumsum(np.asarray(bits, np.int64)) % 2
    half = np.where(diff[:, None] == 1, [1.0, -1.0], [-1.0, 1.0]).reshape(-1)
    sps = fs / (2 * RDS_BAUD)
    n = int(len(half) * sps)
    k = np.floor(np.arange(n) / sps).astype(int)
    return np.convolve(half[np.clip(k, 0, len(half) - 1)],
                       np.ones(smooth) / smooth, mode="same")


def test_rds_chain_bits_match_jax_after_lock():
    bits = _groups(0x2ABC, b"JAXRADIO", reps=4)
    wave = _biphase(bits, RDS_RATE, 2)
    rng = np.random.default_rng(6)
    x = (wave * np.exp(2j * np.pi * 30.0 * np.arange(len(wave)) / RDS_RATE)
         + 0.05 * (rng.standard_normal(len(wave))
                   + 1j * rng.standard_normal(len(wave)))).astype(np.complex64)
    n = (len(x) // 2) // 96 * 96
    chain, jchain = RDSChain(device="cpu"), JaxRDSChain()
    st, jst = chain.init_state(), jchain.init_state()
    jstep = jax.jit(jchain)
    got, want = [], []
    for k in range(2):
        blk = x[k * n:(k + 1) * n]
        st, (bits_t, nv) = chain(st, torch.from_numpy(blk))
        jst, (bits_j, jnv) = jstep(jst, jnp.asarray(blk))
        assert int(nv) == int(jnv)
        assert abs(int(nv) - n / (RDS_RATE / RDS_BAUD)) < 30
        got.append(bits_t[:int(nv)].numpy())
        want.append(np.asarray(bits_j)[:int(jnv)])
    got, want = np.concatenate(got), np.concatenate(want)
    lock = 200  # bits: both Costas loops and the M&M settle within this
    np.testing.assert_array_equal(got[lock:], want[lock:])
    dec = rds.RDSDecoder()
    dec.process(got)
    assert dec.pi_code == 0x2ABC and dec.ps_name == "JAXRADIO"


def test_full_wfm_rds_chain_from_rf():
    """tests/test_rds.py:116 through the port: FM-modulated MPX (pilot,
    stereo, the 57 kHz RDS subcarrier) -> WFMDemod stereo + RDS tap ->
    RDSReceiver -> PI and PS name."""
    fs, dev = 240000.0, 75000.0
    bits = _groups(0x2ABC, b"JAXRADIO", reps=8)
    rds_bb = _biphase(bits, fs, 64)
    n = len(rds_bb)
    t = np.arange(n) / fs
    l = 0.4 * np.sin(2 * np.pi * 1000.0 * t)
    r = 0.4 * np.sin(2 * np.pi * 3000.0 * t)
    mpx = (0.41 * (l + r) + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.41 * (l - r) * np.sin(2 * np.pi * 38000.0 * t)
           + 0.06 * rds_bb * np.cos(2 * np.pi * 57000.0 * t))
    iq = np.exp(1j * np.cumsum(2 * np.pi * dev * mpx / fs)).astype(np.complex64)
    d = WFMDemod(deviation=dev, samplerate=fs, stereo=True, rds_out=True,
                 device="cpu")
    bm = d.rds_resamp.block_multiple
    blk = (n // bm) * bm
    st, (stereo, rdsout) = d(d.init_state(), torch.from_numpy(iq[:blk]))
    assert stereo.shape == (blk, 2) and rdsout.dtype == torch.complex64
    rx = RDSReceiver(device="cpu")
    half = (rdsout.shape[0] // 2)
    rx.process(rdsout[:half])
    rx.process(rdsout[half:].numpy())
    assert rx.decoder.pi_code == 0x2ABC
    assert rx.decoder.ps_name == "JAXRADIO"
    assert rx.decoder.groups_decoded >= 10
