"""Port parity for the host layers of the digital decoders: the sync-word
``Deframer``, HRPT's Manchester deframer and minor-frame demux, Falcon 9's
frame FEC (``FalconRS``), packet reassembly and classification, the KG-STV
soft deframer, M17's Golay(24,12), CRC-16, callsigns, LSF and LICH, 4FSK
slicing and the frame demux, and ``RRCInterpolator``.

The same numpy-seeded inputs go through the JAX package and the port.
Tolerances: every layer but the interpolator is held exactly (equal
frames, words, bytes and ints): it is the same integer and bit logic, and
the Viterbi and RS decodes it reaches are bit-exact (test_torch_fec.py,
test_torch_viterbi16.py). ``RRCInterpolator`` (float and complex, two
blocks with the state carried) within 1e-6 of the largest output: the
port's polyphase resampler is one strided conv1d, XLA's its own
convolution, so the sums of the same products round in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdrpp_tpu.decoders import falcon9 as jf9
from sdrpp_tpu.decoders import hrpt as jhrpt
from sdrpp_tpu.decoders import kg_sstv as jkg
from sdrpp_tpu.decoders import m17 as jm17
from sdrpp_tpu.decoders import m17_frame as jmf
from sdrpp_tpu.ops import deframing as jdeframing
from sdrpp_tpu.ops import resample as jresample
from sdrpp_tpu_torch.decoders import falcon9 as tf9
from sdrpp_tpu_torch.decoders import hrpt as thrpt
from sdrpp_tpu_torch.decoders import kg_sstv as tkg
from sdrpp_tpu_torch.decoders import m17 as tm17
from sdrpp_tpu_torch.decoders import m17_frame as tmf
from sdrpp_tpu_torch.ops import deframing as tdeframing
from sdrpp_tpu_torch.ops import resample as tresample

torch.set_num_threads(1)

LSF = jm17.encode_lsf("SP5WWP", "N0CALL", (1 << 0) | (2 << 1) | (5 << 7),
                      b"HELLO")


def _hrpt_words(rng, spacecraft_id=13, frame_number=1):
    words = rng.integers(0, 1024, jhrpt.WORDS_PER_FRAME).astype(np.int32)
    words[:6] = jhrpt.SYNC_WORDS
    words[6] = (spacecraft_id << 2) | frame_number
    return words


def _word_bits(words):
    return np.unpackbits(words.astype(">u2").view(np.uint8).reshape(-1, 2),
                         axis=1)[:, 6:].reshape(-1)


# ---------------------------------------------------------------------------
# Deframer and HRPT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [77, 450, 10 ** 6])
@pytest.mark.parametrize("errors", [0, 2])
def test_deframer_matches_jax_across_blocks(errors, block):
    """Frames among noise bits (gaps of 0 to 89, sync bit errors), fed in
    blocks shorter than a frame, a few frames long, and all at once."""
    rng = np.random.default_rng(errors)
    sync = rng.integers(0, 2, 24).astype(np.uint8)
    parts = []
    for _ in range(12):
        frame = np.concatenate([sync, rng.integers(0, 2, 176)]).astype(
            np.uint8)
        frame[rng.choice(24, errors, replace=False)] ^= 1
        parts += [rng.integers(0, 2, int(rng.integers(0, 90))), frame]
    stream = np.concatenate(parts).astype(np.uint8)
    j = jdeframing.Deframer(200, sync, max_sync_errors=errors)
    t = tdeframing.Deframer(200, sync, max_sync_errors=errors)
    got, want = [], []
    for i in range(0, len(stream), block):
        want += j.process(stream[i:i + block])
        got += t.process(stream[i:i + block])
        np.testing.assert_array_equal(t._buf, j._buf)
    assert len(want) >= 12 and len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_hrpt_constants_and_minor_frame_match_jax():
    for name in ("SYNC_WORDS", "SYNC_BITS", "MANCHESTER_SYNC_BITS"):
        np.testing.assert_array_equal(getattr(thrpt, name),
                                      getattr(jhrpt, name))
    assert (thrpt.VFO_RATE, thrpt.SYMBOL_RATE) == (jhrpt.VFO_RATE,
                                                   jhrpt.SYMBOL_RATE)
    words = _hrpt_words(np.random.default_rng(0), 7, 2)
    words[3] ^= 5
    a, b = thrpt.parse_minor_frame(words), jhrpt.parse_minor_frame(words)
    assert (a.sync_errors, a.spacecraft_id, a.frame_number) == \
        (b.sync_errors, b.spacecraft_id, b.frame_number) == (1, 7, 2)
    np.testing.assert_array_equal(a.avhrr, b.avhrr)
    np.testing.assert_array_equal(a.tip, b.tip)


@pytest.mark.parametrize("flips", [0, 3])
def test_hrpt_deframer_matches_jax(flips):
    """Manchester frames among noise, split into blocks, with raw sync bit
    errors (the deframer allows 4)."""
    rng = np.random.default_rng(1 + flips)
    words = [_hrpt_words(rng, 13, k) for k in range(2)]
    raws = []
    for w in words:
        raw = jhrpt.manchester_encode(_word_bits(w))
        raw[rng.choice(60, flips, replace=False)] ^= 1
        raws += [rng.integers(0, 2, 999).astype(np.uint8), raw]
    stream = np.concatenate(raws + [np.zeros(70, np.uint8)])
    j, t = jhrpt.HRPTDeframer(), thrpt.HRPTDeframer()
    got, want = [], []
    for i in range(0, len(stream), 50000):
        want += j.process(stream[i:i + 50000])
        got += t.process(stream[i:i + 50000])
    assert len(got) == len(want) == 2
    for a, b, w in zip(got, want, words):
        np.testing.assert_array_equal(a.words, b.words)
        np.testing.assert_array_equal(a.words[6:], w[6:])
        assert a.sync_errors == b.sync_errors


# ---------------------------------------------------------------------------
# Falcon 9
# ---------------------------------------------------------------------------

def _packet(pkt_id, body):
    total = 2 + 8 + 15 + len(body) + 2
    return (bytes([(total - 2) >> 8 & 0b1111, (total - 2) & 0xFF])
            + pkt_id.to_bytes(8, "big") + bytes(15) + body + bytes(2))


def _frame(counter, pkt_ptr, data):
    hdr = bytes([(counter >> 13) & 0b111111, (counter >> 5) & 0xFF,
                 ((counter & 0b11111) << 3) | ((pkt_ptr >> 8) & 0b111),
                 pkt_ptr & 0xFF])
    return np.frombuffer(hdr + data.ljust(jf9.DATA_LEN, b"\0"), np.uint8)


def test_falcon_tables_match_jax():
    for name in ("TO_DB", "FROM_DB", "RAND_VALS", "SYNC_BITS"):
        np.testing.assert_array_equal(getattr(tf9, name), getattr(jf9, name))


def test_falcon_rs_matches_jax_on_corrected_and_failed_frames():
    """Clean, 8 byte errors a block (the 16-root code's limit) and one
    block with 9 (uncorrectable): equal decodes, None where JAX gives
    None; ``decode_frames`` decodes the three in one batch alike."""
    rng = np.random.default_rng(0)
    j, t = jf9.FalconRS(), tf9.FalconRS(device="cpu")
    payload = rng.integers(0, 256, 4 + jf9.DATA_LEN).astype(np.uint8)
    wire = j.encode(payload)
    np.testing.assert_array_equal(t.encode(payload), wire)
    w8 = wire.copy()
    for b in range(5):
        for p in rng.choice(255, 8, replace=False):
            w8[5 * p + b] ^= rng.integers(1, 256)
    w9 = wire.copy()
    for p in rng.choice(255, 9, replace=False):
        w9[5 * p] ^= rng.integers(1, 256)
    frames = [wire, w8, w9]
    want = [j.decode(f) for f in frames]
    assert want[2] is None
    np.testing.assert_array_equal(want[1], payload)
    got = t.decode_frames(np.stack(frames))
    for g, w, f in zip(got, want, frames):
        one = t.decode(f)
        if w is None:
            assert g is None and one is None
        else:
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(one, w)
    assert t.decode_frames(np.zeros((0, 1275), np.uint8)) == []


def test_falcon_packet_sync_and_parse_match_jax():
    p1 = _packet(jf9.PKT_GPS_A, b"hello gps log\n")
    p2 = _packet(0x0101010101010101, b"other")
    big = _packet(jf9.PKT_GPS_B, bytes(1500))
    vid = _packet(jf9.PKT_VIDEO, bytes(range(256)) * 4)
    f1, f2 = big[:jf9.DATA_LEN], big[jf9.DATA_LEN:]
    frames = [_frame(1, 0, p1 + p2), _frame(2, 0, f1),
              _frame(3, len(f2), f2 + p1), _frame(4, 2047, bytes(100)),
              _frame(9, len(f2), f2 + vid), _frame(10, 0, vid[:50])]
    j, t = jf9.FalconPacketSync(), tf9.FalconPacketSync()
    for f in frames:
        want, got = j.process(f), t.process(f)
        assert got == want
        assert [tf9.parse_packet(p) for p in got] == \
            [jf9.parse_packet(p) for p in want]
    assert tf9.parse_packet(b"short") == jf9.parse_packet(b"short")


# ---------------------------------------------------------------------------
# KG-STV
# ---------------------------------------------------------------------------

def test_kgsstv_deframer_matches_jax():
    """Frames among noise, four sync errors, soft symbol noise, blocks of
    97 symbols: equal frames (all 7 bytes)."""
    rng = np.random.default_rng(0)
    frames = [bytes(rng.integers(0, 256, 7).astype(np.uint8))
              for _ in range(3)]
    enc = [jkg.KGSSTVDeframer.encode_frame(f) for f in frames]
    np.testing.assert_array_equal(tkg.KGSSTVDeframer.encode_frame(frames[0]),
                                  enc[0])
    for p in rng.choice(len(jkg.SYNC_WORD), 4, replace=False):
        enc[1][p] = -enc[1][p]
    sym = np.concatenate([rng.normal(0, 0.3, 40)] + enc
                         + [rng.normal(0, 0.3, 200)]).astype(np.float32)
    sym += rng.normal(0, 0.2, len(sym)).astype(np.float32)
    j, t = jkg.KGSSTVDeframer(), tkg.KGSSTVDeframer(device="cpu")
    got, want = [], []
    for i in range(0, len(sym), 97):
        want += j.process(sym[i:i + 97])
        got += t.process(sym[i:i + 97])
    assert len(want) == 3 and got == want


# ---------------------------------------------------------------------------
# M17
# ---------------------------------------------------------------------------

def test_golay_crc_callsigns_and_lsf_match_jax():
    rng = np.random.default_rng(0)
    for data in rng.integers(0, 4096, 200):
        cw = jm17.golay24_encode(int(data))
        assert tm17.golay24_encode(int(data)) == cw
        for nerr in (0, 2, 3, 4):
            bad = cw
            for p in rng.choice(24, nerr, replace=False):
                bad ^= 1 << int(p)
            assert tm17.golay24_decode(bad) == jm17.golay24_decode(bad)
    for n in (0, 5, 28, 30):
        data = bytes(rng.integers(0, 256, n).astype(np.uint8))
        assert tm17.crc16(data) == jm17.crc16(data)
    for call in ("SP5WWP", "N0CALL", "A/B-1.", ""):
        e = jm17.encode_callsign_base40(call)
        assert tm17.encode_callsign_base40(call) == e
        assert tm17.decode_callsign_base40(e) == jm17.decode_callsign_base40(e)
    raw = tm17.encode_lsf("SP5WWP", "N0CALL", 0x2A5, b"HELLO")
    assert raw == jm17.encode_lsf("SP5WWP", "N0CALL", 0x2A5, b"HELLO")
    broken = bytearray(raw)
    broken[3] ^= 1
    for lsf_bytes in (raw, bytes(broken)):
        a, b = tm17.decode_lsf(lsf_bytes), jm17.decode_lsf(lsf_bytes)
        assert vars(a) == vars(b)


def test_slice_demux_and_frame_decodes_match_jax():
    """4FSK slicing, the sync demux over LSF, stream and packet frames
    among noise bits in odd-sized blocks, and each frame's K = 5 decode
    (LSF, payload) and LICH assembly: equal frames, LSFs and bytes."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 900).astype(np.uint8)
    sym = jmf.symbols_from_bits(bits)
    np.testing.assert_array_equal(tmf.symbols_from_bits(bits), sym)
    noisy = sym + rng.normal(0, 0.15, len(sym)).astype(np.float32)
    np.testing.assert_array_equal(tmf.slice_4fsk(noisy),
                                  jmf.slice_4fsk(noisy))
    blocks = [jmf.encode_lsf_frame(LSF)]
    blocks += [jmf.encode_stream_frame(LSF, fn, bytes(range(fn, fn + 16)))
               for fn in range(7)]
    np.testing.assert_array_equal(tmf.encode_lsf_frame(LSF), blocks[0])
    np.testing.assert_array_equal(
        tmf.encode_stream_frame(LSF, 3, bytes(range(3, 19))), blocks[4])
    pkf = np.concatenate([jmf.SYNC_PKF, rng.integers(0, 2, 368)]).astype(
        np.uint8)
    blocks[3] = blocks[3].copy()
    blocks[3][40:42] ^= 1     # two bit errors in one stream frame
    stream = np.concatenate([rng.integers(0, 2, 101)] + blocks[:5] + [pkf]
                            + blocks[5:]).astype(np.uint8)
    jd, td = jmf.FrameDemux(), tmf.FrameDemux()
    jl, tl = jmf.LICHAssembler(), tmf.LICHAssembler()
    n_lsf = n_payload = 0
    for i in range(0, len(stream), 333):
        want, got = jd.process(stream[i:i + 333]), td.process(
            stream[i:i + 333])
        assert [f[0] for f in got] == [f[0] for f in want]
        for (ft, tf), (_, jf) in zip(got, want):
            assert tf.keys() == jf.keys()
            for k in tf:
                np.testing.assert_array_equal(tf[k], jf[k])
            if ft == jmf.FRAME_LSF:
                a = tmf.decode_lsf_frame(tf["lsf"], device="cpu")
                b = jmf.decode_lsf_frame(jf["lsf"])
                assert vars(a) == vars(b) and a.valid
                n_lsf += 1
            elif ft == jmf.FRAME_STREAM:
                assert tmf.decode_stream_payload(tf["payload"],
                                                 device="cpu") == \
                    jmf.decode_stream_payload(jf["payload"])
                a, b = tl.process(tf["lich"]), jl.process(jf["lich"])
                assert (a is None) == (b is None)
                if a is not None:
                    assert vars(a) == vars(b)
                n_payload += 1
    assert n_lsf == 1 and n_payload == 7


# ---------------------------------------------------------------------------
# RRCInterpolator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("symbolrate,samplerate,beta", [
    (4800.0, 48000.0, 0.5), (1200.0, 12000.0, 0.7), (4800.0, 7200.0, 0.5)])
def test_rrc_interpolator_matches_jax_over_two_blocks(cplx, symbolrate,
                                                      samplerate, beta):
    dtype = (jnp.complex64, torch.complex64) if cplx else (jnp.float32,
                                                           torch.float32)
    j = jresample.RRCInterpolator(symbolrate, samplerate, beta, 31,
                                  dtype=dtype[0])
    t = tresample.RRCInterpolator(symbolrate, samplerate, beta, 31,
                                  dtype=dtype[1], device="cpu")
    assert (t.interp, t.decim, t.block_multiple) == (j.interp, j.decim,
                                                     j.block_multiple)
    rng = np.random.default_rng(int(samplerate))
    n = 64 * t.block_multiple
    x = rng.choice([-1.0, -1 / 3, 1 / 3, 1.0], 2 * n)
    if cplx:
        x = x + 1j * rng.choice([-1.0, 1.0], 2 * n)
    x = x.astype(np.complex64 if cplx else np.float32)
    js, ts = j.init_state(), t.init_state()
    for k in range(2):
        blk = x[k * n:(k + 1) * n]
        js, jy = j(js, jnp.asarray(blk))
        ts, ty = t(ts, torch.from_numpy(blk))
        jy = np.asarray(jy)
        assert ty.shape == jy.shape == (t.out_count(n),)
        assert np.abs(ty.numpy() - jy).max() <= 1e-6 * np.abs(jy).max()
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=0)
