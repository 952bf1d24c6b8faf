"""Port parity for the digital decode paths end to end: ``HRPTDecoder``,
``Falcon9Decoder``, ``KGSSTVDecoder`` and M17 (the GFSK demodulator and the
frame layer, and ``M17Decoder`` with its voice), each on the signal of the
JAX package's own test (tests/test_hrpt.py, test_falcon9.py,
test_kg_sstv.py, test_m17_chain.py), in the same blocks, through the JAX
decoder and the port's with ``device="cpu"``.

Held exactly: the HRPT minor frames (words, sync errors, spacecraft id,
frame number, AVHRR), the Falcon 9 packets, the KG-STV frames, the M17 LSF
events and every stream frame's 18 payload bytes, and, where the system
libcodec2 is present, the M17 voice PCM. The KG-STV frames are compared
with their last two bits masked, as the JAX test compares them: the
reference decodes 16 bits past the 108 symbols a frame carries
(kg_sstv_dsp.h:196 vs :177), so those two bits come out of erasures and
follow the soft symbols' last ulps. The port's HRPT loops run chunked at
these blocks (``_chunk_lanes_for`` decides on every device), the JAX
package's FastAGC and Costas on the CPU exact; both recover the frame.
The HRPT and M17 M&Ms run chunked on both sides (the JAX one with
``interpret = True``, as on its accelerator).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdrpp_tpu.decoders import falcon9 as jf9
from sdrpp_tpu.decoders import hrpt as jhrpt
from sdrpp_tpu.decoders import kg_sstv as jkg
from sdrpp_tpu.decoders import m17_frame as jmf
from sdrpp_tpu.decoders.m17 import encode_lsf
from sdrpp_tpu.ops.resample import RRCInterpolator
from sdrpp_tpu.ops.taps import root_raised_cosine_rate
from sdrpp_tpu_torch.decoders import codec2 as tcodec2
from sdrpp_tpu_torch.decoders import falcon9 as tf9
from sdrpp_tpu_torch.decoders import hrpt as thrpt
from sdrpp_tpu_torch.decoders import kg_sstv as tkg
from sdrpp_tpu_torch.decoders import m17_frame as tmf
from sdrpp_tpu_torch.models import digital as tdigital

torch.set_num_threads(1)

LSF = encode_lsf("SP5WWP", "N0CALL", (1 << 0) | (2 << 1) | (5 << 7),
                 b"HELLO")


def _blocks(iq, bs, pad=True):
    if pad:
        iq = np.concatenate([iq, np.zeros((-len(iq)) % bs, np.complex64)])
    return [iq[i:i + bs] for i in range(0, len(iq) - bs + 1, bs)]


def hrpt_signal():
    """tests/test_hrpt.py:73: one minor frame, Manchester BPSK at 3 Msps."""
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1024, jhrpt.WORDS_PER_FRAME).astype(np.int32)
    words[:6] = jhrpt.SYNC_WORDS
    words[6] = (13 << 2) | 1
    bits = np.unpackbits(words.astype(">u2").view(np.uint8).reshape(-1, 2),
                         axis=1)[:, 6:].reshape(-1)
    raw = jhrpt.manchester_encode(bits)
    pn = rng.integers(0, 2, 6000).astype(np.uint8)
    sym = np.concatenate([pn, raw, rng.integers(0, 2, 2000)]) * 2.0 - 1.0
    sps = jhrpt.VFO_RATE / jhrpt.SYMBOL_RATE
    n = int(len(sym) * sps)
    idx = np.minimum((np.arange(n) / sps).astype(np.int64), len(sym) - 1)
    iq = sym[idx].astype(np.complex64)
    iq *= np.exp(1j * 0.3)
    return words, iq


def _fpacket(pkt_id, body):
    total = 2 + 8 + 15 + len(body) + 2
    return (bytes([(total - 2) >> 8 & 0b1111, (total - 2) & 0xFF])
            + pkt_id.to_bytes(8, "big") + bytes(15) + body + bytes(2))


def _fframe(counter, pkt_ptr, data):
    hdr = bytes([(counter >> 13) & 0b111111, (counter >> 5) & 0xFF,
                 ((counter & 0b11111) << 3) | ((pkt_ptr >> 8) & 0b111),
                 pkt_ptr & 0xFF])
    return np.frombuffer(hdr + data.ljust(jf9.DATA_LEN, b"\0"), np.uint8)


def falcon9_signal():
    """tests/test_falcon9.py:93: one GPS frame as 3.5714 MBaud FM at 6 Msps."""
    rng = np.random.default_rng(1)
    rs = jf9.FalconRS()
    pkt = _fpacket(jf9.PKT_GPS_A, b"GPS: T+00:01:02 OK\n")
    payload = np.frombuffer(pkt + bytes(jf9.DATA_LEN - len(pkt)), np.uint8)
    wire = rs.encode(_fframe(1, 0, payload.tobytes()))
    bits = np.concatenate(
        [rng.integers(0, 2, 4000).astype(np.uint8), jf9.SYNC_BITS,
         np.unpackbits(wire), rng.integers(0, 2, 500).astype(np.uint8)])
    sym = bits.astype(np.float64) * 2.0 - 1.0
    fs, baud = jf9.Falcon9Decoder.INPUT_RATE, jf9.Falcon9Decoder.BAUDRATE
    sps = fs / baud
    n = int(len(sym) * sps)
    idx = np.minimum((np.arange(n) / sps).astype(np.int64), len(sym) - 1)
    phase = np.cumsum(2 * np.pi * jf9.Falcon9Decoder.DEVIATION * sym[idx]
                      / fs)
    return np.exp(1j * phase).astype(np.complex64)


def _shaped_fm(sym, symbolrate, fs, beta, deviation, rng, noise):
    """RRC-shaped frequency pulses (the JAX package's RRCInterpolator) with
    the TX x RX cascade gain calibrated to unit symbols, FM, light noise
    (tests/test_kg_sstv.py:46, test_m17_chain.py:78)."""
    shaper = RRCInterpolator(symbolrate, fs, beta, rrc_tap_count=31,
                             dtype=jnp.float32)
    sym = np.concatenate([sym, np.zeros((-len(sym)) % shaper.block_multiple,
                                        np.float32)])
    _, wave = shaper(shaper.init_state(), jnp.asarray(sym))
    wave = np.asarray(wave, np.float64)
    nimp = 64 + (-64) % shaper.block_multiple
    imp = np.zeros(nimp, np.float32)
    imp[32] = 1.0
    _, imp_shaped = shaper(shaper.init_state(), jnp.asarray(imp))
    rx = root_raised_cosine_rate(31, beta, symbolrate, fs)
    wave /= np.max(np.abs(np.convolve(np.asarray(imp_shaped, np.float64),
                                      rx)))
    iq = np.exp(1j * np.cumsum(2 * np.pi * deviation * wave / fs)).astype(
        np.complex64)
    n = len(iq)
    return iq + (rng.normal(0, noise, n)
                 + 1j * rng.normal(0, noise, n)).astype(np.complex64)


def kgsstv_signal():
    rng = np.random.default_rng(2)
    frames = [bytes(rng.integers(0, 256, 7).astype(np.uint8))
              for _ in range(4)]
    sym = np.concatenate(
        [(rng.integers(0, 2, 400) * 2.0 - 1.0).astype(np.float32)]
        + [jkg.KGSSTVDeframer.encode_frame(f) for f in frames]
        + [np.zeros(50, np.float32)])
    return frames, _shaped_fm(sym, jkg.BAUDRATE, 12000.0, jkg.RRC_ALPHA,
                              jkg.DEVIATION, rng, 0.01)


def m17_signal(blocks, seed):
    prng = np.random.default_rng(99)
    sym = np.concatenate(
        [(prng.integers(0, 2, 1200) * 2.0 - 1.0).astype(np.float32)]
        + [jmf.symbols_from_bits(b) for b in blocks]
        + [np.zeros(100, np.float32)])
    return _shaped_fm(sym, jmf.M17_BAUDRATE, 48000.0, jmf.M17_RRC_ALPHA,
                      jmf.M17_DEVIATION, np.random.default_rng(seed), 0.02)


def _mask(frames):
    return [f[:6] + bytes([f[6] & 0b11111100]) for f in frames]


def test_hrpt_decoder_matches_jax():
    words, iq = hrpt_signal()
    j = jhrpt.HRPTDecoder(jhrpt.VFO_RATE)
    j.demod.recov.interpret = True    # JAX's chunked M&M, as the port's
    t = thrpt.HRPTDecoder(thrpt.VFO_RATE, device="cpu")
    assert t.demod.recov._lanes_for(120_000) >= 1
    want, got = [], []
    for blk in _blocks(iq, 120_000):
        want += j.process(blk)
        got += t.process(blk)
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.words, b.words)
        assert (a.sync_errors, a.spacecraft_id, a.frame_number) == \
            (b.sync_errors, b.spacecraft_id, b.frame_number)
    assert got[0].sync_errors == 0 and got[0].spacecraft_id == 13
    np.testing.assert_array_equal(got[0].avhrr,
                                  words[750:750 + 10240].reshape(2048, 5).T)


def test_falcon9_decoder_matches_jax():
    iq = falcon9_signal()
    j, t = jf9.Falcon9Decoder(), tf9.Falcon9Decoder(device="cpu")
    want, got = [], []
    for blk in _blocks(iq, 8192, pad=False):
        want += j.process(blk)
        got += t.process(blk)
    assert got == want
    assert ("gps", b"GPS: T+00:01:02 OK\n") in got


def test_kgsstv_decoder_matches_jax():
    frames, iq = kgsstv_signal()
    j, t = jkg.KGSSTVDecoder(12000.0), tkg.KGSSTVDecoder(12000.0,
                                                         device="cpu")
    want, got = [], []
    for blk in _blocks(iq, 6000):
        want += j.process(blk)
        got += t.process(blk)
    assert _mask(got) == _mask(want) == _mask(frames)


def test_m17_lsf_and_payloads_match_jax():
    """GFSK demod -> slice -> demux -> the K = 5 decodes on each side: the
    same frames, LSF fields and payload bytes (no libcodec2 needed)."""
    import jax

    from sdrpp_tpu.models.digital import GFSKDemod as JGFSK

    kw = dict(rrc_tap_count=31, rrc_beta=jmf.M17_RRC_ALPHA, omega_gain=1e-6,
              mu_gain=0.01, omega_rel_limit=0.01)
    voice = [bytes(range(fn, fn + 16)) for fn in range(8)]
    blocks = [jmf.encode_lsf_frame(LSF)] + [
        jmf.encode_stream_frame(LSF, fn, voice[fn]) for fn in range(8)]
    iq = m17_signal(blocks, 3)
    jd = JGFSK(jmf.M17_BAUDRATE, 48000.0, jmf.M17_DEVIATION, **kw)
    jd.recov.interpret = True         # JAX's chunked M&M, as the port's
    td = tdigital.GFSKDemod(jmf.M17_BAUDRATE, 48000.0, jmf.M17_DEVIATION,
                            **kw, device="cpu")
    assert td.recov._lanes_for(12000) >= 1
    jstep, jst, tst = jax.jit(jd), jd.init_state(), td.init_state()
    jdemux, tdemux = jmf.FrameDemux(), tmf.FrameDemux()
    jl, tl = jmf.LICHAssembler(), tmf.LICHAssembler()
    payloads, lsfs = [], []
    for blk in _blocks(iq, 12000):
        jst, (jy, jv) = jstep(jst, jnp.asarray(blk))
        tst, (ty, tv) = td(tst, torch.from_numpy(blk))
        jf = jdemux.process(jmf.slice_4fsk(
            np.asarray(jy)[np.asarray(jv).astype(bool)]))
        tf = tdemux.process(tmf.slice_4fsk(ty[tv].numpy()))
        assert [f[0] for f in tf] == [f[0] for f in jf]
        for (ft, a), (_, b) in zip(tf, jf):
            if ft == jmf.FRAME_LSF:
                x = tmf.decode_lsf_frame(a["lsf"], device="cpu")
                y = jmf.decode_lsf_frame(b["lsf"])
                assert vars(x) == vars(y)
                lsfs.append(x)
            elif ft == jmf.FRAME_STREAM:
                p = tmf.decode_stream_payload(a["payload"], device="cpu")
                assert p == jmf.decode_stream_payload(b["payload"])
                payloads.append(p)
                x, y = tl.process(a["lich"]), jl.process(b["lich"])
                assert (x is None) == (y is None)
                if x is not None:
                    assert vars(x) == vars(y)
                    lsfs.append(x)
    for fn in range(8):   # among frames the demux finds in the PN run-in
        assert bytes([0, fn]) + voice[fn] in payloads
    assert len(lsfs) == 2 and all(l.valid and l.dst == "SP5WWP"
                                  and l.src == "N0CALL" for l in lsfs)


def test_m17_decoder_voice_matches_jax():
    """``M17Decoder`` on test_m17_chain.py's voice transmission: the same
    LSF events, the same payloads handed to the voice decoder, the same
    number of voice samples. (Their PCM is held equal by
    test_torch_decode_cli.py, each decoder in a process of its own:
    libcodec2 draws its synthesis phases from one generator a process, so
    two decoders in one process do not give the same samples.)"""
    if not tcodec2.available():
        pytest.skip("libcodec2 not present")
    from sdrpp_tpu.decoders import codec2 as jcodec2
    from sdrpp_tpu.models.m17_chain import M17Decoder as JM17
    from sdrpp_tpu_torch.models.m17_chain import M17Decoder as TM17

    enc = jcodec2.Codec2()
    nframes = 12
    t = np.arange(nframes * 2 * 160) / 8000.0
    bits = enc.encode((np.sin(2 * np.pi * 300.0 * t) * 8000).astype(
        np.int16))
    blocks = [jmf.encode_lsf_frame(LSF)] + [
        jmf.encode_stream_frame(LSF, fn, bits[fn * 16:(fn + 1) * 16])
        for fn in range(nframes)]
    iq = m17_signal(blocks, 3)
    j, tdec = JM17(48000.0), TM17(48000.0, device="cpu")
    j.demod.recov.interpret = True    # JAX's chunked M&M, as the port's
    fed = {id(j): [], id(tdec): []}
    for dec in (j, tdec):
        def record(payload, dec=dec, process=dec.voice.process):
            fed[id(dec)].append(bytes(payload))
            return process(payload)
        dec.voice.process = record
    ja = ta = 0
    je, te = [], []
    for blk in _blocks(iq, 12000, pad=False):
        a, ev = j.process(blk)
        ja += len(a)
        je += ev
        a, ev = tdec.process(blk)
        ta += len(a)
        te += ev
    assert [vars(e) for e in te] == [vars(e) for e in je]
    assert any(e.dst == "SP5WWP" for e in te)
    assert fed[id(tdec)] == fed[id(j)]
    for fn in range(nframes - 2):
        assert bytes([0, fn]) + bits[fn * 16:(fn + 1) * 16] in fed[id(tdec)]
    assert ta == ja >= (nframes - 2) * 320
