"""Port parity for the last public pieces of the JAX package's library:
``ConvCode.acs_decisions`` / ``decode_soft_bytes`` / ``decode_hard``,
``LRPTDecoder.viterbi``, ``MeteorCostas``, ``mix_dynamic``, ``fft_zoom``,
the test-table source, ``NetworkSink`` and ``scan_blocks``.

The JAX side runs as the JAX package's own tests run it on the CPU: the
ACS as its ``lax.scan`` form, the stream decode put on its chunked path
(interpret-mode Pallas) by standing in for ``fec_pallas._pallas_available``
with chunk_bits <= 1024, the loops as ``jax.jit`` blocks. Inputs are made
from numpy seeds. Tolerances, with their reasons:

- the ACS decisions, decoded bits and bytes, the stream decode, the zoom,
  the tables and the sink's bytes: exact. Soft bits are integers in
  0..255, so every path metric is one rounding of the same operands in
  the same order on both sides; a zoom is a max; the tables and PCM are
  integer arithmetic;
- MeteorCostas (orders 4 and "meteor", exact loops on both sides):
  COSTAS_TOL = 2e-4 on the rotated output and the phases as phasors, the
  bound of tests/test_clock_recovery_pallas.py:104 and
  tests/test_torch_digital.py (XLA contracts the loop body into FMAs and
  evaluates cos/sin to other ulps);
- mix_dynamic: bit-equal to the port's static ``mix`` at the pair's
  omega, and within MIX_DYNAMIC_TOL = 5e-3 rad a block of the JAX
  function, the residual its docstring states (sdrpp_tpu/ops/mix.py:184);
- scan_blocks over an FIR: FIR_TOL = 2e-5, tests/test_torch_kernels.py's
  FIR bound (the port's FIR is an FFT overlap-save, XLA's a direct sum).
"""

import socket
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.io import sinks as jsinks
from sdrpp_tpu.io import sources as jsources
from sdrpp_tpu.models import digital as jdigital
from sdrpp_tpu.models import lrpt as jlrpt
from sdrpp_tpu.ops import fec as jfec
from sdrpp_tpu.ops import fec_pallas
from sdrpp_tpu.ops import fir as jfir
from sdrpp_tpu.ops import mix as jmix
from sdrpp_tpu.ops import spectrum as jspectrum
from sdrpp_tpu.utils import blocks as jblocks
from sdrpp_tpu_torch.io import sinks as tsinks
from sdrpp_tpu_torch.io import sources as tsources
from sdrpp_tpu_torch.models import digital as tdigital
from sdrpp_tpu_torch.models import lrpt as tlrpt
from sdrpp_tpu_torch.ops import fec as tfec
from sdrpp_tpu_torch.ops import fir as tfir
from sdrpp_tpu_torch.ops import mix as tmix
from sdrpp_tpu_torch.ops import spectrum as tspectrum
from sdrpp_tpu_torch.ops.scans_kernels import METEOR_PHASES
from sdrpp_tpu_torch.utils import blocks as tblocks

torch.set_num_threads(1)

VEC = np.load(Path(__file__).parent / "data" / "libcorrect_vectors.npz")
POLYS = {5: (0o23, 0o35), 7: jfec.CONV_R12_7, 9: jfec.CONV_R12_9}
COSTAS_TOL = 2e-4
MIX_DYNAMIC_TOL = 5e-3
FIR_TOL = 2e-5


def _codes(order, polys=None):
    polys = polys or POLYS[order]
    return (jfec.ConvCode(2, order, polys),
            tfec.ConvCode(2, order, polys, device="cpu"))


def _noisy_soft(code, nbytes, seed, sigma=60.0):
    """Random bytes encoded, as 0/255 soft bits with seeded noise, rounded
    to integers in 0..255 (uint8)."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 256, nbytes).astype(np.uint8)
    nbits = code.encode_len_bits(nbytes)
    bits = np.unpackbits(code.encode(msg))[:nbits]
    soft = np.clip(np.round(bits * 255.0 + rng.normal(0, sigma, nbits)),
                   0, 255).astype(np.uint8)
    return msg, soft


# ---------------------------------------------------------------------------
# ConvCode and LRPTDecoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order,kind,as_tensor", [
    (5, "noisy", False), (7, "noisy", True), (9, "noisy", False),
    (7, "ties", False)])
def test_acs_decisions_match_jax(order, kind, as_tensor):
    """[T, S] decisions on the device (uint8, nonzero = took (n >> 1) +
    S / 2), equal to JAX's as booleans; soft bits as numpy or a tensor;
    all-128 soft bits make every comparison a tie."""
    jcode, tcode = _codes(order)
    if kind == "ties":
        soft = np.full(2 * 150, 128, np.uint8)
    else:
        _, soft = _noisy_soft(tcode, 40, order, sigma=80.0)
    got = tcode.acs_decisions(torch.from_numpy(soft) if as_tensor else soft)
    want = np.asarray(jax.jit(jcode.acs_decisions)(
        jnp.asarray(soft.astype(np.float32))))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (len(soft) // 2,
                                              tcode.num_states)
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)


@pytest.mark.parametrize("case", ["soft_k7", "hard_k7", "hard_k9",
                                  "flips_k7", "flips_k9"])
def test_decode_bytes_match_libcorrect_and_jax(case):
    """tests/test_fec.py's cases: libcorrect's soft vector, hard decodes of
    its K = 7 and K = 9 encodings, and round trips with 2 % of the hard
    bits flipped; each equal to the vectors' message and to JAX's
    bytes."""
    order = 9 if case.endswith("k9") else 7
    jcode, tcode = _codes(order)
    msg = VEC["conv_msg"]
    if case == "soft_k7":
        got = tcode.decode_soft_bytes(VEC["conv_soft"])
        want = jcode.decode_soft_bytes(VEC["conv_soft"])
        n = int(VEC["conv_declen"])
        np.testing.assert_array_equal(got[:n], VEC["conv_dec"])
    elif case.startswith("hard"):
        enc, nbits = ((VEC["conv_enc"], VEC["conv_nbits"]) if order == 7
                      else (VEC["conv9_enc"], VEC["conv9_nbits"]))
        got = tcode.decode_hard(enc, int(nbits))
        want = jcode.decode_hard(enc, int(nbits))
    else:
        rng = np.random.default_rng(order)
        msg = rng.integers(0, 256, 128).astype(np.uint8)
        nbits = tcode.encode_len_bits(len(msg))
        bits = np.unpackbits(tcode.encode(msg))[:nbits].astype(np.float32)
        bits *= 255.0
        flip = rng.choice(nbits, nbits // 50, replace=False)
        bits[flip] = 255.0 - bits[flip]
        got = tcode.decode_soft_bytes(bits)
        want = jcode.decode_soft_bytes(bits)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:len(msg)], msg)


@pytest.fixture(scope="module")
def lrpt_stream():
    """Noisy uint8 soft bits of a 600-byte message (4814 trellis steps,
    five windows of 1024 + 2 x 96) and JAX's ``LRPTDecoder.viterbi`` of
    them on its chunked stream path."""
    t = tlrpt.LRPTDecoder(device="cpu")
    msg, soft = _noisy_soft(t.conv, 600, 4, sigma=70.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fec_pallas, "_pallas_available", lambda: True)
        want = jlrpt.LRPTDecoder().viterbi(soft, chunk_bits=1024,
                                           overlap_bits=96)
    return msg, soft, want


@pytest.mark.parametrize("as_tensor", [False, True])
def test_lrpt_viterbi_matches_jax(lrpt_stream, as_tensor):
    msg, soft, want = lrpt_stream
    dec = tlrpt.LRPTDecoder(device="cpu")
    arg = torch.from_numpy(soft) if as_tensor else soft
    got = dec.viterbi(arg, chunk_bits=1024, overlap_bits=96)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:len(msg)], msg)


def test_lrpt_viterbi_short_stream_takes_exact_decode():
    dec = tlrpt.LRPTDecoder(device="cpu")
    msg, soft = _noisy_soft(dec.conv, 100, 5)
    np.testing.assert_array_equal(dec.viterbi(soft)[:len(msg)], msg)
    np.testing.assert_array_equal(dec.viterbi(soft),
                                  jlrpt.LRPTDecoder().viterbi(soft))


# ---------------------------------------------------------------------------
# MeteorCostas
# ---------------------------------------------------------------------------

def _psk(n, seed, phases, noise=0.05, drift=2e-4):
    rng = np.random.default_rng(seed)
    ph = np.asarray(phases)[rng.integers(0, len(phases), n)] \
        + drift * np.arange(n)
    x = np.exp(1j * ph) + noise * (rng.standard_normal(n)
                                   + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _phasor_err(a, b):
    return float(np.abs(np.exp(1j * np.asarray(a, np.float64))
                        - np.exp(1j * np.asarray(b, np.float64))).max())


def test_meteor_costas_phases_and_defaults():
    assert tdigital.MeteorCostas.PHASES == jdigital.MeteorCostas.PHASES
    assert tdigital.MeteorCostas.PHASES == METEOR_PHASES
    assert "MeteorCostas" in tdigital.__all__
    for broken in (False, True):
        t = tdigital.MeteorCostas(0.005, broken, device="cpu")
        j = jdigital.MeteorCostas(0.005, broken)
        assert t.order == ("meteor" if broken else 4)
        assert (t.warmup, t.max_lanes, t.broken) == (j.warmup, j.max_lanes,
                                                     j.broken)
        assert (t.alpha, t.beta) == (j.alpha, j.beta)
    demod = tdigital.MeteorDemod(broken_modulation=True, device="cpu")
    assert isinstance(demod.costas, tdigital.MeteorCostas)
    assert demod.costas.order == "meteor"


@pytest.mark.parametrize("broken", [False, True])
def test_meteor_costas_matches_jax_over_blocks(broken):
    pts = (METEOR_PHASES if broken
           else np.pi / 4 + np.pi / 2 * np.arange(4))
    x = _psk(4000, 50 + broken, pts)
    j = jdigital.MeteorCostas(0.01, broken_modulation=broken,
                              init_phase=0.2, init_freq=1e-3)
    t = tdigital.MeteorCostas(0.01, broken_modulation=broken,
                              init_phase=0.2, init_freq=1e-3, device="cpu")
    js, ts = j.init_state(), t.init_state()
    np.testing.assert_allclose(ts["hist_re"].numpy(),
                               np.asarray(js["hist_re"]), atol=1e-6)
    step = jax.jit(j)
    for blk in (x[:2000], x[2000:]):
        js, jy = step(js, jnp.asarray(blk))
        ts, ty = t(ts, torch.from_numpy(blk))
        assert np.abs(ty.numpy() - np.asarray(jy)).max() <= COSTAS_TOL
        assert _phasor_err(ts["phase"], js["phase"]) <= COSTAS_TOL
    assert abs(float(ts["freq"]) - float(js["freq"])) <= COSTAS_TOL
    np.testing.assert_array_equal(ts["hist_im"].numpy(),
                                  np.asarray(js["hist_im"]))


# ---------------------------------------------------------------------------
# mix_dynamic, fft_zoom
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [100e3, -250e3, 123456.7, -3.3])
def test_mix_dynamic_is_mix_and_within_jax_residual(offset):
    fs, n = 1e6, 65536
    rng = np.random.default_rng(7)
    d = tmix.DynamicFrequencyXlator(offset, fs, device="cpu")
    hi, lo = d.offset_state(offset)
    omega = float(np.float64(hi) + np.float64(lo))
    phase = jphase = np.float32(0.7)
    tphase = torch.tensor(phase)
    for b in range(2):
        x = np.exp(2j * np.pi * rng.random(n)).astype(np.complex64)
        tx = torch.from_numpy(x)
        new, y = tmix.mix_dynamic(tphase, tx, torch.tensor(hi),
                                  torch.tensor(lo))
        ref_phase, ref = tmix.mix(tphase, tx, omega)
        assert torch.equal(new, ref_phase) and torch.equal(y, ref)
        jphase, jy = jax.jit(jmix.mix_dynamic)(jnp.float32(jphase),
                                               jnp.asarray(x), hi, lo)
        bound = MIX_DYNAMIC_TOL * (b + 1)
        assert np.abs(np.angle(y.numpy() * np.conj(np.asarray(jy)))).max() \
            <= bound
        assert _phasor_err(new, jphase) <= bound
        tphase = new
    st = d.init_state()
    st2, y2 = d(st, torch.from_numpy(x))
    ref_phase, ref = tmix.mix(st["phase"], torch.from_numpy(x), omega)
    assert torch.equal(y2, ref) and torch.equal(st2["phase"], ref_phase)


@pytest.mark.parametrize("shape,offset,width,out_width", [
    ((1024,), 256, 512, 128), ((1000,), 0, 1000, 128), ((3, 2, 1000), 0,
                                                        1000, 128),
    ((2, 4096), 100, 3000, 1024), ((2, 1000), 900, 300, 77),
    ((1000,), -5, 100, 200), ((2, 999), 10, 990, 990)])
def test_fft_zoom_matches_jax(shape, offset, width, out_width):
    """Even zooms (a reshape and a max) and uneven ones (a segment max),
    an offset past the end and a negative one, and more pixels than bins
    (empty pixels -inf): equal to the JAX function."""
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    got = tspectrum.fft_zoom(torch.from_numpy(x), offset, width, out_width)
    want = np.asarray(jspectrum.fft_zoom(jnp.asarray(x), offset, width,
                                         out_width))
    assert got.shape == want.shape == (*shape[:-1], out_width)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# TableSource, NetworkSink
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jsources.TEST_TABLES_14BIT))
def test_test_tables_and_table_source_match_jax(name):
    assert (tsources.TEST_TABLES_14BIT[name]
            == jsources.TEST_TABLES_14BIT[name])
    got, want = tsources.decode_test_table(name), \
        jsources.decode_test_table(name)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    t, j = (tsources.TableSource(48000.0, name),
            jsources.TableSource(48000.0, name))
    t.tune(1e6)
    assert t.center_freq == 1e6 and t.samplerate == j.samplerate
    for n in (10, 23, 16, 1):
        a, b = t.read(n), j.read(n)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _udp_rx():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    return rx


@pytest.mark.parametrize("stereo", [False, True])
def test_network_sink_udp_matches_jax(stereo):
    """The same writes (mono and stereo audio, numpy and tensors, a
    remainder carried across writes, samples past full scale) through the
    port's and the JAX sink: the same datagrams, byte for byte."""
    rng = np.random.default_rng(9)
    writes = [rng.uniform(-1.2, 1.2, 600).astype(np.float32),
              rng.uniform(-1.0, 1.0, (300, 2)).astype(np.float32),
              rng.uniform(-1.0, 1.0, 200).astype(np.float32)]
    pkts = {}
    for side, mod in (("port", tsinks), ("jax", jsinks)):
        rx = _udp_rx()
        sink = mod.NetworkSink("127.0.0.1", rx.getsockname()[1], "udp",
                               stereo=stereo, packet_samples=256)
        got = []
        try:
            for k, w in enumerate(writes):
                arg = torch.from_numpy(w) if side == "port" and k % 2 else w
                sink.write(arg)
            frames = 1100 // 256
            got = [rx.recv(65536) for _ in range(frames)]
        finally:
            sink.close()
            rx.close()
        pkts[side] = got
    assert pkts["port"] == pkts["jax"]
    assert all(len(p) == 256 * 2 * (2 if stereo else 1)
               for p in pkts["port"])


def test_network_sink_tcp_stream():
    srv = socket.create_server(("127.0.0.1", 0))
    audio = np.linspace(-0.5, 0.5, 700).astype(np.float32)
    sink = tsinks.NetworkSink("127.0.0.1", srv.getsockname()[1], "tcp",
                              packet_samples=256)
    conn, _ = srv.accept()
    try:
        sink.write(torch.from_numpy(audio))
        data = b""
        conn.settimeout(5.0)
        while len(data) < 512 * 2:
            data += conn.recv(4096)
    finally:
        sink.close()
        conn.close()
        srv.close()
    want = np.clip(audio[:512] * 32768.0, -32768, 32767).astype("<i2")
    assert data == want.tobytes()


# ---------------------------------------------------------------------------
# scan_blocks
# ---------------------------------------------------------------------------

def test_scan_blocks_matches_jax_over_fir():
    """An FIR run by ``scan_blocks`` over [4, 4096] blocks, its tail
    carried, against JAX's ``scan_blocks`` over the JAX FIR, and equal to
    the port's FIR called block by block."""
    rng = np.random.default_rng(10)
    taps = rng.standard_normal(63).astype(np.float32) / 8
    xs = (rng.standard_normal((4, 4096))
          + 1j * rng.standard_normal((4, 4096))).astype(np.complex64)
    tf = tfir.FIR(taps, dtype=torch.complex64, device="cpu")
    jf = jfir.FIR(taps, dtype=jnp.complex64)
    st, ys = tblocks.scan_blocks(tf, tf.init_state(), torch.from_numpy(xs))
    jst, jys = jax.jit(lambda s, x: jblocks.scan_blocks(jf, s, x))(
        jf.init_state(), jnp.asarray(xs))
    assert ys.shape == (4, 4096)
    scale = np.abs(np.asarray(jys)).max()
    assert np.abs(ys.numpy() - np.asarray(jys)).max() <= FIR_TOL * scale
    assert np.abs(st.numpy() - np.asarray(jst)).max() <= FIR_TOL * scale
    s = tf.init_state()
    for k in range(4):
        s, y = tf(s, torch.from_numpy(xs[k]))
        assert torch.equal(y, ys[k])


def test_scan_blocks_stacks_trees():
    class Acc(tblocks.Block):
        def __call__(self, s, x):
            s = s + x.sum()
            return s, {"y": x * 2, "s": (s, x[:1])}

    xs = torch.arange(12.0).reshape(3, 4)
    st, ys = tblocks.scan_blocks(Acc(), torch.zeros(()), xs)
    jst, jys = jblocks.scan_blocks(
        lambda s, x: (s + x.sum(), {"y": x * 2, "s": (s + x.sum(), x[:1])}),
        jnp.zeros(()), jnp.asarray(xs.numpy()))
    assert float(st) == float(jst) == 66.0
    for a, b in ((ys["y"], jys["y"]), (ys["s"][0], jys["s"][0]),
                 (ys["s"][1], jys["s"][1])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
