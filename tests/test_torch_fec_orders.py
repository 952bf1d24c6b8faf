"""ConvCode at every order and rate, the general Viterbi kernels' plain
versions, and Reed-Solomon erasure decoding: the port against the JAX
package on the same numpy-seeded inputs.

- ``ConvCode.decode_soft_np`` of the port at orders 2, 3, 4, 6, 8, 9, 12
  and 15 (S = 2 ... 16384 states) at rate 2, at rates 3 and 6 at order 9
  and rate 5 at order 5, against the JAX ``ConvCode.decode_soft`` (the
  CPU scan): bit-equal. The soft bits are integers in 0..255 (every branch and path
  metric an exact float32 sum on both sides); one float32 case at order 9,
  rate 2, where both sides round the same two-term sums in the same order.
- The plain ACS (``fec_kernels.viterbi_acs_batched`` on the CPU) against
  the interpret-mode Pallas single-stream ACS ``viterbi_acs_pallas`` (B5)
  up to order 9, decisions unpacked: bit-equal; the plain traceback
  against ``decode_soft_tpu`` (the Pallas ACS and the JAX survivor walk)
  and, for S <= 128, the interpret-mode Pallas walk (B7): bit-equal.
- ``decode_soft_stream`` at order 6 (S = 32) against the JAX package's
  windowed path (B6 / B7 in interpret mode, ``_pallas_available`` standing
  in as true, chunk_bits <= 1024), and at order 9 (S = 256) against the
  JAX exact decode, which the JAX package takes there on a TPU
  (fec.py:298-303): bit-equal.
- csrc/viterbi.cu's ACS schedules (the general CTA kernel's deferred
  minimum, the fast form's reference steps and renormalisations) emulated
  in float32 against the reference form: equal decisions.
- ``ReedSolomon.decode_with_erasures`` against the JAX
  ``decode_with_erasures``: the libcorrect vector and the (f, e) capacity
  grid of tests/test_fec.py, a batch of every f + 2e <= 32 at the limit,
  and blocks beyond it: equal bytes and ok flags (integer GF(256)
  arithmetic on both sides).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.ops import fec as jfec
from sdrpp_tpu.ops import fec_pallas
from sdrpp_tpu_torch.ops import fec as tfec
from sdrpp_tpu_torch.ops import fec_kernels as FK

torch.set_num_threads(1)

VEC = np.load(Path(__file__).parent / "data" / "libcorrect_vectors.npz")
NAMED = {(2, 6): tfec.CONV_R12_6, (2, 7): tfec.CONV_R12_7,
         (2, 8): tfec.CONV_R12_8, (2, 9): tfec.CONV_R12_9}


def _polys(rate, order):
    """The named libcorrect polynomials where there are some, else seeded
    polynomials of the order (top and bottom bit set)."""
    if (rate, order) in NAMED:
        return NAMED[(rate, order)]
    rng = np.random.default_rng(100 * rate + order)
    top, low = 1 << (order - 1), 1
    return tuple(int(rng.integers(0, 1 << order)) | top | low
                 for _ in range(rate))


def _codes(rate, order):
    polys = _polys(rate, order)
    return (jfec.ConvCode(rate, order, polys),
            tfec.ConvCode(rate, order, polys, device="cpu"))


def _soft(code, nbytes, seed, sigma=70.0, integral=True):
    """Seeded message -> encoded 0/255 soft bits plus N(0, sigma) noise,
    clipped to 0..255 (rounded to integers when ``integral``)."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 256, nbytes).astype(np.uint8)
    bits = np.unpackbits(code.encode(msg))[:code.encode_len_bits(nbytes)]
    soft = bits * 255.0 + rng.normal(0.0, sigma, bits.size)
    if integral:
        soft = np.round(soft)
    return msg, np.clip(soft, 0, 255).astype(np.float32)


ORDER_CASES = ([(2, o) for o in (2, 3, 4, 6, 8, 9, 12, 15)]
               + [(3, 9), (6, 9), (5, 5)])


@pytest.mark.parametrize("rate,order", ORDER_CASES,
                         ids=[f"r{r}k{o}" for r, o in ORDER_CASES])
def test_decode_soft_np_matches_jax(rate, order):
    jc, tc = _codes(rate, order)
    msg, soft = _soft(jc, 40, seed=order * 10 + rate)  # 321 + K + 1 steps
    want = np.asarray(jc.decode_soft(jnp.asarray(soft)))
    got = tc.decode_soft_np(soft)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if order >= 4:  # enough free distance to correct this noise
        np.testing.assert_array_equal(np.packbits(got)[:len(msg)], msg)


def test_decode_soft_np_float_soft_bits_matches_jax():
    jc, tc = _codes(2, 9)
    _, soft = _soft(jc, 40, seed=3, integral=False)
    want = np.asarray(jc.decode_soft(jnp.asarray(soft)))
    np.testing.assert_array_equal(tc.decode_soft_np(soft), want)


def _expected(code):
    return code.reg_outputs.astype(np.float32) * 255.0


@pytest.mark.parametrize("order", [2, 3, 4, 5, 6, 7, 8, 9])
def test_plain_acs_and_walk_match_pallas(order):
    jc, tc = _codes(2, order)
    S = jc.num_states
    _, soft = _soft(jc, 24, seed=order)
    steps = soft.reshape(-1, 2)
    want = np.asarray(fec_pallas.viterbi_acs_pallas(
        jnp.asarray(steps), jnp.asarray(_expected(jc)), S, interpret=True))
    words = FK.viterbi_acs_batched(
        torch.from_numpy(steps), torch.zeros(1, dtype=torch.int32),
        steps.shape[0], torch.from_numpy(_expected(jc)))
    assert list(words.shape) == ([1, steps.shape[0], S // 64] if S > 64
                                 else [1, steps.shape[0]])
    np.testing.assert_array_equal(
        FK.unpack_decisions(words[0], S).numpy(), want.astype(np.int8))
    bits = FK.viterbi_traceback_batched(words, num_states=S)
    flush = order + 1
    np.testing.assert_array_equal(
        bits[0, :steps.shape[0] - flush].numpy(),
        np.asarray(fec_pallas.decode_soft_tpu(jc, jnp.asarray(soft),
                                              interpret=True)))
    if S <= 128:  # the Pallas walk pads states to one 128-lane tile
        walk = np.asarray(fec_pallas.viterbi_traceback_pallas_batched(
            jnp.asarray(want[None].astype(np.int8)), S, interpret=True))
        np.testing.assert_array_equal(bits.numpy(), walk)


@pytest.mark.parametrize("S", [2, 32, 128, 256, 16384])
def test_pack_unpack_every_state_count(S):
    rng = np.random.default_rng(S)
    dec = torch.from_numpy(rng.integers(0, 2, (2, 3, S)).astype(np.int8))
    words = FK.pack_decisions(dec)
    assert list(words.shape) == ([2, 3, S // 64] if S > 64 else [2, 3])
    torch.testing.assert_close(FK.unpack_decisions(words, S), dec, rtol=0,
                               atol=0)


@pytest.fixture
def pallas_stream(monkeypatch):
    """The JAX stream decode on its chunked path (interpret-mode kernels),
    as on a TPU."""
    monkeypatch.setattr(fec_pallas, "_pallas_available", lambda: True)


def test_windowed_stream_32_states_matches_jax(pallas_stream):
    jc, tc = _codes(2, 6)
    _, soft = _soft(jc, 400, seed=32, sigma=60.0)  # 3207 steps, 4 windows
    want = jc.decode_soft_stream(soft, chunk_bits=1024, overlap_bits=96)
    got = tc.decode_soft_stream(soft, chunk_bits=1024, overlap_bits=96)
    np.testing.assert_array_equal(got, want)
    # the windows equal the exact decode at this noise
    np.testing.assert_array_equal(got, tc.decode_soft_np(soft))


def test_stream_above_64_states_is_the_exact_decode(pallas_stream):
    jc, tc = _codes(2, 9)
    msg, soft = _soft(jc, 200, seed=9)  # 1610 steps > one 1216-step window
    want = jc.decode_soft_np(soft)
    got = tc.decode_soft_stream(soft, chunk_bits=1024, overlap_bits=96)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.packbits(got)[:len(msg)], msg)


# ---------------------------------------------------------------------------
# Reed-Solomon erasures
# ---------------------------------------------------------------------------


def _rs():
    return (jfec.ReedSolomon(jfec.RS_CCSDS, 112, 11, 32),
            tfec.ReedSolomon(tfec.RS_CCSDS, 112, 11, 32, device="cpu"))


def _jax_erasures(jrs, blocks, pos, counts):
    fn = jax.jit(jax.vmap(jrs.decode_with_erasures))
    out, ok = fn(jnp.asarray(blocks), jnp.asarray(pos.astype(np.int32)),
                 jnp.asarray(counts.astype(np.int32)))
    return np.asarray(out), np.asarray(ok)


def test_rs_erasures_libcorrect_vector():
    _, trs = _rs()
    epos = np.zeros((1, 32), np.int32)
    npos = len(VEC["rs_er_positions"])
    epos[0, :npos] = VEC["rs_er_positions"]
    out, ok = trs.decode_with_erasures(
        torch.from_numpy(VEC["rs_er_corrupted"][None].astype(np.uint8)),
        torch.from_numpy(epos), torch.tensor([npos]))
    assert bool(ok[0])
    np.testing.assert_array_equal(out[0].numpy(), VEC["rs_er_dec"])
    np.testing.assert_array_equal(out[0].numpy(), VEC["rs_er_msg"])


def _corrupt(rng, rs, f, e):
    """A seeded codeword with f erasures (known, corrupted or not) and e
    errors at unknown positions -> (message, block, positions [32])."""
    msg = rng.integers(0, 256, rs.msg_len).astype(np.uint8)
    c = rs.encode(msg)
    pos = rng.choice(255, f + e, replace=False)
    c[pos] ^= rng.integers(1, 256, f + e).astype(np.uint8)
    epos = np.zeros(32, np.int32)
    epos[:f] = pos[:f]
    return msg, c, epos


def test_rs_erasure_grid_matches_jax():
    """Every (f, e) with f + 2e <= 32 at the limit and below it, the grid
    of tests/test_fec.py among them, plus blocks beyond the limit."""
    jrs, trs = _rs()
    rng = np.random.default_rng(21)
    cases = sorted({(f, e) for e in range(17) for f in (32 - 2 * e,
                                                        max(0, 30 - 2 * e))}
                   | {(32, 0), (20, 6), (10, 11), (4, 14)})
    beyond = [(33 - 2 * e, e) for e in range(1, 10)] + [(0, 17), (8, 13)]
    msgs, blocks, pos, counts = [], [], [], []
    for f, e in cases + beyond:
        m, c, p = _corrupt(rng, trs, min(f, 32), e)
        msgs.append(m)
        blocks.append(c)
        pos.append(p)
        counts.append(min(f, 32))
    blocks, pos = np.stack(blocks), np.stack(pos)
    counts = np.asarray(counts)
    want_out, want_ok = _jax_erasures(jrs, blocks, pos, counts)
    out, ok = trs.decode_with_erasures(torch.from_numpy(blocks),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(counts))
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(out.numpy(), want_out)
    inside = len(cases)
    assert ok[:inside].all()
    np.testing.assert_array_equal(out[:inside].numpy(),
                                  np.stack(msgs[:inside]))


def test_rs_erasures_refuse_mismatched_batches():
    _, trs = _rs()
    blocks = torch.zeros((2, 255), dtype=torch.uint8)
    with pytest.raises(ValueError, match="erasure_pos must be"):
        trs.decode_with_erasures(blocks, torch.zeros((3, 4),
                                                     dtype=torch.int32),
                                 torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="blocks must be"):
        trs.decode_with_erasures(blocks[:, :200], torch.zeros((2, 4)),
                                 torch.zeros(2))


RENORM = 40  # a short renormalisation interval for the emulation


@pytest.mark.parametrize("order,integral", [(2, True), (4, True), (6, True),
                                            (9, True), (9, False),
                                            (12, True)],
                         ids=["k2-u8", "k4-u8", "k6-u8", "k9-u8", "k9-f32",
                              "k12-u8"])
def test_kernel_schedules_equal_reference(order, integral):
    """csrc/viterbi.cu's schedules emulated in float32, against the
    reference form (the minimum subtracted every step), decisions bit for
    bit. The general CTA kernel keeps a step's new metrics unnormalised
    and, where the step records its minimum, subtracts it as the next step
    reads a predecessor, (m_old[p] - min) + bm; float32 soft bits record
    every step; integral ones (and the tuned kernels for S <= 32, which
    subtract the minimum in place) only a window's first K - 1 steps and
    every RENORM-th (4096 in the kernels), the metrics then exact integers
    off by a common offset."""
    jc, _ = _codes(2, order)
    S = jc.num_states
    _, soft = _soft(jc, 30, seed=77 + order, integral=integral)
    steps = torch.from_numpy(soft.reshape(-1, 2))
    expected = torch.from_numpy(_expected(jc))
    n = torch.arange(S)
    p0, p1 = n >> 1, (n >> 1) + S // 2
    m = torch.full((S,), 1e9)
    m[0] = 0.0
    mn, use_mn = torch.zeros(()), False
    words, peak = [], 0.0
    for t, s in enumerate(steps):
        bm = (s[0] - expected[:, 0]).abs() + (s[1] - expected[:, 1]).abs()
        a, b = m[p0], m[p1]
        if use_mn:
            a, b = a - mn, b - mn
        c0, c1 = a + bm[:S], b + bm[S:]
        take = c1 < c0
        m = torch.where(take, c1, c0)
        use_mn = not integral or t < order - 1 or (t + 1) % RENORM == 0
        mn = m.min()
        if t >= order - 1:
            peak = max(peak, float(m.max()))
        words.append(FK.pack_decisions(take))
    want = FK.viterbi_acs_batched_plain(
        steps, torch.zeros(1, dtype=torch.int32), steps.shape[0], expected)
    torch.testing.assert_close(torch.stack(words)[None], want, rtol=0,
                               atol=0)
    if integral:  # the bound that keeps every add exact
        assert peak < (RENORM + order - 1) * 2 * 255
