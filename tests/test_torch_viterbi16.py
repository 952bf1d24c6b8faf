"""The 16-state Viterbi (M17's K = 5 code) beside the 64-state codes, on the
CPU: the port's plain kernel versions and ``ConvCode`` against the JAX
package on the same numpy-seeded soft bits.

- Decisions of ``fec_kernels.viterbi_acs_batched`` (plain version) for
  S = 16 and S = 64, unpacked, against the interpret-mode Pallas
  single-stream ACS ``fec_pallas.viterbi_acs_pallas``: bit-exact (integral
  soft bits make every metric exact; the non-integral KG-STV soft bits
  round the same adds of the same operands on both sides, and the 0/1
  predecessor matmul of the Pallas kernel is exact).
- ``ConvCode.decode_soft_np`` for M17's code and the KG-STV K = 7 code
  against the JAX ``decode_soft_np`` on clean, noisy, punctured with
  erasures (M17's P1 and P2 patterns, 128 at every punctured position) and
  all-128 soft bits: equal bits.
- ``csrc/viterbi.cu``'s S = 16 schedule emulated in float32 torch (the
  reference form for the first K - 1 = 4 steps, then the minimum
  subtracted only after every N-th step, fminf as the select) equals the
  reference form bit for bit, and its S = 16 walker equals the plain walk.
- Codes of other orders decode equal to the JAX package; a state count
  that is not a power of two in [2, 16384] raises ValueError: the
  wrappers, the pack/unpack helpers, and the compiled host path's checks,
  which repeat the Python ones with the same messages.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdrpp_tpu.decoders import m17_frame as jmf
from sdrpp_tpu.ops import fec as jfec
from sdrpp_tpu.ops import fec_pallas
from sdrpp_tpu_torch.ops import fec as tfec
from sdrpp_tpu_torch.ops import fec_kernels as FK
from sdrpp_tpu_torch.utils import cuda_lib

torch.set_num_threads(1)

M17 = (0b11001, 0b10111)     # m17dsp.h:92, K = 5
KGSSTV = (0o155, 0o117)      # kg_sstv_dsp.h:57, K = 7
RENORM = 40                  # a short renormalisation interval for the emulation
REF_STEPS = 4                # csrc/viterbi.cu Trellis<16>::kRef (K - 1)


def _codes(order):
    polys = M17 if order == 5 else KGSSTV
    return (jfec.ConvCode(2, order, polys),
            tfec.ConvCode(2, order, polys, device="cpu"))


def _m17_soft(kind, seed):
    """Depunctured float32 soft bits of an M17 frame: "lsf" (240 bits,
    P1, 244 steps) or "payload" (144 bits, P2, 148 steps), with a few hard
    bit errors before the depuncture for the noisy kinds."""
    rng = np.random.default_rng(seed)
    lsf = kind.startswith("lsf")
    nbits, pattern, size = ((240, jmf.PUNCT_P1, jmf.ENCODED_LSF_SIZE) if lsf
                            else (144, jmf.PUNCT_P2,
                                  jmf.ENCODED_PAYLOAD_SIZE))
    enc = jmf._conv_encode_terminated(rng.integers(0, 2, nbits))
    sent = jmf._puncture(enc, pattern)
    if kind.endswith("noisy"):
        sent = sent.copy()
        sent[rng.choice(len(sent), 6, replace=False)] ^= 1
    return jmf._depuncture_soft(sent, pattern, size)


def _soft(order, kind, seed=0):
    """[T * 2] soft bits of one family for the order's code."""
    rng = np.random.default_rng(seed)
    if kind.startswith(("lsf", "payload")):
        return _m17_soft(kind, seed)
    steps = 244 if order == 5 else 62
    if kind == "all128":
        return np.full(2 * steps, 128.0, np.float32)
    code = tfec.ConvCode(2, order, M17 if order == 5 else KGSSTV,
                         device="cpu")
    bits = np.unpackbits(code.encode(
        rng.integers(0, 256, -(-(steps - order - 1) // 8))
        .astype(np.uint8)))[:2 * steps].astype(np.float32)
    if kind == "clean":
        return bits * 255.0
    # the KG-STV deframer's soft bits: clip((v + 1) * 128, 0, 255) of a
    # noisy +-1 symbol, non-integral
    v = bits * 2.0 - 1.0 + rng.normal(0, 0.45, bits.size)
    return np.clip((v + 1.0) * 128.0, 0.0, 255.0).astype(np.float32)


def _expected(code):
    return torch.from_numpy(code.reg_outputs.astype(np.float32) * 255.0)


@pytest.mark.parametrize("order,kind", [
    (5, "lsf"), (5, "lsf_noisy"), (5, "payload_noisy"), (5, "all128"),
    (5, "noisy"), (7, "noisy"), (7, "all128")])
def test_acs_decisions_match_pallas(order, kind):
    jcode, tcode = _codes(order)
    soft = _soft(order, kind, 1)
    steps = tcode._soft_steps(soft)
    expected = _expected(tcode)
    got = FK.viterbi_acs_batched(steps, torch.zeros(1, dtype=torch.int32),
                                 steps.shape[0], expected)
    S = tcode.num_states
    want = np.asarray(fec_pallas.viterbi_acs_pallas(
        jnp.asarray(soft.reshape(-1, 2)), jnp.asarray(expected.numpy()), S,
        interpret=True))
    assert want.shape == (steps.shape[0], S)
    np.testing.assert_array_equal(FK.unpack_decisions(got[0], S).numpy(),
                                  want)
    if S == 16:
        assert int((got >> 16).abs().sum()) == 0  # bits >= S stay zero


@pytest.mark.parametrize("order,kind,flush", [
    (5, "lsf", 4), (5, "lsf_noisy", 4), (5, "payload", 4),
    (5, "payload_noisy", 4), (5, "all128", 4), (5, "noisy", 6),
    (7, "clean", 6), (7, "noisy", 6), (7, "all128", 6)])
def test_decode_soft_np_matches_jax(order, kind, flush):
    jcode, tcode = _codes(order)
    soft = _soft(order, kind, 2)
    want = np.asarray(jcode.decode_soft_np(soft, flush_bits=flush))
    got = tcode.decode_soft_np(soft, flush_bits=flush)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_m17_frames_round_trip():
    """Clean punctured LSF and payload frames decode error-free: the bits
    come back as they were encoded."""
    _, code = _codes(5)
    rng = np.random.default_rng(3)
    for nbits, pattern, size in ((240, jmf.PUNCT_P1, jmf.ENCODED_LSF_SIZE),
                                 (144, jmf.PUNCT_P2,
                                  jmf.ENCODED_PAYLOAD_SIZE)):
        msg = rng.integers(0, 2, nbits).astype(np.uint8)
        sent = jmf._puncture(jmf._conv_encode_terminated(msg), pattern)
        soft = jmf._depuncture_soft(sent, pattern, size)
        np.testing.assert_array_equal(
            code.decode_soft_np(soft, flush_bits=4)[:nbits], msg)


def kernel_schedule16(soft, starts, T, expected, renorm):
    """The S = 16 ACS kernel's uint8 schedule in float32: the reference
    form for the first REF_STEPS steps, then the minimum subtracted only
    after every ``renorm``-th step, fminf as the select. Returns (words,
    the largest metric carried after the reference steps)."""
    total, R, T = FK._check_acs(soft, starts, T, expected)
    st = starts.long().clamp(0, total - T)
    windows = soft[st[:, None] + torch.arange(T)].float()
    B, S = windows.shape[0], 16
    n = torch.arange(S)
    p0, p1 = n >> 1, (n >> 1) + S // 2
    m = torch.full((B, S), 1e9)
    m[:, 0] = 0.0
    words = torch.empty((B, T), dtype=torch.int64)
    peak = 0.0
    for t in range(T):
        s = windows[:, t, None, :]
        bm = (s[..., 0] - expected[:, 0]).abs()
        for j in range(1, R):
            bm = bm + (s[..., j] - expected[:, j]).abs()
        cand0 = m[:, p0] + bm[:, :S]
        cand1 = m[:, p1] + bm[:, S:]
        take1 = cand1 < cand0
        new = torch.minimum(cand0, cand1)
        if t >= REF_STEPS:
            peak = max(peak, float(new.max()))
        if t < REF_STEPS or (t + 1) % renorm == 0:
            new = new - new.min(dim=1, keepdim=True).values
        m = new
        words[:, t] = FK.pack_decisions(take1)
    return words, peak


@pytest.mark.parametrize("kind", ["lsf", "payload_noisy", "all128", "noisy"])
def test_kernel_schedule16_equals_reference(kind):
    """Windows renormalised every 40 steps decide exactly as the per-step
    reference form does, on M17's punctured frames (erasures at 128), ties
    everywhere (all 128) and noisy coded bits (rounded to integers, as the
    fast form takes only uint8); window starts clamp."""
    _, code = _codes(5)
    soft = code._soft_steps(np.round(_soft(5, kind, 4)))
    assert soft.dtype == torch.uint8
    T = soft.shape[0] - 20
    starts = torch.tensor([0, 7, 10 ** 6], dtype=torch.int32)
    expected = _expected(code)
    want = FK.viterbi_acs_batched_plain(soft, starts, T, expected)
    got, peak = kernel_schedule16(soft, starts, T, expected, RENORM)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert peak < (RENORM + REF_STEPS) * 2 * 255


def test_traceback16_walker_form_equals_plain():
    """The S = 16 walker (csrc/viterbi.cu Walker<16>): the decision is bit
    s of the word's low half, the predecessor (s >> 1) | took << 3."""
    rng = np.random.default_rng(9)
    words = torch.from_numpy(rng.integers(0, 1 << 16, (5, 120),
                                          dtype=np.int64))
    B, T = words.shape
    s = torch.zeros(B, dtype=torch.int64)
    bits = torch.empty((B, T), dtype=torch.uint8)
    for t in range(T - 1, -1, -1):
        bits[:, t] = (s & 1).to(torch.uint8)
        took = (words[:, t] & 0xffff) >> s & 1
        s = (s >> 1) | (took << 3)
    torch.testing.assert_close(
        bits, FK.viterbi_traceback_batched(words, num_states=16),
        rtol=0, atol=0)
    want = np.asarray(fec_pallas.viterbi_traceback_pallas_batched(
        jnp.asarray(FK.unpack_decisions(words, 16).numpy()), 16,
        interpret=True))
    np.testing.assert_array_equal(bits.numpy(), want)


def test_pack_unpack16_round_trip():
    rng = np.random.default_rng(6)
    dec = torch.from_numpy(rng.integers(0, 2, (3, 5, 16)).astype(np.int8))
    words = FK.pack_decisions(dec)
    assert int(words.max()) < 1 << 16
    torch.testing.assert_close(FK.unpack_decisions(words, 16), dec, rtol=0,
                               atol=0)


@pytest.mark.parametrize("order", [4, 6, 9])
def test_other_state_counts_raise(order):
    """Orders 4, 6 and 9 decode, equal to the JAX package; their expected
    outputs cut to a row count that is not 2S for a power of two S
    raise."""
    polys = ((0b1011, 0b1101) if order == 4 else (0o73, 0o61) if order == 6
             else (0o767, 0o545))
    jc = jfec.ConvCode(2, order, polys)
    code = tfec.ConvCode(2, order, polys, device="cpu")
    soft = np.random.default_rng(order).integers(0, 256, 80) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        code.decode_soft_np(soft, flush_bits=4),
        np.asarray(jc.decode_soft(jnp.asarray(soft), flush_bits=4)))
    steps = torch.from_numpy(soft.astype(np.uint8).reshape(-1, 2))
    with pytest.raises(ValueError, match=re.escape(
            "float32 [2S, 2] for S = 2, 4, ..., 16384 states")):
        FK.viterbi_acs_batched(steps, torch.zeros(1, dtype=torch.int32), 10,
                               code._expected[:3 * code.num_states // 2])


def test_wrappers_refuse_other_state_counts():
    soft = torch.zeros((50, 2), dtype=torch.uint8)
    starts = torch.zeros(1, dtype=torch.int32)
    for rows in (2, 48, 65536, 33):
        with pytest.raises(ValueError, match=re.escape(
                "float32 [2S, 2] for S = 2, 4, ..., 16384 states")):
            FK.viterbi_acs_batched(soft, starts, 10, torch.zeros((rows, 2)))
    words = torch.zeros((1, 10), dtype=torch.int64)
    for S in (1, 12, 48, 32768):
        with pytest.raises(ValueError, match=f"16384 states, got {S}"):
            FK.viterbi_traceback_batched(words, num_states=S)
        with pytest.raises(ValueError, match=f"16384 states, got {S}"):
            FK.unpack_decisions(words, S)
    with pytest.raises(ValueError, match="decisions must be"):
        FK.pack_decisions(torch.zeros((2, 48), dtype=torch.int8))


@pytest.fixture(scope="module")
def host():
    return cuda_lib.load_host("kernels_host", cuda=False)


def _message(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("rows,rate", [(32, 2), (32, 4), (64, 2), (256, 2),
                                       (16, 2), (512, 6), (32768, 3), (4, 32),
                                       (48, 2), (2, 2), (65536, 2), (33, 2),
                                       (32, 33)])
def test_host_acs_state_checks_match_python(host, rows, rate):
    soft = torch.zeros((50, rate), dtype=torch.uint8)
    starts = torch.zeros(2, dtype=torch.int32)
    expected = torch.zeros((rows, rate))
    want = _message(FK._check_acs, soft, starts, 10, expected)
    got = _message(host.viterbi_acs, soft, starts, 10, expected, None)
    S = rows // 2
    if rows % 2 == 0 and 2 <= S <= 16384 and S & (S - 1) == 0 \
            and rate <= 32:
        assert want is None
        assert got == "the compiled Viterbi ACS takes CUDA tensors"
    else:
        assert got == want and ("16384 states" in want
                                or "soft bits a step" in want)


@pytest.mark.parametrize("S,shape", [(16, (2, 3)), (64, (2, 3)),
                                     (32, (2, 3)), (2, (2, 3)),
                                     (256, (2, 3, 4)), (16384, (1, 3, 256)),
                                     (0, (2, 3)), (24, (2, 3)),
                                     (256, (2, 3)), (128, (2, 3, 4))])
def test_host_traceback_state_checks_match_python(host, S, shape):
    dec = torch.zeros(shape, dtype=torch.int64)
    want = _message(FK._check_traceback, dec, S)
    got = _message(host.viterbi_traceback, dec, None, S)
    if S in (16, 64, 32, 2) or (S, shape) in ((256, (2, 3, 4)),
                                              (16384, (1, 3, 256))):
        assert want is None
        assert got == "the compiled Viterbi traceback takes CUDA tensors"
    elif S in (0, 24):
        assert got == want == f"the Viterbi kernels take S = 2, 4, ..., " \
                              f"16384 states, got {S}"
    else:
        assert got == want == f"dec must be int64 [B, T, {S // 64}] " \
                              f"decision words, B and T >= 1"
