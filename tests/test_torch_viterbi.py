"""The Viterbi kernels' contracts on the CPU: packed decisions, windows read
from a soft-bit stream by their starts, and the ACS kernel's schedule.

- The plain packed ACS (``fec_kernels.viterbi_acs_batched_plain``) on a
  uint8 or float32 stream plus window starts, unpacked, against the
  interpret-mode Pallas kernels of the JAX package on the gathered windows
  (``viterbi_acs_pallas_batched``, and ``viterbi_acs_pallas`` for one
  window), at rates 2 and 4; the plain traceback from packed words against
  ``viterbi_traceback_pallas_batched``. Tolerance: bit-exact (integral
  soft bits make every metric exact; for the non-integral float32 stream
  both sides round the same adds of the same operands: at R = 2 a branch
  metric is one add of two terms, and the 0/1 predecessor matmul of the
  Pallas kernel is exact).
- ``csrc/viterbi.cu`` cannot run here, so its schedule is emulated in
  float32 torch (``kernel_schedule``): the reference form for the first
  6 steps of a window, then no per-step minimum and one renormalisation
  after every N-th step, with fminf as the select. Its decisions must
  equal the plain reference form's bit for bit on uint8 families (random,
  all 0, all 255, all 128 with ties everywhere, noisy coded bits), with a
  small N that crosses many renormalisations and with the kernel's own N
  = 4096 on a stream that crosses two; the metrics it carries stay below
  2^24, where float32 adds of integers are exact. The traceback kernel's
  walker form (the state as bit 5 and bits 0-4) is emulated the same way
  against the plain walk.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdrpp_tpu.ops import fec_pallas
from sdrpp_tpu_torch.ops import fec as tfec
from sdrpp_tpu_torch.ops import fec_kernels as FK

torch.set_num_threads(1)

LRPT = (0o171, 0o133)
RATE4 = (0o171, 0o133, 0o165, 0o117)
KERNEL_RENORM = 4096   # csrc/viterbi.cu: kRenormGroups x 32 steps
KERNEL_REF_STEPS = 6   # csrc/viterbi.cu: kRef (K - 1)


def _code(rate):
    return tfec.ConvCode(rate, 7, LRPT if rate == 2 else RATE4, device="cpu")


def _expected(code):
    return torch.from_numpy(code.reg_outputs.astype(np.float32) * 255.0)


def _stream(code, total, kind, seed):
    """[total, R] uint8 soft bits of one family."""
    rng = np.random.default_rng(seed)
    R = code.rate
    if kind == "random":
        return rng.integers(0, 256, (total, R)).astype(np.uint8)
    if kind in ("zeros", "all255", "all128"):
        return np.full((total, R), {"zeros": 0, "all255": 255,
                                    "all128": 128}[kind], np.uint8)
    nbytes = -(-total // 8)
    bits = np.unpackbits(code.encode(
        rng.integers(0, 256, nbytes).astype(np.uint8)))[:total * R]
    return np.clip(np.round(255.0 * bits + rng.normal(0, 90, total * R)),
                   0, 255).astype(np.uint8).reshape(total, R)


def _gathered(soft, starts, T):
    st = np.clip(starts, 0, soft.shape[0] - T)
    return soft[st[:, None] + np.arange(T)]


@pytest.mark.parametrize("rate", [2, 4])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_plain_acs_matches_pallas_on_stream_windows(rate, dtype):
    """Windows read from one stream by their starts (one before 0 and one
    past the end, both clamped) equal the Pallas kernels on the gathered
    windows; B = 1 with start 0 and T = total is the single-stream ACS."""
    code = _code(rate)
    soft = _stream(code, 640, "noisy", 3)
    if dtype == "float32":
        rng = np.random.default_rng(4)
        soft = soft.astype(np.float32)
        if rate == 2:  # non-integral soft bits
            soft = soft + rng.uniform(-0.5, 0.5, soft.shape).astype(np.float32)
    starts = np.array([0, 137, 300, -20, 10 ** 6], np.int32)
    T = 200
    expected = _expected(code)
    got = FK.viterbi_acs_batched(torch.from_numpy(soft),
                                 torch.from_numpy(starts), T, expected)
    assert got.dtype == torch.int64 and list(got.shape) == [5, T]
    windows = _gathered(soft, starts, T).astype(np.float32)
    want = np.asarray(fec_pallas.viterbi_acs_pallas_batched(
        jnp.asarray(windows), jnp.asarray(expected.numpy()), 64,
        interpret=True))
    np.testing.assert_array_equal(FK.unpack_decisions(got).numpy(), want)

    one = FK.viterbi_acs_batched(torch.from_numpy(soft[:T]),
                                 torch.zeros(1, dtype=torch.int32), T,
                                 expected)
    want_one = np.asarray(fec_pallas.viterbi_acs_pallas(
        jnp.asarray(soft[:T].astype(np.float32)),
        jnp.asarray(expected.numpy()), 64, interpret=True))
    np.testing.assert_array_equal(FK.unpack_decisions(one[0]).numpy(),
                                  want_one)


def test_plain_traceback_matches_pallas_from_packed_words():
    code = _code(2)
    soft = _stream(code, 900, "noisy", 5)
    starts = np.array([0, 250, 500, 700], np.int32)
    words = FK.viterbi_acs_batched(torch.from_numpy(soft),
                                   torch.from_numpy(starts), 200,
                                   _expected(code))
    want = np.asarray(fec_pallas.viterbi_traceback_pallas_batched(
        jnp.asarray(FK.unpack_decisions(words).numpy()), 64,
        interpret=True))
    got = FK.viterbi_traceback_batched(words)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_unpack_round_trip():
    rng = np.random.default_rng(6)
    dec = torch.from_numpy(rng.integers(0, 2, (3, 5, 64)).astype(np.int8))
    dec[0, 0] = 1  # bit 63 set: a negative word
    words = FK.pack_decisions(dec)
    assert words.dtype == torch.int64 and list(words.shape) == [3, 5]
    assert int(words[0, 0]) == -1
    torch.testing.assert_close(FK.unpack_decisions(words), dec, rtol=0,
                               atol=0)
    raw = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, (4, 7),
                                        dtype=np.int64))
    torch.testing.assert_close(FK.pack_decisions(FK.unpack_decisions(raw)),
                               raw, rtol=0, atol=0)
    with pytest.raises(ValueError, match="decisions must be"):
        FK.pack_decisions(dec[..., :48])


def kernel_schedule(soft, starts, T, expected, renorm):
    """The ACS kernel's uint8 schedule in float32: the reference form for
    the first KERNEL_REF_STEPS steps, then the minimum subtracted only
    after every ``renorm``-th step; the value of a state is the min of its
    two candidates (fminf). Returns (words, the largest metric carried
    after the reference steps)."""
    total, R, T = FK._check_acs(soft, starts, T, expected)
    st = starts.long().clamp(0, total - T)
    windows = soft[st[:, None] + torch.arange(T)].float()
    B, S = windows.shape[0], 64
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
        if t >= KERNEL_REF_STEPS:
            peak = max(peak, float(new.max()))
        if t < KERNEL_REF_STEPS or (t + 1) % renorm == 0:
            new = new - new.min(dim=1, keepdim=True).values
        m = new
        words[:, t] = FK.pack_decisions(take1)
    return words, peak


@pytest.mark.parametrize("kind", ["random", "zeros", "all255", "all128",
                                  "noisy"])
@pytest.mark.parametrize("rate", [2, 4])
def test_kernel_schedule_equals_reference(kind, rate):
    """Windows of 300 steps renormalised every 40 steps (7 times) decide
    exactly as the per-step reference form does."""
    code = _code(rate)
    soft = torch.from_numpy(_stream(code, 700, kind, 7))
    starts = torch.tensor([0, 211, 400], dtype=torch.int32)
    expected = _expected(code)
    want = FK.viterbi_acs_batched_plain(soft, starts, 300, expected)
    got, peak = kernel_schedule(soft, starts, 300, expected, 40)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert peak < (40 + KERNEL_REF_STEPS) * rate * 255


def test_kernel_schedule_crosses_two_renormalisations():
    """One window over a stream of 2 x 4096 + 300 steps at the kernel's own
    interval: bit-exact, and the carried metrics stay below the bound
    (4096 + 6) * R * 255 < 2^24 that keeps every float32 add exact."""
    code = _code(4)
    total = 2 * KERNEL_RENORM + 300
    soft = torch.from_numpy(_stream(code, total, "random", 8))
    starts = torch.zeros(1, dtype=torch.int32)
    expected = _expected(code)
    want = FK.viterbi_acs_batched_plain(soft, starts, total, expected)
    got, peak = kernel_schedule(soft, starts, total, expected, KERNEL_RENORM)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    bound = (KERNEL_RENORM + KERNEL_REF_STEPS) * 4 * 255
    assert 2 ** 20 < peak < bound < 2 ** 24


def test_traceback_walker_form_equals_plain():
    """The traceback kernel's walk (csrc/viterbi.cu, step_back): the state
    kept as its bit 5 (`top`, which picks the word's half) and its bits
    0-4 (`sh`, the shift), the next state's bit 5 the decision and its
    bits 0-4 s >> 1."""
    rng = np.random.default_rng(9)
    words = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, (6, 500),
                                          dtype=np.int64))
    B, T = words.shape
    sh = torch.zeros(B, dtype=torch.int64)
    top = torch.zeros(B, dtype=torch.bool)
    bits = torch.empty((B, T), dtype=torch.uint8)
    for t in range(T - 1, -1, -1):
        bits[:, t] = (sh & 1).to(torch.uint8)
        w = words[:, t]
        half = torch.where(top, (w >> 32) & 0xffffffff, w & 0xffffffff)
        took = ((half >> sh) & 1).bool()
        sh = (sh >> 1) | torch.where(top, 16, 0)
        top = took
    torch.testing.assert_close(bits, FK.viterbi_traceback_batched(words),
                               rtol=0, atol=0)


def test_soft_steps_keep_integral_bits_as_uint8():
    """Integral soft bits in 0..255 (uint8, other integers, integral
    floats) reach the kernels as uint8; others as float32; both decode
    alike."""
    code = _code(2)
    soft = _stream(code, 400, "noisy", 10).reshape(-1)
    for arr in (soft, soft.astype(np.int16), soft.astype(np.float32),
                torch.from_numpy(soft)):
        assert code._soft_steps(arr).dtype == torch.uint8
    for arr in (soft.astype(np.float32) + 0.5, soft.astype(np.int16) - 1,
                torch.from_numpy(soft.astype(np.float32))):
        assert code._soft_steps(arr).dtype == torch.float32
    torch.testing.assert_close(
        code.decode_soft(soft),
        code.decode_soft(torch.from_numpy(soft.astype(np.float32))),
        rtol=0, atol=0)
    k9 = tfec.ConvCode(2, 9, (0o767, 0o545), device="cpu")
    torch.testing.assert_close(
        k9.decode_soft(soft),
        k9.decode_soft(torch.from_numpy(soft.astype(np.float32))),
        rtol=0, atol=0)


def _acs_cases():
    """(id, soft, starts, T, expected, message)."""
    s = torch.zeros((50, 2), dtype=torch.uint8)
    st = torch.zeros(2, dtype=torch.int32)
    e = torch.zeros((128, 2))
    return [
        ("soft dtype", s.double(), st, 10, e, "uint8 or float32"),
        ("soft dims", s[None], st, 10, e, "uint8 or float32"),
        ("rate", torch.zeros((50, 33), dtype=torch.uint8), st, 10,
         torch.zeros((128, 33)), "2 to 32 soft bits a step, got 33"),
        ("expected rows", s, st, 10, e[:96], "float32 [2S, 2]"),
        ("expected dtype", s, st, 10, e.double(), "float32 [2S, 2]"),
        ("starts dtype", s, st.long(), 10, e, "int32 vector"),
        ("starts empty", s, st[:0], 10, e, "int32 vector"),
        ("starts device", s, st.to("meta"), 10, e, "one device"),
        ("T zero", s, st, 0, e, "window length 0 outside [1, 50]"),
        ("T long", s, st, 51, e, "window length 51 outside [1, 50]"),
    ]


@pytest.mark.parametrize("case", _acs_cases(), ids=lambda c: c[0])
def test_acs_rejects_wrong_arguments(case):
    _, soft, starts, T, expected, message = case
    with pytest.raises(ValueError, match=re.escape(message)):
        FK.viterbi_acs_batched(soft, starts, T, expected)


@pytest.mark.parametrize("dec", [torch.zeros((2, 3), dtype=torch.int32),
                                 torch.zeros(3, dtype=torch.int64),
                                 torch.zeros((0, 3), dtype=torch.int64)],
                         ids=["dtype", "1-D", "empty"])
def test_traceback_rejects_wrong_arguments(dec):
    with pytest.raises(ValueError, match="int64 \\[B, T\\] decision words"):
        FK.viterbi_traceback_batched(dec)
