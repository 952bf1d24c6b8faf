"""The general Viterbi ACS's radix-4 design (csrc/viterbi.cu
``acs_r4_kernel``: uint8 soft bits, S = 64 ... 1024, a thread a state, two
trellis steps a barrier), modelled in numpy and held bit for bit to the
plain version ``fec_kernels.viterbi_acs_batched_plain`` on the CPU.

The kernel runs only on the card (chip_smoke.py holds it to the plain
version there); ``r4_model`` repeats its schedule step for step:

- a pair of plain steps reads state n's four ancestors n >> 2 + {0, S / 4,
  S / 2, 3 S / 4}, takes the intermediate states q0 = n >> 1 and q1 = q0 +
  S / 2 with the reference's rule (c1 < c0), then state n;
- the intermediate step's words come from the kernel's shuffle and ballot
  (lane l < 16 takes q0's decision from lane 2 l, lane l >= 16 q1's from
  lane 2 (l - 16)), written as u16 halves at w and S / 32 + w;
- a window's first K - 1 steps, every 4096th step, the step after each
  (which subtracts the recorded minimum as it reads) and a plain run's odd
  last step run the radix-2 reference step; every step does when the
  expected outputs are not integral;
- the soft-bit chunks (staged at c CH and c CH + CH / 2) and the decision
  groups (flushed in the first unit after each 32 steps), both before
  that unit's barrier, are checked against the unit (barrier) order: no
  unit reads a chunk that an earlier unit has not stored, or that one at
  or before it has overwritten, and no group leaves before its last step
  or after its buffer is reused.

Cases: S = 64 at R = 6, S = 128, 256 and 1024 at R = 2 (and 3), odd and
even T, T across a renormalisation (plain runs of odd and even length:
K - 1 = 7 and 8), all-128 ties, and expected outputs off the integers.
"""

import numpy as np
import pytest
import torch

from sdrpp_tpu_torch.ops import fec as F
from sdrpp_tpu_torch.ops import fec_kernels as FK

F32 = np.float32
RENORM = 4096           # csrc/viterbi.cu kRenormSteps
FAST_RATE = 16          # kFastRate


def _chunk_shift(S, R):
    """csrc/viterbi.cu launch_r4: CH = 2^cs steps, the largest with CH R
    <= 4 S."""
    cs = 0
    while (2 << cs) * R <= 4 * S:
        cs += 1
    return cs


class _Order:
    """The unit (barrier) order of the kernel's shared buffers."""

    def __init__(self, T, cs):
        self.unit = 0
        self.stored = {0: -1}          # chunk -> unit that stored it
        self.written = {}              # step -> unit that staged its words
        self.flushed = {}              # group -> unit
        self.cs, self.T = cs, T
        CH = 1 << cs
        self.flush_at, self.chunk_ev, self.phase = 32, 0, 0
        self.half = CH >> 1

    def events(self, t):
        if t >= self.flush_at:
            g = (self.flush_at >> 5) - 1
            self.flush(g)
            self.flush_at += 32
        if t >= self.chunk_ev:
            c = (self.chunk_ev >> self.cs) + 1
            if self.phase == 1:
                # the buffer held chunk c - 2: no later read may need it
                self.stored[c] = self.unit
            self.phase ^= 1
            self.chunk_ev += self.half

    def read(self, t):
        c = min(t, self.T - 1) >> self.cs
        assert self.stored.get(c, 10 ** 9) < self.unit, (t, c)
        assert self.stored.get(c + 2, 10 ** 9) > self.unit, (t, c)

    def stage(self, t):
        self.written[t] = self.unit

    def flush(self, g):
        steps = range(32 * g, min(32 * g + 32, self.T))
        assert all(self.written[s] < self.unit for s in steps), g
        # the buffer is reused by group g + 2: none of its steps yet
        assert all(self.written.get(s, 10 ** 9) > self.unit
                   for s in range(32 * g + 64, 32 * g + 96)), g
        self.flushed[g] = self.unit

    def barrier(self):
        self.unit += 1


def r4_model(soft, expected):
    """numpy model of ``acs_r4_kernel`` over one window from step 0:
    soft [T, R] uint8, expected [2S, R] float32 -> [T, S / 32] uint32
    decision words."""
    soft = np.asarray(soft)
    e = np.asarray(expected, F32)
    T, R = soft.shape
    S = e.shape[0] // 2
    assert 64 <= S <= 1024 and R <= FAST_RATE
    n = np.arange(S)
    q0, a = n >> 1, n >> 2
    half, quarter, wps = S // 2, S // 4, S // 32
    rows = [q0, q0 + S, q0 + half, q0 + half + S, n, n + S]
    s = soft.astype(F32)

    def bm(k, t):
        r = rows[k]
        acc = np.abs(s[t, 0] - e[r, 0])
        for j in range(1, R):
            acc = acc + np.abs(s[t, j] - e[r, j])
        return acc.astype(F32)

    fast = bool(np.all((e == np.rint(e)) & (e >= 0) & (e <= 255)))
    ref_steps = S.bit_length() - 1

    def rec(t):
        return not fast or t < ref_steps or (t + 1) % RENORM == 0

    m = np.full(S, F32(1e9), F32)
    m[0] = 0
    words = np.zeros((T, wps), np.uint32)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)

    def ballot(bits):  # [S] bools -> [S / 32] words, one a warp
        return (bits.reshape(-1, 32).astype(np.uint64) * weights).sum(
            1).astype(np.uint32)

    order = _Order(T, _chunk_shift(S, R))
    mn = F32(0)
    peak = F32(0)

    def step2(t, use_mn, record):
        nonlocal m, mn
        order.read(t)
        order.read(t + 1)
        order.read(t + 2)
        x, y = m[q0], m[q0 + half]
        if use_mn:
            x, y = x - mn, y - mn
        c0, c1 = x + bm(4, t), y + bm(5, t)
        take = c1 < c0
        m = np.where(take, c1, c0).astype(F32)
        words[t] = ballot(take)
        order.stage(t)
        if record:
            mn = m.min()
        order.events(t)
        order.barrier()

    order.read(0)
    order.read(1)
    t = 0
    while t < T:
        if rec(t) or (t > 0 and rec(t - 1)):
            step2(t, t > 0 and rec(t - 1), rec(t))
            t += 1
            continue
        e_end = min(T, t | (RENORM - 1))
        while t + 1 < e_end:
            for k in range(4):
                order.read(t + k)
            m0, m1 = m[a], m[a + quarter]
            m2, m3 = m[a + half], m[a + half + quarter]
            c00, c01 = m0 + bm(0, t), m2 + bm(1, t)
            tq0 = c01 < c00
            mq0 = np.where(tq0, c01, c00)
            c10, c11 = m1 + bm(2, t), m3 + bm(3, t)
            tq1 = c11 < c10
            mq1 = np.where(tq1, c11, c10)
            c0, c1 = mq0 + bm(4, t + 1), mq1 + bm(5, t + 1)
            tn = c1 < c0
            m = np.where(tn, c1, c0).astype(F32)
            # the intermediate words: lane l takes bit (l >> 4) of lane
            # (2 l) & 31's pair (tq0 | tq1 << 1)
            lane = np.arange(32)
            src = (np.arange(S) & ~31) + ((2 * lane) & 31)[None, :].repeat(
                S // 32, 0).reshape(-1)
            both = tq0.astype(np.uint32) | (tq1.astype(np.uint32) << 1)
            bit = (both[src] >> (np.tile(lane, S // 32) >> 4)) & 1
            x = ballot(bit.astype(bool))
            u16 = words[t].view(np.uint16)
            u16[:wps] = (x & 0xFFFF).astype(np.uint16)        # index w
            u16[wps:] = (x >> 16).astype(np.uint16)           # S/32 + w
            words[t + 1] = ballot(tn)
            order.stage(t)
            order.stage(t + 1)
            if t >= ref_steps:
                peak = max(peak, F32(np.maximum(mq0, mq1).max()), m.max())
            order.events(t)
            order.barrier()
            t += 2
        if t < e_end:
            step2(t, False, False)
            t += 1
    while order.flush_at - 32 < T:
        order.flush((order.flush_at >> 5) - 1)
        order.flush_at += 32
    if fast:  # every add exact between two renormalisations
        assert peak < (RENORM + ref_steps) * R * 255 < 2 ** 24
    return words


def _expected(rate, order):
    polys = {(2, 7): F.CONV_R12_7, (2, 8): F.CONV_R12_8,
             (2, 9): F.CONV_R12_9}.get((rate, order))
    if polys is None:
        rng = np.random.default_rng(100 * rate + order)
        polys = tuple(int(rng.integers(0, 1 << order)) | (1 << (order - 1))
                      | 1 for _ in range(rate))
    code = F.ConvCode(rate, order, polys, device="cpu")
    return code, code._expected.numpy()


def _stream(code, T, seed, kind="coded"):
    """[T, R] uint8: noisy code bits (0 / 255 plus N(0, 60), rounded and
    clipped) of a seeded message, or all 128 (every comparison a tie)."""
    if kind == "ties":
        return np.full((T, code.rate), 128, np.uint8)
    rng = np.random.default_rng(seed)
    k = code.order
    bits = rng.integers(0, 2, T + k - 1).astype(np.int64)
    reg = sum(bits[k - 1 - j:k - 1 - j + T] << j for j in range(k))
    soft = 255.0 * code.reg_outputs[reg] + rng.normal(0, 60, (T, code.rate))
    return np.clip(np.round(soft), 0, 255).astype(np.uint8)


CASES = {
    # name: (rate, order, T, kind)
    "s64-r6-odd": (6, 7, 301, "coded"),
    "s128-r2-odd": (2, 8, 97, "coded"),
    "s256-r2-even": (2, 9, 130, "coded"),
    "s1024-r2-odd": (2, 11, 77, "coded"),
    "s128-r2-renorm-odd": (2, 8, RENORM + 3, "coded"),
    "s256-r2-renorm-even": (2, 9, RENORM + 6, "coded"),
    "s256-r3-renorm-odd": (3, 9, RENORM + 101, "coded"),
    "s1024-r2-renorm-even": (2, 11, RENORM + 10, "coded"),
    "s256-ties": (2, 9, 201, "ties"),
    "s512-r2-two-renorms": (2, 10, 2 * RENORM + 41, "coded"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_radix4_model_equals_plain(case):
    rate, order, T, kind = CASES[case]
    code, expected = _expected(rate, order)
    soft = _stream(code, T, seed=order * 31 + rate, kind=kind)
    got = r4_model(soft, expected)
    S = expected.shape[0] // 2
    want = FK.viterbi_acs_batched_plain(
        torch.from_numpy(soft), torch.zeros(1, dtype=torch.int32), T,
        torch.from_numpy(expected)).numpy()
    assert np.array_equal(got.view(np.int64).reshape(want.shape), want)
    if S <= 64:
        assert want.shape == (1, T)


def test_radix4_model_reference_form_when_outputs_are_not_integral():
    """Expected outputs off the integers: every step the radix-2 reference
    step (the minimum subtracted each step), still equal to the plain
    version."""
    code, expected = _expected(2, 8)
    expected = (expected * F32(0.999) + F32(0.25)).astype(F32)
    soft = _stream(code, 90, seed=5)
    got = r4_model(soft, expected)
    want = FK.viterbi_acs_batched_plain(
        torch.from_numpy(soft), torch.zeros(1, dtype=torch.int32), 90,
        torch.from_numpy(expected)).numpy()
    assert np.array_equal(got.view(np.int64).reshape(want.shape), want)


def test_intermediate_words_are_the_states_in_order():
    """The shuffle-and-ballot packing of the intermediate decisions puts
    state q's decision at bit q & 31 of word q >> 5, for every S."""
    rng = np.random.default_rng(3)
    for S in (64, 128, 256, 512, 1024):
        dec = rng.integers(0, 2, S).astype(bool)   # intermediate state q
        n = np.arange(S)
        tq0, tq1 = dec[n >> 1], dec[(n >> 1) + S // 2]
        lane = np.tile(np.arange(32), S // 32)
        src = (n & ~31) + ((2 * lane) & 31)
        both = tq0.astype(np.uint32) | (tq1.astype(np.uint32) << 1)
        bit = ((both[src] >> (lane >> 4)) & 1).astype(np.uint64)
        x = (bit.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(
            1).astype(np.uint32)
        u16 = np.zeros(S // 16, np.uint16)
        u16[:S // 32] = x & 0xFFFF
        u16[S // 32:] = x >> 16
        got = np.unpackbits(u16.view(np.uint8), bitorder="little")
        assert np.array_equal(got.astype(bool), dec)
