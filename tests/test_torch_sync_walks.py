"""The redesigned walk kernels of csrc/sync_walk.cu, modelled in numpy and
held to their plain versions (ops/sync_walks.py) on the CPU.

The kernels run only on the card (chip_smoke.py holds them to the plain
versions there); these tests check the designs' arithmetic here:

- ``cyclic_model``: CyclicSync's split design step by step as the kernel
  does it: the average's pass records each sample's average before its
  update, the walker walks the peak / since machine over rc > avg a
  32-sample word at a time (words that cannot hold an emit, one or four
  at once, by a prefix maximum; the plain step otherwise), recording each
  sample's reset as a bit, and the buffer pass recovers every sample's
  write index from the reset bits and keeps the last write of each
  index. It must equal ``cyclic_sync_walk_plain``
  exactly (emits, count, carry, since, buffer) on the cases chip_smoke.py
  runs the kernel on, cut in length.
- ``wrap_model``: ChromaPLL's phase wrap with fmodf replaced by one
  compare-and-subtract (or add) of 2 pi inside (-2 pi, 4 pi): equal bit
  for bit to the plain version's ``_py_mod(x + pi, 2 pi) - pi`` on every
  float32 of the ATV decoder's reachable range and on draws from the whole
  short-form domain.
- ``line_model``: LineSync's split design: a one-warp walker over the 88
  sync samples (three a lane, its windows from a staged ring above the
  release or from ``buf``), the tree's first two levels in the lane and
  xor shuffles after, the update in every lane; each line's (pos, freq)
  recorded and the lines drawn from the records afterwards. It must equal
  ``line_sync_walk_plain`` bit for bit (lines, count, carry, locked) on
  chip_smoke.py's line cases at a CPU size, a carried head of
  ceil(720 max_freq) + 7 samples that a line before the block start
  reads among them.
- ``chroma_model``: the burst walk with atan2 and sin / cos off the chain
  (each burst sample's angle taken before the walk, the error from
  angle - phase, the outputs mixed afterwards from the recorded phases):
  within chip_smoke's WALK_TOL (3.6e-6 rad, phases) and WALK_OUT_TOL
  (1e-5, the unit-amplitude outputs) of ``chroma_burst_walk_plain``, at
  the locking bandwidth and on the wrap-heavy case.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sdrpp_tpu_torch.ops import sync_walks as W

F32 = np.float32
TILE = 1024            # csrc/sync_walk.cu kCycTile
WALK_TOL = 3.6e-6      # chip_smoke.py: chroma_burst_walk phases (rad)
WALK_OUT_TOL = 1e-5    # and its unit-amplitude outputs
PI = W.FL_PI
TWO_PI = F32(2) * PI


# ------------------------------------------------------------ CyclicSync

def cyclic_model(rcorr, vals, carry, since, symbuf, max_syms, agc):
    """numpy model of ``cyclic_sync_kernel``: returns what the kernel
    writes (emits, count, carry, since, symbol buffer)."""
    r = np.asarray(rcorr, F32)
    v = np.asarray(vals, np.complex64)
    n, sym = r.shape[0], len(symbuf)
    agc = F32(agc)
    agc_inv = F32(1) - agc
    avg, peak = F32(carry[0]), F32(carry[1])
    # the average's pass: one bit a sample, rc > avg before its update
    bits = np.zeros(n, bool)
    for i in range(n):
        bits[i] = r[i] > avg
        avg = agc * r[i] + agc_inv * avg
    # the walker: 32-sample words in tiles of TILE, the deadline d = the
    # sample at which the count reaches sym; a reset bit where the count
    # restarts
    d = sym - 1 - int(since)
    pend, emits = False, []
    reset = np.zeros(n, bool)

    def peak_words(c0, g_words):
        nonlocal peak, d, pend
        for g in range(g_words):
            seg = slice(c0 + 32 * g, c0 + 32 * g + 32)
            m = np.where(bits[seg], r[seg], F32(-np.inf)).astype(F32)
            before = np.concatenate([[F32(-np.inf)],
                                     np.maximum.accumulate(m)[:-1]])
            isp = m > np.fmax(peak, before)
            nxt = np.fmax(peak, m.max())
            if nxt == 0:   # the select keeps the first zero
                nxt = peak if peak == 0 else m[np.argmax(m == 0)]
            peak = nxt
            if isp.any():
                d = c0 + 32 * g + int(np.nonzero(isp)[0][-1]) + sym - 1
            reset[seg] |= isp
            reset[c0 + 32 * g] |= pend
            pend = False

    for base in range(0, n, TILE):
        end_ = min(base + TILE, n)
        c0 = base
        while c0 < end_:
            full = (end_ - c0) // 32
            if full >= 4 and sym > 128 and d >= c0 + 128 and peak == peak:
                peak_words(c0, 4)
                c0 += 128
            elif full >= 1 and sym > 32 and d >= c0 + 32 and peak == peak:
                peak_words(c0, 1)
                c0 += 32
            else:
                for i in range(c0, min(c0 + 32, end_)):
                    due = i >= d
                    p = bool(bits[i] and r[i] > peak)
                    e = (sym == 1) if p else due
                    reset[i] = p or pend
                    pend = e
                    peak = F32(0) if e else (r[i] if p else peak)
                    d = i + sym if e else (i + sym - 1 if p else d)
                    if e:
                        emits.append(i)
                c0 += 32
    # the buffer pass: each sample's write index from the reset bits; the
    # last write of an index wins (__match_any_sync within a word)
    buf = np.asarray(symbuf, np.complex64).copy()
    c = int(since) - 1
    for c0 in range(0, n, 32):
        idx = []
        for lane in range(min(32, n - c0)):
            ks = [k for k in range(lane + 1) if reset[c0 + k]]
            s = lane - ks[-1] if ks else c + 1 + lane
            idx.append(s)
        at = [min(max(s, 0), sym - 1) for s in idx]
        word = reset[c0:c0 + 32]
        if not word[1:].any() and (word[0] or c + 1 >= 0):
            # the kernel's short form: one segment counting from >= 0
            assert len(set(at)) == len(at)
        for lane, a in enumerate(at):
            if a not in at[lane + 1:]:
                buf[a] = v[c0 + lane]
        c = idx[-1]
    cnt = min(len(emits), max_syms)
    pos = np.full(max_syms, -1, np.int32)
    pos[:cnt] = emits[:cnt]
    return pos, cnt, (avg, peak, r[-1]), n + sym - 1 - d, buf


def _cyclic_cases():
    """chip_smoke.cyclic_walk_cases' kinds at CPU sizes: a DAB-like
    correlation (a bump at each symbol's prefix over noise), constant
    (ties), strictly rising (a peak every sample), sym = 1, a ragged block
    with a negative carried since, a carried since >= sym, more emits than
    max_syms, a symbol over the kernel's shared-memory buffer, signed
    zeros above a negative average (the peak a zero of either sign) and a
    carried NaN peak."""
    rng = np.random.default_rng(16)

    def noise(n):
        return (rng.standard_normal(n)
                + 1j * rng.standard_normal(n)).astype(np.complex64)

    def dab(n, period=320, sym=256):
        k = np.arange(n)
        return (np.abs(rng.standard_normal(n)) * 0.3
                + np.exp(-0.5 * ((k % period - 40) / 6.0) ** 2)).astype(F32)

    sym = 256
    return {
        "dab": (dab(6144), noise(6144), (0.0, 0.0), 0, sym, 6144 // sym + 2),
        "ties": (np.full(3000, 0.25, F32), noise(3000), (0.25, 0.25), 0,
                 sym, 3000 // sym + 2),
        "rising": (F32(1) + np.arange(4096, dtype=F32) * F32(1e-3),
                   noise(4096), (0.0, 0.0), 5, sym, 4),
        "sym1": (rng.random(700, F32), noise(700), (0.5, 0.0), 0, 1, 702),
        "ragged": (dab(6144 - 333), noise(6144 - 333), (0.0, 0.0), -300,
                   sym, 6144 // sym + 2),
        "since": (dab(4096), noise(4096), (0.0, 0.1), sym + 7, sym,
                  4096 // sym + 2),
        "max_syms": (rng.random(3000, F32), noise(3000), (0.5, 0.0), 0, 64,
                     10),
        "big_sym": (dab(12288, period=9000, sym=8000), noise(12288),
                    (0.0, 0.0), 0, 8000, 4),
        "zeros": (np.where(rng.random(4096) < 0.5, F32(0), F32(-0.0))
                  * (np.arange(4096) % 300 > 5) - F32(0.5)
                  * (np.arange(4096) % 300 <= 5), noise(4096), (-1.0, -0.0),
                  0, sym, 4096 // sym + 2),
        "nan_peak": (dab(3000), noise(3000), (0.0, np.nan), 3, sym,
                     3000 // sym + 2),
    }


@pytest.mark.parametrize("case", sorted(_cyclic_cases()))
def test_cyclic_split_design_equals_plain(case):
    rc, v, (avg, peak), since, sym, max_syms = _cyclic_cases()[case]
    buf = np.random.default_rng(17).standard_normal(sym).astype(
        np.complex64)
    agc = F32(1e-3)
    got = cyclic_model(rc, v, (avg, peak), since, buf, max_syms, agc)
    ref = W.cyclic_sync_walk_plain(
        torch.from_numpy(rc), torch.from_numpy(v),
        torch.tensor([avg, peak, 0.5], dtype=torch.float32),
        torch.tensor([since], dtype=torch.int32), torch.from_numpy(buf),
        max_syms, agc)
    pos, cnt, carry, s, b = got
    np.testing.assert_array_equal(pos, ref[0].numpy())
    assert cnt == int(ref[1])
    assert np.array_equal(np.array(carry, F32).view(np.uint32),
                          ref[2].numpy().view(np.uint32)), (carry, ref[2])
    assert s == int(ref[3])
    assert np.array_equal(b.view(np.uint64), ref[4].numpy().view(np.uint64))


# ------------------------------------------------------------- ChromaPLL

def wrap_model(t):
    """The kernel's ``wrap_phase`` before its last normalize, on t =
    fl(ph + pi) (float32 array): one compare-and-subtract (or add) of 2 pi
    inside (-2 pi, 4 pi), the plain version's py_mod outside."""
    t = np.asarray(t, F32)
    inside = (t > -TWO_PI) & (t < F32(2) * TWO_PI)
    fast = np.where(t >= TWO_PI, t - TWO_PI, np.where(t < 0, t + TWO_PI, t))
    return np.where(inside, fast, _py_mod_array(t)).astype(F32)


def _py_mod_array(t):
    """``sync_walks._py_mod(t, 2 pi)`` over an array."""
    r = np.fmod(t, TWO_PI).astype(F32)
    return np.where((r != 0) & (r < 0), r + TWO_PI, r).astype(F32)


def _same_bits(a, b):
    return np.array_equal(np.asarray(a, F32).view(np.uint32),
                          np.asarray(b, F32).view(np.uint32))


def test_py_mod_array_is_the_plain_versions():
    rng = np.random.default_rng(18)
    t = np.concatenate([rng.uniform(-40, 40, 2000).astype(F32),
                        np.array([0.0, -0.0, TWO_PI, -TWO_PI], F32)])
    assert _same_bits(_py_mod_array(t),
                      [W._py_mod(x, TWO_PI) for x in t])


def _floats_between(lo, hi):
    """Every float32 in [lo, hi] (0 < lo < hi), in ascending order."""
    a, b = np.array([lo, hi], F32).view(np.int32)
    return np.arange(a, b + 1, dtype=np.int32).view(F32)


def test_wrap_equals_py_mod_on_every_float_the_decoder_reaches():
    """Every float32 t = fl(ph + pi) a burst step of the ATV decoder's
    ChromaPLL (bandwidth 0.01, frequency within 10 % of the subcarrier)
    can produce after its line's first step: ph in (-pi, pi], fr in
    [min_freq, max_freq], |alpha * err| <= alpha * pi; widened by 1e-3 on
    either side for the roundings. ~17M values."""
    from sdrpp_tpu_torch.decoders import atv
    from sdrpp_tpu_torch.ops.scans import _critically_damped

    w0 = 2 * np.pi * atv.CHROMA_SUBCARRIER / atv.SAMPLE_RATE
    alpha, _ = _critically_damped(0.01)
    lo = F32(w0 * 0.9) - alpha * PI - 1e-3
    hi = F32(2) * PI + F32(w0 * 1.1) + alpha * PI + 1e-3
    t = _floats_between(lo, hi)
    assert t.size > 15_000_000
    for part in np.array_split(t, 8):
        assert _same_bits(wrap_model(part), _py_mod_array(part))


def test_wrap_equals_py_mod_at_the_short_forms_edges():
    edges = []
    for x in (0.0, TWO_PI, -TWO_PI, F32(2) * TWO_PI, PI, -PI):
        x = F32(x)
        edges += [x, np.nextafter(x, F32(np.inf)),
                  np.nextafter(x, F32(-np.inf))]
    t = np.array(edges + [-0.0, 1e-38, -1e-38, 1e-45, -1e-45], F32)
    assert _same_bits(wrap_model(t), _py_mod_array(t))


@settings(max_examples=2000, deadline=None, database=None)
@given(st.floats(min_value=-2 * float(TWO_PI), max_value=2 * float(TWO_PI),
                 width=32, allow_nan=False))
def test_wrap_equals_py_mod_on_the_short_forms_domain(x):
    t = np.array([x], F32)
    assert _same_bits(wrap_model(t), _py_mod_array(t))


def chroma_model(burst, refs, carry, pre_len, post_len, alpha, beta,
                 min_freq, max_freq):
    """numpy model of design (b) of ``chroma_burst_kernel``: each burst
    sample's angle taken before the walk; a line's first step (its phase
    not yet reduced) mixes and takes atan2 as the plain version does, the
    others take the error from normalize(angle - ph); the outputs are
    mixed afterwards from the phases each step used."""
    v = np.asarray(burst, np.complex64)
    angles = np.arctan2(v.imag, v.real).astype(F32)
    L, nb = v.shape
    a, bt, lo, hi = (F32(x) for x in (alpha, beta, min_freq, max_freq))
    pre_k, post_k = F32(pre_len - 1), F32(post_len - 1)
    phase, freq = (F32(x) for x in carry)
    norm = W._normalize_phase

    def wrap(x):
        return norm(W._py_mod(x + PI, TWO_PI) - PI)

    line_phase = np.zeros((L, 4), F32)
    out = np.zeros((L, nb), np.complex64)
    for l in range(L):
        line_phase[l, 0], line_phase[l, 1] = phase, freq
        ph = (phase + pre_k * freq) + freq if pre_len > 0 else phase
        fr, ref = freq, F32(refs[l])
        used = np.zeros(nb, F32)
        for j in range(nb):
            used[j] = ph
            if j == 0:
                xr, xi = F32(v[l, 0].real), F32(v[l, 0].imag)
                c, s = np.cos(-ph), np.sin(-ph)
                g = np.arctan2(xr * s + xi * c, xr * c - xi * s)
            else:
                g = norm(angles[l, j] - ph)
            err = norm(g - ref)
            fr = min(max(fr + bt * err, lo), hi)
            ph = wrap((ph + fr) + a * err)
        c, s = np.cos(-used), np.sin(-used)
        xr, xi = v[l].real, v[l].imag
        out[l] = (xr * c - xi * s) + 1j * (xr * s + xi * c)
        line_phase[l, 2], line_phase[l, 3] = ph, fr
        p3 = (ph + post_k * fr) + fr if post_len > 0 else ph
        phase, freq = wrap(p3), fr
    return line_phase, out, np.array([phase, freq], F32)


def _chroma_case(kind, lines=64):
    """chip_smoke.chroma_walk_case's two cases on ``lines`` lines."""
    from sdrpp_tpu_torch.decoders import atv

    nb = atv.BURST_END - atv.BURST_START
    t = np.arange(lines)[:, None] * 720 + atv.BURST_START + np.arange(nb)
    if kind == "locked":
        w0 = 2 * np.pi * atv.CHROMA_SUBCARRIER / atv.SAMPLE_RATE
        x = np.exp(1j * (w0 * t + 0.3))
        lo, hi, ref = w0 * 0.9, w0 * 1.1, 0.0
    else:
        w0 = 1.8 * np.pi
        rng = np.random.default_rng(15)
        x = np.exp(1j * (w0 * t + np.pi)) + 0.01 * (
            rng.standard_normal(t.shape) + 1j * rng.standard_normal(t.shape))
        lo, hi, ref = 1.7 * np.pi, 1.9 * np.pi, np.pi
    pll = atv.ChromaPLL(0.003, 720, atv.BURST_START, atv.BURST_END,
                        init_freq=w0, min_freq=lo, max_freq=hi, device="cpu")
    return (x.astype(np.complex64), np.full(lines, ref, F32),
            np.array([0.0, w0], F32), atv.BURST_START,
            720 - atv.BURST_END, pll.alpha, pll.beta, pll.min_freq,
            pll.max_freq)


@pytest.mark.parametrize("kind", ["locked", "wrap"])
def test_chroma_off_chain_form_within_walk_tol(kind):
    burst, refs, carry, *rest = _chroma_case(kind)
    got = chroma_model(burst, refs, carry, *rest)
    ref = W.chroma_burst_walk_plain(torch.from_numpy(burst),
                                    torch.from_numpy(refs),
                                    torch.from_numpy(carry), *rest)
    assert np.abs(got[0] - ref[0].numpy()).max() <= WALK_TOL
    assert np.abs(got[2] - ref[2].numpy()).max() <= WALK_TOL
    assert np.abs(got[1] - ref[1].numpy()).max() <= WALK_OUT_TOL


# -------------------------------------------------------------- LineSync

LINE_RING = 16384      # csrc/sync_walk.cu kLineRing
TAPS = 8


def _locate(p, nh, bc):
    """A sample position's bank row and window start in buf = [head | x]
    (nh = n + head - 7; bc = base + head - 7, the line's window base), as
    the kernel and the plain version take them."""
    fp = np.floor(p)
    ph = min(max(int(F32(p - fp) * F32(128)), 0), 127)
    return ph, min(max(int(fp) + bc, 0), nh - 1)


def _taps(w, b):
    acc = w[0] * b[0]
    for j in range(1, TAPS):
        acc = acc + w[j] * b[j]
    return acc


def line_model(buf, bank, carry, base, locked, max_lines, omega_gain,
               mu_gain, min_freq, max_freq, sync_level, sync_bias, head):
    """numpy model of the split ``line_sync_kernel``: the walker (one warp)
    interpolates only the 88 sync samples, lanes 0-15 the left half and
    16-31 the right, three a lane (v[L], v[L + 16], v[L + 32]), reading
    the line's 8-tap windows from the staged ring when all of them (k = 0
    ... 719) lie at or above the release and below what the stager has
    staged (a greedy stager: up to the last published release plus the
    ring), else from ``buf``; sums
    each half by the tree's first two levels in the lane and xor
    shuffles 8, 4, 2, 1 and 16 (every lane's copy checked equal); updates
    the frequency with its compensated remainder and rebases the
    position (an integer base and a fraction) after every line; records
    each line's (pos, freq) and window base; the lines are drawn
    afterwards from the records. Returns the kernel's outputs and the
    count of ring reads and of reads from device memory."""
    buf = np.asarray(buf, F32)
    bank = np.asarray(bank, F32)
    n, total, hoff = buf.shape[0] - head, buf.shape[0], head - 7
    nh = n + hoff
    og, mg, lo, hi, level, bias = (F32(x) for x in (
        omega_gain, mu_gain, min_freq, max_freq, sync_level, sync_bias))
    pos, freq, flo = (F32(x) for x in carry)
    pos, at = W.rebase(pos, int(base))
    lk = bool(locked)
    ring = np.full(LINE_RING + TAPS, np.nan, F32)
    staged, published, release = 0, 0, 0
    kf = np.zeros((32, 3), F32)
    for lane in range(32):
        half, L = lane >> 4, lane & 15
        for r in range(3):
            i = L + 16 * r if (r < 2 or L + 32 < 44) else L
            kf[lane, r] = 27 + i if half else (703 + i if i < 17 else i - 17)
    records, reads = [], {"ring": 0, "device": 0}
    l = 0
    fits = abs(freq) <= W.FREQ_LIMIT
    while fits and l < max_lines:
        # the kernel's exact test: the integer n - at clipped to +-2^22
        if not pos + F32(720) * freq < F32(min(max(n - at, -2 ** 22),
                                               2 ** 22)):
            break
        bc = min(max(at + hoff, -2 ** 23), nh + 2 ** 23)
        # the stager, as far as the published release allows
        staged = max(staged, published)
        end = min(total, published + LINE_RING)
        for i in range(staged, end):
            ring[i & (LINE_RING - 1)] = buf[i]
            if (i & (LINE_RING - 1)) < TAPS:
                ring[LINE_RING + (i & (LINE_RING - 1))] = buf[i]
        staged = max(staged, end)
        w0 = _locate(pos, nh, bc)[1]
        w1 = _locate(pos + F32(719) * freq, nh, bc)[1]
        release = max(release, min(w0, w1))
        # the whole line from the ring, or from buf
        ring_line = min(w0, w1) >= release and max(w0, w1) + TAPS <= staged
        v = np.zeros((32, 3), F32)
        for lane in range(32):
            for r in range(3):
                ph, b = _locate(pos + kf[lane, r] * freq, nh, bc)
                if ring_line:
                    assert b >= release and b + TAPS <= staged
                    w = ring[(b & (LINE_RING - 1)):][:TAPS]
                    assert np.array_equal(w.view(np.uint32),
                                          buf[b:b + TAPS].view(np.uint32))
                    reads["ring"] += 1
                else:
                    w = buf[b:b + TAPS]
                    reads["device"] += 1
                v[lane, r] = _taps(w, bank[ph])
        records.append((pos, freq, bc))
        published = release
        third = (np.arange(32) & 15) + 32 < 44
        t = (v[:, 0] + np.where(third, v[:, 2], F32(0))) + (v[:, 1] + F32(0))
        for off in (8, 4, 2, 1):
            t = t + t[np.arange(32) ^ off]
        o = t[np.arange(32) ^ 16]
        sl = np.where(np.arange(32) < 16, t, o)
        sr = np.where(np.arange(32) < 16, o, t)
        assert len(set(sl.view(np.uint32))) == 1 == len(set(sr.view(
            np.uint32)))
        left, right = sl[0] / F32(44), sr[0] / F32(44)
        ok = bool(left < level and right < level)
        err = (left + bias) - right if ok else F32(0)
        y = og * err + flo
        fy = freq + y
        nf = min(max(fy, lo), hi)
        flo = y - (fy - freq) if nf == fy else F32(0)
        pos, at = W.rebase(((pos + F32(719) * freq) + nf) + mg * err, at)
        freq, lk = F32(nf), ok
        l += 1
    lines = np.zeros((max_lines, 720), F32)
    ks = np.arange(720, dtype=F32)
    for d, (p0, f0, bc) in enumerate(records):
        for k in range(720):
            ph, b = _locate(p0 + ks[k] * f0, nh, bc)
            lines[d, k] = _taps(buf[b:b + TAPS], bank[ph])
    return (lines, l, np.array([pos, freq, flo], F32), at, lk), reads


def _line_cases():
    """chip_smoke.line_walk_cases' kinds at CPU sizes (30 lines, the ring
    wrapped once): a PAL-like sync pattern with noise, a carried pos near
    -717 (behind a 7-sample head: its windows clipped to sample 0; behind
    LineSync's head of ceil(720 max_freq) + 7: read from the head), freq
    pinned at either limit, unlocked lines, max_lines reached,
    no line, jumps past the staging guard over noise, positions past 2^22
    each way (rebased on entry: the kernel's floorf path below -2^22), a
    nonzero base (the walk starts mid-block) and a carried frequency
    remainder. Carried positions are given whole as carry[0] with base 0
    (the entry's rebase splits them) but in "mid_base"."""
    from sdrpp_tpu_torch.decoders import atv

    ls = atv.LineSync(1.0, omega_gain=1e-6, mu_gain=1.0,
                      omega_rel_limit=0.05, device="cpu")
    rng = np.random.default_rng(19)
    k = np.arange(30 * 720) % 720
    video = np.where((k < 71) | (k >= 703), -0.3,
                     0.1 + 0.3 * (k - 71) / 632.0)
    y = (video + 0.01 * rng.standard_normal(k.shape)).astype(F32)
    buf = np.concatenate([np.zeros(7, F32), y])
    # the same block behind the line carried from a block before it
    headed = np.concatenate([y[-ls.head_len:], y])
    noise = rng.standard_normal(buf.shape).astype(F32)
    big = rng.standard_normal(2 ** 22 + 30 * 720).astype(F32)
    n = buf.shape[0] - 7
    base = dict(buf=buf, carry=(0.0, 1.0, 0.0), base=0, locked=False,
                max_lines=ls.max_lines(n), omega_gain=ls.omega_gain,
                mu_gain=ls.mu_gain, sync_level=ls.sync_level,
                sync_bias=ls.sync_bias, head=7)
    cases = {
        "atv": {},
        "neg_pos": dict(carry=(-717.25, 1.0, 0.0)),
        "carried_head": dict(buf=headed, head=ls.head_len,
                             carry=(-717.25, 1.0, 0.0)),
        "freq_hi": dict(omega_gain=0.05, sync_level=1e9, sync_bias=1.0),
        "freq_lo": dict(omega_gain=0.05, sync_level=1e9, sync_bias=-1.0),
        "unlocked": dict(locked=True, sync_level=-1e9),
        "max_lines": dict(max_lines=7),
        "no_line": dict(carry=(n - 700.0, 1.0, 0.0)),
        "jump": dict(buf=noise, mu_gain=4000.0, sync_level=1e9),
        "far_jump": dict(buf=noise, mu_gain=40000.0, sync_level=1e9),
        "big_pos": dict(buf=big, carry=(2.0 ** 22 - 100.25, 1.0, 0.0),
                        max_lines=40, sync_level=1e9),
        "big_neg": dict(carry=(-5e6, 1.0, 0.0), max_lines=7),
        "mid_base": dict(carry=(0.375, 1.0, 0.0), base=9000),
        "freq_rem": dict(carry=(0.0, 1.0, 5e-8)),
    }
    out = {}
    for name, kw in cases.items():
        c = {**base, **kw}
        out[name] = (c["buf"], ls.bank.numpy(), c["carry"], c["base"],
                     c["locked"], c["max_lines"], c["omega_gain"], c["mu_gain"],
                     ls.min_freq, ls.max_freq, c["sync_level"],
                     c["sync_bias"], c["head"])
    return out


@pytest.mark.parametrize("case", sorted(_line_cases()))
def test_line_split_design_equals_plain(case):
    buf, bank, carry, base, locked, *rest = _line_cases()[case]
    (lines, count, carry_out, at, lk), reads = line_model(
        buf, bank, carry, base, locked, *rest)
    ref = W.line_sync_walk_plain(
        torch.from_numpy(buf), torch.from_numpy(bank),
        torch.tensor(carry, dtype=torch.float32), torch.tensor([base]),
        torch.tensor([locked]), *rest)
    assert np.array_equal(lines.view(np.uint32), ref[0].numpy().view(
        np.uint32))
    assert count == int(ref[1])
    assert np.array_equal(carry_out.view(np.uint32),
                          ref[2].numpy().view(np.uint32))
    assert at == int(ref[3]) and lk == bool(ref[4])
    assert 0 <= carry_out[0] <= 1
    if case == "max_lines":
        assert count == rest[0]
    if case in ("freq_hi", "freq_lo"):   # freq pinned at the limit
        assert carry_out[1] == (rest[4] if case == "freq_hi" else rest[3])
    if case == "unlocked":
        assert not lk and carry_out[1] == F32(carry[1])
    if case == "no_line":
        assert count == 0 and not lines.any()
    if case == "big_pos":  # the buffer's end, past 2^22, ends the walk
        assert 0 < count < rest[0] and at + carry_out[0] > 2 ** 22
    if case == "mid_base":  # from the block's middle to its end
        assert count == (len(buf) - 7 - 9000) // 720
        assert at + carry_out[0] > len(buf) - 7 - 760
    if case == "freq_rem":  # the remainder reaches freq
        assert carry_out[1] != F32(1) or carry_out[2] != F32(5e-8)
    if case in ("atv", "jump", "far_jump", "carried_head"):
        assert reads["ring"] > 0
    if case == "carried_head":  # the carried line's windows lie in the head
        assert count > 0 and carry[0] + 7 < 0 and rest[-1] > 7
    if case in ("jump", "far_jump"):  # some windows fell outside the ring
        assert reads["device"] > 0
