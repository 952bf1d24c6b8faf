"""Port parity for the chunk-parallel M&M (``ops.clock_recovery_chunked``)
and the FD synchronizer (``ops.clock_recovery.FDClockRecovery``).

The JAX side runs as its own tests run it on the CPU: ``mm_symbols_chunked``
called directly (it is XLA, no Pallas) and the chunked block with
``interpret=True``; the port's wrappers, given CPU tensors, run their
plain versions (``mm_symbols_chunked_plain``, ``fd_symbols_plain``),
operation for operation the CUDA kernels. Tolerances, with their reasons:

- the chunked M&M against ``mm_symbols_chunked`` at K = 16 and 128, float
  and complex, and the block against the interpret-mode block over two
  carried blocks: equal counts and equal ``valid`` masks; symbols,
  positions and carry within 2e-5 (MM_TOL), the chunked-loop tests'
  bound. XLA's CPU backend contracts the position and period closed forms
  into fused multiply-adds; the port rounds those four once as well
  (``clock_recovery_chunked.fma``, ``__fmaf_rn`` in the kernel), so
  positions come out equal and symbols within a few ulp (the 8-tap sums'
  order and FMAs). No knife-edge case occurs on these inputs: the masks
  and positions are equal symbol for symbol;
- JAX's chunked-M&M contract tests (tests/test_clock_recovery_chunked.py,
  the M&M cases of tests/test_chunked_stress.py) run on the port with
  their own bounds, the port's exact ``MMClockRecovery`` the reference;
- SDRPP_TPU_LOOPS=exact: the block is the exact walker bit for bit;
- FDClockRecovery against the JAX block over two carried blocks: equal
  counts, symbols and state within MM_TOL (the JAX scan sums the 8 taps
  by XLA's reduction, the port in order).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.ops import clock_recovery as jcr
from sdrpp_tpu.ops import clock_recovery_chunked as jcc
from sdrpp_tpu_torch.ops import clock_recovery_chunked as CC
from sdrpp_tpu_torch.ops import clock_recovery_kernels as CK
from sdrpp_tpu_torch.ops import scans_kernels as SK
from sdrpp_tpu_torch.ops.clock_recovery import (FDClockRecovery,
                                                MMClockRecovery)
from sdrpp_tpu_torch.ops.clock_recovery_chunked import MMClockRecoveryChunked
from sdrpp_tpu_torch.utils.blocks import state_to_numpy

from test_chunked_stress import _qpsk_shaped, _quant, _windowed_ser
from test_clock_recovery_chunked import _bpsk_real, _qpsk_cplx

torch.set_num_threads(1)

MM_TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _signal(cplx, n, seed=5):
    return _qpsk_cplx(n, seed=seed) if cplx else _bpsk_real(n, seed=seed)


def _kw(sps, cplx, **extra):
    return dict(omega=sps, omega_gain=0.001, mu_gain=0.01,
                omega_rel_limit=0.01, complex_input=cplx, **extra)


# ---------------------------------------------------------------------------
# mm_symbols_chunked against the JAX function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("K,n", [(16, 1 << 14), (128, 1 << 16)])
def test_chunked_matches_jax_mm_symbols_chunked(cplx, K, n):
    sig, sps = _signal(cplx, n)
    j = jcc.MMClockRecoveryChunked(**_kw(sps, cplx), interpret=True)
    t = MMClockRecoveryChunked(**_kw(sps, cplx), device="cpu")
    js, ts = j.init_state(), t.init_state()
    err0 = js["p1"] if cplx else js["last"]
    jy, jv, jp, jc = jax.jit(lambda x, h, o, p, f, e: jcc.mm_symbols_chunked(
        x, h, o, p, f, e, j.bank, j.mu_gain, j.omega_gain, j.min_freq,
        j.max_freq, lanes_k=K, warmup=512))(
            jnp.asarray(sig), js["hist"], js["offset"], js["phase"],
            js["freq"], err0)
    ty, tv, tp, tc = CC.mm_symbols_chunked(
        _t(sig), ts["hist"], ts["offset"], ts["phase"], ts["freq"], None,
        t._bank, t.mu_gain, t.omega_gain, t.min_freq, t.max_freq,
        lanes_k=K, warmup=512)
    jv = np.asarray(jv).astype(bool)
    assert ty.shape == jy.shape and tv.shape == jv.shape
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert int(tv.sum()) > 0.9 * n / sps
    np.testing.assert_allclose(ty.numpy()[jv], np.asarray(jy)[jv], rtol=0,
                               atol=MM_TOL)
    np.testing.assert_allclose(tp.numpy()[jv], np.asarray(jp)[jv], rtol=0,
                               atol=MM_TOL)
    assert set(tc) == set(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=0,
                                   atol=MM_TOL, err_msg=k)


@pytest.mark.parametrize("cplx", [False, True])
def test_chunked_block_matches_jax_interpret_over_two_blocks(cplx):
    """Two carried 16384-sample blocks (K = 32), ``hist`` and ``tail``
    included, against the JAX block in interpret mode."""
    sig, sps = _signal(cplx, 1 << 15, seed=7)
    j = jcc.MMClockRecoveryChunked(**_kw(sps, cplx), interpret=True)
    t = MMClockRecoveryChunked(**_kw(sps, cplx), device="cpu")
    n = len(sig) // 2
    assert t._lanes_for(n) == 32
    js, ts = j.init_state(), t.init_state()
    step = jax.jit(j)
    for i in range(2):
        blk = sig[i * n:(i + 1) * n]
        js, (jy, jv) = step(js, jnp.asarray(blk))
        ts, (ty, tv) = t(ts, _t(blk))
        jv = np.asarray(jv).astype(bool)
        assert ty.shape[0] == t.max_symbols(n) == jy.shape[0]
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_allclose(ty.numpy()[jv], np.asarray(jy)[jv],
                                   rtol=0, atol=MM_TOL)
    jn, tn = jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts)
    assert set(jn) == set(tn)
    for k in jn:
        assert jn[k].dtype == tn[k].dtype and jn[k].shape == tn[k].shape, k
        np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=MM_TOL,
                                   err_msg=k)


def test_lane_sum_is_the_kernels_order():
    """The across-lane sum: each warp's 32 lanes by halves (the kernel's
    xor-shuffle tree), then the warps in turn, zeros past K."""
    e = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 45)).astype(np.float32))
    got = CC._lane_sum(e, 45)
    v = np.zeros((4, 64), np.float32)
    v[:, :45] = e.numpy()
    want = np.zeros(4, np.float32)
    for w in range(2):
        lanes = v[:, 32 * w:32 * w + 32]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ o]
        want = lanes[:, 0] if w == 0 else want + lanes[:, 0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_seed_sum_is_the_kernels_order():
    """The seed's sums over a lane's warm-up: 8 strided partials (partial p
    over columns p, p + 8, ..., one float32 add a column in order from
    0.0), then the xor tree 4, 2, 1 over them; 45 columns leave partials
    of 6 and 5 terms."""
    p = np.random.default_rng(4).standard_normal((3, 45)).astype(np.float32)
    got = CC._seed_sum(_t(p))
    part = np.zeros((3, 8), np.float32)
    for i in range(45):
        part[:, i % 8] = part[:, i % 8] + p[:, i]
    for o in (4, 2, 1):
        part = part + part[:, np.arange(8) ^ o]
    np.testing.assert_array_equal(got.numpy(), part[:, 0])


def _glue_then_plain(x, hist, offset0, phase0, freq0, bank, lanes_k, blk):
    """The chunked M&M's glue written out in torch operations (the
    extended stream by concatenation, the Oerder-Meyr seed with its sums in
    the kernel's order, the emission bounds), then
    ``mm_symbols_chunked_plain``."""
    f32 = torch.float32
    K, W, n, T = lanes_k, blk.warmup, x.shape[0], blk.tap_count
    geom, pad_e, pad = CC.chunk_geometry(n, K, W, T, blk.min_freq,
                                         blk.max_freq)
    L = geom.L
    omega = float((blk.min_freq + blk.max_freq) / 2.0)
    zeros = torch.zeros(geom.cols - (W + L + T - 1), dtype=x.dtype)
    ext = torch.cat([hist, x, x[-1:].expand(pad), zeros])
    lane0 = torch.arange(K) == 0
    base = torch.arange(K).to(f32) * float(np.float32(L))
    p0 = (offset0.to(f32) + phase0) + float(np.float32(W))
    warm = ext.as_strided((K, W), (L, 1))
    pw = (warm.real * warm.real + warm.imag * warm.imag if x.is_complex()
          else warm * warm)
    ang = (float(np.float32(-2.0 * np.pi)) * torch.arange(W, dtype=f32)
           / freq0)
    c_re = CC._seed_sum(pw * torch.cos(ang))
    c_im = CC._seed_sum(pw * torch.sin(ang))
    two_pi = torch.full((), float(np.float32(2.0 * np.pi)))
    t_hat = (-torch.atan2(c_im, c_re) * freq0) / two_pi
    pj = torch.where(lane0, torch.remainder(p0 - base, freq0),
                     torch.remainder(t_hat - float(np.float32((T - 1) / 2.0)),
                                     freq0))
    fl = torch.floor(pj)
    emit_hi = torch.full((K,), W + L, dtype=torch.int32)
    emit_hi[-1] = W + L - pad
    emit_lo = torch.where(lane0, p0 - float(np.float32(0.4 * omega)),
                          torch.full((K,), float(np.float32(W - pad_e))))
    return CC.mm_symbols_chunked_plain(
        ext, fl.to(torch.int32), pj - fl, freq0.expand(K).contiguous(),
        emit_lo, emit_hi, base - float(np.float32(W)), bank, geom,
        *(float(np.float32(v)) for v in (
            blk.mu_gain, blk.omega_gain, blk.min_freq, blk.max_freq,
            omega / 2.0)))


@pytest.mark.parametrize("cplx", [False, True])
def test_block_entry_plain_is_the_glue_then_plain_over_two_blocks(cplx):
    """The fused entry's plain version (``mm_symbols_chunked`` on CPU
    tensors: ``mm_symbols_chunked_block_plain``) equals the glue written
    out in torch operations followed by ``mm_symbols_chunked_plain``, bit
    for bit, at K = 16 and n = 2^14 over two carried blocks."""
    sig, sps = _signal(cplx, 1 << 15, seed=11)
    blk = MMClockRecoveryChunked(**_kw(sps, cplx), device="cpu")
    n, K = 1 << 14, 16
    st = blk.init_state()
    hist, off, ph, fr = st["hist"], st["offset"], st["phase"], st["freq"]
    for i in range(2):
        x = _t(sig[i * n:(i + 1) * n])
        want = _glue_then_plain(x, hist, off, ph, fr, blk._bank, K, blk)
        got = CC.mm_symbols_chunked(x, hist, off, ph, fr, None, blk._bank,
                                    blk.mu_gain, blk.omega_gain,
                                    blk.min_freq, blk.max_freq, lanes_k=K,
                                    warmup=blk.warmup)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w.reshape(-1))
        carry = got[3]
        assert torch.equal(carry["offset"], want[3])
        fst = torch.stack([carry["phase"], carry["freq"]] + (
            [v for k in ("p1", "p2", "c1", "c2")
             for v in (carry[k].real, carry[k].imag)] if cplx
            else [carry["last"]]))
        assert torch.equal(fst, want[4])
        assert int(got[1].sum()) > 0.9 * n / sps
        hist = torch.cat([hist, x])[-hist.shape[0]:]
        off, ph, fr = carry["offset"], carry["phase"], carry["freq"]


def test_fma_rounds_once():
    """``fma`` equals a * b + c rounded once: checked against exact
    rationals, including float32 halfway points that a float64 sum would
    round twice."""
    from fractions import Fraction

    rng = np.random.default_rng(1)
    a = rng.standard_normal(400).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = (rng.standard_normal(400) * 64).astype(np.float32)
    # 4097^2 = 2^24 + 8193, a float32 halfway point; + 2^-40 puts the exact
    # sum past it (round up to 2^24 + 8194), where float64 drops the 2^-40
    # and rounding the halfway point to even gives 2^24 + 8192
    a[0] = b[0] = np.float32(4097.0)
    c[0] = np.float32(2.0 ** -40)
    got = CC.fma(_t(a), _t(b), _t(c)).numpy()
    assert got[0] == np.float32(2 ** 24 + 8194)
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        r = np.float32(got[i])
        nbrs = (np.nextafter(r, np.float32(-np.inf)),
                np.nextafter(r, np.float32(np.inf)))
        err = abs(Fraction(float(r)) - exact)
        assert all(err <= abs(Fraction(float(q)) - exact) for q in nbrs), i


# ---------------------------------------------------------------------------
# JAX's chunked-M&M contract tests, run on the port
# ---------------------------------------------------------------------------

def _run_pair(sig, ref, chk, blocks=2):
    n = sig.shape[0] // blocks
    s1, s2 = ref.init_state(), chk.init_state()
    r_all, c_all = [], []
    for i in range(blocks):
        blk = _t(sig[i * n:(i + 1) * n])
        s1, (y1, v1) = ref(s1, blk)
        s2, (y2, v2) = chk(s2, blk)
        r_all.append(y1[v1].numpy())
        c_all.append(y2[v2].numpy())
    return np.concatenate(r_all), np.concatenate(c_all), s1, s2


def test_contract_float_matches_sequential():
    sig, sps = _bpsk_real(1 << 18)
    kw = _kw(sps, False)
    r, c, _, s2 = _run_pair(sig, MMClockRecovery(**kw, device="cpu"),
                            MMClockRecoveryChunked(**kw, device="cpu"))
    assert abs(len(r) - len(c)) <= 1, (len(r), len(c))
    m = min(len(r), len(c))
    assert np.mean(np.sign(r[200:m]) == np.sign(c[200:m])) == 1.0
    assert np.mean(np.abs(r[200:m] - c[200:m])) < 0.05
    assert s2["hist"].shape == (512 + 7,)


def test_contract_complex_matches_sequential():
    sig, sps = _qpsk_cplx(1 << 18)
    kw = _kw(sps, True)
    r, c, _, _ = _run_pair(sig, MMClockRecovery(**kw, device="cpu"),
                           MMClockRecoveryChunked(**kw, device="cpu"))
    assert abs(len(r) - len(c)) <= 1, (len(r), len(c))
    m = min(len(r), len(c))
    qr = np.floor(np.angle(r[500:m]) / (np.pi / 2)).astype(int) % 4
    qc = np.floor(np.angle(c[500:m]) / (np.pi / 2)).astype(int) % 4
    assert np.mean(qr == qc) == 1.0
    assert np.mean(np.abs(r[500:m] - c[500:m])) < 0.05


def test_contract_falls_back_on_short_blocks():
    sig, sps = _bpsk_real(1024)
    kw = _kw(sps, False)
    ref = MMClockRecovery(**kw, device="cpu")
    chk = MMClockRecoveryChunked(**kw, device="cpu")
    assert chk._lanes_for(1024) == 0
    s1, (y1, v1) = ref(ref.init_state(), _t(sig))
    s2, (y2, v2) = chk(chk.init_state(), _t(sig))
    assert torch.equal(y1[v1], y2[v2])
    np.testing.assert_allclose(s2["hist"].numpy(), sig[-(512 + 7):],
                               atol=1e-6)


def test_contract_positions_strictly_monotone():
    sig, sps = _bpsk_real(1 << 17)
    chk = MMClockRecoveryChunked(**_kw(sps, False), device="cpu")
    st = chk.init_state()
    _, valid, pos, _ = CC.mm_symbols_chunked(
        _t(sig), st["hist"], st["offset"], st["phase"], st["freq"],
        st["last"], chk._bank, chk.mu_gain, chk.omega_gain, chk.min_freq,
        chk.max_freq, lanes_k=128, warmup=512)
    d = np.diff(pos[valid].numpy())[200:]
    assert d.min() > sps / 2, d.min()
    assert d.max() < 1.5 * sps, d.max()


def test_contract_no_seam_loss_with_lane_padding():
    """A realistic RRC-shaped QPSK stream at meteor's omega in 62500-sample
    blocks (pad = 86 at K = 122): per-block counts exact to +-3, the carry
    continuing the grid (the JAX test's signal, made by the JAX
    package's RRC interpolator and FIR)."""
    from sdrpp_tpu.ops import taps as taps_mod
    from sdrpp_tpu.ops.fir import FIR
    from sdrpp_tpu.ops.resample import RRCInterpolator

    rng = np.random.default_rng(5)
    ph = np.pi / 4 + np.pi / 2 * rng.integers(0, 4, 60000)
    sh = RRCInterpolator(72000.0, 150000.0, 0.35, rrc_tap_count=31,
                         dtype=jnp.complex64)
    wave = np.asarray(sh(sh.init_state(), jnp.asarray(
        np.exp(1j * ph).astype(np.complex64)))[1]).astype(np.complex64)
    wave += 0.02 * (rng.standard_normal(len(wave))
                    + 1j * rng.standard_normal(len(wave))).astype(np.complex64)
    mf = FIR(taps_mod.root_raised_cosine_rate(31, 0.35, 72000., 150000.),
             dtype=jnp.complex64)
    y = np.asarray(mf(mf.init_state(), jnp.asarray(wave))[1])
    y = (y / np.abs(y).max()).astype(np.complex64)

    omega = 150000.0 / 72000.0
    chk = MMClockRecoveryChunked(omega, 0.001, 0.01, 0.01,
                                 complex_input=True, device="cpu")
    bs = len(y) // 2
    k = chk._lanes_for(bs)
    assert k * (-(-bs // k)) > bs, "must exercise a padded lane layout"
    st = chk.init_state()
    for i in range(2):
        st, (syms, valid) = chk(st, _t(y[i * bs:(i + 1) * bs]))
        cnt = int(valid.sum())
        assert abs(cnt - bs / omega) <= 3, (i, cnt, bs / omega)
    assert int(st["offset"]) < int(np.ceil(omega)) + 1


@pytest.mark.parametrize("omega,group", [(10.0, 8), (4.0, 16), (2.0, 32)])
def test_contract_max_symbols_matches_output(omega, group):
    chk = MMClockRecoveryChunked(**_kw(omega, False), device="cpu")
    assert chk._group_for() == group
    n = 1 << 15
    sig = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    _, (syms, valid) = chk(chk.init_state(), _t(sig))
    assert syms.shape[-1] == valid.shape[-1] == chk.max_symbols(n)


def test_contract_engages_midsize_block():
    sig, sps = _bpsk_real(1 << 15)
    kw = _kw(sps, False)
    chk = MMClockRecoveryChunked(**kw, device="cpu")
    assert chk._lanes_for(1 << 13) == 16
    r, c, _, _ = _run_pair(sig, MMClockRecovery(**kw, device="cpu"), chk,
                           blocks=4)
    assert abs(len(r) - len(c)) <= 1, (len(r), len(c))
    m = min(len(r), len(c))
    assert np.mean(np.sign(r[200:m]) == np.sign(c[200:m])) == 1.0
    assert np.mean(np.abs(r[200:m] - c[200:m])) < 0.12


def test_contract_nondefault_tap_count():
    sig, sps = _bpsk_real(1 << 18)
    kw = _kw(sps, False, interp_tap_count=6)
    r, c, _, _ = _run_pair(sig, MMClockRecovery(**kw, device="cpu"),
                           MMClockRecoveryChunked(**kw, device="cpu"))
    assert abs(len(r) - len(c)) <= 1, (len(r), len(c))
    m = min(len(r), len(c))
    assert np.mean(np.sign(r[200:m]) == np.sign(c[200:m])) == 1.0
    assert np.mean(np.abs(r[200:m] - c[200:m])) < 0.05


def _run_mm(mm, sig, blocks=2):
    st = mm.init_state()
    out = []
    n = len(sig) // blocks
    for i in range(blocks):
        st, (s, v) = mm(st, _t(sig[i * n:(i + 1) * n]))
        out.append(s[v].numpy())
    return np.concatenate(out), st


def test_stress_awgn_bounded_degradation():
    sig, tx, sps = _qpsk_shaped(1 << 18, ebn0_db=5.0)
    kw = _kw(sps, True)
    r, _ = _run_mm(MMClockRecovery(**kw, device="cpu"), sig)
    c, _ = _run_mm(MMClockRecoveryChunked(**kw, device="cpu"), sig)
    sr, offr = _windowed_ser(r, tx)
    sc, offc = _windowed_ser(c, tx)
    assert sr.mean() < 0.03, sr.mean()
    assert sc.mean() <= sr.mean() + 0.01, (sc.mean(), sr.mean())
    assert np.abs(np.diff(offc)).sum() <= 2, offc
    assert np.abs(np.diff(offr)).sum() <= 1, offr


def test_stress_clock_rate_offset_near_limit():
    sig, tx, sps = _qpsk_shaped(1 << 18)
    kw = _kw(sps * 1.008, True)
    r, s1 = _run_mm(MMClockRecovery(**kw, device="cpu"), sig)
    c, s2 = _run_mm(MMClockRecoveryChunked(**kw, device="cpu"), sig)
    assert abs(len(r) - len(c)) <= 1, (len(r), len(c))
    m = min(len(r), len(c))
    assert np.mean(_quant(r[500:m]) == _quant(c[500:m])) == 1.0
    assert abs(float(s1["freq"]) - sps) < 1e-3, float(s1["freq"])
    assert abs(float(s2["freq"]) - sps) < 1e-3, float(s2["freq"])


def test_stress_squelched_warmup_gap():
    sig, tx, sps = _qpsk_shaped(1 << 17, seed=9)
    sigg = sig.copy()
    sigg[60000:63000] = 0

    def tail_ser(got):
        gq, tq = _quant(got), _quant(tx)
        s = 3 * len(gq) // 4
        best = 1.0
        for o in range(-30, 31):
            if s + o < 0 or s + o + (len(gq) - s) > len(tq):
                continue
            best = min(best, np.mean(gq[s:] != tq[s + o:s + o + len(gq) - s]))
        return best

    for cls in (MMClockRecovery, MMClockRecoveryChunked):
        got, st = _run_mm(cls(**_kw(sps, True), device="cpu"), sigg,
                          blocks=1)
        assert not np.isnan(got).any()
        assert not any(torch.isnan(v).any() for v in st.values())
        assert tail_ser(got) < 1e-3, (cls.__name__, tail_ser(got))


# ---------------------------------------------------------------------------
# the branch rule and SDRPP_TPU_LOOPS=exact
# ---------------------------------------------------------------------------

def test_loops_exact_mode_is_the_exact_walker_bit_for_bit(monkeypatch):
    """Under LOOPS_MODE "exact" the chunked M&M is the exact walker and a
    chunked loop (FastAGC) the exact recurrence, bit for bit, on blocks
    that chunk otherwise."""
    from sdrpp_tpu_torch.ops.scans import FastAGC

    sig, sps = _qpsk_cplx(1 << 16)
    kw = _kw(sps, True)
    chk = MMClockRecoveryChunked(**kw, device="cpu")
    agc_c = SK.FastAGCChunked(1.0, 10e6, 0.001, device="cpu")
    assert chk._lanes_for(len(sig)) == 128
    assert SK._chunk_lanes_for(len(sig), agc_c.warmup, agc_c.max_lanes) > 0
    monkeypatch.setattr(SK, "LOOPS_MODE", "exact")
    assert chk._lanes_for(len(sig)) == 0
    ref = MMClockRecovery(**kw, device="cpu")
    s1, (y1, v1) = ref(ref.init_state(), _t(sig))
    s2, (y2, v2) = chk(chk.init_state(), _t(sig))
    assert torch.equal(y1, y2) and torch.equal(v1, v2)
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k
    agc = FastAGC(1.0, 10e6, 0.001, device="cpu")
    a1, g1 = agc(agc.init_state(), _t(sig))
    a2, g2 = agc_c(agc_c.init_state(), _t(sig))
    assert torch.equal(g1, g2)
    assert torch.equal(a1, a2["gain"])


def test_loops_mode_read_from_the_environment():
    code = ("from sdrpp_tpu_torch.ops import scans_kernels as S;"
            "print(S.LOOPS_MODE, S._chunk_lanes_for(1 << 18, 512, 256))")
    for mode, want in (("exact", "exact 0"), ("auto", "auto 128")):
        env = dict(os.environ, SDRPP_TPU_LOOPS=mode)
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, check=True, env=env, timeout=120,
                             cwd=Path(__file__).resolve().parent.parent)
        assert out.stdout.split() == want.split(), out.stdout


def test_chunked_on_other_devices_raises():
    sig, sps = _qpsk_cplx(1 << 15)
    chk = MMClockRecoveryChunked(**_kw(sps, True), device="cpu")
    st = chk.init_state()
    cap = {}
    orig = CC.mm_symbols_chunked_plain

    def spy(*a):
        cap["a"] = a
        return orig(*a)

    CC.mm_symbols_chunked_plain = spy
    try:
        chk(st, _t(sig))
    finally:
        CC.mm_symbols_chunked_plain = orig
    meta = [v.to("meta") if torch.is_tensor(v) else v for v in cap["a"]]
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        CC.mm_symbols_chunked_lanes(*meta)


# ---------------------------------------------------------------------------
# FDClockRecovery
# ---------------------------------------------------------------------------

def _fd_signal(n, sps, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, int(n / sps) + 4) * 2.0 - 1.0
    x = np.repeat(bits, int(np.ceil(sps)))[:n]
    h = np.hanning(9) / np.hanning(9).sum()
    x = np.convolve(x, h, mode="same") + rng.normal(0, 0.05, n)
    return x.astype(np.float32)


def test_fd_matches_jax_over_two_blocks():
    x = _fd_signal(4000, 10.0, 3)
    kw = dict(omega=10.0, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.05)
    j = jcr.FDClockRecovery(**kw)
    t = FDClockRecovery(**kw, device="cpu")
    js, ts = j.init_state(), t.init_state()
    step = jax.jit(j)
    for blk in (x[:1900], x[1900:]):
        js, (jy, jv) = step(js, jnp.asarray(blk))
        ts, (ty, tv) = t(ts, _t(blk))
        jv = np.asarray(jv).astype(bool)
        assert ty.shape[0] == t.max_symbols(len(blk)) == jy.shape[0]
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=MM_TOL)
    jn, tn = jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts)
    assert set(jn) == set(tn)
    for k in jn:
        assert jn[k].dtype == tn[k].dtype and jn[k].shape == tn[k].shape, k
        np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=MM_TOL,
                                   err_msg=k)


def test_fd_clock_recovery():
    """tests/test_digital.py's FD case on the port."""
    rng = np.random.default_rng(5)
    sps, nsym = 10, 400
    bits = rng.integers(0, 2, nsym) * 2.0 - 1.0
    x = np.repeat(bits, sps).astype(np.float32)
    fd = FDClockRecovery(omega=sps, omega_gain=0.001, mu_gain=0.01,
                         omega_rel_limit=0.05, device="cpu")
    st, (syms, valid) = fd(fd.init_state(), _t(x))
    nv = int(valid.sum())
    s = syms.numpy()[2:nv] > 0
    best = 0
    for off in range(4):
        m = min(len(s), nsym - off)
        best = max(best, np.mean(s[:m] == (bits[off:off + m] > 0)))
    assert best > 0.95


def test_fd_symbols_streams_are_independent_and_reject_other_devices():
    fd = FDClockRecovery(10.0, 0.001, 0.01, 0.05, device="cpu")
    bufs = np.stack([_fd_signal(1007, 10.0, s) for s in (1, 2)])
    fstate = torch.tensor([[0.0, 10.0], [0.5, 10.2]])
    off = torch.tensor([0, 3], dtype=torch.int32)
    args = (fd._bank, fd.max_symbols(1000), fd.omega_gain, fd.mu_gain,
            fd.min_freq, fd.max_freq)
    both = CK.fd_symbols(_t(bufs), off, fstate, *args)
    for c in range(2):
        one = CK.fd_symbols(_t(bufs[c:c + 1]), off[c:c + 1],
                            fstate[c:c + 1], *args)
        for a, b in zip(both, one):
            assert torch.equal(a[c], b[0])
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        CK.fd_symbols(_t(bufs).to("meta"), off.to("meta"),
                      fstate.to("meta"), fd._bank.to("meta"), *args[1:])


# ---------------------------------------------------------------------------
# the host path's entries against mm_clock.cu's C entries
# ---------------------------------------------------------------------------

def _c_params(src, entry):
    m = re.search(rf"\bint {entry}\(([^)]*)\)", src)
    assert m, entry
    return [p.strip() for p in m.group(1).split(",")]


def _kinds(params):
    out = []
    for p in params:
        p = re.sub(r"\b(const|__restrict__)\b", "", p).split()
        out.append("ptr" if "*" in "".join(p) else p[0])
    return out


@pytest.mark.parametrize("entry,typedef", [
    ("mm_symbols_complex", "MmSymbolsEntry"),
    ("mm_symbols_real", "MmSymbolsEntry"),
    ("mm_chunked_complex", "MmChunkedEntry"),
    ("mm_chunked_real", "MmChunkedEntry"),
    ("fd_symbols", "FdSymbolsEntry"),
    ("mm_chunked_block_complex", "MmChunkedBlockEntry"),
    ("mm_chunked_block_real", "MmChunkedBlockEntry")])
def test_host_entries_bind_every_c_argument(entry, typedef):
    """Each C entry of csrc/mm_clock.cu and the function type the compiled
    host path calls it through (csrc/kernels_host.cpp) agree argument for
    argument (pointer, int or float; the stream last), and the Python
    binder hands them over in the host's order (bind_mm_clock's, or
    bind_mm_chunked_block's for the chunked M&M's block entries)."""
    csrc = Path(CK.__file__).resolve().parent.parent / "csrc"
    cu = (csrc / "mm_clock.cu").read_text()
    host = (csrc / "kernels_host.cpp").read_text()
    m = re.search(rf"using {typedef} = int \(\*\)\(([^;]*)\);", host)
    assert m, typedef
    want = _kinds(_c_params(cu, entry))
    got = _kinds(p.strip() for p in m.group(1).split(","))
    assert got == want
    assert _c_params(cu, entry)[-1] == "void* stream"
    entries, binder = ((CK.MM_CHUNKED_BLOCK_ENTRIES, "bind_mm_chunked_block")
                       if typedef == "MmChunkedBlockEntry"
                       else (CK.MM_CLOCK_ENTRIES, "bind_mm_clock"))
    assert entry in entries
    order = re.search(rf"{binder}\(([^)]*)\)\"\);", host).group(1)
    assert len(entries) == len(order.split(","))


def test_kernel_geometry_fits_the_kernel():
    """Every block the decode paths run chunks into a layout the CUDA
    kernel takes: K <= 256 lanes (a cluster of ceil(K / 32) CTAs, 32 lanes
    each), M in {8, 16, 32}, and each CTA's shared memory for the bank,
    its lanes' whole windows of a group step (R samples and 8 of slack
    either side, copied from a 16-byte boundary: 35,328 bytes at hrpt's
    and meteor's 32 lanes of R = 120 complex), prefetched a step ahead,
    the errors and the carry within the 227 KB a CTA may take, for either
    sample type. A symbol period of ~250 samples (R = 2,048, 2.4 Msps at
    9,600 Bd) fits too: each pass copies its windows in pieces of the
    largest buffer that fits, three complex, two float, overlapping by 7
    samples and covering R with none to spare."""
    for n, omega, cplx, window in (
            (262144, 3e6 / 1.3308e6, True, 35328),
            (262144, 10.0, False, 16896),
            (65536, 150000.0 / 72000.0, True, 35328),
            (15120, 150000 / 72000, True, 32016),
            (16200, 150000 / 72000, True, 34224)):
        k = SK._chunk_lanes_for(n, 512, 256)
        geom, _, _ = CC.chunk_geometry(n, k, 512, 8, np.float32(omega * 0.99),
                                       np.float32(omega * 1.01))
        assert 1 <= geom.K <= CC.KERNEL_MAX_LANES and geom.M in (8, 16, 32)
        lanes = min(geom.K, CC.KERNEL_CTA_LANES)
        for c in (False, True):
            a = 2 if c else 4
            stride = (geom.R + 2 * CC.WINDOW_SLACK + 2 * (a - 1)) // a * a
            if c == cplx:
                assert lanes * stride * (8 if cplx else 4) == window
            smem, lane, pieces = CC.kernel_layout(geom, c)
            assert pieces == 0 and lane == stride, (n, c, lane)
            assert lanes * stride * (8 if c else 4) < smem
            assert smem <= CC.KERNEL_SMEM_BYTES, (n, c, smem)
    slow, _, _ = CC.chunk_geometry(262144, 128, 512, 8, np.float32(247.5),
                                   np.float32(252.5))
    assert slow.R == 2048 and slow.M == 8
    for cplx, want in ((True, 3), (False, 2)):
        smem, lane, pieces = CC.kernel_layout(slow, cplx)
        assert smem <= CC.KERNEL_SMEM_BYTES and pieces == want
        plen = lane - 16 // (8 if cplx else 4) + 1
        step = plen - 7
        assert (pieces - 1) * step + plen >= slow.R > (pieces - 2) * step + plen
