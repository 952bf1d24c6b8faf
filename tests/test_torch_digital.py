"""Port parity for the Meteor demodulator's loops: FastAGC, Costas, the M&M
clock recovery, the JAX MeteorCostas (the port's CostasChunked with order
"meteor" or 4 and a 1024-sample warm-up) and MeteorDemod.

The JAX side runs as the JAX package's own tests run it on the CPU: the
Pallas loop kernels in interpret mode (``interpret=True``), the exact
blocks through ``jax.jit``. The port's wrappers, given CPU tensors, run
their plain PyTorch versions, operation for operation the CUDA kernels.
Tolerances, with their reasons:

- FastAGC gains (exact and chunked): 1e-5 relative to the largest gain. The
  same float32 operations in the same order; XLA contracts the interpret
  bodies' a*b + c into FMAs, the port rounds twice (as its --fmad=false
  kernel does), a few ulp that the contracting loop does not grow;
- Costas (orders 2/4/8 and "meteor", exact and chunked): 2e-4 on the
  rotated output and the phases as phasors, the bound of
  tests/test_clock_recovery_pallas.py:104. Beyond the FMA ulps, the
  orders 2/4/8 rotate by cos/sin of the phase, which XLA and torch
  evaluate to different ulps, and the chunked seeds come from
  atan2/cos/sin/mean;
- M&M against MMClockRecovery (jit) and MMClockRecoveryPallas
  (interpret), complex and float: 2e-5 on symbols and carried state, the
  bound of tests/test_clock_recovery_pallas.py:45; symbol counts equal.
  The port sums the 8 taps in order, as the Pallas kernel does; XLA's
  reduction in the lax.scan block sums them in another order, and where a
  noisy sample sits within an ulp of 0 the sign decision of the M&M error
  flips and the loops part (on the order of 1e-2 for a few hundred
  symbols). The lax.scan comparisons use inputs where that does not
  happen, as the JAX package's own test does;
- MeteorDemod on short blocks (exact loops on both sides), with the JAX
  state after block 0 carried into the port through ``state_from_numpy``:
  symbol counts equal, symbols within 1e-2 (max) and 1e-3 (RMS). Each
  stage alone agrees to 1e-6 (the RRC FIR runs as an FFT in the port and
  directly in XLA, then the loops above), but the chain feeds the M&M
  ulp-different samples, and the M&M flips a sign decision wherever an
  interpolated sample lies within rounding of 0 (often with the OQPSK Q
  delay); both loops then re-converge over some tens of symbols
  (measured: max 7.9e-3, RMS 8e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.models import digital as jdigital
from sdrpp_tpu.ops import scans as jscans
from sdrpp_tpu.ops import scans_pallas as SP
from sdrpp_tpu.ops.clock_recovery import MMClockRecovery as JaxMM
from sdrpp_tpu.ops.clock_recovery_pallas import MMClockRecoveryPallas
from sdrpp_tpu_torch.models.digital import MeteorDemod
from sdrpp_tpu_torch.ops import scans_kernels as K
from sdrpp_tpu_torch.ops.clock_recovery import MMClockRecovery
from sdrpp_tpu_torch.ops.clock_recovery_chunked import MMClockRecoveryChunked
from sdrpp_tpu_torch.ops.clock_recovery_kernels import mm_symbols
from sdrpp_tpu_torch.ops.scans import Costas, FastAGC
from sdrpp_tpu_torch.utils.blocks import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

BW = 0.01
ALPHA, BETA = jscans._critically_damped(BW)
COSTAS_TOL = 2e-4
MM_TOL = 2e-5


def _psk(n, order, seed, phases=None, noise=0.05, drift=2e-4):
    """Seeded PSK samples (a slow carrier, AWGN); ``phases`` overrides the
    uniform constellation (the meteor points)."""
    rng = np.random.default_rng(seed)
    pts = (np.pi / order * (order != 2) + 2 * np.pi / order * np.arange(order)
           if phases is None else np.asarray(phases))
    ph = pts[rng.integers(0, len(pts), n)] + drift * np.arange(n)
    x = np.exp(1j * ph) + noise * (rng.standard_normal(n)
                                   + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _phasor_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(np.exp(1j * a) - np.exp(1j * b)).max())


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a.astype(np.complex128) - b).max()
                 / max(float(np.abs(b).max()), 1e-30))


# ---------------------------------------------------------------------------
# FastAGC
# ---------------------------------------------------------------------------

def test_fast_agc_exact_matches_jax_over_blocks():
    x = _psk(3000, 4, 0) * 0.3
    j = jscans.FastAGC(1.0, 10e6, 0.01)
    t = FastAGC(1.0, 10e6, 0.01, device="cpu")
    js, ts = j.init_state(), t.init_state()
    step = jax.jit(j)
    for blk in (x[:1500], x[1500:]):
        js, jy = step(js, jnp.asarray(blk))
        ts, ty = t(ts, _t(blk))
        assert _rel(ty.numpy(), jy) <= 1e-5
    assert abs(float(ts) - float(js)) <= 1e-5 * abs(float(js))


def test_fast_agc_chunked_matches_pallas_chunked():
    a = np.abs(_psk(20000, 4, 1)) * 0.2
    hist = np.full(1024, 0.25, np.float32)
    want = SP.fast_agc_gains_chunked(jnp.asarray(a), jnp.asarray(hist), 1.0,
                                     10e6, 0.001, lanes_k=16, interpret=True)
    got = K.fast_agc_gains_chunked(_t(a), _t(hist), 1.0, 10e6, 0.001,
                                   lanes_k=16)
    assert _rel(got[0].numpy(), want[0]) <= 1e-5
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert abs(float(got[2]) - float(want[2])) <= 1e-5 * abs(float(want[2]))


def test_fast_agc_chunked_block_over_blocks():
    """FastAGCChunked (chunked at 66000 samples: K = 64) against the JAX
    block in interpret mode, two blocks, state tree and values."""
    x = _psk(2 * 66000, 4, 2) * 0.3
    j = SP.FastAGCChunked(1.0, 10e6, 0.001, interpret=True)
    t = K.FastAGCChunked(1.0, 10e6, 0.001, device="cpu")
    assert SP._chunk_lanes_for(66000, 1024, 512) == 64
    js, ts = j.init_state(), t.init_state()
    step = jax.jit(j)
    for k in range(2):
        blk = x[k * 66000:(k + 1) * 66000]
        js, jy = step(js, jnp.asarray(blk))
        ts, ty = t(ts, _t(blk))
        assert _rel(ty.numpy(), jy) <= 1e-5
    jn, tn = jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts)
    assert jn.keys() == tn.keys()
    for k in jn:
        assert jn[k].shape == tn[k].shape and jn[k].dtype == tn[k].dtype
        assert _rel(tn[k], jn[k]) <= 1e-5


# ---------------------------------------------------------------------------
# Costas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [2, 4, 8])
def test_costas_exact_matches_jax_over_blocks(order):
    x = _psk(3000, order, 3 + order)
    j = jscans.Costas(order, BW, init_freq=1e-4)
    t = Costas(order, BW, init_freq=1e-4, device="cpu")
    js, ts = j.init_state(), t.init_state()
    step = jax.jit(j)
    for blk in (x[:1500], x[1500:]):
        js, jy = step(js, jnp.asarray(blk))
        ts, ty = t(ts, _t(blk))
        assert np.abs(ty.numpy() - np.asarray(jy)).max() <= COSTAS_TOL
    assert _phasor_err(ts["phase"], js["phase"]) <= COSTAS_TOL
    assert abs(float(ts["freq"]) - float(js["freq"])) <= 1e-6


@pytest.mark.parametrize("order", [2, 4, 8, "meteor"])
def test_costas_phases_exact_matches_pallas(order):
    m = 4 if order == "meteor" else order
    x = _psk(2500, m, 10, phases=K.METEOR_PHASES if order == "meteor"
             else None)
    s1, s2 = SP.costas_streams(jnp.asarray(x.real), jnp.asarray(x.imag),
                               order)
    want = SP.costas_phases_pallas(
        jnp.asarray(x.real), jnp.asarray(x.imag), jnp.float32(0.2),
        jnp.float32(1e-4), order, ALPHA, BETA, -np.pi, np.pi, interpret=True)
    got = K.costas_phases(_t(x.real), _t(x.imag), torch.tensor(0.2),
                          torch.tensor(1e-4), order, ALPHA, BETA, -np.pi,
                          np.pi)
    assert _phasor_err(got[0].numpy(), want[0]) <= COSTAS_TOL
    assert _phasor_err(got[1], want[1]) <= COSTAS_TOL
    assert abs(float(got[2]) - float(want[2])) <= 1e-6
    # the meteor streams are atan2 / |v|
    t1, t2 = K.costas_streams(_t(x.real), _t(x.imag), order)
    np.testing.assert_allclose(t1.numpy(), np.asarray(s1), atol=1e-6)
    np.testing.assert_allclose(t2.numpy(), np.asarray(s2), atol=1e-6)


@pytest.mark.parametrize("order", [4, 8, "meteor"])
def test_costas_phases_chunked_matches_pallas_chunked(order):
    m = 4 if order == "meteor" else order
    pts = K.METEOR_PHASES if order == "meteor" else None
    x = _psk(16384, m, 20, phases=pts)
    h = _psk(512, m, 21, phases=pts)
    js = SP.costas_streams(jnp.asarray(x.real), jnp.asarray(x.imag), order)
    jh = SP.costas_streams(jnp.asarray(h.real), jnp.asarray(h.imag), order)
    want = SP.costas_phases_chunked(*js, *jh, jnp.float32(0.3),
                                    jnp.float32(2e-4), order, ALPHA, BETA,
                                    -np.pi, np.pi, lanes_k=16, interpret=True)
    ts = K.costas_streams(_t(x.real), _t(x.imag), order)
    th = K.costas_streams(_t(h.real), _t(h.imag), order)
    got = K.costas_phases_chunked(*ts, *th, torch.tensor(0.3),
                                  torch.tensor(2e-4), order, ALPHA, BETA,
                                  -np.pi, np.pi, lanes_k=16)
    assert got[0].shape == tuple(want[0].shape)
    assert _phasor_err(got[0].numpy(), want[0]) <= COSTAS_TOL
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    assert _phasor_err(got[3], want[3]) <= COSTAS_TOL
    assert abs(float(got[4]) - float(want[4])) <= 1e-6


def test_costas_chunked_block_over_blocks():
    """CostasChunked (order 4, K = 32 at 16384 samples) against the JAX
    block in interpret mode over two blocks; the state tree matches."""
    x = _psk(2 * 16384, 4, 30)
    j = SP.CostasChunked(4, BW, interpret=True)
    t = K.CostasChunked(4, BW, device="cpu")
    js, ts = j.init_state(), t.init_state()
    step = jax.jit(j)
    for k in range(2):
        blk = x[k * 16384:(k + 1) * 16384]
        js, jy = step(js, jnp.asarray(blk))
        ts, ty = t(ts, _t(blk))
        assert np.abs(ty.numpy() - np.asarray(jy)).max() <= COSTAS_TOL
    jn, tn = jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts)
    assert jn.keys() == tn.keys()
    for k in jn:
        assert jn[k].shape == tn[k].shape and jn[k].dtype == tn[k].dtype
    assert _phasor_err(tn["phase"], jn["phase"]) <= COSTAS_TOL


# ---------------------------------------------------------------------------
# M&M clock recovery
# ---------------------------------------------------------------------------

def _mm_signal(n, sps, cplx, seed):
    rng = np.random.default_rng(seed)
    nsym = int(n / sps) + 4
    if cplx:
        sym = (rng.integers(0, 2, nsym) * 2 - 1
               + 1j * (rng.integers(0, 2, nsym) * 2 - 1)).astype(np.complex64)
    else:
        sym = (rng.integers(0, 2, nsym) * 2.0 - 1.0).astype(np.float32)
    x = sym[np.minimum((np.arange(n) / sps).astype(np.int64), nsym - 1)]
    x += (rng.normal(0, 0.05, n) * (1 + 1j if cplx else 1)).astype(x.dtype)
    return x


def _check_mm_blocks(jblock, tblock, x, halves, jit=True):
    js, ts = jblock.init_state(), tblock.init_state()
    step = jax.jit(jblock) if jit else jblock
    for blk in halves(x):
        js, (jy, jv) = step(js, jnp.asarray(blk))
        ts, (ty, tv) = tblock(ts, _t(blk))
        nj, nt = int(np.asarray(jv).sum()), int(tv.sum())
        assert nj == nt
        assert tv[:nt].all() and not tv[nt:].any()  # a prefix
        assert ty.shape[0] == tblock.max_symbols(len(blk))
        jy = np.asarray(jy)[np.asarray(jv).astype(bool)]
        assert np.abs(ty.numpy()[:nt] - jy).max() <= MM_TOL
    jn, tn = jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts)
    assert set(jn) == set(tn)
    for k in jn:
        assert jn[k].dtype == tn[k].dtype and jn[k].shape == tn[k].shape, k
        np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=MM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("cplx", [True, False])
def test_mm_matches_jax_scan(cplx):
    sps = 150000.0 / 72000.0
    x = _mm_signal(6000, sps, cplx, 0 if cplx else 1)
    _check_mm_blocks(JaxMM(sps, 0.001, 0.01, 0.01, complex_input=cplx),
                     MMClockRecovery(sps, 0.001, 0.01, 0.01,
                                     complex_input=cplx, device="cpu"),
                     x, lambda x: (x[:2500], x[2500:]))


@pytest.mark.parametrize("cplx", [True, False])
def test_mm_matches_pallas_interpret(cplx):
    """MMClockRecoveryPallas (interpret, 4096-sample chunks) pads its
    symbol slots per chunk; the valid symbols and state agree."""
    sps = 2.5
    x = _mm_signal(2 * 4096, sps, cplx, 2)
    _check_mm_blocks(MMClockRecoveryPallas(sps, 0.001, 0.01, 0.01,
                                           complex_input=cplx,
                                           interpret=True),
                     MMClockRecovery(sps, 0.001, 0.01, 0.01,
                                     complex_input=cplx, device="cpu"),
                     x, lambda x: (x[:4096], x[4096:]), jit=False)


def test_mm_chunked_block_state_tree_and_exact_branch():
    """The port's MMClockRecoveryChunked carries the JAX chunked block's
    state tree (with ``hist``) and takes its branch: the exact recurrence
    on short blocks, and the chunked one on long blocks, where it matches
    the JAX block in interpret mode (equal masks, MM_TOL)."""
    from sdrpp_tpu.ops.clock_recovery_chunked import \
        MMClockRecoveryChunked as JaxChunked

    sps = 150000.0 / 72000.0
    x = _mm_signal(6000, sps, True, 0)
    t = MMClockRecoveryChunked(sps, 0.001, 0.01, 0.01, complex_input=True,
                               device="cpu")
    assert t._lanes_for(2000) == 0
    _check_mm_blocks(JaxChunked(sps, 0.001, 0.01, 0.01, complex_input=True),
                     t, x, lambda x: (x[:2000], x[2000:4000]))
    # the chunked branch: 2 x 16384 samples, K = 32 lanes
    x = _mm_signal(2 * 16384, sps, True, 1)
    assert t._lanes_for(16384) == 32
    j = JaxChunked(sps, 0.001, 0.01, 0.01, complex_input=True,
                   interpret=True)
    js, ts = j.init_state(), t.init_state()
    step = jax.jit(j)
    for blk in (x[:16384], x[16384:]):
        js, (jy, jv) = step(js, jnp.asarray(blk))
        ts, (ty, tv) = t(ts, _t(blk))
        jv = np.asarray(jv).astype(bool)
        assert ty.shape[0] == t.max_symbols(16384) == jy.shape[0]
        np.testing.assert_array_equal(tv.numpy(), jv)
        assert not tv[:int(tv.sum())].all()     # a mask, not a prefix
        assert np.abs(ty.numpy()[jv] - np.asarray(jy)[jv]).max() <= MM_TOL
    jn, tn = jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts)
    assert set(jn) == set(tn)
    for k in jn:
        np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=MM_TOL,
                                   err_msg=k)


def test_mm_symbols_streams_are_independent():
    """C streams in one call equal each stream on its own."""
    mm = MMClockRecovery(2.5, 0.001, 0.01, 0.01, complex_input=True,
                         device="cpu")
    bufs = np.stack([_mm_signal(1007, 2.5, True, s) for s in (4, 5)])
    fstate = torch.zeros((2, 10))
    fstate[:, 1] = 2.5
    fstate[1, 0] = 0.5
    off = torch.tensor([0, 1], dtype=torch.int32)
    args = (mm._bank, mm.max_symbols(1000), mm.mu_gain, mm.omega_gain,
            mm.min_freq, mm.max_freq)
    both = mm_symbols(_t(bufs), off, fstate, *args)
    for c in range(2):
        one = mm_symbols(_t(bufs[c:c + 1]), off[c:c + 1], fstate[c:c + 1],
                         *args)
        for a, b in zip(both, one):
            assert torch.equal(a[c], b[0])


def test_mm_symbols_rejects_other_devices():
    mm = MMClockRecovery(2.5, 0.001, 0.01, 0.01, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        mm_symbols(torch.zeros((1, 20), dtype=torch.complex64,
                               device="meta"),
                   torch.zeros(1, dtype=torch.int32, device="meta"),
                   torch.zeros((1, 10), device="meta"),
                   mm._bank.to("meta"), 10, 0.01, 0.001, 2.4, 2.6)


# ---------------------------------------------------------------------------
# MeteorCostas and MeteorDemod
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("broken", [False, True])
def test_meteor_costas_matches_jax_over_blocks(broken):
    pts = K.METEOR_PHASES if broken else None
    x = _psk(4000, 4, 40, phases=pts)
    j = jdigital.MeteorCostas(0.01, broken_modulation=broken)
    t = K.CostasChunked("meteor" if broken else 4, 0.01, warmup=1024,
                        device="cpu")
    js, ts = j.init_state(), t.init_state()
    step = jax.jit(j)
    for blk in (x[:2000], x[2000:]):
        js, jy = step(js, jnp.asarray(blk))
        ts, ty = t(ts, _t(blk))
        assert np.abs(ty.numpy() - np.asarray(jy)).max() <= COSTAS_TOL
    jn, tn = jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts)
    assert jn.keys() == tn.keys()
    for k in jn:
        assert jn[k].shape == tn[k].shape and jn[k].dtype == tn[k].dtype
    np.testing.assert_allclose(tn["hist_re"], jn["hist_re"], atol=1e-6)


def test_meteor_costas_chunked_matches_pallas_chunked():
    """The port's Costas (MeteorCostas's settings: order 4, warm-up 1024)
    takes its chunked branch at 66000 samples (K = 64) on every device; the
    JAX package takes it on the TPU only, so it is held to
    ``costas_phases_chunked(..., interpret=True)``."""
    x = _psk(66000, 4, 41)
    t = K.CostasChunked(4, 0.005, warmup=1024, device="cpu")
    j = jdigital.MeteorCostas(0.005)
    st0 = t.init_state()
    _, ty = t(st0, _t(x))
    jst = j.init_state()
    s = SP.costas_streams(jnp.asarray(x.real), jnp.asarray(x.imag), 4)
    h = SP.costas_streams(jst["hist_re"], jst["hist_im"], 4)
    ph, *_ = SP.costas_phases_chunked(*s, *h, jst["phase"], jst["freq"], 4,
                                      j.alpha, j.beta, j.min_freq,
                                      j.max_freq, lanes_k=64, interpret=True)
    want = x * np.exp(-1j * np.asarray(ph, np.float64))
    assert np.abs(ty.numpy() - want).max() <= COSTAS_TOL


def _meteor_iq(n, seed):
    """QPSK at 72 ksym/s (rectangular hold) at 150 kHz, a small carrier
    offset and AWGN."""
    rng = np.random.default_rng(seed)
    sps = 150000.0 / 72000.0
    nsym = int(n / sps) + 2
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
    x = sym[(np.arange(n) / sps).astype(np.int64)] \
        * np.exp(2j * np.pi * 30.0 * np.arange(n) / 150000.0)
    x += 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (0.3 * x).astype(np.complex64)


@pytest.mark.parametrize("oqpsk", [False, True])
def test_meteor_demod_matches_jax_with_state_carried(oqpsk):
    """Blocks of 2000 samples (both sides exact): block 1 from the JAX
    state after block 0, carried in with state_from_numpy."""
    x = _meteor_iq(4000, 50)
    j = jdigital.MeteorDemod(oqpsk=oqpsk)
    t = MeteorDemod(oqpsk=oqpsk, device="cpu")
    assert K._chunk_lanes_for(2000, 1024, 512) == 0
    step = jax.jit(j)
    js0 = jax.jit(j.init_state)()
    js1, (jy0, jv0) = step(js0, jnp.asarray(x[:2000]))
    _, (jy1, jv1) = step(js1, jnp.asarray(x[2000:]))

    ts1, (ty0, tv0) = t(t.init_state(), _t(x[:2000]))
    carried = state_from_numpy(jax.tree_util.tree_map(np.asarray, js1), "cpu")
    _, (ty1, tv1) = t(carried, _t(x[2000:]))
    for ty, tv, jy, jv in ((ty0, tv0, jy0, jv0), (ty1, tv1, jy1, jv1)):
        jy = np.asarray(jy)[np.asarray(jv).astype(bool)]
        assert int(tv.sum()) == len(jy)
        d = np.abs(ty[tv].numpy() - jy)
        assert d.max() <= 1e-2 and np.sqrt(np.mean(d ** 2)) <= 1e-3
    jn, tn = jax.tree_util.tree_map(np.asarray, js1), state_to_numpy(ts1)
    jl, jdef = jax.tree_util.tree_flatten(jn)
    tl, tdef = jax.tree_util.tree_flatten(tn)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_state_from_numpy_carries_digital_leaves():
    """int32 offsets, complex scalars and hist buffers keep their dtypes
    and shapes through state_from_numpy."""
    j = jdigital.MeteorDemod()
    jn = jax.tree_util.tree_map(np.asarray, jax.jit(j.init_state)())
    st = state_from_numpy(jn, "cpu")
    assert st["recov"]["offset"].dtype == torch.int32
    assert st["recov"]["p1"].dtype == torch.complex64
    assert st["recov"]["p1"].shape == ()
    assert st["costas"]["hist_re"].shape == (1024,)
    assert st["agc"]["hist"].dtype == torch.float32
    back = state_to_numpy(st)
    for a, b in zip(jax.tree_util.tree_leaves(jn),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
