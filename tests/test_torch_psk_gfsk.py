"""Port parity for the PSK and GFSK demodulators (``models.digital``):
``PSKDemod`` at HRPT's settings (BPSK, 1.3308 Msym/s at 3 Msps) and at
order 4, and ``GFSKDemod`` at M17's (4FSK at 4800 baud, 48 kHz), each over
two blocks with the state carried.

The JAX side runs as its own tests run it on the CPU: exact loops through
``jax.jit``, and, for the chunked comparison, the chunk-parallel FastAGC
and Costas with ``interpret = True``; the port decides chunked or exact by
``_chunk_lanes_for`` on every device, as the JAX package does on the TPU.
The port's PSKDemod warms its loops up over four of their time constants
(ROADMAP C); the JAX loops are given the same warm-ups, so both sides
take the same branch and lanes (HRPT's FastAGC runs exact on both).
The JAX M&M runs with ``interpret = True`` too, so both sides take the
chunked M&M on the long blocks and the exact one (the JAX one through its
Pallas kernel in interpret mode, which sums the 8 taps in order as the
port's does) on the short ones; on the JAX chain's input the two give the
same ``valid`` mask.

Each stage of the port's chain gets the JAX chain's input to that stage
and carries its own state: the RRC FIR within 1e-6 of the largest output
(an FFT in the port, a direct sum in XLA), FastAGC within 1e-5, the PSK
Costas output and phase within COSTAS_TOL = 2e-4 (cos/sin of the phase
differ by ulps between XLA and torch, and the chunked seeds come from
atan2/mean), the symbol counts and the state tree (keys, shapes, dtypes)
equal. The M&M's symbols, on the JAX chain's input and for each whole
chain on its own, are held within MM_PART (2e-2) of the largest at most
and MM_SPREAD (2e-3) in RMS, with the same hard decisions (BPSK sign, QPSK
quadrant, 4FSK level) wherever a symbol is clear of a decision threshold;
the carried timing to the same sample offset, one bank step of phase and
MM_SPREAD of the period. Not MM_TOL (2e-5, tests/test_torch_digital.py):
that holds on inputs where no timing phase lies within an ulp of a step of
the interpolation bank, but over the thousands of symbols here a
difference of an ulp (XLA contracts the interpret kernel's a*b + c into
FMAs, the port's kernel does not) moves some interpolation across one of
the bank's 128 phase steps (1/128 of a sample), and the two loops part by
up to ~1e-2 for some symbols before they converge again.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.decoders import hrpt as jhrpt
from sdrpp_tpu.decoders import m17_frame as jmf
from sdrpp_tpu.models import digital as jdigital
from sdrpp_tpu_torch.models import digital as tdigital
from sdrpp_tpu_torch.ops.scans_kernels import _chunk_lanes_for
from sdrpp_tpu_torch.utils.blocks import state_to_numpy

torch.set_num_threads(1)

COSTAS_TOL = 2e-4
# the M&M's symbols where the two loops part: one bank phase step (1/128 of
# a sample) of timing moves a symbol by up to its slope / 128; the loops
# part at most by about two such steps (MM_PART of the peak) and converge
# again within tens of symbols (MM_SPREAD of the peak in RMS)
MM_PART = 2e-2
MM_SPREAD = 2e-3

HRPT = dict(rrc_tap_count=31, rrc_beta=0.6, agc_rate=0.02e-3,
            costas_bandwidth=(0.06 ** 2) / 2.0, omega_gain=(0.01 ** 2) / 4.0,
            mu_gain=0.01, omega_rel_limit=0.005)
M17 = dict(rrc_tap_count=31, rrc_beta=jmf.M17_RRC_ALPHA, omega_gain=1e-6,
           mu_gain=0.01, omega_rel_limit=0.01)


def _psk_iq(n, order, sps, seed, phase=0.3, freq=2e-5):
    """NRZ PSK symbols held ``sps`` samples, a carrier phase and a slow
    frequency offset, a little noise."""
    rng = np.random.default_rng(seed)
    nsym = int(n / sps) + 2
    pts = np.pi / order * (order != 2) + 2 * np.pi / order * np.arange(order)
    sym = np.exp(1j * pts[rng.integers(0, order, nsym)])
    x = sym[(np.arange(n) / sps).astype(np.int64)] * np.exp(
        1j * (phase + freq * np.arange(n)))
    x += 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (0.5 * x).astype(np.complex64)


def _fsk_iq(n, fs, seed):
    """4FSK at 4800 baud, frequency pulses held, 2400 Hz deviation."""
    rng = np.random.default_rng(seed)
    sps = fs / jmf.M17_BAUDRATE
    sym = rng.choice([-1.0, -1 / 3, 1 / 3, 1.0], int(n / sps) + 2)
    wave = sym[(np.arange(n) / sps).astype(np.int64)]
    ph = np.cumsum(2 * np.pi * jmf.M17_DEVIATION * wave / fs)
    return np.exp(1j * ph).astype(np.complex64)


THRESHOLDS = {2: [0.0], 4: [0.0], "4fsk": [-2 / 3, 0.0, 2 / 3]}


def _close(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    tol = {"rrc": 1e-6 * max(np.abs(want).max(), 1e-30), "agc": 1e-5,
           "demod": 1e-6, "costas": COSTAS_TOL}[name]
    assert np.abs(got - want).max() <= tol, name


def _symbols_close(got, want, kind):
    """The M&M's symbols: within MM_SPREAD of the largest in RMS and
    MM_PART at most, and the same hard decision (BPSK sign, QPSK quadrant,
    4FSK level) wherever the JAX symbol lies farther than MM_PART from a
    decision threshold."""
    peak = float(np.abs(want).max())
    d = np.abs(got - want)
    assert d.max() <= MM_PART * peak
    assert np.sqrt(np.mean(d ** 2)) <= MM_SPREAD * peak
    for part in ((want.real, got.real), (want.imag, got.imag)) \
            if np.iscomplexobj(want) else ((want, got),):
        w, g = part
        if not np.any(w):
            continue
        th = np.asarray(THRESHOLDS[kind])
        clear = np.abs(w[:, None] - th).min(axis=1) > MM_PART * peak
        np.testing.assert_array_equal(np.digitize(g[clear], th),
                                      np.digitize(w[clear], th))


def _run(j, t, x, nblk, chunked, stages, kind):
    """Two blocks through both chains: each port stage on the JAX stage's
    input (held to its tolerance), and each whole chain on its own (equal
    symbol counts and hard decisions). Returns both carried states."""
    # the JAX M&M in interpret mode: its chunked branch on the blocks the
    # port chunks, its exact Pallas kernel on the others
    j.recov.interpret = True
    if chunked:
        j.agc.interpret = True
        j.costas.interpret = True

    @jax.jit
    def jstep(st, y):
        st, ins = dict(st), []
        for name in stages:
            ins.append(y)
            st[name], y = getattr(j, name)(st[name], y)
        st["recov"], out = j.recov(st["recov"], y)
        return st, ins + [y], out

    js = jax.jit(j.init_state)()
    ts, ts_whole = t.init_state(), t.init_state()
    for k in range(len(x) // nblk):
        blk = x[k * nblk:(k + 1) * nblk]
        js, ins, (jy, jv) = jstep(js, jnp.asarray(blk))
        for name, y_in, y_next in zip(stages, ins, ins[1:]):
            ts[name], ty = getattr(t, name)(ts[name],
                                            torch.from_numpy(np.array(y_in)))
            _close(name, ty.numpy(), y_next)
        ts["recov"], (ty, tv) = t.recov(ts["recov"],
                                        torch.from_numpy(np.array(ins[-1])))
        jv = np.asarray(jv).astype(bool)
        jy = np.asarray(jy)[jv]
        np.testing.assert_array_equal(tv.numpy(), jv)  # mask or prefix
        _symbols_close(ty[tv].numpy(), jy, kind)
        ts_whole, (wy, wv) = t(ts_whole, torch.from_numpy(blk))
        assert int(wv.sum()) == len(jy)
        _symbols_close(wy[wv].numpy(), jy, kind)
    return jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts)


def _same_tree(jn, tn):
    jl, jdef = jax.tree_util.tree_flatten(jn)
    tl, tdef = jax.tree_util.tree_flatten(tn)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype


def _timing_close(got, want, omega):
    """The carried M&M timing: the sample offset equal, the phase within one
    bank step (1/128 of a sample) and the period within MM_SPREAD of it."""
    assert int(got["offset"]) == int(want["offset"])
    assert abs(float(got["phase"]) - float(want["phase"])) <= 1 / 128
    assert abs(float(got["freq"]) - float(want["freq"])) <= MM_SPREAD * omega


def _phasor_err(a, b):
    return float(np.abs(np.exp(1j * np.float64(a))
                        - np.exp(1j * np.float64(b))))


@pytest.mark.parametrize("order,chunked", [(2, False), (2, True), (4, False),
                                           (4, True)])
def test_psk_demod_matches_jax_over_blocks(order, chunked):
    fs, rate, kw = ((jhrpt.VFO_RATE, jhrpt.SYMBOL_RATE, HRPT) if order == 2
                    else (150000.0, 72000.0, {}))
    nblk = 16384 if chunked else 2000
    x = _psk_iq(2 * nblk, order, fs / rate, 10 + order)
    j = jdigital.PSKDemod(order, rate, fs, **kw)
    t = tdigital.PSKDemod(order, rate, fs, **kw, device="cpu")
    # the JAX loops at the port's warm-ups (four time constants), so both
    # take the same branch and lanes
    j.agc.warmup, j.costas.warmup = t.agc.warmup, t.costas.warmup
    lanes = (_chunk_lanes_for(nblk, t.agc.warmup, t.agc.max_lanes),
             _chunk_lanes_for(nblk, t.costas.warmup, t.costas.max_lanes))
    # HRPT's FastAGC (a warm-up of 200,000) runs exact at any such block
    assert (lanes[1] >= 2 and (lanes[0] >= 2) == (order == 4)) if chunked \
        else lanes == (0, 0)
    jn, tn = _run(j, t, x, nblk, chunked, ("rrc", "agc", "costas"), order)
    _same_tree(jn, tn)
    assert _phasor_err(tn["costas"]["phase"], jn["costas"]["phase"]) \
        <= COSTAS_TOL
    _timing_close(tn["recov"], jn["recov"], fs / rate)
    np.testing.assert_allclose(tn["agc"]["hist"], jn["agc"]["hist"],
                               atol=1e-6)


def test_gfsk_demod_matches_jax_over_blocks():
    fs = 48000.0
    x = _fsk_iq(2 * 12000, fs, 20)
    j = jdigital.GFSKDemod(jmf.M17_BAUDRATE, fs, jmf.M17_DEVIATION, **M17)
    t = tdigital.GFSKDemod(jmf.M17_BAUDRATE, fs, jmf.M17_DEVIATION, **M17,
                           device="cpu")
    jn, tn = _run(j, t, x, 12000, False, ("demod", "rrc"), "4fsk")
    _same_tree(jn, tn)
    _timing_close(tn["recov"], jn["recov"], fs / jmf.M17_BAUDRATE)
    np.testing.assert_allclose(tn["rrc"], jn["rrc"], atol=1e-6)
