"""Port parity: affine scans, DC blocker, de-emphasis, squelch and the
loop-scan kernels' plain versions and chunk-parallel loops.

The JAX side runs as the JAX package's own tests run it on the CPU: the
Pallas loop kernels in interpret mode (as tests/test_scans_chunked.py
does). The port's loop wrappers, given CPU tensors, run their plain
PyTorch versions, whose arithmetic is the CUDA kernel's operation for
operation. Tolerances, with their reasons:

- kernel bodies (plain lane/single scan vs the Pallas bodies): the same
  float32 operations in the same order and IEEE division, but XLA's CPU
  backend contracts the bodies' a*b + c into fused multiply-adds (a
  float64 emulation with FMAs reproduces the interpret-mode PLL exactly;
  without, 80 of 2400 samples differ by an ulp), while the port rounds
  twice, as its CUDA kernel does (built with --fmad=false) -> PLL phases
  within 4e-6 rad, AGC gains within 1e-6 relative: a few ulp, which the
  contracting loops do not grow;
- affine scans: a blocked matrix form vs lax.associative_scan. Near
  a = 1 (the 2.4 Msps DC blocker: a = 1 - 2.1e-5) the associative scan's
  float32 products drift (3.5e-6 absolute on a 0.1 offset over 20000
  samples, measured against float64), the blocked form does not (2e-8):
  parity within 1e-4 of the peak, and the port at least as close to a
  float64 recurrence as the JAX scan;
- chunk-parallel loops: the lane seeds come from atan2/abs/mean, which
  round differently in XLA and torch; the loops then contract the
  difference -> PLL phasors within 1e-5 (the JAX suite pins chunked vs
  exact at 1e-4), AGC gains within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.ops import scans as jscans
from sdrpp_tpu.ops import scans_pallas as SP
from sdrpp_tpu_torch.ops import scans as tscans
from sdrpp_tpu_torch.ops import scans_kernels as K
from sdrpp_tpu_torch.utils.blocks import state_to_numpy

torch.set_num_threads(1)

FS_IF = 240000.0


def _hz(f, fs=FS_IF):
    return np.float32(2.0 * np.pi * f / fs)


def _rel_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(a).max()), 1e-30)
    err = float(np.abs(a.astype(np.complex128) - b.astype(np.complex128)).max())
    assert err <= tol * scale, (err, scale)


def _phasor_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(np.exp(1j * a) - np.exp(1j * b)).max())


# ---------------------------------------------------------------------------
# affine scans and the blocks built on them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a,n,complex_", [
    (1.0 - 50.0 / 2.4e6, 5000, True),   # the 2.4 Msps DC blocker
    (0.7059, 300, False),               # 50 us de-emphasis at 48 kHz
    (0.99, 256, False),                 # exactly one scan block
    (0.999, 70000, False),              # three levels of blocks
])
def test_affine_scan(a, n, complex_):
    rng = np.random.default_rng(0)
    b = rng.standard_normal((2, n)).astype(np.float32)
    y0 = rng.standard_normal(2).astype(np.float32)
    if complex_:
        b = (b + 1j * rng.standard_normal((2, n))).astype(np.complex64)
        y0 = (y0 + 1j * rng.standard_normal(2)).astype(np.complex64)
    a = np.float32(a)
    want = np.asarray(jax.jit(jscans.affine_scan)(a, jnp.asarray(b),
                                                  jnp.asarray(y0)))
    got = tscans.affine_scan(a, torch.from_numpy(b),
                             torch.from_numpy(y0)).numpy()
    _rel_close(want, got, 1e-4)
    truth = np.empty(b.shape, np.complex128)
    acc = y0.astype(np.complex128)
    for i in range(n):
        acc = float(a) * acc + b[:, i]
        truth[:, i] = acc
    assert np.abs(got - truth).max() <= np.abs(want - truth).max() + 1e-6


def _two_blocks(jblock, tblock, blocks, tol=1e-4):
    js, ts = jblock.init_state(), tblock.init_state()
    jstep = jax.jit(jblock)
    for x in blocks:
        js, jy = jstep(js, jnp.asarray(x))
        ts, ty = tblock(ts, torch.from_numpy(x))
        _rel_close(jy, ty.numpy(), tol)
    for a, b in zip(jax.tree_util.tree_leaves(js),
                    jax.tree_util.tree_leaves(state_to_numpy(ts))):
        _rel_close(a, b, tol)
    return js, ts


def test_dc_blocker_2p4msps():
    rng = np.random.default_rng(1)
    x = (0.3 + 0.1j + 0.05 * (rng.standard_normal(40000)
                              + 1j * rng.standard_normal(40000))
         ).astype(np.complex64)
    _two_blocks(jscans.DCBlocker(50.0 / 2.4e6),
                tscans.DCBlocker(50.0 / 2.4e6, device="cpu"),
                [x[:20000], x[20000:]])


@pytest.mark.parametrize("stereo", [False, True])
def test_deemphasis(stereo):
    rng = np.random.default_rng(2)
    shape = (2, 3000, 2) if stereo else (2, 3000)
    x = rng.standard_normal(shape).astype(np.float32)
    _two_blocks(jscans.Deemphasis(50e-6, 48000.0, stereo=stereo),
                tscans.Deemphasis(50e-6, 48000.0, stereo=stereo,
                                  device="cpu"), list(x))


def test_squelch_state_machine():
    rng = np.random.default_rng(3)
    # 4 sub-blocks per block; levels walk across the -30 dB threshold so
    # that mute, hysteresis and the 10-frame unmute count all engage
    amps = np.repeat([1e-3] * 4 + [1e-1] * 12 + [1e-2] * 2 + [1e-1] * 6, 250)
    x = (amps * (rng.standard_normal(amps.size)
                 + 1j * rng.standard_normal(amps.size))).astype(np.complex64)
    blocks = list(x.reshape(-1, 1000))
    js, ts = _two_blocks(jscans.Squelch(-30.0, sub_blocks=4),
                         tscans.Squelch(-30.0, sub_blocks=4, device="cpu"),
                         blocks, tol=0.0)
    assert bool(js["mute"]) == bool(ts["mute"])
    assert int(js["cnt"]) == int(ts["cnt"])


# ---------------------------------------------------------------------------
# the loop-scan kernels' plain versions vs the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

PLL_ARGS = (SP.PLL(25000.0 / FS_IF).alpha, SP.PLL(25000.0 / FS_IF).beta,
            _hz(18750.0), _hz(19250.0))
AGC_ARGS = (1.0, 50.0 / 48000.0, 5.0 / 48000.0, 10e6, 10.0)


def _pilot_phases(n, lanes, seed):
    rng = np.random.default_rng(seed)
    ph = (2 * np.pi * 19000.0 * np.arange(n)[:, None] / FS_IF
          + rng.uniform(-np.pi, np.pi, lanes)[None, :]
          + 0.3 * rng.standard_normal((n, lanes)))
    return np.angle(np.exp(1j * ph)).astype(np.float32)


def _amps(n, lanes, seed):
    rng = np.random.default_rng(seed)
    env = 0.05 * (1.0 + 0.5 * np.sin(np.arange(n) / 40.0))[:, None]
    a = np.abs(env * rng.standard_normal((n, lanes))).astype(np.float32)
    a[::37] = 0.0  # zero samples take the `nonzero` branch
    return a


def _suffix_max_np(a):
    return np.flip(np.maximum.accumulate(np.flip(a, 0), axis=0), 0).copy()


def _kernel_case(body, lanes):
    n = 300
    if body == "pll":
        make = SP._pll_make_body(*PLL_ARGS)
        tbody = K.pll_body(*PLL_ARGS)
        streams = [_pilot_phases(n, lanes, 4)]
        state = np.stack([np.linspace(-3, 3, lanes),
                          np.full(lanes, _hz(19000.0))]).astype(np.float32)
    else:
        make = SP._agc_make_body(*AGC_ARGS)
        tbody = K.agc_body(*AGC_ARGS)
        a = _amps(n, lanes, 5)
        streams = [a, _suffix_max_np(a)]
        state = np.stack([np.full(lanes, 0.04),
                          np.full(lanes, 25.0)]).astype(np.float32)
    return make, tbody, state, streams


def _body_close(body, jax_result, torch_result):
    for j, t in zip(jax_result, torch_result):
        j, t = np.asarray(j), t.numpy()
        if body == "pll":  # wrapped phases: compare phasors
            assert _phasor_err(j, t) < 4e-6
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


@pytest.mark.parametrize("body", ["pll", "agc"])
def test_lane_scan_plain_matches_pallas(body):
    make, tbody, state, streams = _kernel_case(body, lanes=8)
    jout, jfin = SP._lane_scan_call(make, jnp.asarray(state),
                                    [jnp.asarray(s) for s in streams],
                                    streams[0].shape[0], interpret=True)
    tout, tfin = K.lane_scan(tbody, torch.from_numpy(state),
                             [torch.from_numpy(s) for s in streams])
    _body_close(body, (jout, jfin), (tout, tfin))


@pytest.mark.parametrize("body", ["pll", "agc"])
def test_single_scan_plain_matches_pallas(body):
    make, tbody, state, streams = _kernel_case(body, lanes=1)
    state, streams = state[:, 0], [s[:, 0].copy() for s in streams]
    jout, jfin = SP._smem_scan_call(make, jnp.asarray(state),
                                    [jnp.asarray(s) for s in streams],
                                    streams[0].shape[0], interpret=True)
    tout, tfin = K.single_scan(tbody, torch.from_numpy(state),
                               [torch.from_numpy(s) for s in streams])
    _body_close(body, (jout, jfin), (tout, tfin))


def test_valid_rows_do_not_advance_the_carry():
    _, tbody, state, streams = _kernel_case("agc", lanes=4)
    s = [torch.from_numpy(x) for x in streams]
    st = torch.from_numpy(state)
    out, fin = K.lane_scan(tbody, st, s, valid=120)
    ref_out, ref_fin = K.lane_scan(tbody, st, [x[:120] for x in s])
    assert torch.equal(out[:120], ref_out) and torch.equal(fin, ref_fin)
    assert not out[120:].any()


def test_wrappers_run_plain_on_cpu_and_raise_elsewhere():
    _, tbody, state, streams = _kernel_case("pll", lanes=2)
    before = (K.lane_scan.launches, K.single_scan.launches)
    K.lane_scan(tbody, torch.from_numpy(state),
                [torch.from_numpy(s) for s in streams])
    assert (K.lane_scan.launches, K.single_scan.launches) == before
    meta = torch.empty((2, 2), device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        K.lane_scan(tbody, meta, [torch.empty((300, 2), device="meta")])
    with pytest.raises(ValueError):
        K.lane_scan(tbody, torch.zeros(3, 2), [torch.zeros(300, 2)])


# ---------------------------------------------------------------------------
# chunk-parallel loops and loop classes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,warmup,max_lanes,channels", [
    (65440, 128, 512, 1),    # the slice's WFM pilot PLL: K = 128
    (13088, 2048, 512, 1),   # the slice's USB AGC: K = 6
    (6544, 2048, 512, 1),    # the slice's AM audio AGC: exact
    (26080, 128, 512, 1), (2608, 2048, 512, 1), (96000, 128, 512, 4),
    (16384, 512, 512, 1), (24000, 2048, 512, 1),
])
def test_chunk_lanes_for_matches_jax(n, warmup, max_lanes, channels):
    assert K._chunk_lanes_for(n, warmup, max_lanes, channels) == \
        SP._chunk_lanes_for(n, warmup, max_lanes, channels)


def _pilot_tone(n, seed):
    rng = np.random.default_rng(seed)
    ph = 2 * np.pi * 19000.0 * np.arange(n) / FS_IF + 0.3
    return (np.exp(1j * ph) + 0.01 * (rng.standard_normal(n)
            + 1j * rng.standard_normal(n))).astype(np.complex64)


def test_pll_phases_chunked_matches_jax():
    n, W, Kl = 4096, 64, 16
    x = _pilot_tone(n + W, 6)
    ph = np.angle(x).astype(np.float32)
    hist, blk = ph[:W], ph[W:]
    j = SP.pll_phases_chunked(jnp.asarray(blk), jnp.asarray(hist),
                              *PLL_ARGS, lanes_k=Kl, interpret=True)
    t = K.pll_phases_chunked(torch.from_numpy(blk), torch.from_numpy(hist),
                             *PLL_ARGS, lanes_k=Kl)
    assert _phasor_err(j[0], t[0].numpy()) < 1e-5
    np.testing.assert_array_equal(np.asarray(j[1]), t[1].numpy())
    assert _phasor_err(j[2], t[2].numpy()) < 1e-5
    assert abs(float(j[3]) - float(t[3])) < 1e-6


def test_agc_gains_chunked_matches_jax():
    n, W, Kl = 4096, 256, 8
    a = _amps(n + W, 1, 7)[:, 0]
    hist, blk = a[:W], a[W:]
    j = SP.agc_gains_chunked(jnp.asarray(blk), jnp.asarray(hist), *AGC_ARGS,
                             lanes_k=Kl, interpret=True)
    t = K.agc_gains_chunked(torch.from_numpy(blk), torch.from_numpy(hist),
                            *AGC_ARGS, lanes_k=Kl)
    _rel_close(j[0], t[0].numpy(), 1e-5)
    np.testing.assert_array_equal(np.asarray(j[1]), t[1].numpy())
    _rel_close(j[2], t[2].numpy(), 1e-5)
    _rel_close(j[3], t[3].numpy(), 1e-5)


@pytest.mark.parametrize("n", [4096, 200])  # chunked (K = 16), exact
def test_pll_chunked_two_blocks(n):
    kw = dict(bandwidth=25000.0 / FS_IF, init_phase=0.0,
              init_freq=_hz(19000.0), min_freq=_hz(18750.0),
              max_freq=_hz(19250.0), warmup=64, max_lanes=16)
    j = SP.PLLChunked(**kw, interpret=True)
    t = K.PLLChunked(**kw, device="cpu")
    x = _pilot_tone(2 * n, 8)
    js, ts = j.init_state(), t.init_state()
    np.testing.assert_array_equal(np.asarray(js["hist"]), ts["hist"].numpy())
    for k in range(2):
        blk = x[k * n:(k + 1) * n]
        js, jy = j(js, jnp.asarray(blk))
        ts, ty = t(ts, torch.from_numpy(blk))
        assert float(np.abs(np.asarray(jy) - ty.numpy()).max()) < 1e-5
    assert _phasor_err(js["phase"], ts["phase"].numpy()) < 1e-5
    assert abs(float(js["freq"]) - float(ts["freq"])) < 1e-6


@pytest.mark.parametrize("n", [4096, 300])  # chunked (K = 8), exact
def test_agc_chunked_two_blocks(n):
    j = SP.AGCChunked(*AGC_ARGS, float("inf"), warmup=256, max_lanes=8,
                      interpret=True)
    t = K.AGCChunked(*AGC_ARGS, float("inf"), warmup=256, max_lanes=8,
                     device="cpu")
    rng = np.random.default_rng(9)
    env = 0.05 * (1.0 + 0.5 * np.sin(np.arange(2 * n) / 300.0))
    x = (env * rng.standard_normal(2 * n)).astype(np.float32)
    js, ts = j.init_state(), t.init_state()
    for k in range(2):
        blk = x[k * n:(k + 1) * n]
        js, jy = j(js, jnp.asarray(blk))
        ts, ty = t(ts, torch.from_numpy(blk))
        _rel_close(jy, ty.numpy(), 1e-5)
    for key in ("amp", "gain", "hist"):
        _rel_close(js[key], ts[key].numpy(), 1e-5)
