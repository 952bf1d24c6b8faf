"""The rest of the DSP library against the JAX package: DecimatingFIR (real
and complex taps), the complex-tap polyphase resampler, FFTPowerDecimator
and CarrierTrackingPLL, each over two blocks with the state carried, on
the same numpy-seeded inputs.

Tolerances, each with its reason:
- DecimatingFIR and the complex-tap resampler: the port's strided conv1d
  (and, for real taps at R >= 8, the decimating-FIR kernel's plain
  version) sums the same float32 products as the JAX polyphase sum in
  another order; on unit-variance noise the outputs agree within 5e-5, the
  tolerance tests/test_fir_resample.py pins against the reference, and the
  carried tails are equal input samples.
- FFTPowerDecimator: both are float32 FFTs (pocketfft in torch, XLA's on
  the JAX side) of the same frames; within 5e-5 of the output's peak, the
  tolerance tests/test_fft_decimator.py pins against the time-domain
  cascade, which the port's block is held to as well.
- CarrierTrackingPLL: the loop's phases round like the PLL's of
  tests/test_torch_scans.py (XLA contracts a*b + c into FMAs, the port
  rounds twice): within 4e-6 rad, a few ulp, which the contracting loop
  does not grow; the mixed output then within 1e-5 of its unit amplitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.ops import fir as jfir
from sdrpp_tpu.ops import resample as jres
from sdrpp_tpu.ops import scans as jscans
from sdrpp_tpu_torch.ops import fir as tfir
from sdrpp_tpu_torch.ops import resample as tres
from sdrpp_tpu_torch.ops import scans as tscans
from sdrpp_tpu_torch.ops import taps as ttaps
from sdrpp_tpu_torch.utils.blocks import state_to_numpy

torch.set_num_threads(1)

FIR_TOL = 5e-5
FFT_TOL = 5e-5
PLL_PHASE_TOL = 4e-6
PLL_OUT_TOL = 1e-5


def _noise(shape, seed, cplx=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64 if cplx else np.float32)


def _run_both(jblk, tblk, blocks):
    """Both blocks over the same host blocks, the state carried; returns
    (JAX outputs, port outputs, JAX final state, port final state) as
    numpy."""
    jf = jax.jit(jblk.__call__)
    js, ts = jblk.init_state(), tblk.init_state()
    jys, tys = [], []
    for b in blocks:
        js, jy = jf(js, jnp.asarray(b))
        ts, ty = tblk(ts, torch.from_numpy(b))
        jys.append(np.asarray(jy))
        tys.append(ty.numpy())
    return (np.concatenate(jys, -1), np.concatenate(tys, -1),
            jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts))


def _complex_taps(m=63, f0=0.11):
    """A low-pass shifted to f0 (cycles a sample): complex taps."""
    lp = ttaps.low_pass(0.05, 0.03, 1.0)[:m].astype(np.float64)
    return (lp * np.exp(2j * np.pi * f0 * np.arange(lp.size))) \
        .astype(np.complex64)


DECIM_CASES = [("real r4", 4, False, True), ("real r8 kernel", 8, False, True),
               ("real r16 f32", 16, False, False),
               ("complex r4", 4, True, True), ("complex r8", 8, True, True),
               ("complex r8 real x", 8, True, False)]


@pytest.mark.parametrize("case", DECIM_CASES, ids=[c[0] for c in DECIM_CASES])
def test_decimating_fir_matches_jax(case):
    _, r, complex_taps, cplx = case
    taps = _complex_taps() if complex_taps else tres.decim_plan(r)[0][1]
    dtype_j = jnp.complex64 if cplx else jnp.float32
    dtype_t = torch.complex64 if cplx else torch.float32
    jblk = jfir.DecimatingFIR(taps, r, dtype=dtype_j, lead_shape=(2,))
    tblk = tfir.DecimatingFIR(taps, r, dtype=dtype_t, lead_shape=(2,),
                              device="cpu")
    n = 96 * r
    x = _noise((2, 2 * n), seed=r + 10 * complex_taps, cplx=cplx)
    jy, ty, js, ts = _run_both(jblk, tblk, [x[:, :n], x[:, n:]])
    assert ty.dtype == jy.dtype and ty.shape == jy.shape == (2, 2 * n // r)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=FIR_TOL)
    np.testing.assert_array_equal(ts, js)


def test_decimating_fir_real_taps_r8_take_the_kernel(monkeypatch):
    """Real taps at R >= 8 on a CPU tensor go through the decimating-FIR
    kernel's wrapper (its plain version there); complex taps do not."""
    from sdrpp_tpu_torch.ops import fir_kernels

    calls = []
    real = fir_kernels.decimating_fir_plain

    def spy(*a):
        calls.append(a[3])
        return real(*a)

    monkeypatch.setattr(fir_kernels, "decimating_fir_plain", spy)
    x = torch.from_numpy(_noise(256, 1))
    for taps in (tres.decim_plan(8)[0][1], _complex_taps()):
        blk = tfir.DecimatingFIR(taps, 8, device="cpu")
        blk(blk.init_state(), x)
    assert calls == [8]  # the real taps' call alone


@pytest.mark.parametrize("interp,decim", [(3, 8), (1, 5), (4, 3)])
def test_complex_tap_polyphase_resampler_matches_jax(monkeypatch, interp,
                                                     decim):
    monkeypatch.setattr(jres, "POLYPHASE_MODE", "zero_stuff")
    taps = _complex_taps(m=48, f0=0.07) * np.float32(interp)
    jblk = jres.PolyphaseResampler(interp, decim, taps)
    tblk = tres.PolyphaseResampler(interp, decim, taps, device="cpu")
    n = 120 * decim
    x = _noise(2 * n, seed=interp * 10 + decim)
    jy, ty, js, ts = _run_both(jblk, tblk, [x[:n], x[n:]])
    assert ty.shape == jy.shape == (2 * n * interp // decim,)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=FIR_TOL * interp)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("ratio,fft_len", [(16, 1 << 14), (32, 1 << 15),
                                           (256, 1 << 16), (256, 1 << 17)])
def test_fft_power_decimator_matches_jax(ratio, fft_len):
    jblk = jres.FFTPowerDecimator(ratio, fft_len=fft_len)
    tblk = tres.FFTPowerDecimator(ratio, fft_len=fft_len, device="cpu")
    assert tblk.block_multiple == jblk.block_multiple
    np.testing.assert_array_equal(tblk.taps, jres.equivalent_decim_taps(ratio))
    n = 2 * tblk.block_multiple  # two segments a block
    x = _noise(2 * n, seed=ratio)
    jy, ty, js, ts = _run_both(jblk, tblk, [x[:n], x[n:]])
    scale = max(float(np.abs(jy).max()), 1.0)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=FFT_TOL * scale)
    np.testing.assert_array_equal(ts, js)
    # and the port's block is the port's time-domain cascade
    pd = tres.PowerDecimator(ratio, device="cpu")
    ps, py0 = pd(pd.init_state(), torch.from_numpy(x[:n]))
    _, py1 = pd(ps, torch.from_numpy(x[n:]))
    py = torch.cat([py0, py1]).numpy()
    np.testing.assert_allclose(ty, py, rtol=0, atol=FFT_TOL * scale)


def test_fft_power_decimator_lead_axes_and_real_input():
    tblk = tres.FFTPowerDecimator(16, fft_len=1 << 14, lead_shape=(3,),
                                  device="cpu")
    jblk = jres.FFTPowerDecimator(16, fft_len=1 << 14, lead_shape=(3,))
    x = _noise((3, tblk.block_multiple), seed=5)
    jy, ty, _, _ = _run_both(jblk, tblk, [x])
    np.testing.assert_allclose(ty, jy, rtol=0, atol=FFT_TOL)
    xr = _noise(tblk.block_multiple, seed=6, cplx=False)
    rb = tres.FFTPowerDecimator(16, torch.float32, fft_len=1 << 14,
                                device="cpu")
    jr = jres.FFTPowerDecimator(16, jnp.float32, fft_len=1 << 14)
    jy, ty, _, _ = _run_both(jr, rb, [xr])
    assert ty.dtype == np.float32
    np.testing.assert_allclose(ty, jy, rtol=0, atol=FFT_TOL)


def test_fft_power_decimator_refuses_unaligned_fft_len():
    """A deliberate difference from the JAX package: an fft_len that is not
    a multiple of ratio x out_multiple raises in the constructor, where the
    JAX block accepts it and fails later in a reshape (or loses the output
    alignment)."""
    with pytest.raises(ValueError, match="multiple of ratio x out_multiple"):
        tres.FFTPowerDecimator(256, fft_len=100000, device="cpu")
    with pytest.raises(ValueError, match="= 48"):
        tres.FFTPowerDecimator(16, fft_len=1 << 14, out_multiple=3,
                               device="cpu")
    with pytest.raises(ValueError, match="too small"):
        tres.FFTPowerDecimator(256, fft_len=1 << 13, device="cpu")
    jres.FFTPowerDecimator(256, fft_len=100096)  # the JAX block takes it
    blk = tres.FFTPowerDecimator(16, fft_len=1 << 14, device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        blk(blk.init_state(), torch.zeros(1000, dtype=torch.complex64))


@pytest.mark.parametrize("lead", [(), (2,)], ids=["stream", "lanes"])
def test_carrier_tracking_pll_matches_jax(lead):
    fs, f0, n = 48000.0, 1500.0, 4096
    rng = np.random.default_rng(8)
    shape = (*lead, 2 * n)
    t = np.arange(2 * n)
    data = rng.standard_normal(shape) * 0.2 + 1.0
    x = (data * np.exp(1j * (2 * np.pi * f0 * t / fs + 0.4))) \
        .astype(np.complex64)
    jblk = jscans.CarrierTrackingPLL(bandwidth=0.02, lead_shape=lead)
    tblk = tscans.CarrierTrackingPLL(bandwidth=0.02, lead_shape=lead,
                                     device="cpu")
    jy, ty, js, ts = _run_both(jblk, tblk, [x[..., :n], x[..., n:]])
    np.testing.assert_allclose(ts["phase"], js["phase"], rtol=0,
                               atol=PLL_PHASE_TOL)
    np.testing.assert_allclose(ts["freq"], js["freq"], rtol=0,
                               atol=PLL_PHASE_TOL)
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(ty, jy, rtol=0, atol=PLL_OUT_TOL * scale)
    # locked: the carrier is gone
    y = ty[..., n:]
    assert np.mean(y.real > 0) > 0.95
    assert np.mean(np.abs(y.imag)) < 0.2 * np.mean(np.abs(y.real))
