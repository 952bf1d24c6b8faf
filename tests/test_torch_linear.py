"""Port parity: the linear DSP blocks, over two blocks with state carried.

Each case feeds the same seeded numpy input to the JAX block (on the CPU)
and to its sdrpp_tpu_torch counterpart, carries each side's own state into
a second block, and compares outputs and final states. Tolerance: float32
arithmetic in another order (FFT overlap-save, strided conv1d instead of
XLA's polyphase sums) -> max |error| <= 2e-5 relative to the output's
peak, far below the 0.1 dB audio bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.ops import convert as jconvert
from sdrpp_tpu.ops import delay as jdelay
from sdrpp_tpu.ops import fir as jfir
from sdrpp_tpu.ops import fm as jfm
from sdrpp_tpu.ops import mix as jmix
from sdrpp_tpu.ops import resample as jresample
from sdrpp_tpu.ops import taps as jtaps
from sdrpp_tpu_torch.ops import convert as tconvert
from sdrpp_tpu_torch.ops import delay as tdelay
from sdrpp_tpu_torch.ops import fir as tfir
from sdrpp_tpu_torch.ops import fm as tfm
from sdrpp_tpu_torch.ops import mix as tmix
from sdrpp_tpu_torch.ops import resample as tresample
from sdrpp_tpu.utils import blocks as jblocks
from sdrpp_tpu_torch.utils import blocks as tblocks
from sdrpp_tpu_torch.utils.blocks import state_to_numpy

torch.set_num_threads(1)
REL_TOL = 2e-5


def _signal(n, complex_, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if complex_:
        return (x + 1j * rng.standard_normal(n)).astype(np.complex64)
    return x.astype(np.float32)


def _close(a, b, tol=REL_TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return
    scale = max(float(np.abs(a).max()), 1e-30)
    err = float(np.abs(a.astype(np.complex128) - b.astype(np.complex128)).max())
    assert err <= tol * scale, (err, scale)


def _trees_close(jstate, tstate):
    jflat = jax.tree_util.tree_leaves(jstate)
    tflat = jax.tree_util.tree_leaves(state_to_numpy(tstate))
    assert len(jflat) == len(tflat)
    for a, b in zip(jflat, tflat):
        assert np.asarray(a).dtype == b.dtype
        _close(a, b)


def _two_blocks(jblock, tblock, n, complex_in, lead=()):
    js, ts = jblock.init_state(), tblock.init_state()
    jstep = jax.jit(jblock)
    for k in range(2):
        x = _signal(int(np.prod(lead)) * n, complex_in, seed=k).reshape(*lead, n)
        js, jy = jstep(js, jnp.asarray(x))
        ts, ty = tblock(ts, torch.from_numpy(x))
        _close(jy, ty.numpy())
    _trees_close(js, ts)


@pytest.mark.parametrize("offset", [300000.0, -700000.0, 1234.5])
def test_frequency_xlator(offset):
    _two_blocks(jmix.FrequencyXlator(offset, 2.4e6),
                tmix.FrequencyXlator(offset, 2.4e6, device="cpu"),
                65440, True)


@pytest.mark.parametrize("case", ["complex_taps", "real_taps_complex_in",
                                  "real_taps_real_in", "single_tap"])
def test_fir(case):
    if case == "complex_taps":
        taps, cin = jtaps.band_pass(18750.0, 19250.0, 3000.0, 240000.0,
                                    complex_taps=True,
                                    odd_tap_count=True), True
    elif case == "single_tap":
        taps, cin = np.ones(1, np.float32), False
    else:
        taps, cin = jtaps.low_pass(15000.0, 4000.0, 240000.0), \
            case == "real_taps_complex_in"
    jd = jnp.complex64 if cin else jnp.float32
    td = torch.complex64 if cin else torch.float32
    _two_blocks(jfir.FIR(taps, dtype=jd, lead_shape=(2,)),
                tfir.FIR(taps, dtype=td, lead_shape=(2,), device="cpu"),
                4000, cin, lead=(2,))


@pytest.mark.parametrize("ratio,complex_in", [(2, True), (4, False),
                                              (5, True)])
def test_decimating_fir(ratio, complex_in):
    taps = jtaps.low_pass(20000.0, 5000.0, 240000.0)
    js = jfir.fir_init_tail(taps.shape[0],
                            jnp.complex64 if complex_in else jnp.float32)
    ts = tfir.fir_init_tail(taps.shape[0],
                            torch.complex64 if complex_in else torch.float32,
                            device="cpu")
    for k in range(2):
        x = _signal(ratio * 700, complex_in, seed=k)
        js, jy = jfir.decimating_fir_correlate(js, jnp.asarray(x), taps, ratio)
        ts, ty = tfir.decimating_fir_correlate(ts, torch.from_numpy(x), taps,
                                               ratio)
        _close(jy, ty.numpy())
    _close(js, ts.numpy())


@pytest.mark.parametrize("filter_on", [True, False])
def test_chain_with_bypass(filter_on):
    taps = jtaps.low_pass(5000.0, 1000.0, 48000.0)
    j = jblocks.Chain([jmix.FrequencyXlator(1234.5, 48000.0),
                       jfir.FIR(taps)])
    t = tblocks.Chain([tmix.FrequencyXlator(1234.5, 48000.0, device="cpu"),
                       tfir.FIR(taps, device="cpu")])
    j.set_enabled(1, filter_on)
    t.set_enabled(1, filter_on)
    _two_blocks(j, t, 3000, True)


@pytest.mark.parametrize("ratio", [2, 8, 64])
def test_power_decimator(ratio):
    _two_blocks(jresample.PowerDecimator(ratio),
                tresample.PowerDecimator(ratio, device="cpu"),
                ratio * 300, True)


@pytest.mark.parametrize("fin,fout,complex_in,lead", [
    (2.4e6, 240e3, True, ()),     # the WFM VFO: /8, then 4/5
    (2.4e6, 48e3, True, ()),      # the USB VFO: /32, then 16/25
    (2.4e6, 24e3, True, ()),      # the AM VFO: /64, then 16/25
    (240e3, 48e3, False, (2,)),   # the WFM stereo AF stage
    (24e3, 48e3, False, ()),      # the AM AF stage: interp 2
])
def test_rational_resampler(fin, fout, complex_in, lead, monkeypatch):
    # the JAX package's zero-stuffed polyphase form (its TPU choice)
    # compiles in a fraction of the CPU-default unrolled grouped form's time
    monkeypatch.setattr(jresample, "POLYPHASE_MODE", "zero_stuff")
    jd = jnp.complex64 if complex_in else jnp.float32
    td = torch.complex64 if complex_in else torch.float32
    j = jresample.RationalResampler(fin, fout, dtype=jd, lead_shape=lead)
    t = tresample.RationalResampler(fin, fout, dtype=td, lead_shape=lead,
                                    device="cpu")
    assert t.block_multiple == j.block_multiple
    _two_blocks(j, t, j.block_multiple * 4, complex_in, lead)


def test_quadrature():
    _two_blocks(jfm.Quadrature(75000.0, 240000.0),
                tfm.Quadrature(75000.0, 240000.0, device="cpu"), 5000, True)


def test_delay():
    _two_blocks(jdelay.Delay(153, dtype=jnp.complex64),
                tdelay.Delay(153, dtype=torch.complex64, device="cpu"),
                1000, True)


def test_convert():
    x = _signal(64, True, 3)
    r = _signal(64, False, 4)
    for jf, tf in [(jconvert.complex_to_real, tconvert.complex_to_real),
                   (jconvert.real_to_complex, tconvert.real_to_complex),
                   (jconvert.complex_to_stereo, tconvert.complex_to_stereo)]:
        arg = r if jf is jconvert.real_to_complex else x
        np.testing.assert_array_equal(np.asarray(jf(jnp.asarray(arg))),
                                      tf(torch.from_numpy(arg)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jconvert.l_r_to_stereo(jnp.asarray(r), jnp.asarray(r))),
        tconvert.l_r_to_stereo(torch.from_numpy(r), torch.from_numpy(r)))
