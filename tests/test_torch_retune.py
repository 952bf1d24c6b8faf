"""Port parity for retuning through state: ``pad_taps_front``,
``RuntimeFIR``, ``DynamicFrequencyXlator``, the dynamic-deviation
``Quadrature``, ``RxVFO(dynamic_offset, dynamic_bandwidth)`` and
RadioChannel's ``retune_state`` / ``set_bandwidth_state`` /
``set_squelch_state`` between blocks (the port cases of
tests/test_runtime_bandwidth.py).

Tolerances, with their reasons:

- ``pad_taps_front``: bit-exact (the same float32 numpy);
- ``RuntimeFIR`` against the port's static ``FIR`` at the same taps:
  within 1e-6 of the output's largest magnitude (the two overlap-save
  FFTs differ only in length); against JAX's ``RuntimeFIR``: within 1e-5;
- ``DynamicFrequencyXlator`` against the port's ``FrequencyXlator`` at
  the same offset: within 1e-5 (the same float64 ramp, from the float32
  pair's sum); against JAX's double-float ramp: within that ramp's own
  5e-3 rad a block (sdrpp_tpu/ops/mix.py:184-186), measured as phase;
- RadioChannel with writes between blocks against JAX making the same
  writes: as tests/test_torch_radio.py, below -40 dB after the first
  quarter and below -60 dB from JAX's carried state;
- the dynamic channel against a static one at the same bandwidth: the
  JAX suite's 5e-4 of full scale after the filters' transient, and after
  set_bandwidth_state its 1e-3 of the channel's full-scale audio.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.models.radio import RadioChannel as JaxRadioChannel
from sdrpp_tpu.ops import fir as jfir
from sdrpp_tpu.ops import mix as jmix
from sdrpp_tpu.ops import resample as jresample
from sdrpp_tpu.ops.fm import Quadrature as JaxQuadrature
from sdrpp_tpu_torch.models.channel import RxVFO
from sdrpp_tpu_torch.models.radio import RadioChannel
from sdrpp_tpu_torch.ops import taps as taps_mod
from sdrpp_tpu_torch.ops.fir import FIR, RuntimeFIR, pad_taps_front
from sdrpp_tpu_torch.ops.fm import Quadrature
from sdrpp_tpu_torch.ops.mix import DynamicFrequencyXlator, FrequencyXlator
from sdrpp_tpu_torch.utils.blocks import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

FS = 960000.0


@pytest.fixture(autouse=True)
def _zero_stuff(monkeypatch):
    monkeypatch.setattr(jresample, "POLYPHASE_MODE", "zero_stuff")


def _rms_db(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref = np.sqrt(np.mean(want ** 2)) + 1e-30
    return 20 * np.log10(np.sqrt(np.mean((got - want) ** 2)) / ref + 1e-30)


def _tone_iq(fs, f_ch, dev, f_aud, n, seed=0):
    t = np.arange(n) / fs
    audio = np.sin(2 * np.pi * f_aud * t)
    ph = 2 * np.pi * f_ch * t + np.cumsum(2 * np.pi * dev * audio / fs)
    rng = np.random.default_rng(seed)
    return (np.exp(1j * ph) + 0.001 * (rng.standard_normal(n)
            + 1j * rng.standard_normal(n))).astype(np.complex64)


@pytest.mark.parametrize("m,max_taps", [(1, 8), (145, 1024), (2049, 2049)])
def test_pad_taps_front_bit_exact(m, max_taps):
    taps = np.random.default_rng(m).standard_normal(m).astype(np.float32)
    got = pad_taps_front(taps, max_taps)
    np.testing.assert_array_equal(got, jfir.pad_taps_front(taps, max_taps))
    assert got.dtype == np.float32 and (got[:max_taps - m] == 0).all()


def test_pad_taps_front_rejects_oversize():
    with pytest.raises(ValueError):
        pad_taps_front(np.ones(300, np.float32), 256)


@pytest.mark.parametrize("dtype", ["complex64", "float32"])
def test_runtime_fir_matches_static_and_jax(dtype):
    t = taps_mod.low_pass(6250.0, 625.0, 48000.0)
    tdt = getattr(torch, dtype)
    fir = FIR(t, dtype=tdt, device="cpu")
    rfir = RuntimeFIR(1024, t, dtype=tdt, device="cpu")
    jrfir = jfir.RuntimeFIR(1024, t, dtype=getattr(jnp, dtype))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(8192)
    if dtype == "complex64":
        x = x + 1j * rng.standard_normal(8192)
    x = x.astype(dtype)
    s1, s2, s3 = fir.init_state(), rfir.init_state(), jrfir.init_state()
    jstep = jax.jit(jrfir)
    for blk in (x[:4096], x[4096:]):
        s1, y1 = fir(s1, torch.from_numpy(blk))
        s2, y2 = rfir(s2, torch.from_numpy(blk))
        s3, y3 = jstep(s3, jnp.asarray(blk))
        scale = np.abs(y1.numpy()).max()
        assert y2.dtype == tdt
        assert np.abs(y2.numpy() - y1.numpy()).max() <= 1e-6 * scale
        assert np.abs(y2.numpy() - np.asarray(y3)).max() <= 1e-5 * scale
    np.testing.assert_array_equal(s2["taps"].numpy(), np.asarray(s3["taps"]))


def test_runtime_fir_taps_write_keeps_the_delay_line():
    """A taps write between blocks: the next block is the static FIR of
    the new taps run over the same history."""
    a = taps_mod.low_pass(6000.0, 600.0, 48000.0)
    b = taps_mod.low_pass(2000.0, 400.0, 48000.0)
    rfir = RuntimeFIR(1024, a, dtype=torch.complex64, device="cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal(8192)
                          + 1j * rng.standard_normal(8192)).astype(np.complex64))
    st, _ = rfir(rfir.init_state(), x[:4096])
    st = dict(st, taps=rfir.taps_state(b))
    _, y = rfir(st, x[4096:])
    fb = FIR(b, dtype=torch.complex64, device="cpu")
    _, want = fb(fb.init_state(), x)
    want = want[4096:]
    assert (y - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("offset", [-123456.7, 1000.0, 0.0])
def test_dynamic_xlator_matches_static_and_jax(offset):
    n = 65536
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n)).astype(
        np.complex64)
    dyn = DynamicFrequencyXlator(offset, FS, device="cpu")
    stat = FrequencyXlator(offset, FS, device="cpu")
    jdyn = jmix.DynamicFrequencyXlator(offset, FS)
    sd, ss, sj = dyn.init_state(), stat.init_state(), jdyn.init_state()
    for k in (0, 1):
        assert set(sd) == set(sj)
        for key in sd:
            assert sd[key].numpy().dtype == np.asarray(sj[key]).dtype
        blk = x[k * n:(k + 1) * n]
        sd, yd = dyn(sd, torch.from_numpy(blk))
        ss, ys = stat(ss, torch.from_numpy(blk))
        sj, yj = jdyn(sj, jnp.asarray(blk))
        assert (yd - ys).abs().max() <= 1e-5
        assert abs(float(sd["phase"]) - float(ss)) <= 1e-5
        # JAX's ramp, as phase against the exact product
        dphi = np.angle(np.asarray(yj) / yd.numpy())
        assert np.abs(dphi).max() <= 5e-3


def test_dynamic_xlator_retune_is_a_state_write():
    dyn = DynamicFrequencyXlator(1000.0, FS, device="cpu")
    st = dyn.init_state()
    st2 = dict(st, **dyn.omega_leaves(-5000.0))
    hi, lo = jmix.DynamicFrequencyXlator(1000.0, FS).offset_state(-5000.0)
    assert float(st2["omega_hi"]) == float(hi)
    assert float(st2["omega_lo"]) == float(lo)
    x = torch.ones(4800, dtype=torch.complex64)
    _, y = dyn(st2, x)
    ref = FrequencyXlator(-5000.0, FS, device="cpu")
    _, want = ref(ref.init_state(), x)
    assert (y - want).abs().max() <= 1e-5


def test_dynamic_quadrature_matches_jax():
    x = _tone_iq(48000.0, 500.0, 3000.0, 700.0, 9600)
    q = Quadrature(6250.0, 48000.0, dynamic_deviation=True, device="cpu")
    jq = JaxQuadrature(6250.0, 48000.0, dynamic_deviation=True)
    st, jst = q.init_state(), jq.init_state()
    assert float(st["inv_dev"]) == float(jst["inv_dev"])
    st, y = q(st, torch.from_numpy(x[:4800]))
    jst, jy = jq(jst, jnp.asarray(x[:4800]))
    st = dict(st, inv_dev=q.inv_dev_state(2000.0))
    jst = dict(jst, inv_dev=jq.inv_dev_state(2000.0))
    assert float(st["inv_dev"]) == float(jst["inv_dev"])
    st, y2 = q(st, torch.from_numpy(x[4800:]))
    jst, jy2 = jq(jst, jnp.asarray(x[4800:]))
    for a, b in ((y, jy), (y2, jy2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_vfo_retune_matches_a_static_vfo():
    """After a retune the dynamic VFO's channel is the static VFO's at the
    new offset, up to the NCO's phase, once the resampler's history holds
    only retuned samples."""
    n = 48000
    x = _tone_iq(FS, 150000.0, 3000.0, 1000.0, 3 * n)
    dyn = RxVFO(FS, 48000.0, 12500.0, -100000.0, dynamic_offset=True,
                device="cpu")
    stat = RxVFO(FS, 48000.0, 12500.0, 150000.0, device="cpu")
    sd, ss = dyn.init_state(), stat.init_state()
    sd, _ = dyn(sd, torch.from_numpy(x[:n]))
    sd = dyn.retune_state(sd, 150000.0)
    for k in (1, 2):
        sd, yd = dyn(sd, torch.from_numpy(x[k * n:(k + 1) * n]))
    for k in (0, 1, 2):
        ss, ys = stat(ss, torch.from_numpy(x[k * n:(k + 1) * n]))
    yd, ys = yd.numpy(), ys.numpy()
    rot = np.vdot(ys, yd) / abs(np.vdot(ys, yd))  # the NCO's phase
    assert np.abs(yd - rot * ys).max() <= 1e-4 * np.abs(ys).max()


def _run(chan, x, nb, writes):
    """Blocks through ``chan`` with ``writes[k](state)`` applied before
    block k; returns (outputs, states) as numpy (either package)."""
    jaxside = isinstance(chan, JaxRadioChannel)
    step = jax.jit(chan) if jaxside else chan
    st = chan.init_state()
    outs, states = [], []
    for k in range(len(x) // nb):
        if k in writes:
            st = writes[k](chan, st)
        blk = x[k * nb:(k + 1) * nb]
        st, y = step(st, jnp.asarray(blk) if jaxside
                     else torch.from_numpy(blk))
        y = y[0] if isinstance(y, tuple) else y
        outs.append(np.asarray(y) if jaxside else y.numpy())
        states.append(jax.tree_util.tree_map(np.asarray, st) if jaxside
                      else state_to_numpy(st))
    return outs, states


WRITES = {
    "retune": (dict(dynamic_offset=True),
               {1: lambda c, s: c.retune_state(s, 45000.0)}),
    "bandwidth": (dict(dynamic_bandwidth=True),
                  {1: lambda c, s: c.set_bandwidth_state(s, 6000.0)}),
    "both": (dict(dynamic_offset=True, dynamic_bandwidth=True),
             {1: lambda c, s: c.retune_state(s, 45000.0),
              2: lambda c, s: c.set_bandwidth_state(s, 9000.0)}),
    "squelch": (dict(squelch_level=-200.0),
                {1: lambda c, s: c.set_squelch_state(s, 20.0)}),
}


# cw has no bandwidth-dependent stage past the VFO: its retune case only
WRITE_CASES = [(m, w) for m in ("nfm", "am", "usb", "wfm") for w in WRITES] \
    + [("cw", "retune")]


@pytest.mark.parametrize("mode,what", WRITE_CASES)
def test_writes_between_blocks_match_jax(mode, what):
    opts, writes = WRITES[what]
    jchan = JaxRadioChannel(mode, FS, offset=30000.0, **opts)
    for name in ("pilot_pll", "audio_agc", "carrier_agc", "agc"):
        loop = getattr(jchan.demod, name, None)
        if loop is not None and hasattr(loop, "interpret"):
            loop.interpret = True
    chan = RadioChannel(mode, FS, offset=30000.0, device="cpu", **opts)
    nb = chan.block_multiple * max(1, 48000 // chan.block_multiple)
    t = np.arange(4 * nb) / FS
    rng = np.random.default_rng(10)
    # an AM carrier (600 Hz) 500 Hz above the first tuning, and an FM
    # station at the retune's 45 kHz: broadcast FM with its 19 kHz pilot
    # (a WFM channel's PLL without a pilot wanders, and then amplifies
    # rounding), narrow FM for the other modes
    if mode == "wfm":
        mpx = 0.4 * np.sin(2 * np.pi * 800.0 * t) \
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
        fm = np.cumsum(2 * np.pi * 75000.0 * mpx / FS)
    else:
        fm = 2.0 * np.sin(2 * np.pi * 800.0 * t)
    x = (0.3 * (1 + 0.5 * np.sin(2 * np.pi * 600.0 * t))
         * np.exp(2j * np.pi * 30500.0 * t)
         + 0.3 * np.exp(1j * (2 * np.pi * 45000.0 * t + fm))
         + 1e-3 * (rng.standard_normal(4 * nb)
                   + 1j * rng.standard_normal(4 * nb))).astype(np.complex64)
    jout, jst = _run(jchan, x, nb, writes)
    out, st = _run(chan, x, nb, writes)
    assert chan.bandwidth == jchan.bandwidth
    got, want = np.concatenate(out[:3]), np.concatenate(jout[:3])
    s = len(want) // 12
    assert _rms_db(got[s:], want[s:]) < -40.0
    for k in writes:
        assert jax.tree_util.tree_structure(st[k]) == \
            jax.tree_util.tree_structure(jst[k])
    # JAX's state after block 3 (the writes in it) carried into the port
    _, y = chan(state_from_numpy(jst[2], "cpu"),
                torch.from_numpy(x[3 * nb:]))
    y = y[0] if isinstance(y, tuple) else y
    assert _rms_db(y.numpy(), jout[3]) < -60.0


@pytest.mark.parametrize("mode,bw", [
    ("nfm", 9000.0), ("am", 8000.0), ("usb", 2400.0), ("wfm", 150000.0),
])
def test_dynamic_channel_matches_static_at_same_bandwidth(mode, bw):
    n = 96000
    iq = _tone_iq(FS, 0.0, bw / 4, 1000.0, 2 * n)
    kw = dict(in_samplerate=FS, offset=0.0, bandwidth=bw, audio_rate=48000.0,
              device="cpu")
    stat = RadioChannel(mode, **kw)
    dyn = RadioChannel(mode, dynamic_bandwidth=True, **kw)
    nb = (n // max(stat.block_multiple, dyn.block_multiple)) * \
        max(stat.block_multiple, dyn.block_multiple)

    def run(chan):
        st = chan.init_state()
        outs = []
        for blk in (iq[:nb], iq[nb:2 * nb]):
            st, y = chan(st, torch.from_numpy(blk))
            outs.append(y.numpy())
        return np.concatenate(outs, axis=0)

    y_s, y_d = run(stat), run(dyn)
    assert y_s.shape == y_d.shape
    cut = len(y_s) // 8
    scale = max(np.abs(y_s).max(), 1e-6)
    assert np.abs(y_s[cut:] - y_d[cut:]).max() <= 5e-4 * scale


def test_set_bandwidth_takes_effect_and_tracks_static():
    f_aud = 6000.0  # inside the 16 kHz audio band, outside the 4 kHz one
    n = 96000
    iq = _tone_iq(FS, 0.0, 4000.0, f_aud, 4 * n)
    dyn = RadioChannel("nfm", FS, bandwidth=16000.0, dynamic_bandwidth=True,
                       device="cpu")
    nb = (n // dyn.block_multiple) * dyn.block_multiple
    st = dyn.init_state()
    st, y_wide = dyn(st, torch.from_numpy(iq[:nb]))
    st = dyn.set_bandwidth_state(st, 4000.0)
    st, _ = dyn(st, torch.from_numpy(iq[nb:2 * nb]))
    st, y_narrow = dyn(st, torch.from_numpy(iq[2 * nb:3 * nb]))
    assert y_narrow.abs().max() < 0.2 * y_wide[2000:].abs().max()
    stat = RadioChannel("nfm", FS, bandwidth=4000.0, device="cpu")
    sst = stat.init_state()
    for i in range(4):
        sst, y_stat = stat(sst, torch.from_numpy(iq[i * nb:(i + 1) * nb]))
    _, y_dyn = dyn(st, torch.from_numpy(iq[3 * nb:4 * nb]))
    # the narrowed channel's output is the cut tone's residue (1e-4): held
    # against the channel's full scale, the wide block's tone
    scale = float(y_wide.abs().max())
    assert float((y_dyn - y_stat).abs().max()) <= 1e-3 * scale


def test_set_bandwidth_clamps_and_keeps_the_state_tree():
    dyn = RadioChannel("nfm", FS, bandwidth=12500.0, dynamic_bandwidth=True,
                       device="cpu")
    st = dyn.init_state()
    dyn.set_bandwidth_state(st, 1.0)
    assert dyn.bandwidth == 1000.0
    st2 = dyn.set_bandwidth_state(st, 1e9)
    assert dyn.bandwidth == dyn.if_rate
    a, b = state_to_numpy(st), state_to_numpy(st2)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    assert [x.shape for x in jax.tree_util.tree_leaves(a)] == \
        [x.shape for x in jax.tree_util.tree_leaves(b)]
    with pytest.raises(ValueError):
        RadioChannel("nfm", FS, device="cpu").set_bandwidth_state(
            st, 9000.0)
