"""The ATV and DAB OFDM decoders, the modulators and the reshapers of the
port against the JAX package, on the same numpy-seeded inputs, with the
state carried over two blocks; and the JAX tests' own cases
(tests/test_atv.py, test_ofdm.py, test_modulators.py) on the port.

The walks are checked here through their plain versions (the CPU path of
``ops.sync_walks``); chip_smoke.py holds the CUDA kernels to these.

Tolerances, each with its reason:
- LineSync: the per-line update (pos, freq, locked) rounds in JAX's
  float32 order, but XLA sums the 44-sample half of the sync region in an
  order of its own (its vectorised reduction), which the port does not
  copy; the port sums it in a fixed tree, the same in the kernel. An ulp
  of difference in the error moves pos by an ulp, and a sample whose
  fractional position sits on a boundary of the 128 interpolation phases
  can take the neighbouring phase: 1/128 of a sample step, within
  LINE_TOL = 2e-2 on the test ramp's steepest edge (the valid line count
  is exact, pos within 5e-2 of a sample, freq within 1e-5, locked equal).
- ChromaPLL: cos / sin / atan2 of numpy and of XLA differ by ulps; the
  frequency carry agrees within PLL_TOL = 3.6e-6 rad of a locked tone
  (the tolerance tests/test_torch_scans.py pins for the PLLs); the phase
  carry is wrapped from the free run past the burst, ~60 rad on the test's
  256-sample lines, where an ulp is 3.8e-6: within PHASE_TOL = 1.6e-5
  (4 ulps there); the free-run mixes evaluate cos / sin at phases up to ~80 rad (a line of
  256 samples at 0.3 rad a sample), where one ulp of the argument is
  7.6e-6, on samples of magnitude up to ~1.5: MIX_TOL = 5e-5.
- CyclicSync: emits (positions and valid count) exact; the symbols are
  copies of input samples and equal exactly when the emits do; the
  correlation is a float32 cumsum in both (torch accumulates it in
  float64 on the CPU, XLA in float32), so avg / peak / last agree within
  CORR_TOL = 1e-4 relative.
- KeepSkipReshaper, Packer: exact (gathers).
- QuadratureMod, GFSKMod: the phase is a float32 cumsum whose sums round
  in another order: within MOD_TOL = 2e-4 of the unit-amplitude output
  (the JAX test's oracle tolerance is 2e-3); PSKMod is the RRC resampler
  (tests/test_torch_psk_gfsk.py's tolerance, 5e-5).
- ATVDecoder: the same vertical scan; frames within 1 LSB (a line's uint8
  pixels round the same float32 values) where the chroma PLL locks. The
  decoder's own ChromaPLL (bandwidth 0.01) does not lock at 720-sample
  lines, in JAX and the port alike (ROADMAP C): its free run of ~700
  samples a line multiplies the loop's frequency gain past stability, and
  the phases of the two packages part chaotically from their first ulp of
  difference. The frame comparison therefore gives both decoders the same
  ChromaPLL at LOCKING_BW = 0.003, where it locks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.decoders import atv as jatv
from sdrpp_tpu.ops import modulators as jmod
from sdrpp_tpu.ops import ofdm as jofdm
from sdrpp_tpu.ops import reshape as jreshape
from sdrpp_tpu_torch.decoders import atv as tatv
from sdrpp_tpu_torch.ops import modulators as tmod
from sdrpp_tpu_torch.ops import ofdm as tofdm
from sdrpp_tpu_torch.ops import reshape as treshape
from sdrpp_tpu_torch.ops import sync_walks
from sdrpp_tpu_torch.utils.blocks import state_to_numpy

torch.set_num_threads(1)

LINE_TOL = 2e-2
POS_TOL = 5e-2
FREQ_TOL = 1e-5
PLL_TOL = 3.6e-6
PHASE_TOL = 1.6e-5
MIX_TOL = 5e-5
CORR_TOL = 1e-4
MOD_TOL = 2e-4
RRC_TOL = 5e-5
LOCKING_BW = 0.003
LINE_LEN = tatv.LINE_LEN
CPU = "cpu"


def make_video(n_lines, sps=2.0, sync_depth=-0.3, phase_offset=0.0, seed=0):
    """tests/test_atv.py's composite-ish video: each line a sync tip and a
    ramp, at ``sps`` input samples per output sample."""
    rng = np.random.default_rng(seed)
    line_out = np.zeros(LINE_LEN, np.float32)
    line_out[:71] = sync_depth
    line_out[71:] = 0.5 * np.linspace(0, 1, LINE_LEN - 71)
    line_out[LINE_LEN - 17:] = sync_depth
    n_in = int(n_lines * LINE_LEN * sps)
    t = np.arange(n_in) / sps + phase_offset
    idx = np.mod(np.floor(t).astype(int), LINE_LEN)
    sig = line_out[idx] + 0.01 * rng.standard_normal(n_in)
    return sig.astype(np.float32)


def make_ofdm_stream(n_syms, fft_len=256, cp_len=32, seed=0):
    """tests/test_ofdm.py's random OFDM symbols with cyclic prefixes."""
    rng = np.random.default_rng(seed)
    syms = []
    for _ in range(n_syms):
        spec = rng.standard_normal(fft_len) + 1j * rng.standard_normal(fft_len)
        td = np.fft.ifft(spec)
        td = td / np.sqrt(np.mean(np.abs(td) ** 2))
        syms.append(np.concatenate([td[-cp_len:], td]))
    return np.concatenate(syms).astype(np.complex64)


def burst_lines(n_lines=30, line_len=256, bs=20, be=60, f_sub=0.3, seed=1):
    """tests/test_atv.py's lines with a colour burst at a fixed phase."""
    rng = np.random.default_rng(seed)
    lines = np.zeros((n_lines, line_len), np.complex64)
    k = np.arange(line_len)
    for i in range(n_lines):
        phase0 = f_sub * (i * line_len + k)
        content = 0.3 * (rng.standard_normal(line_len)
                         + 1j * rng.standard_normal(line_len))
        ln = content * np.exp(1j * phase0)
        ln[bs:be] = np.exp(1j * phase0)[bs:be]
        lines[i] = ln
    return lines


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- LineSync

LINE_CASES = {
    "atv": dict(kw=dict(omega=2.0, omega_gain=1e-6, mu_gain=1.0,
                        omega_rel_limit=0.05, sync_level=-0.03),
                video=dict(n_lines=120, sps=2.0004, phase_offset=10.0)),
    "fast_loop": dict(kw=dict(omega=2.0, omega_gain=1e-4, mu_gain=0.2,
                              omega_rel_limit=0.02),
                      video=dict(n_lines=60, sps=2.0, phase_offset=55.0)),
}


@pytest.mark.parametrize("case", sorted(LINE_CASES))
def test_line_sync_matches_jax_over_two_blocks(case):
    c = LINE_CASES[case]
    x = make_video(**c["video"])
    jl = jatv.LineSync(**c["kw"])
    tl = tatv.LineSync(**c["kw"], device=CPU)
    jf = jax.jit(jl.__call__)
    js, ts = jl.init_state(), tl.init_state()
    half = len(x) // 2
    for blk in (x[:half], x[half:]):
        js, (jlines, jvalid) = jf(js, jnp.asarray(blk))
        ts, (tlines, tvalid) = tl(ts, torch.from_numpy(blk))
        np.testing.assert_array_equal(np.asarray(jvalid), tvalid.numpy())
        np.testing.assert_allclose(tlines.numpy(), np.asarray(jlines),
                                   atol=LINE_TOL, rtol=0)
    jsn, tsn = _np(js), state_to_numpy(ts)
    assert set(jsn) == set(tsn)
    np.testing.assert_array_equal(jsn["tail"], tsn["tail"])
    assert abs(float(jsn["pos"]) - float(tsn["pos"])) <= POS_TOL
    assert abs(float(jsn["freq"]) - float(tsn["freq"])) <= FREQ_TOL
    assert bool(jsn["locked"]) == bool(tsn["locked"])
    for k in jsn:
        assert jsn[k].shape == tsn[k].shape and jsn[k].dtype == tsn[k].dtype


def test_line_sync_locks_and_aligns():
    """tests/test_atv.py::test_line_sync_locks_and_aligns on the port."""
    x = make_video(120, sps=2.0004, phase_offset=10.0)
    ls = tatv.LineSync(omega=2.0, omega_gain=1e-6, mu_gain=1.0,
                       omega_rel_limit=0.05, sync_level=-0.03, device=CPU)
    st, (lines, valid) = ls(ls.init_state(), torch.from_numpy(x))
    nv = int(valid.sum())
    assert nv >= 110
    lines = lines.numpy()[:nv]
    assert bool(st["locked"])
    late = lines[-10:]
    assert np.mean(late[:, :27] < -0.1) > 0.7
    assert np.mean(late[:, 200:600] > -0.05) > 0.9


def test_line_sync_multiblock():
    """tests/test_atv.py::test_line_sync_multiblock on the port."""
    x = make_video(30, sps=2.0, phase_offset=55.0)
    ls = tatv.LineSync(omega=2.0, omega_gain=1e-4, mu_gain=0.2,
                       omega_rel_limit=0.02, device=CPU)
    st = ls.init_state()
    total = 0
    half = len(x) // 2
    for blk in (x[:half], x[half:]):
        st, (lines, valid) = ls(st, torch.from_numpy(blk))
        total += int(valid.sum())
    assert abs(total - 30) <= 3


def test_line_sync_sum_tree_is_the_kernels():
    """tree_sum44 pairs v[i] with v[i + 32], then halves: the order the
    kernel's warp shuffles take (csrc/sync_walk.cu tree44)."""
    rng = np.random.default_rng(3)
    v = (rng.standard_normal(44) * np.exp(3 * rng.standard_normal(44))) \
        .astype(np.float32)
    s = list(np.concatenate([v, np.zeros(20, np.float32)]))
    s = [np.float32(s[i] + s[i + 32]) for i in range(32)]
    for off in (16, 8, 4, 2, 1):
        s = [np.float32(s[i] + s[i + off]) for i in range(off)]
    assert float(sync_walks.tree_sum44(torch.from_numpy(v))) == float(s[0])


# --------------------------------------------------------------- ChromaPLL

def test_chroma_pll_matches_jax_over_two_blocks():
    lines = burst_lines()
    kw = dict(bandwidth=0.05, line_len=256, burst_start=20, burst_end=60,
              ref_phase=0.0, init_freq=0.3 * 0.98, min_freq=0.3 * 0.9,
              max_freq=0.3 * 1.1)
    jp, tp = jatv.ChromaPLL(**kw), tatv.ChromaPLL(**kw, device=CPU)
    jf = jax.jit(jp.__call__)
    js, ts = jp.init_state(), tp.init_state()
    rng = np.random.default_rng(2)
    refs = rng.uniform(-1, 1, len(lines)).astype(np.float32)
    for sl in (slice(0, 15), slice(15, 30)):
        js, jout = jf(js, jnp.asarray(lines[sl]), jnp.asarray(refs[sl]))
        ts, tout = tp(ts, torch.from_numpy(lines[sl]),
                      torch.from_numpy(refs[sl]))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=MIX_TOL, rtol=0)
    assert abs(float(js["phase"]) - float(ts["phase"])) <= PHASE_TOL
    assert abs(float(js["freq"]) - float(ts["freq"])) <= PLL_TOL


def test_chroma_pll_locks_burst():
    """tests/test_atv.py::test_chroma_pll_locks_burst on the port."""
    lines = burst_lines()
    pll = tatv.ChromaPLL(bandwidth=0.05, line_len=256, burst_start=20,
                         burst_end=60, ref_phase=0.0, init_freq=0.3 * 0.98,
                         min_freq=0.3 * 0.9, max_freq=0.3 * 1.1, device=CPU)
    st, out = pll(pll.init_state(), torch.from_numpy(lines))
    out = out.numpy()
    assert np.abs(np.angle(out[-5:, 20:60])).mean() < 0.2
    assert abs(float(st["freq"]) - 0.3) < 0.01


def test_frame_assembler_matches_jax():
    """tests/test_atv.py's vsync / rollover case through both classes."""
    normal = np.full(LINE_LEN, 0.3, np.float32)
    full_sync = np.full(LINE_LEN, -0.3, np.float32)
    half_sync = normal.copy()
    half_sync[:306] = -0.3
    lines = np.stack([normal] * 10 + [full_sync] * 2 + [half_sync]
                     + [normal] * 2)
    rng = np.random.default_rng(4)
    mixed = (rng.uniform(-0.2, 1.2, (jatv.FRAME_LINES, LINE_LEN))
             + 1j * rng.uniform(-0.2, 1.2, (jatv.FRAME_LINES, LINE_LEN))) \
        .astype(np.complex64)
    outs = []
    for mod in (jatv, tatv):
        asm = mod.FrameAssembler(sync_level=-0.06)
        a = asm.plan(lines)
        b = asm.plan(np.tile(normal, (mod.FRAME_LINES, 1)))
        asm.commit(mixed, b[0], b[2])
        outs.append((a, b, asm.take_frames(), asm.ypos, asm.even_frame))
    (ja, jb, jfr, jy, je), (ta, tb, tfr, ty, te) = outs
    for x, y in zip(ja + jb, ta + tb):
        np.testing.assert_array_equal(x, y)
    assert len(jfr) == len(tfr) == 1 and (jy, je) == (ty, te)
    np.testing.assert_array_equal(jfr[0], tfr[0])
    assert tfr[0].shape == (tatv.FRAME_LINES, LINE_LEN, 2)


def _atv_iq(n_lines=80, fs=tatv.SAMPLE_RATE):
    """tests/test_atv.py's FM-modulated composite video with a chroma
    carrier over the active region."""
    line = np.zeros(LINE_LEN, np.float32)
    line[:71] = -0.3
    line[LINE_LEN - 17:] = -0.3
    line[71:LINE_LEN - 17] = 0.2
    video = np.tile(line, n_lines)
    t = np.arange(len(video))
    w0 = 2 * np.pi * tatv.CHROMA_SUBCARRIER / fs
    mask = np.zeros(LINE_LEN, bool)
    mask[tatv.BURST_START:LINE_LEN - 17] = True
    video = video + 0.15 * np.cos(w0 * t) * np.tile(mask, n_lines)
    dev = fs / 2.0
    return np.exp(1j * np.cumsum(2 * np.pi * dev * video / fs)) \
        .astype(np.complex64)


def _with_pll(dec, mod, bandwidth, **kw):
    """Give ``dec`` (a decoder of ``mod``) a ChromaPLL of ``bandwidth`` at
    the decoder's own subcarrier settings."""
    w0 = 2.0 * np.pi * mod.CHROMA_SUBCARRIER / dec.samplerate
    dec.pll = mod.ChromaPLL(bandwidth, LINE_LEN, mod.BURST_START,
                            mod.BURST_END, init_freq=w0, min_freq=w0 * 0.9,
                            max_freq=w0 * 1.1, **kw)
    dec.state["pll"] = dec.pll.init_state()
    if mod is jatv:
        dec._chroma = jax.jit(dec._chroma_fn)
    return dec


@pytest.mark.parametrize("bandwidth", [None, LOCKING_BW])
def test_atv_decoder_matches_jax(bandwidth):
    """ATVDecoder.process on the JAX test's make_video-style composite, 9
    calls of 80 lines (one frame rollover), in both packages: the same
    vertical scan, and, with a chroma PLL that locks (LOCKING_BW in both
    decoders), the same frames within 1 LSB. At the decoder's own
    bandwidth (None: 0.01) the PLL does not lock at 720-sample lines (JAX
    and port alike, ROADMAP C), so its phase, and the frames rendered from
    it, wander chaotically from the first ulp of difference."""
    iq = _atv_iq()
    jd = jatv.ATVDecoder(span_level=1.0)
    td = tatv.ATVDecoder(span_level=1.0, device=CPU)
    if bandwidth is not None:
        _with_pll(jd, jatv, bandwidth)
        _with_pll(td, tatv, bandwidth, device=CPU)
    jframes, tframes = [], []
    for _ in range(9):
        jframes += jd.process(iq)
        tframes += td.process(iq)
    assert len(jframes) == len(tframes) >= 1
    assert (jd.assembler.ypos, jd.assembler.even_frame) == \
        (td.assembler.ypos, td.assembler.even_frame)
    for a, b in zip(jframes, tframes):
        assert a.shape == b.shape == (tatv.FRAME_LINES, LINE_LEN, 2)
        if bandwidth is not None:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_atv_decoder_end_to_end():
    """tests/test_atv.py::test_atv_decoder_end_to_end on the port."""
    dec = tatv.ATVDecoder(span_level=1.0, device=CPU)
    iq = _atv_iq()
    frames = dec.process(iq)
    assert frames == []
    assert dec.assembler.ypos > 50
    reps = int(np.ceil((tatv.FRAME_LINES + 10) / 80))
    for _ in range(reps):
        frames += dec.process(iq)
    assert frames
    fr = frames[0]
    assert fr.shape == (tatv.FRAME_LINES, LINE_LEN, 2)
    row = fr[200].astype(np.float32)
    assert row[tatv.BURST_END + 40:LINE_LEN - 60].mean() > 1.0


# -------------------------------------------------------------- CyclicSync

@pytest.mark.parametrize("fft_len,cp,n_syms", [(256, 32, 10), (128, 16, 14)])
def test_cyclic_sync_matches_jax_over_two_blocks(fft_len, cp, n_syms):
    x = make_ofdm_stream(n_syms, fft_len, cp, seed=fft_len)
    jc = jofdm.CyclicSync(fft_len, cp, 1.0)
    tc = tofdm.CyclicSync(fft_len, cp, 1.0, device=CPU)
    jf = jax.jit(jc.__call__)
    js, ts = jc.init_state(), tc.init_state()
    cut = len(x) // 2 + 37   # blocks that split a symbol
    for blk in (x[:cut], x[cut:]):
        js, (jsyms, jvalid) = jf(js, jnp.asarray(blk))
        ts, (tsyms, tvalid) = tc(ts, torch.from_numpy(blk))
        np.testing.assert_array_equal(np.asarray(jvalid), tvalid.numpy())
        assert int(tvalid.sum()) >= 1
        np.testing.assert_array_equal(np.asarray(jsyms), tsyms.numpy())
    jsn, tsn = _np(js), state_to_numpy(ts)
    assert set(jsn) == set(tsn)
    for k in ("tail", "sym_buf", "since_peak"):
        np.testing.assert_array_equal(jsn[k], tsn[k])
    for k in ("avg_corr", "peak_corr", "last_corr"):
        np.testing.assert_allclose(tsn[k], jsn[k], rtol=CORR_TOL, atol=0)
    for k in jsn:
        assert jsn[k].shape == tsn[k].shape and jsn[k].dtype == tsn[k].dtype


def test_cp_correlation_matches_jax_and_carries():
    fft_len, cp = 128, 16
    x = make_ofdm_stream(12, fft_len, cp)
    jtail = jnp.zeros(fft_len + cp - 1, jnp.complex64)
    ttail = torch.zeros(fft_len + cp - 1, dtype=torch.complex64)
    joined = []
    half = len(x) // 2
    for blk in (x[:half], x[half:]):
        jtail, jr, jv = jofdm.cyclic_prefix_correlation(
            jtail, jnp.asarray(blk), fft_len, cp)
        ttail, tr, tv = tofdm.cyclic_prefix_correlation(
            ttail, torch.from_numpy(blk), fft_len, cp)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-3)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        joined.append(tr.numpy())
    _, ref, _ = tofdm.cyclic_prefix_correlation(
        torch.zeros(fft_len + cp - 1, dtype=torch.complex64),
        torch.from_numpy(x), fft_len, cp)
    np.testing.assert_allclose(np.concatenate(joined), ref.numpy(),
                               atol=1e-3)


def test_cp_correlation_peaks_at_symbol_ends():
    """tests/test_ofdm.py::test_cp_correlation_peaks_at_symbol_ends."""
    fft_len, cp = 256, 32
    x = make_ofdm_stream(8, fft_len, cp)
    _, rcorr, _ = tofdm.cyclic_prefix_correlation(
        torch.zeros(fft_len + cp - 1, dtype=torch.complex64),
        torch.from_numpy(x), fft_len, cp)
    rcorr = rcorr.numpy()
    period = fft_len + cp
    peaks = [np.argmax(rcorr[k * period:(k + 1) * period])
             for k in range(2, 7)]
    ang = np.exp(2j * np.pi * np.asarray(peaks) / period)
    circ_dev = np.sqrt(-2 * np.log(np.abs(np.mean(ang)) + 1e-12)) \
        * period / (2 * np.pi)
    assert circ_dev < 3.0
    assert np.max(rcorr[period:]) > 3 * np.median(rcorr[period:])


def test_cyclic_sync_emits_symbols():
    """tests/test_ofdm.py::test_cyclic_sync_emits_symbols on the port."""
    x = make_ofdm_stream(10, 256, 32)
    cs = tofdm.CyclicSync(256, 32, 1.0, device=CPU)
    st, (syms, valid) = cs(cs.init_state(), torch.from_numpy(x))
    assert 6 <= int(valid.sum()) <= 12
    assert torch.isfinite(torch.view_as_real(syms)).all()


def test_phase_reference_sync_matches_jax():
    rng = np.random.default_rng(1)
    n = 512
    prs = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    rx = np.roll(prs, 37) + 0.05 * (rng.standard_normal(n)
                                    + 1j * rng.standard_normal(n))
    for shift_bins in (0, 3):
        r = (rx * np.exp(2j * np.pi * shift_bins * np.arange(n) / n)) \
            .astype(np.complex64)
        jk, jm, jc = jofdm.phase_reference_sync(jnp.asarray(r), prs)
        tk, tm, tc = tofdm.phase_reference_sync(torch.from_numpy(r), prs)
        assert int(jk) == int(tk) and int(jc) == int(tc)
        assert abs(float(jm) - float(tm)) <= 1e-4 * float(jm)
        if shift_bins == 0:
            assert int(tk) == 37 and int(tc) == 0
        else:
            assert abs(int(tc) - 3) <= 1


def test_dab_prs_cfo_and_constellation_match_jax():
    prs_conj = tofdm.load_dab_prs_conj()
    np.testing.assert_array_equal(prs_conj, jofdm.load_dab_prs_conj())
    assert prs_conj.shape == (2048,)
    prs = np.conj(prs_conj)
    for bins in (0.0, 3.0, -2.4):
        cfo = 2 * np.pi * bins / 2048
        rx = (prs * np.exp(1j * cfo * np.arange(2048))).astype(np.complex64)
        j = float(jofdm.dab_prs_cfo(jnp.asarray(rx)))
        t = float(tofdm.dab_prs_cfo(torch.from_numpy(rx)))
        assert abs(j - t) <= 1e-6
        if bins == 0.0:
            assert abs(t) < 5e-3
        elif bins == 3.0:
            assert abs(t - cfo) < 5e-4
        jcon = np.asarray(jofdm.dab_prs_constellation(jnp.asarray(rx)))
        tcon = tofdm.dab_prs_constellation(torch.from_numpy(rx)).numpy()
        # X[i] / X[i-1] is ill-conditioned where |X[i-1]| nears a null of
        # the spectrum (a fractional CFO's leakage): compare the bins whose
        # denominator is above 1 % of the median magnitude
        a0 = np.abs(np.fft.fft(rx.astype(np.complex128)))[
            np.where(np.arange(-768, 767) >= 0, np.arange(-768, 767),
                     2048 + np.arange(-768, 767))]
        a0 = np.delete(a0, 768)
        ok = a0 > 1e-2 * np.median(a0)
        assert ok.mean() > 0.9
        np.testing.assert_allclose(tcon[ok], jcon[ok], atol=1e-4, rtol=1e-4)
    c = tofdm.dab_prs_constellation(torch.from_numpy(
        prs.astype(np.complex64))).numpy()
    h, _ = np.histogram(np.mod(np.angle(c), np.pi / 2), bins=9,
                        range=(0, np.pi / 2))
    assert h.max() > 0.9 * h.sum()
    assert tofdm.dab_null_detect(10.0, 100.0) == \
        jofdm.dab_null_detect(10.0, 100.0)


# ------------------------------------------------- reshapers, modulators

def test_keep_skip_reshaper_matches_jax():
    x = np.arange(3 * 4 * 10, dtype=np.float32).reshape(3, 40)
    _, j = jreshape.KeepSkipReshaper(6, 4)((), jnp.asarray(x))
    _, t = treshape.KeepSkipReshaper(6, 4)((), torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_packer_matches_jax_over_blocks():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(173) + 1j * rng.standard_normal(173)) \
        .astype(np.complex64)
    jp, tp = jreshape.Packer(16), treshape.Packer(16, device=CPU)
    js, ts = jp.init_state(), tp.init_state()
    for a, b in ((0, 40), (40, 47), (47, 120), (120, 173)):
        js, (jf, jn) = jp(js, jnp.asarray(x[a:b]))
        ts, (tf, tn) = tp(ts, torch.from_numpy(x[a:b]))
        assert int(jn) == int(tn)
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
        for k in ("partial", "fill"):
            np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy())


def _oracle_quadrature_mod(x, dev_rads):
    """tests/test_modulators.py's per-sample loop (mod/quadrature.h)."""
    phase = 0.0
    out = np.empty(len(x), np.complex64)
    for i, v in enumerate(x):
        phase += dev_rads * v
        phase = (phase + np.pi) % (2 * np.pi) - np.pi
        out[i] = np.cos(phase) + 1j * np.sin(phase)
    return out


def test_quadrature_mod_matches_jax_and_oracle():
    rng = np.random.default_rng(0)
    fs, dev = 48000.0, 5000.0
    x = rng.normal(0, 0.7, 4096).astype(np.float32)
    jm, tm = jmod.QuadratureMod(dev, fs), tmod.QuadratureMod(dev, fs,
                                                             device=CPU)
    js, ts = jm.init_state(), tm.init_state()
    outs = []
    for blk in (x[:2048], x[2048:]):
        js, jo = jm(js, jnp.asarray(blk))
        ts, to = tm(ts, torch.from_numpy(blk))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=MOD_TOL)
        outs.append(to.numpy())
    assert abs(float(js["phase"]) - float(ts["phase"])) <= MOD_TOL
    np.testing.assert_allclose(
        np.concatenate(outs), _oracle_quadrature_mod(x, 2 * np.pi * dev / fs),
        atol=2e-3)


def test_quadrature_mod_roundtrips_through_discriminator():
    """tests/test_modulators.py's round trip on the port."""
    from sdrpp_tpu_torch.ops.fm import Quadrature

    fs, dev = 48000.0, 5000.0
    x = np.sin(2 * np.pi * 1000.0 * np.arange(9600) / fs).astype(np.float32)
    m = tmod.QuadratureMod(dev, fs, device=CPU)
    _, iq = m(m.init_state(), torch.from_numpy(x))
    d = Quadrature(dev, fs, device=CPU)
    _, y = d(d.init_state(), iq)
    np.testing.assert_allclose(y.numpy()[1:], x[1:], atol=1e-2)


def test_psk_mod_matches_jax():
    rng = np.random.default_rng(3)
    jm = jmod.PSKMod(1200.0, 12000.0, 0.35, 31)
    tm = tmod.PSKMod(1200.0, 12000.0, 0.35, 31, device=CPU)
    nsym = 64 + (-64) % tm.block_multiple
    sym = np.exp(1j * np.pi / 2 * rng.integers(0, 4, 2 * nsym)) \
        .astype(np.complex64)
    js, ts = jm.init_state(), tm.init_state()
    for blk in (sym[:nsym], sym[nsym:]):
        js, jo = jm(js, jnp.asarray(blk))
        ts, to = tm(ts, torch.from_numpy(blk))
        assert to.shape[-1] == tm.out_count(nsym) == nsym * 10
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=RRC_TOL)


def test_gfsk_mod_matches_jax():
    rng = np.random.default_rng(4)
    fs, baud, dev = 9600.0, 1200.0, 1200.0
    jm = jmod.GFSKMod(baud, fs, 0.5, 31, dev)
    tm = tmod.GFSKMod(baud, fs, 0.5, 31, dev, device=CPU)
    n = 300 + (-300) % tm.block_multiple
    sym = (rng.integers(0, 2, 2 * n) * 2.0 - 1.0).astype(np.float32)
    js, ts = jm.init_state(), tm.init_state()
    for blk in (sym[:n], sym[n:]):
        js, jo = jm(js, jnp.asarray(blk))
        ts, to = tm(ts, torch.from_numpy(blk))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=MOD_TOL)
    assert abs(float(js["mod"]["phase"]) - float(ts["mod"]["phase"])) \
        <= MOD_TOL


def test_gfsk_mod_end_to_end_bits():
    """tests/test_modulators.py::test_gfsk_mod_end_to_end_bits on the
    port: GFSKMod -> GFSKDemod recovers the bit stream."""
    from sdrpp_tpu_torch.models.digital import GFSKDemod

    rng = np.random.default_rng(4)
    fs, baud, dev = 9600.0, 1200.0, 1200.0
    bits = rng.integers(0, 2, 600) * 2.0 - 1.0
    m = tmod.GFSKMod(baud, fs, 0.5, 31, dev, device=CPU)
    sym = bits.astype(np.float32)
    sym = np.concatenate([sym, np.zeros((-len(sym)) % m.block_multiple,
                                        np.float32)])
    _, iq = m(m.init_state(), torch.from_numpy(sym))
    d = GFSKDemod(baud, fs, dev, rrc_tap_count=31, rrc_beta=0.5,
                  omega_gain=0.001, mu_gain=0.01, device=CPU)
    _, (syms, valid) = d(d.init_state(), iq)
    got = np.sign(syms.numpy()[valid.numpy().astype(bool)])
    tx = np.sign(bits)
    c = np.correlate(got.astype(np.float32), tx[200:400].astype(np.float32))
    off = int(np.argmax(np.abs(c))) - 200
    polarity = np.sign(c[off + 200]) or 1.0
    a = tx[250:550]
    b = polarity * got[250 + off:550 + off]
    L = min(len(a), len(b))
    assert L > 200
    assert float(np.mean(a[:L] == b[:L])) > 0.95


def test_walk_entries_bind_every_c_argument():
    """Each walk's ctypes argument list matches its C entry in
    csrc/sync_walk.cu, argument for argument (pointer, int or float; the
    stream last), so no argument is passed as a truncated int."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(sync_walks.__file__).parent.parent / "csrc"
           / "sync_walk.cu").read_text()
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    for entry, argtypes in (("line_sync_walk", sync_walks._LINE_ARGS),
                            ("chroma_burst_walk", sync_walks._BURST_ARGS),
                            ("cyclic_sync_walk", sync_walks._CYCLIC_ARGS)):
        m = re.search(rf"\nint {entry}\(([^)]*)\)", src)
        assert m, entry
        params = [p.strip() for p in m.group(1).split(",")]
        want = ["ptr" if "*" in p else p.split()[0] for p in params]
        assert [kinds[a] for a in argtypes] == want, entry
        assert params[-1] == "void* stream"
