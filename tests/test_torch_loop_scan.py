"""Contracts of the loop-scan kernel's redesign (csrc/loop_scan.cu), checked
on the CPU through the plain versions and the Python glue the card runs.

- The kernel's wrapped remainder: for x in (-2pi, 4pi) it takes x - 2pi,
  x + 2pi or x, and fmodf's form elsewhere. That form equals
  ``torch.remainder(x, 2pi)`` (the plain bodies' ``remainder(p + pi, 2pi)
  - pi``) bit for bit on a dense float32 grid over the range and at its
  boundaries; the values outside it take the fallback, and the boundaries
  it leaves out are the ones where the short form would be wrong.
- ``lane_scan`` reads its streams where they lie and writes into a
  caller-given view: on an overlapping ``as_strided`` view, a transposed
  [C, n] view and a bank's [n, channels, K] lanes it gives, bit for bit,
  what it gives on contiguous copies, also with leading steps skipped into
  a strided output and a side output.
- The chunk drivers, which now pass lane views and write each lane's
  payload in place, give outputs and states bit-identical to the drivers
  as they were before (lanes and outputs copied around the kernel; kept
  here as the reference), over two carried blocks.
- The wrappers raise on an output whose elements overlap (the kernel
  cannot write it), on wrong shapes, ``skip`` and ``side``, and never run
  the plain version for another device.
"""

import numpy as np
import pytest
import torch

from sdrpp_tpu_torch.ops import scans_kernels as K
from sdrpp_tpu_torch.ops.scans import FL_PI

torch.set_num_threads(1)

PI = float(FL_PI)
TWO_PI = float(np.float32(2.0) * FL_PI)


def _kernel_remainder(x):
    """csrc/loop_scan.cu's jmod_2pi, elementwise in float32."""
    y = torch.tensor(TWO_PI, dtype=torch.float32)
    fast = (x > -y) & (x < 2 * y)
    short = torch.where(x >= y, x - y, torch.where(x < 0, x + y, x))
    return torch.where(fast, short, torch.remainder(x, y)), fast


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_wrapped_remainder_short_form_is_exact():
    y = np.float32(TWO_PI)
    grid = np.linspace(-y, 2 * y, 2_000_001, dtype=np.float32)[1:-1]
    edges = []
    for v in (-y, np.float32(0.0), y, 2 * y):
        edges += [v, np.nextafter(v, np.float32(-np.inf)),
                  np.nextafter(v, np.float32(np.inf))]
    edges.append(np.float32(-0.0))
    x = torch.from_numpy(np.concatenate([grid, np.array(edges, np.float32)]))
    got, fast = _kernel_remainder(x)
    want = torch.remainder(x, TWO_PI)
    assert torch.equal(_bits(got), _bits(want))
    # and as the bodies use it: the phase update
    assert torch.equal(_bits(got - PI), _bits(want - PI))
    inside = (x > -TWO_PI) & (x < 2 * np.float32(TWO_PI))
    assert torch.equal(fast, inside) and int((~fast).sum()) >= 4
    # the boundaries left out are where the short form would be wrong
    for v in (-y, 2 * y):
        t = torch.tensor([v])
        short = torch.where(t >= y, t - y, torch.where(t < 0, t + y, t))
        assert not torch.equal(_bits(short), _bits(torch.remainder(t, y)))


def test_wrapped_remainder_fallback_outside_the_range():
    x = torch.tensor([-1e4, -3 * TWO_PI, 2 * TWO_PI, 5e3, float("inf"),
                      float("-inf"), float("nan")], dtype=torch.float32)
    got, fast = _kernel_remainder(x)
    assert not bool(fast.any())
    assert torch.equal(_bits(got), _bits(torch.remainder(x, TWO_PI)))


# ---------------------------------------------------------------------------
# lane_scan on views
# ---------------------------------------------------------------------------

AGC = K.agc_body(1.0, 50.0 / 48000.0, 5.0 / 48000.0, 10e6, 10.0)
PLL = K.pll_body(0.14, 0.0055, 0.49, 0.51)
COSTAS4 = K.costas_body(4, 0.0141, 0.0001, -np.pi, np.pi)


def _body_streams(body, ext):
    """The body's streams made from one [..., m] float32 tensor."""
    if body is AGC:
        return [ext, K.suffix_max(ext)]
    if body is COSTAS4:
        return [torch.cos(3 * ext), torch.sin(3 * ext)]
    return [ext]


def _seed(body, lanes, rng):
    s = rng.uniform(0.01, 0.5, (body.k, *lanes)).astype(np.float32)
    return torch.from_numpy(s)


@pytest.mark.parametrize("body", [AGC, PLL, COSTAS4],
                         ids=["agc", "pll", "costas4"])
def test_lane_scan_plain_on_overlapping_lanes_equals_copies(body):
    rng = np.random.default_rng(11)
    Kl, L, W = 5, 40, 12
    ext = torch.from_numpy(rng.uniform(0.0, 0.3, W + Kl * L)
                           .astype(np.float32))
    streams = [e.as_strided((W + L, Kl), (1, L)) for e in
               _body_streams(body, ext)]
    state = _seed(body, [Kl], rng)
    want_out, want_fin = K.lane_scan(body, state, [s.contiguous()
                                                   for s in streams])
    out, fin = K.lane_scan(body, state, streams)
    assert torch.equal(out, want_out) and torch.equal(fin, want_fin)
    # steps >= W into a strided, sample-ordered output, the last 4 warm-up
    # steps into a side output
    res = torch.full((Kl * L,), 7.0)
    side = torch.full((Kl, 4), 7.0)
    got, fin2 = K.lane_scan(body, state, streams,
                            out=res.as_strided((L, Kl), (1, L)), skip=W,
                            side=side.T)
    assert got.data_ptr() == res.data_ptr() and torch.equal(fin2, want_fin)
    assert torch.equal(res, want_out[W:].T.reshape(-1))
    assert torch.equal(side, want_out[W - 4:W].T)


def test_lane_scan_plain_on_a_transposed_bank_equals_copies():
    rng = np.random.default_rng(12)
    bank = torch.from_numpy(rng.uniform(0.0, 0.2, (6, 300)).astype(np.float32))
    streams = [s.T for s in _body_streams(AGC, bank)]   # [300, 6] views
    state = _seed(AGC, [6], rng)
    want = K.lane_scan(AGC, state, [s.contiguous() for s in streams])
    res = torch.empty(6, 300)
    got = K.lane_scan(AGC, state.T.contiguous().T, streams, out=res.T)
    assert torch.equal(res.T, want[0]) and torch.equal(got[1], want[1])
    # the exact entry that takes [channels, n] streams returns them so
    amps = bank
    g, amp_f, gain_f = K.agc_gains(amps, K.suffix_max(amps), state[0],
                                   state[1], 1.0, 50.0 / 48000.0,
                                   5.0 / 48000.0, 10e6, 10.0)
    assert torch.equal(g, want[0].T)
    assert torch.equal(torch.stack([amp_f, gain_f]), want[1])


def test_lane_scan_plain_on_two_lane_axes_equals_copies():
    rng = np.random.default_rng(13)
    M, Kl, L, W = 3, 4, 30, 8
    ext = torch.from_numpy(rng.uniform(0.0, 0.3, (M, W + Kl * L))
                           .astype(np.float32))
    streams = [e.as_strided((W + L, M, Kl), (1, e.stride(0), L))
               for e in _body_streams(COSTAS4, ext)]
    state = _seed(COSTAS4, [M, Kl], rng)
    want_out, want_fin = K.lane_scan(
        COSTAS4, state.reshape(2, M * Kl),
        [s.reshape(W + L, M * Kl) for s in streams])
    res = torch.empty(M, Kl * L)
    out, fin = K.lane_scan(COSTAS4, state, streams,
                           out=res.as_strided((L, M, Kl), (1, Kl * L, L)),
                           skip=W)
    assert torch.equal(fin.reshape(2, -1), want_fin)
    assert torch.equal(out.reshape(L, -1), want_out[W:])
    assert torch.equal(res.view(M, Kl, L).permute(2, 0, 1).reshape(L, -1),
                       want_out[W:])


def test_single_scan_plain_with_skip_and_valid():
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.uniform(0.0, 0.3, 2 * 200).astype(np.float32))
    strided = x[::2]     # a stride-2 [200] stream
    state = torch.tensor([0.1, 25.0])
    streams = [strided, K.suffix_max(strided)]
    want, want_fin = K.single_scan(AGC, state, [s.contiguous()
                                                for s in streams], valid=150)
    assert not bool(want[150:].any())
    got, fin = K.single_scan(AGC, state, streams, valid=150)
    assert torch.equal(got, want) and torch.equal(fin, want_fin)
    # skip and side belong to lane_scan: one lane of the same stream
    out = torch.full((140, 1), 7.0)
    side = torch.full((10, 1), 7.0)
    got, fin = K.lane_scan(AGC, state[:, None], [s[:, None] for s in streams],
                           valid=150, out=out, skip=60, side=side)
    assert got is out and torch.equal(fin[:, 0], want_fin)
    assert torch.equal(out[:, 0], want[60:])
    assert torch.equal(side[:, 0], want[50:60])


# ---------------------------------------------------------------------------
# the chunk drivers against the drivers that copied lanes and outputs
# ---------------------------------------------------------------------------

def _lane_slice(ext, Kl, L, W):
    lead = ext.shape[:-1]
    warm = ext[..., :Kl * L].reshape(*lead, Kl, L)[..., :W]
    return torch.cat([warm, ext[..., W:].reshape(*lead, Kl, L)], dim=-1)


def _pad_last(s, pad):
    if not pad:
        return s
    return torch.cat([s, s[..., -1:].expand(*s.shape[:-1], pad)], dim=-1)


def _build_lanes(streams, hists, Kl):
    W = hists[0].shape[-1]
    n = streams[0].shape[-1]
    L = -(-n // Kl)
    pad = Kl * L - n
    lanes = []
    for s, h in zip(streams, hists):
        ext = torch.cat([h.float(), _pad_last(s.float(), pad)], dim=-1)
        lanes.append(_lane_slice(ext, Kl, L, W))
    return lanes, L, pad


def _run_lanes(body, state, lanes):
    shp = lanes[0].shape
    m = int(np.prod(shp[:-1]))
    tm = [l.reshape(m, shp[-1]).T.contiguous() for l in lanes]
    out, fin = K.lane_scan(body, state.reshape(body.k, m).contiguous(), tm)
    return out.T.reshape(shp), fin.reshape(body.k, *shp[:-1])


def _copying_pll(in_phases, hist, alpha, beta, min_freq, max_freq, lanes_k):
    n, lead, W = in_phases.shape[-1], in_phases.shape[:-1], hist.shape[-1]
    lanes, L, _ = _build_lanes([in_phases], [hist], lanes_k)
    lane = lanes[0]
    d = lane[..., 1:W + 1] - lane[..., :W]
    d = torch.where(d > PI, d - TWO_PI, d)
    d = torch.where(d <= -PI, d + TWO_PI, d)
    seed_freq = torch.clamp(torch.mean(d, dim=-1), float(np.float32(min_freq)),
                            float(np.float32(max_freq)))
    state = torch.stack([lane[..., 0], seed_freq])
    out, fin = _run_lanes(K.pll_body(alpha, beta, min_freq, max_freq), state,
                          lanes)
    out = out[..., W:].reshape(*lead, lanes_k * L)[..., :n]
    return (out, in_phases[..., n - W:].float().clone(), fin[0, ..., -1],
            fin[1, ..., -1])


def _copying_agc(amps, hist, set_point, attack, decay, max_gain, max_out,
                 lanes_k):
    n, lead, W = amps.shape[-1], amps.shape[:-1], hist.shape[-1]
    L = -(-n // lanes_k)
    ext = torch.cat([hist.float(), _pad_last(amps.float(), lanes_k * L - n)],
                    dim=-1)
    lane_a = _lane_slice(ext, lanes_k, L, W)
    lane_s = _lane_slice(K.suffix_max(ext), lanes_k, L, W)
    mean_amp = torch.mean(lane_a[..., :W], dim=-1)
    seed_amp = torch.where(mean_amp > 0, mean_amp, 1.0)
    sp = torch.full_like(seed_amp, float(np.float32(set_point)))
    seed_gain = torch.clamp(sp / seed_amp, max=float(np.float32(max_gain)))
    out, fin = _run_lanes(
        K.agc_body(set_point, attack, decay, max_gain, max_out),
        torch.stack([seed_amp, seed_gain]), [lane_a, lane_s])
    out = out[..., W:].reshape(*lead, lanes_k * L)[..., :n]
    return (out, amps[..., n - W:].float().clone(), fin[0, ..., -1],
            fin[1, ..., -1])


def _copying_fast_agc(amps, hist, set_point, max_gain, rate, lanes_k):
    n, lead, W = amps.shape[-1], amps.shape[:-1], hist.shape[-1]
    lanes, L, _ = _build_lanes([amps], [hist], lanes_k)
    mean_amp = torch.mean(lanes[0][..., :W], dim=-1)
    sp = torch.full_like(mean_amp, float(np.float32(set_point)))
    seed_gain = torch.where(
        mean_amp > 0,
        torch.clamp(sp / mean_amp, max=float(np.float32(max_gain))), 1.0)
    out, fin = _run_lanes(K.fast_agc_body(set_point, max_gain, rate),
                          seed_gain[None], lanes)
    out = out[..., W:].reshape(*lead, lanes_k * L)[..., :n]
    return out, amps[..., n - W:].float().clone(), fin[0, ..., -1]


def _copying_costas(s1, s2, hist1, hist2, phase0, freq0, order, alpha, beta,
                    min_freq, max_freq, lanes_k):
    n, lead, W = s1.shape[-1], s1.shape[:-1], hist1.shape[-1]
    Kl = lanes_k
    lo, hi = float(np.float32(min_freq)), float(np.float32(max_freq))
    (a, b), L, _ = _build_lanes([s1, s2], [hist1, hist2], Kl)
    phase0, freq0 = phase0.float(), freq0.float()
    carried = freq0[..., None].expand(*lead, Kl)
    M = float(int(order))
    ang = torch.atan2(b[..., :W], a[..., :W])
    d = M * (ang[..., 1:] - ang[..., :-1])
    zr, zi = torch.mean(torch.cos(d), -1), torch.mean(torch.sin(d), -1)
    est = torch.atan2(zi, zr) / M
    coh = torch.sqrt(zr * zr + zi * zi)
    energy = torch.mean(a[..., :W] ** 2 + b[..., :W] ** 2, dim=-1)
    ok = (coh > 0.5) & (energy > 1e-12)
    seed_freq = torch.clamp(torch.where(ok, est, carried), lo, hi)
    t0 = torch.arange(Kl, dtype=torch.float32) * float(L) - float(W)
    seed_phase = torch.remainder(phase0[..., None] + seed_freq * t0 + PI,
                                 TWO_PI) - PI
    out, fin = _run_lanes(
        K.costas_body(order, alpha, beta, min_freq, max_freq),
        torch.stack([seed_phase, seed_freq]), [a, b])
    step_rot = float(np.float32(TWO_PI) / np.float32(M))
    tail = min(W, 32)
    d_seam = out[..., 1:, W - tail:W] - out[..., :-1, L + W - tail:L + W]
    d_hat = torch.atan2(torch.mean(torch.sin(d_seam), -1),
                        torch.mean(torch.cos(d_seam), -1))
    d0 = torch.remainder(out[..., 0, W] - phase0 + PI, TWO_PI) - PI
    k_rot = torch.round(torch.cat([d0[..., None], d_hat], dim=-1) / step_rot)
    rot = torch.cumsum(k_rot, dim=-1) * step_rot
    out = torch.remainder(out[..., W:] - rot[..., None] + PI, TWO_PI) - PI
    out = out.reshape(*lead, Kl * L)[..., :n]
    phase_f = torch.remainder(fin[0, ..., -1] - rot[..., -1] + PI,
                              TWO_PI) - PI
    return (out, s1[..., n - W:].float().clone(),
            s2[..., n - W:].float().clone(), phase_f, fin[1, ..., -1])


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_pll_chunked_views_equal_copies(lead):
    rng = np.random.default_rng(21)
    n, W, Kl = 1000, 24, 8      # L = 125, 0 padded samples
    ph = np.angle(np.exp(1j * (0.3 * np.arange(2 * n + W)
                               + 0.2 * rng.standard_normal((*lead, 2 * n + W))
                               ))).astype(np.float32)
    ph = torch.from_numpy(ph)
    hist = ph[..., :W]
    args = (0.14, 0.0055, 0.2, 0.4)
    for k in range(2):
        blk = ph[..., W + k * n:W + (k + 1) * n]
        got = K.pll_phases_chunked(blk, hist, *args, lanes_k=Kl)
        _assert_same(got, _copying_pll(blk, hist, *args, Kl))
        hist = got[1]


@pytest.mark.parametrize("lead", [(), (2,)])
def test_agc_chunked_views_equal_copies(lead):
    rng = np.random.default_rng(22)
    n, W, Kl = 997, 64, 6       # L = 167, 5 padded samples
    a = torch.from_numpy(np.abs(0.05 * rng.standard_normal((*lead, 2 * n + W))
                                ).astype(np.float32))
    a[..., ::31] = 0.0
    hist = a[..., :W]
    args = (1.0, 50.0 / 48000.0, 5.0 / 48000.0, 10e6, 10.0)
    for k in range(2):
        blk = a[..., W + k * n:W + (k + 1) * n]
        got = K.agc_gains_chunked(blk, hist, *args, lanes_k=Kl)
        _assert_same(got, _copying_agc(blk, hist, *args, Kl))
        hist = got[1]


def test_fast_agc_chunked_views_equal_copies():
    rng = np.random.default_rng(23)
    n, W, Kl = 1030, 32, 16     # L = 65, 10 padded samples
    a = torch.from_numpy(np.abs(0.3 + 0.05 * rng.standard_normal(2 * n + W)
                                ).astype(np.float32))
    hist = a[:W]
    for k in range(2):
        blk = a[W + k * n:W + (k + 1) * n]
        got = K.fast_agc_gains_chunked(blk, hist, 1.0, 10e6, 0.001,
                                       lanes_k=Kl)
        _assert_same(got, _copying_fast_agc(blk, hist, 1.0, 10e6, 0.001, Kl))
        hist = got[1]


@pytest.mark.parametrize("lead", [(), (2,)])
def test_costas_chunked_views_equal_copies(lead):
    rng = np.random.default_rng(24)
    n, W, Kl = 1200, 48, 8      # L = 150; the seam uses 32 warm-up steps
    m = 2 * n + W
    pts = np.pi / 4 + np.pi / 2 * rng.integers(0, 4, (*lead, m))
    v = np.exp(1j * (pts + 2e-3 * np.arange(m) + 0.4)) + 0.05 * (
        rng.standard_normal((*lead, m)) + 1j * rng.standard_normal((*lead, m)))
    re = torch.from_numpy(v.real.astype(np.float32))
    im = torch.from_numpy(v.imag.astype(np.float32))
    h1, h2 = re[..., :W], im[..., :W]
    phase = torch.full(lead, 0.3)
    freq = torch.full(lead, 1e-3)
    args = (4, 0.0141, 0.0001, -np.pi, np.pi)
    for k in range(2):
        sl = slice(W + k * n, W + (k + 1) * n)
        got = K.costas_phases_chunked(re[..., sl], im[..., sl], h1, h2, phase,
                                      freq, *args, lanes_k=Kl)
        _assert_same(got, _copying_costas(re[..., sl], im[..., sl], h1, h2,
                                          phase, freq, *args, Kl))
        _, h1, h2, phase, freq = got


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------

def test_loop_scan_wrappers_raise_on_what_the_kernel_cannot_take():
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.uniform(0, 0.3, (100, 4)).astype(np.float32))
    streams = [x, K.suffix_max(x.T).T]
    state = torch.ones(2, 4)
    before = (K.lane_scan.launches, K.single_scan.launches)
    # an output whose elements overlap: a broadcast row, a zero time stride
    with pytest.raises(ValueError, match="overlapping elements"):
        K.lane_scan(AGC, state, streams, out=torch.zeros(1, 4).expand(100, 4))
    with pytest.raises(ValueError, match="overlapping elements"):
        K.lane_scan(AGC, state, streams,
                    out=torch.zeros(8).as_strided((100, 4), (0, 2)))
    with pytest.raises(ValueError, match="overlapping elements"):
        K.lane_scan(AGC, state[:, :1], [s[:, :1] for s in streams],
                    out=torch.zeros(1, 1).expand(100, 1))
    with pytest.raises(ValueError, match="overlapping elements"):
        K.lane_scan(AGC, state, streams, skip=90,
                    side=torch.zeros(1, 4).expand(5, 4))
    with pytest.raises(ValueError, match=r"out shape \[100, 4\] != \[90, 4\]"):
        K.lane_scan(AGC, state, streams, out=torch.zeros(100, 4), skip=10)
    with pytest.raises(ValueError, match="side shape"):
        K.lane_scan(AGC, state, streams, skip=3, side=torch.zeros(5, 4))
    with pytest.raises(ValueError, match="skip 101 outside"):
        K.lane_scan(AGC, state, streams, skip=101)
    with pytest.raises(ValueError, match="out must be float32"):
        K.lane_scan(AGC, state, streams, out=torch.zeros(100, 4).double())
    with pytest.raises(ValueError, match="2- or 3-D"):
        K.lane_scan(AGC, state[:, :, None, None],
                    [s[:, :, None, None] for s in streams])
    with pytest.raises(ValueError, match="1-D"):
        K.single_scan(AGC, state, streams)
    with pytest.raises(ValueError, match="takes 2 streams"):
        K.lane_scan(AGC, state, streams[:1])
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        K.lane_scan(AGC, state.to("meta"), [s.to("meta") for s in streams])
    # strided inputs, overlapping or not, are taken as they lie
    K.lane_scan(AGC, state, [x.T.contiguous().T, streams[1]])
    K.lane_scan(AGC, state, [torch.ones(1, 4).expand(100, 4), streams[1]])
    assert (K.lane_scan.launches, K.single_scan.launches) == before
