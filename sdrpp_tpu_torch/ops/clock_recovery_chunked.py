"""Chunk-parallel Mueller-Mueller clock recovery.

The counterpart of ``sdrpp_tpu.ops.clock_recovery_chunked`` (see its
docstring for the method and its approximation and noise contracts). The
block is cut into K overlapping lanes of one extended stream [hist | x |
x[-1] x pad | extra zeros], lane j starting at j*L; each lane re-acquires
timing over a W-sample warm-up and runs the M&M recurrence M symbols a
group step, group-predictively: a coarse 2-tap pass predicts the group's
positions, the full 8-tap pass corrects them, and the loop's recurrence
given the group's errors is integrated in closed form (lane 0 with its
own frequency integrator, lanes 1..K-1 with the across-lane mean).
Emissions stay lane-major [K, msc]; a sort-free seam mask drops the
duplicates adjacent lanes claim, so ``valid`` is a mask, not a prefix.

What the TPU form needed and this one does not: the shared [R, K] window,
the one-hot selections and the bank matmul. A symbol reads its taps
directly at its row, ``r0 + gstat[m] + clip(rel - gstat[m], 0, J - T)``,
where ``r0`` is the minimum offset over active lanes and ``gstat`` the
static per-symbol band; the band test ``ok`` decides what is emitted,
and the clipped row what an out-of-band symbol reads, exactly as the JAX
package does, so both are part of the result.

``mm_symbols_chunked`` (the JAX function's arguments) lays a block out
and calls ``mm_symbols_chunked_block``, which on a CUDA tensor launches
``mm_chunked_block`` of ``csrc/mm_clock.cu`` through the compiled host
path (``csrc/kernels_host.cpp``): one launch does the glue (the extended
stream read by index, each lane's Oerder-Meyr seed over its warm-up,
lane 0 on the carried grid, the emission bounds), every group step, the
seam mask and the carry. On a CPU tensor it runs
``mm_symbols_chunked_block_plain``: the glue in torch operations
(``chunked_lanes_args``, the seed's sums in the kernel's order,
``_seed_sum``), then ``mm_symbols_chunked_plain``, a Python loop over
group steps on [M, K] float32 tensors, operation for operation the
kernel's, the across-lane sums in its order (32 lanes by halves, then
the 32-lane groups in turn). ``mm_symbols_chunked_lanes`` runs the group
steps alone on a given extended stream and seeds (the same kernel's
lanes entry, or ``mm_symbols_chunked_plain``). Both wrappers add one to
``mm_symbols_chunked_lanes.launches`` where they launch; any device
other than CUDA or the CPU raises.

``MMClockRecoveryChunked`` is the block: chunked when ``x`` is one stream
and ``_lanes_for(n) >= 1`` (``scans_kernels._chunk_lanes_for``, which
``SDRPP_TPU_LOOPS=exact`` sets to 0), the exact ``mm_symbols`` otherwise,
on every device; the JAX package takes the same branch on its
accelerator.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import scans_kernels
from .clock_recovery import MMClockRecovery
from .clock_recovery_kernels import host_module

__all__ = ["ChunkGeometry", "MMClockRecoveryChunked", "chunk_geometry",
           "chunked_lanes_args", "kernel_layout", "mm_symbols_chunked",
           "mm_symbols_chunked_block", "mm_symbols_chunked_block_plain",
           "mm_symbols_chunked_lanes", "mm_symbols_chunked_plain"]

_GROUP = 32          # symbols a group step, before the adaptive halving
KERNEL_MAX_LANES = 256
KERNEL_WARP = 32
KERNEL_SMEM_BYTES = 232448   # shared memory one CTA may take on an H100
KERNEL_CTA_LANES = 32        # lanes a CTA of the kernel's cluster holds
SEED_PARTS = 8       # the seed sums' strided partials (mm_clock.cu)
SEED_CHUNK = 256     # warm-up samples a lane the kernel stages at a time
WINDOW_SLACK = 8     # samples a prefetched window holds on either side


class ChunkGeometry(NamedTuple):
    """The lane layout of one chunked call: K lanes of ``cols`` columns,
    lane j at j*L in the extended stream; R the window a group spans, J a
    symbol's band, M symbols a group step, ``steps`` group steps
    (msc = steps * M symbol slots a lane), n the block length."""
    K: int
    L: int
    cols: int
    R: int
    J: int
    M: int
    steps: int
    n: int


def group_for(warmup: int, omega: float) -> int:
    """The adaptive group size M: the warm-up must span at least six groups
    so the between-group feedback can re-converge a data-aided seed."""
    warm_syms = max(int(warmup / float(omega)), 1)
    M = _GROUP
    while M > 8 and warm_syms // M < 6:
        M //= 2
    return M


@functools.lru_cache(maxsize=64)
def chunk_geometry(n: int, K: int, W: int, T: int, min_freq, max_freq):
    """(ChunkGeometry, pad_e, pad): the JAX package's layout
    (clock_recovery_chunked.py:92-216) for an n-sample block in K lanes
    with a W-sample warm-up and a T-tap bank."""
    omega = float((min_freq + max_freq) / 2.0)
    pad_e = int(np.ceil(omega))
    M = group_for(W, omega)
    stride_max = int(np.ceil(max_freq))
    spread = stride_max + 6
    R = spread + (M - 1) * stride_max + T + 8
    R = -(-R // 8) * 8
    L = -(-n // K)
    if W > L:
        raise ValueError(f"warm-up {W} longer than the lane payload {L}")
    extra = stride_max + R - T + 1
    cols = W + L + T - 1 + extra
    J = spread + int(np.ceil(M * (float(max_freq) - float(min_freq)))) + 2 + T
    J = min(J, R)
    msc = int(np.ceil((L + W + T) / float(min_freq))) + 1
    msc = M * (-(-msc // M))
    return ChunkGeometry(K, L, cols, R, J, M, msc // M, n), pad_e, K * L - n


def kernel_layout(geom: ChunkGeometry, cplx: bool):
    """(bytes, stride, pieces): the shared memory each CTA of the CUDA
    kernel takes for ``geom`` (mm_clock.cu's chunk_smem, exported there as
    ``mm_chunked_layout``; a CTA holds 32 of the K lanes), a lane's window
    buffer in samples, and the pieces each pass copies a window in (0:
    whole, prefetched a step ahead). The bank, the errors [lanes, M + 4],
    the carry's outputs [lanes, 4], the seam's positions [lanes], the
    means, the two passes' group sums of every CTA [2, 8, M], the bands,
    the warps' and CTAs' minima and four mbarriers, each part rounded up to
    16 bytes; then the windows in the rest of KERNEL_SMEM_BYTES: R samples
    and WINDOW_SLACK either side a lane (copied from the 16-byte boundary
    at or below their start, in 16-byte units) when they fit, else the
    largest buffer a lane that fits, whose pieces overlap by 7 samples;
    at least the block entry's seed region, a SEED_CHUNK-sample rotation
    table and a SEED_CHUNK-sample warm-up chunk a lane."""
    def up(v):
        return -(-v // 16) * 16

    K, R, M = min(geom.K, KERNEL_CTA_LANES), geom.R, geom.M
    sample = 8 if cplx else 4
    a = 16 // sample

    def stride(n):
        return (n + 2 * (a - 1)) // a * a

    o = 128 * 8 * 4
    ctas = KERNEL_MAX_LANES // KERNEL_CTA_LANES
    for size in (K * (M + 4) * 4, K * 16, K * 4, M * 4, 2 * ctas * M * 4,
                 M * 4, (32 + ctas) * 4, 4 * 8):
        o = up(o + size)
    room = KERNEL_SMEM_BYTES - o
    whole = stride(R + 2 * WINDOW_SLACK)
    if K * whole * sample <= room:
        lane, pieces = whole, 0
    else:
        lane = room // (K * sample) // a * a
        pieces = (R - 8) // (lane - a + 1 - 7) + 1
    seed = up(8 * SEED_CHUNK) + K * stride(SEED_CHUNK) * sample
    return up(o + max(K * lane * sample, seed)), lane, pieces


def _gstat(geom: ChunkGeometry, min_freq) -> np.ndarray:
    """Symbol m's static band start in the group window (float64, as the
    JAX package computes it)."""
    g = np.floor(np.arange(geom.M) * float(min_freq)).astype(np.int64)
    return np.minimum(g, geom.R - geom.J)


def _check(ext, off0, ph0, fr0, emit_lo, emit_hi, goff, bank, geom):
    """Validates a chunked call's arguments; on CUDA tensors the compiled
    host path (csrc/kernels_host.cpp) makes the same checks, in this order
    and with these messages."""
    if ext.dtype not in (torch.complex64, torch.float32) or ext.dim() != 1:
        raise ValueError("ext must be a complex64 or float32 vector")
    if bank.dtype != torch.float32 or bank.dim() != 2 or bank.shape[1] < 2:
        raise ValueError("bank must be float32 [phases, taps >= 2]")
    K, L, cols, R, J, M, steps, n = (int(v) for v in geom)
    T = bank.shape[1]
    if (K < 1 or L < 1 or M < 1 or steps < 1 or n < 1 or J < T or R < J
            or cols < R):
        raise ValueError(f"bad geometry {tuple(geom)} for {T} taps")
    if ext.shape[0] < (K - 1) * L + cols:
        raise ValueError(f"ext holds {ext.shape[0]} samples, the lanes "
                         f"need {(K - 1) * L + cols}")
    for name, t, dt in (("off0", off0, torch.int32), ("ph0", ph0, torch.float32),
                        ("fr0", fr0, torch.float32),
                        ("emit_lo", emit_lo, torch.float32),
                        ("emit_hi", emit_hi, torch.int32),
                        ("goff", goff, torch.float32)):
        if t.dtype != dt or tuple(t.shape) != (K,):
            raise ValueError(f"{name} must be {str(dt)[6:]} [{K}]")
    for t in (off0, ph0, fr0, emit_lo, emit_hi, goff, bank):
        if t.device != ext.device:
            raise ValueError("mm_symbols_chunked takes tensors on one device")


def _check_block(x, hist, offset0, phase0, freq0, bank, geom, W, pad):
    """Validates a block call's arguments (``mm_symbols_chunked_block``);
    on CUDA tensors the compiled host path makes the same checks, in this
    order and with these messages."""
    if x.dtype not in (torch.complex64, torch.float32) or x.dim() != 1:
        raise ValueError("x must be a complex64 or float32 vector")
    if bank.dtype != torch.float32 or bank.dim() != 2 or bank.shape[1] < 2:
        raise ValueError("bank must be float32 [phases, taps >= 2]")
    K, L, cols, R, J, M, steps, n = (int(v) for v in geom)
    T = bank.shape[1]
    if (K < 1 or L < 1 or M < 1 or steps < 1 or n < 1 or J < T or R < J
            or cols < R):
        raise ValueError(f"bad geometry {tuple(geom)} for {T} taps")
    if x.shape[0] != n or W < 1 or W > L or pad != K * L - n:
        raise ValueError(f"bad layout: {x.shape[0]} samples, W {W}, pad "
                         f"{pad} for the geometry {tuple(geom)}")
    if hist.dtype != x.dtype or tuple(hist.shape) != (W + T - 1,):
        raise ValueError(f"hist must be {str(x.dtype)[6:]} [{W + T - 1}]")
    for name, t, dt in (("offset0", offset0, torch.int32),
                        ("phase0", phase0, torch.float32),
                        ("freq0", freq0, torch.float32)):
        if t.dtype != dt or t.numel() != 1:
            raise ValueError(f"{name} must be one {str(dt)[6:]}")
    for t in (hist, offset0, phase0, freq0, bank):
        if t.device != x.device:
            raise ValueError("mm_symbols_chunked takes tensors on one device")


_consts: dict = {}


def _const(dev, size: int, kind: str):
    """A cached float32 constant on ``dev``: "ang", -2 pi t for t < size;
    "two_pi", 2 pi (0-d: a tensor divisor keeps the division IEEE on the
    card, where a Python-scalar divisor becomes a reciprocal multiply)."""
    key = (dev, size, kind)
    t = _consts.get(key)
    if t is None:
        if kind == "ang":
            t = (float(np.float32(-2.0 * np.pi))
                 * torch.arange(size, dtype=torch.float32, device=dev))
        else:
            t = torch.full((), float(np.float32(2.0 * np.pi)),
                           dtype=torch.float32, device=dev)
        _consts[key] = t
    return t


def _lanes(dev, dtype, geom: ChunkGeometry, W: int, T: int, pad: int):
    """The lane constants of a layout, cached: lane 0's mask, the lanes'
    starts j*L, their offsets j*L - W from lane to block positions, the
    emission ceilings (W + L, lane K-1's short of the padding) and the
    extended stream's zero tail."""
    key = (dev, dtype, geom, W, T, pad)
    c = _consts.get(key)
    if c is None:
        K, L = geom.K, geom.L
        lane = torch.arange(K, device=dev)
        base = lane.to(torch.float32) * float(np.float32(L))
        emit_hi = torch.full((K,), W + L, dtype=torch.int32, device=dev)
        emit_hi[-1] = W + L - pad
        c = _consts[key] = (
            lane == 0, base, base - float(np.float32(W)), emit_hi,
            torch.zeros(geom.cols - (W + L + T - 1), dtype=dtype,
                        device=dev))
    return c


def _seed_sum(p):
    """[K, W] -> [K]: the kernel's order of the seed's sums, SEED_PARTS
    strided partials (partial j over columns j, j + 8, ..., one float32 add
    a column in order from 0.0), then the xor tree 4, 2, 1 over them."""
    K, W = p.shape
    w8 = -(-W // SEED_PARTS) * SEED_PARTS
    v = torch.nn.functional.pad(p, (0, w8 - W)).reshape(K, -1, SEED_PARTS)
    s = torch.zeros((K, SEED_PARTS), dtype=p.dtype, device=p.device)
    for i in range(v.shape[1]):
        s = s + v[:, i]
    w = SEED_PARTS
    while w > 1:
        w //= 2
        s = s[:, :w] + s[:, w:2 * w]
    return s[:, 0]


def _lane_sum(e, K: int):
    """[M, K] -> [M]: the kernel's across-lane order, each warp's 32 lanes
    (zeros past K) by halves as its xor-shuffles add them, then the warps'
    sums in turn."""
    nw = -(-K // KERNEL_WARP)
    v = torch.nn.functional.pad(e, (0, nw * KERNEL_WARP - K))
    v = v.reshape(e.shape[0], nw, KERNEL_WARP)
    w = KERNEL_WARP
    while w > 1:
        w //= 2
        v = v[..., :w] + v[..., w:2 * w]
    v = v[..., 0]
    s = v[:, 0]
    for j in range(1, nw):
        s = s + v[:, j]
    return s


def fma(a, b, c):
    """a * b + c rounded once to float32 (the kernel's __fmaf_rn): the
    product is exact in float64, the sum's float64 rounding error is
    recovered exactly (TwoSum) and settles the one case where rounding
    float64 to float32 would round twice, a float32 halfway point."""
    dev = next(v.device for v in (a, b, c) if torch.is_tensor(v))
    a, b, c = torch.broadcast_tensors(*(
        torch.as_tensor(v, dtype=torch.float32, device=dev)
        for v in (a, b, c)))
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    e = (p - (s - bv)) + (cd - bv)
    r = s.float()
    rd = r.double()
    toward = torch.where(rd > s, float("-inf"), float("inf")).float()
    nb = torch.nextafter(r, toward)
    mid = (s != rd) & (s == (rd + nb.double()) * 0.5) & (e != 0)
    return torch.where(mid & ((e > 0) != (rd > s)), nb, r)


def _cumsum(a):
    """Running sum over the first axis, one float32 add a row in order
    (torch.cumsum accumulates float32 in double on the CPU)."""
    rows = [a[0]]
    for r in a[1:]:
        rows.append(rows[-1] + r)
    return torch.stack(rows)


def mm_symbols_chunked_plain(ext, off0, ph0, fr0, emit_lo, emit_hi, goff,
                             bank, geom, mu, omega_gain, min_freq, max_freq,
                             half_omega):
    """Plain PyTorch version of ``mm_symbols_chunked_lanes`` (same
    arguments and results): the group steps in a Python loop on [M, K]
    float32 tensors, operation for operation the kernel's."""
    _check(ext, off0, ph0, fr0, emit_lo, emit_hi, goff, bank, geom)
    K, L, cols, R, J, M, steps, n = (int(v) for v in geom)
    P, T = bank.shape
    dev = ext.device
    cplx = ext.is_complex()
    f32 = torch.float32
    xr = (ext.real if cplx else ext).contiguous()
    xi = ext.imag.contiguous() if cplx else None
    mu, og, fmin, fmax, half = (float(np.float32(v)) for v in
                                (mu, omega_gain, min_freq, max_freq,
                                 half_omega))
    gstat = torch.from_numpy(_gstat(geom, min_freq)).to(dev)[:, None]
    base = (torch.arange(K, device=dev) * L)[None]            # [1, K]
    mvec = torch.arange(M, dtype=f32, device=dev)[:, None]    # [M, 1]
    m1vec = mvec + 1.0
    lane0 = (torch.arange(K, device=dev) == 0)[None]
    d = (T - 1) // 2
    one = torch.ones((), dtype=f32, device=dev)
    fK = torch.full((), float(K), dtype=f32, device=dev)
    fn = float(np.float32(n))

    offset = off0.clone()
    phase, freq = ph0.clone(), fr0.clone()
    nerr = 8 if cplx else 1
    err = [torch.zeros(K, dtype=f32, device=dev) for _ in range(nerr)]

    def sign(v):
        return torch.where(v > 0, one, -one)

    def shifted(h, a):
        """[h..., a[:-len(h)]]: the group's values delayed by len(h)."""
        return torch.cat([torch.stack(h), a[:M - len(h)]])

    def evaluate(Pm, r0, coarse):
        fl = torch.floor(Pm)
        o_int = fl.to(torch.int32)
        rel = o_int - r0
        ok = ((rel >= 0) & (rel <= R - T) & (rel >= gstat)
              & (rel <= gstat + (J - T)))
        rel2 = torch.clamp(rel - gstat, 0, J - T)
        ph = Pm - fl
        idx = base + (r0 + gstat + rel2)
        if coarse:
            w0 = 1.0 - ph
            outs = [w0 * p[idx + d] + ph * p[idx + d + 1]
                    for p in ((xr, xi) if cplx else (xr,))]
        else:
            row = torch.clamp(torch.floor(ph * float(P)).to(torch.int64),
                              0, P - 1)
            taps = bank[row]                                  # [M, K, T]
            outs = []
            for p in ((xr, xi) if cplx else (xr,)):
                acc = taps[..., 0] * p[idx]
                for t in range(1, T):
                    acc = acc + taps[..., t] * p[idx + t]
                outs.append(acc)
        outr = outs[0]
        outi = outs[1] if cplx else None
        if cplx:
            p1r, p1i, p2r, p2i, c1r, c1i, c2r, c2i = err
            c0r, c0i = sign(outr), sign(outi)
            yr1, yi1 = shifted([p1r], outr), shifted([p1i], outi)
            yr2, yi2 = shifted([p2r, p1r], outr), shifted([p2i, p1i], outi)
            cr1, ci1 = shifted([c1r], c0r), shifted([c1i], c0i)
            cr2, ci2 = shifted([c2r, c1r], c0r), shifted([c2i, c1i], c0i)
            e = (((outr - yr2) * cr1 + (outi - yi2) * ci1)
                 - ((c0r - cr2) * yr1 + (c0i - ci2) * yi1))
        else:
            c0r = c0i = None
            yr1 = shifted([err[0]], outr)
            e = sign(yr1) * outr - yr1 * sign(outr)
        e = torch.clamp(e, -1.0, 1.0)
        A = _cumsum(e)
        B = _cumsum(mvec * e)
        ebar = _lane_sum(e, K) / fK
        Abar = _cumsum(ebar)[:, None]
        Bbar = _cumsum(mvec[:, 0] * ebar)[:, None]
        start = fma(m1vec, freq[None], pos[None])
        gain = torch.where(lane0, m1vec * A - B, m1vec * Abar - Bbar)
        pos_m = fma(mu, A, fma(og, gain, start))
        freq_m = torch.clamp(fma(og, torch.where(lane0, A, Abar), freq[None]),
                             fmin, fmax)
        return o_int, ok, outr, outi, c0r, c0i, pos_m, freq_m

    slots_r, slots_i, slots_p, slots_e = [], [], [], []
    for _ in range(steps):
        pos = offset.to(f32) + phase
        active = offset < emit_hi
        r0 = int(torch.where(active, torch.clamp(offset, 0, cols - T),
                             cols - T).min())
        r0 = min(max(r0, 0), cols - R)
        pos_m1 = evaluate(fma(mvec, freq[None], pos[None]), r0, True)[6]
        Pm = torch.cat([pos[None], pos_m1[:-1]])
        o_int, ok, outr, outi, c0r, c0i, pos_m, freq_m = evaluate(Pm, r0,
                                                                  False)
        valid_m = o_int < emit_hi[None]
        nv = valid_m.sum(0)[None].long()                       # [1, K]
        new_pos = torch.cat([pos[None], pos_m]).gather(0, nv)[0]
        new_freq = torch.cat([freq[None], freq_m]).gather(0, nv)[0]
        if cplx:
            p1r, p1i, p2r, p2i, c1r, c1i, c2r, c2i = err
            ext_r = torch.cat([p2r[None], p1r[None], outr])
            ext_i = torch.cat([p2i[None], p1i[None], outi])
            ext_cr = torch.cat([c2r[None], c1r[None], c0r])
            ext_ci = torch.cat([c2i[None], c1i[None], c0i])
            err = [a.gather(0, nv + k)[0] for a, k in
                   ((ext_r, 1), (ext_i, 1), (ext_r, 0), (ext_i, 0),
                    (ext_cr, 1), (ext_ci, 1), (ext_cr, 0), (ext_ci, 0))]
        else:
            err = [torch.cat([err[0][None], outr]).gather(0, nv)[0]]
        gpos = goff[None] + Pm
        emit = ok & valid_m & (Pm >= emit_lo[None]) & (gpos < fn)
        slots_r.append(torch.where(emit, outr, 0.0))
        if cplx:
            slots_i.append(torch.where(emit, outi, 0.0))
        slots_p.append(torch.where(emit, gpos, float("inf")))
        slots_e.append(emit)
        new_off = torch.floor(new_pos)
        offset = new_off.to(torch.int32)
        phase = new_pos - new_off
        freq = new_freq

    def lanes(slots):
        return torch.cat(slots).T.contiguous()               # [K, msc]

    sr = lanes(slots_r)
    syms = torch.complex(sr, lanes(slots_i)) if cplx else sr
    pos = lanes(slots_p)
    emit = lanes(slots_e)
    lastpos = torch.where(emit, pos, float("-inf")).amax(1)
    prev = torch.cat([torch.full((1,), float("-inf"), device=dev),
                      lastpos[:-1]])
    valid = emit & (pos > prev[:, None] + half)
    off_f = ((offset[-1].to(f32) + goff[-1]) - fn).to(torch.int32)
    fst = torch.stack([phase[-1], freq[-1], *(e[-1] for e in err)])
    return syms, valid, pos, off_f, fst


def mm_symbols_chunked_lanes(ext, off0, ph0, fr0, emit_lo, emit_hi, goff,
                             bank, geom, mu, omega_gain, min_freq, max_freq,
                             half_omega, cycles=None):
    """The group steps of a chunked call over the lanes of ``ext``.

    ``ext`` [(K - 1) * L + cols] complex64 or float32: the extended stream
    lane j reads at j*L. ``off0`` [K] int32, ``ph0`` / ``fr0`` [K] float32:
    each lane's seeded offset, phase and period (error state zero).
    ``emit_lo`` [K] float32 / ``emit_hi`` [K] int32: each lane's emission
    floor (a position) and ceiling (an offset). ``goff`` [K] float32: lane
    position to block position. ``bank`` [P, T] float32 ([128, 8] on CUDA).
    ``geom``: a ``ChunkGeometry``. Returns (symbols [K, msc], valid [K, msc]
    bool, positions [K, msc] float32 (inf where nothing is emitted), the
    carried offset (int32, next block's coordinates) and fstate
    [10 | 3] float32: phase, freq, then p1 p2 c1 c2 as re/im pairs, or
    ``last``), the carry lane K-1's. ``cycles``: None, or on CUDA a
    contiguous int64 [8] tensor receiving the kernel's clock64 split
    (total, seed, anchor with the window copy, coarse pass, first lane sum
    with the positions, full pass with its stores, second lane sum with
    the carry, seam; a barrier ends each phase)."""
    params = tuple(float(np.float32(v)) for v in (mu, omega_gain, min_freq,
                                                  max_freq, half_omega))
    if ext.device.type == "cpu":
        return mm_symbols_chunked_plain(ext, off0, ph0, fr0, emit_lo,
                                        emit_hi, goff, bank, geom, *params)
    if ext.device.type != "cuda":
        raise RuntimeError(f"mm_symbols_chunked runs on CUDA or CPU tensors, "
                           f"not {ext.device}")
    result = host_module().mm_chunked(ext, off0, ph0, fr0, emit_lo, emit_hi,
                                      goff, bank, tuple(int(v) for v in geom),
                                      params, cycles)
    mm_symbols_chunked_lanes.launches += 1
    return result


mm_symbols_chunked_lanes.launches = 0


def chunked_lanes_args(x, hist, offset0, phase0, freq0, T: int, geom, W: int,
                       pad: int, allow, lo):
    """The glue of a block call in torch operations: the extended stream
    [hist | x | x[-1] x pad | zeros], each lane's seed (lane 0 continues
    the carried grid; lanes 1..K-1 from the Oerder-Meyr square-law
    estimate over their warm-up, mod freq0, its sums in the kernel's order)
    and emission bounds (lane 0 positional from the carried grid origin,
    ``allow`` below it; lanes j > 0 from ``lo``, reaching back into the
    warm-up; lane K-1's ceiling before the replicate padding). Returns
    ``mm_symbols_chunked_lanes``'s (ext, off0, ph0, fr0, emit_lo, emit_hi,
    goff)."""
    K, L = geom.K, geom.L
    cplx = x.is_complex()
    dev, f32 = x.device, torch.float32
    lane0, base, goff, emit_hi, zeros = _lanes(dev, x.dtype, geom, W, T, pad)
    ext = torch.cat([hist, x, x[-1:].expand(pad), zeros])
    p0 = (offset0.to(f32) + phase0) + float(np.float32(W))
    warm = ext.as_strided((K, W), (L, 1))
    pw = warm.real * warm.real + warm.imag * warm.imag if cplx \
        else warm * warm
    # exp(-2 pi i t / freq0) as its real and imaginary planes
    ang = _const(dev, W, "ang") / freq0
    c_re = _seed_sum(pw * torch.cos(ang))
    c_im = _seed_sum(pw * torch.sin(ang))
    t_hat = (-torch.atan2(c_im, c_re) * freq0) / _const(dev, 0, "two_pi")
    pj_om = torch.remainder(t_hat - float(np.float32((T - 1) / 2.0)), freq0)
    pj = torch.where(lane0, torch.remainder(p0 - base, freq0), pj_om)
    fl = torch.floor(pj)
    return (ext, fl.to(torch.int32), pj - fl,
            freq0.reshape(()).expand(K).contiguous(),
            torch.where(lane0, p0 - allow, lo), emit_hi, goff)


def mm_symbols_chunked_block_plain(x, hist, offset0, phase0, freq0, bank,
                                   geom, W, pad, mu, omega_gain, min_freq,
                                   max_freq, half_omega, allow, lo):
    """Plain PyTorch version of ``mm_symbols_chunked_block`` (same
    arguments and results): ``chunked_lanes_args``, then
    ``mm_symbols_chunked_plain``."""
    _check_block(x, hist, offset0, phase0, freq0, bank, geom, W, pad)
    lanes = chunked_lanes_args(x, hist, offset0, phase0, freq0,
                               bank.shape[1], geom, W, pad, allow, lo)
    return mm_symbols_chunked_plain(*lanes, bank, geom, mu, omega_gain,
                                    min_freq, max_freq, half_omega)


def mm_symbols_chunked_block(x, hist, offset0, phase0, freq0, bank, geom, W,
                             pad, mu, omega_gain, min_freq, max_freq,
                             half_omega, allow, lo, cycles=None):
    """One block of the chunked M&M, glue and group steps in one call.

    ``x`` [n] complex64 or float32; ``hist`` [W + T - 1] the previous
    block's last raw samples, of x's type; ``offset0`` (int32), ``phase0``,
    ``freq0`` (float32): the carried loop state, one element each;
    ``bank`` [P, T] float32 ([128, 8] on CUDA); ``geom`` the layout
    (``chunk_geometry``) with ``W`` warm-up samples and ``pad`` = K*L - n;
    ``allow`` lane 0's emission allowance below its first position, ``lo``
    the other lanes' emission floor. Returns what
    ``mm_symbols_chunked_lanes`` returns for ``chunked_lanes_args``'s
    lanes; on CUDA one launch of csrc/mm_clock.cu's block entry
    (``cycles`` as there), on the CPU ``mm_symbols_chunked_block_plain``."""
    params = tuple(float(np.float32(v)) for v in (
        mu, omega_gain, min_freq, max_freq, half_omega, allow, lo))
    if x.device.type == "cpu":
        return mm_symbols_chunked_block_plain(x, hist, offset0, phase0,
                                              freq0, bank, geom, W, pad,
                                              *params)
    if x.device.type != "cuda":
        raise RuntimeError(f"mm_symbols_chunked runs on CUDA or CPU tensors, "
                           f"not {x.device}")
    result = host_module().mm_chunked_block(x, hist, offset0, phase0, freq0,
                                            bank, geom, W, pad, params,
                                            cycles)
    mm_symbols_chunked_lanes.launches += 1
    return result


@functools.lru_cache(maxsize=64)
def _block_layout(n: int, K: int, W: int, T: int, mu_gain, omega_gain,
                  min_freq, max_freq):
    """(geom, pad, the block entry's float parameters: mu, omega_gain,
    min_freq, max_freq, omega / 2, lane 0's allowance 0.4 omega and the
    other lanes' emission floor W - ceil(omega)) of a layout."""
    geom, pad_e, pad = chunk_geometry(n, K, W, T, min_freq, max_freq)
    omega = float((min_freq + max_freq) / 2.0)
    return geom, pad, tuple(float(np.float32(v)) for v in (
        mu_gain, omega_gain, min_freq, max_freq, omega / 2.0, 0.4 * omega,
        W - pad_e))


def _carry(off_f, fst, cplx: bool) -> dict:
    """The carried loop state from a call's offset and fstate, as views."""
    carry = {"offset": off_f, "phase": fst[0], "freq": fst[1]}
    if cplx:
        errs = fst[2:].view(torch.complex64)
        carry.update(zip(("p1", "p2", "c1", "c2"), errs))
    else:
        carry["last"] = fst[2]
    return carry


def mm_symbols_chunked(x, hist, offset0, phase0, freq0, err0, bank, mu_gain,
                       omega_gain, min_freq, max_freq, lanes_k: int,
                       warmup: int):
    """Run the M&M recurrence chunk-parallel over K lanes (the JAX
    package's ``mm_symbols_chunked``, same arguments and results).

    ``x`` [n] complex64 or float32; ``hist`` the previous block's last
    ``warmup + T - 1`` samples; ``offset0`` / ``phase0`` / ``freq0`` the
    carried loop state (``err0`` is not used: every lane's error state
    seeds to zero). Returns (symbols, valid, positions, carry): symbols,
    valid (a mask) and positions flattened [K * msc] lane-major, and the
    carry, lane K-1's final loop state in the next block's coordinates."""
    del err0
    f32 = torch.float32
    bank = bank.to(device=x.device, dtype=f32)
    geom, pad, params = _block_layout(x.shape[-1], int(lanes_k), int(warmup),
                                      bank.shape[1], mu_gain, omega_gain,
                                      min_freq, max_freq)
    syms, valid, pos, off_f, fst = mm_symbols_chunked_block(
        x, hist.to(x.dtype), offset0.to(torch.int32), phase0.to(f32),
        freq0.to(f32), bank, geom, int(warmup), pad, *params)
    return (syms.reshape(-1), valid.reshape(-1), pos.reshape(-1),
            _carry(off_f, fst, x.is_complex()))


class MMClockRecoveryChunked(MMClockRecovery):
    """M&M clock recovery, chunk-parallel for long 1-D blocks and the
    exact ``mm_symbols`` otherwise (the JAX block of the same name,
    clock_recovery_chunked.py:477). State grows ``hist``, the last
    ``warmup + tap_count - 1`` raw samples."""

    def __init__(self, *args, warmup: int = 512, max_lanes: int = 256,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)

    def _hist_len(self):
        return self.warmup + self.tap_count - 1

    def init_state(self):
        st = super().init_state()
        st["hist"] = torch.zeros(self._hist_len(), dtype=self.dtype,
                                 device=self.device)
        return st

    def _lanes_for(self, n: int) -> int:
        return scans_kernels._chunk_lanes_for(n, self.warmup, self.max_lanes)

    def _group_for(self) -> int:
        return group_for(self.warmup,
                         float(self.min_freq + self.max_freq) / 2.0)

    def max_symbols(self, n: int) -> int:
        k = self._lanes_for(n)
        if k >= 1:
            geom = chunk_geometry(n, k, self.warmup, self.tap_count,
                                  self.min_freq, self.max_freq)[0]
            return k * geom.M * geom.steps
        return super().max_symbols(n)

    def __call__(self, state, x):
        x = x.to(self.dtype)
        hist = torch.cat([state["hist"], x])[-self._hist_len():]
        k = self._lanes_for(x.shape[-1])
        if x.ndim != 1 or k < 1:
            sub = {kk: v for kk, v in state.items() if kk != "hist"}
            sub, out = super().__call__(sub, x)
            return {**sub, "hist": hist}, out
        syms, valid, _, carry = mm_symbols_chunked(
            x, state["hist"], state["offset"], state["phase"], state["freq"],
            None, self._bank, self.mu_gain, self.omega_gain, self.min_freq,
            self.max_freq, lanes_k=k, warmup=self.warmup)
        tail = torch.cat([state["tail"], x])[-(self.tap_count - 1):]
        return {"tail": tail, "hist": hist, **carry}, (syms, valid)
