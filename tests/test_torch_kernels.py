"""Contracts of the M&M and decimating-FIR kernels' wrappers that the CUDA
kernels' staging must keep, checked on the CPU through the plain
versions, and the wrappers' checks.

- ``mm_symbols_plain`` is a recurrence over one row: two blocks with the
  offset and state carried give exactly the symbols, counts, offset and
  state of one pass over the concatenated row (the kernel walks its row
  through a ring of shared-memory stages, and the meteor path hands it
  one block at a time). Bit-exact: the same float32 operations in the
  same order.
- On CUDA the kernel writes a symbol count and the wrapper builds the
  valid mask from it; that mask equals the plain version's.
- ``decimating_fir_plain`` against the JAX package's Pallas kernel
  (``decimating_fir_pallas``, interpret mode, as its own tests run it) at
  the /128 stage (r = 128, 726 taps), after a block shorter than the tail
  (n < m - 1, which the Pallas kernel's [4096, r] tiling cannot take, so
  that block goes through ``decimating_fir_correlate``): the surviving
  tail carries into the Pallas block. Outputs within 2e-5 of the peak
  (the Pallas kernel sums phase by phase, the port tap by tap), tails
  exact.
- ``mix.mix_bank`` on the CPU is the torch expression it ran before the
  kernel (``mix_bank_plain``), bit for bit, output and carried phase, for
  a shared and a per-channel x and a channel shard's rows; a CPU call
  launches nothing. The kernel's exact wrap (``fmodf``, then 2pi added
  where negative) is ``torch.remainder`` bit for bit.
- The wrappers raise on a wrong device, dtype or shape and never fall
  back; ``cuda_lib.bind`` sets an entry's types once; a kernel or host
  module is compiled once, and a failed build raises and leaves nothing.
"""

import ctypes
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdrpp_tpu.ops import fir as jfir
from sdrpp_tpu.ops import resample as jresample
from sdrpp_tpu_torch.ops import clock_recovery_kernels as MK
from sdrpp_tpu_torch.ops import fir_kernels as FK
from sdrpp_tpu_torch.ops import mix as MX
from sdrpp_tpu_torch.ops.clock_recovery import MMClockRecovery
from sdrpp_tpu_torch.parallel.spmd import channel_shard
from sdrpp_tpu_torch.utils import cuda_lib

torch.set_num_threads(1)

FIR_TOL = 2e-5
SPS = 150000.0 / 72000.0


def _mm_row(n, cplx, seed):
    """QPSK (or BPSK) held at SPS samples per symbol, with noise."""
    rng = np.random.default_rng(seed)
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n)))
    x = sym[(np.arange(n) / SPS).astype(np.int64)]
    x = x + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64) if cplx else x.real.astype(np.float32)


def _mm(cplx):
    return MMClockRecovery(SPS, 0.001, 0.01, 0.01, complex_input=cplx,
                           device="cpu")


def _params(mm):
    return (mm.mu_gain, mm.omega_gain, mm.min_freq, mm.max_freq)


@pytest.mark.parametrize("cplx", [True, False])
def test_mm_plain_two_blocks_equal_one_pass(cplx):
    mm = _mm(cplx)
    na, nb = 1000, 1300
    row = torch.from_numpy(_mm_row(na + nb + 7, cplx, 3))[None]
    kf = 10 if cplx else 3
    fstate = torch.zeros((1, kf))
    fstate[0, 0], fstate[0, 1] = 0.3, float(np.float32(mm.omega))
    off = torch.tensor([2], dtype=torch.int32)
    whole = MK.mm_symbols_plain(row, off, fstate, mm._bank,
                                mm.max_symbols(na + nb), *_params(mm))
    a = MK.mm_symbols_plain(row[:, :na + 7], off, fstate, mm._bank,
                            mm.max_symbols(na), *_params(mm))
    b = MK.mm_symbols_plain(row[:, na:], a[2], a[3], mm._bank,
                            mm.max_symbols(nb), *_params(mm))
    ka, kb = int(a[1].sum()), int(b[1].sum())
    assert ka > 400 and kb > 550
    assert int(whole[1].sum()) == ka + kb
    assert torch.equal(whole[0][0, :ka + kb],
                       torch.cat([a[0][0, :ka], b[0][0, :kb]]))
    assert torch.equal(whole[2], b[2])
    assert torch.equal(whole[3], b[3])
    assert not bool(whole[0][0, ka + kb:].abs().any())  # zeros past the count


def test_mm_prefix_mask_from_count_equals_the_plain_mask():
    mm = _mm(True)
    n = 700
    rows = torch.from_numpy(np.stack([_mm_row(n + 7, True, s)
                                      for s in (4, 5, 6)]))
    fstate = torch.zeros((3, 10))
    fstate[:, 1] = float(np.float32(mm.omega))
    off = torch.tensor([0, 5, 11], dtype=torch.int32)
    max_syms = mm.max_symbols(n)
    _, valid, _, _ = MK.mm_symbols_plain(rows, off, fstate, mm._bank,
                                         max_syms, *_params(mm))
    count = valid.sum(1).to(torch.int32)
    assert len(set(count.tolist())) > 1  # the streams end apart
    mask = MK._prefix_mask(count, max_syms)
    assert mask.dtype == torch.bool and torch.equal(mask, valid)


def test_mm_wrappers_raise_and_never_fall_back():
    mm = _mm(True)
    row = torch.zeros((1, 40), dtype=torch.complex64)
    off = torch.zeros(1, dtype=torch.int32)
    fst = torch.zeros((1, 10))
    args = (mm.max_symbols(33), *_params(mm))
    with pytest.raises(ValueError, match="complex64 or float32"):
        MK.mm_symbols(row.to(torch.complex128), off, fst, mm._bank, *args)
    with pytest.raises(ValueError, match="offset"):
        MK.mm_symbols(row, off.long(), fst, mm._bank, *args)
    with pytest.raises(ValueError, match="fstate"):
        MK.mm_symbols(row, off, fst[:, :3], mm._bank, *args)
    with pytest.raises(ValueError, match="bank"):
        MK.mm_symbols(row, off, fst, mm._bank.double(), *args)
    with pytest.raises(ValueError, match="one device"):
        MK.mm_symbols(row, off.to("meta"), fst, mm._bank, *args)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        MK.mm_symbols(row.to("meta"), off.to("meta"), fst.to("meta"),
                      mm._bank.to("meta"), *args)
    # the kernel takes the 128 x 8 bank only; the compiled host path checks
    # it before any launch (here its build without CUDA), and the plain
    # version keeps taking other banks
    from sdrpp_tpu_torch.utils import cuda_lib

    bank = mm._bank[:64]
    params = tuple(float(np.float32(v)) for v in _params(mm))
    host = cuda_lib.load_host("kernels_host", cuda=False)
    with pytest.raises(ValueError, match=r"\[128, 8\] bank"):
        host.mm_symbols(row, off, fst, bank, 33, params, None)
    before = MK.mm_symbols.launches
    syms, valid, _, _ = MK.mm_symbols(row, off, fst, bank, *args)
    assert MK.mm_symbols.launches == before and syms.shape == valid.shape


def test_decimating_fir_plain_matches_pallas_after_a_short_block(monkeypatch):
    monkeypatch.setenv("SDRPP_TPU_PALLAS_INTERPRET", "1")
    from sdrpp_tpu.ops.fir_pallas import ROWS, decimating_fir_pallas

    r, taps = jresample.decim_plan(8192)[0]
    m = taps.shape[0]
    assert (r, m) == (128, 726)
    w = torch.from_numpy(taps.astype(np.float32))
    rng = np.random.default_rng(9)

    def signal(n):
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                ).astype(np.complex64)

    jt = jnp.asarray(signal(m - 1))
    tt = torch.from_numpy(np.array(jt))
    # n = 256 < m - 1: the new tail is the old tail's last 469 samples
    # followed by the block
    x = signal(2 * r)
    jt2, jy = jfir.decimating_fir_correlate(jt, jnp.asarray(x), taps, r)
    tt2, ty = FK.decimating_fir_plain(tt, torch.from_numpy(x), w, r)
    np.testing.assert_array_equal(np.asarray(jt2), tt2.numpy())
    np.testing.assert_array_equal(tt2[:m - 1 - 2 * r].numpy(),
                                  tt[2 * r:].numpy())
    peak = float(np.abs(np.asarray(jy)).max())
    assert float(np.abs(np.asarray(jy) - ty.numpy()).max()) <= FIR_TOL * peak
    # then one block of the Pallas kernel's own size from that tail
    x = signal(r * ROWS)
    jt3, jy = decimating_fir_pallas(jt2, jnp.asarray(x), taps, r)
    tt3, ty = FK.decimating_fir_plain(tt2, torch.from_numpy(x), w, r)
    np.testing.assert_array_equal(np.asarray(jt3), tt3.numpy())
    jy = np.asarray(jy)
    assert jy.shape == ty.shape
    peak = float(np.abs(jy).max())
    assert float(np.abs(jy - ty.numpy()).max()) <= FIR_TOL * peak


def test_decimating_fir_wrapper_raises_on_wrong_inputs():
    r, taps = jresample.decim_plan(128)[0]
    m = taps.shape[0]
    w = torch.from_numpy(taps.astype(np.float32))
    x = torch.zeros((2, r * 8), dtype=torch.complex64)
    tail = torch.zeros((2, m - 1), dtype=torch.complex64)
    with pytest.raises(ValueError, match="complex64 or float32"):
        FK.decimating_fir(tail.to(torch.complex128), x.to(torch.complex128),
                          w, r)
    with pytest.raises(ValueError, match="taps"):
        FK.decimating_fir(tail, x, w.double(), r)
    with pytest.raises(ValueError, match="tail"):
        FK.decimating_fir(tail[:1], x, w, r)
    with pytest.raises(ValueError, match="tail"):
        FK.decimating_fir(tail.real.contiguous(), x, w, r)
    with pytest.raises(ValueError, match="one device"):
        FK.decimating_fir(tail, x, w.to("meta"), r)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        FK.decimating_fir(tail.to("meta"), x.to("meta"), w.to("meta"), r)
    # a non-contiguous [rows, n] view gives what its contiguous copy gives
    xs = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, r * 16)).astype(np.float32))[:, ::2]
    a = FK.decimating_fir(tail.real.contiguous(), xs, w, r)
    b = FK.decimating_fir(tail.real.contiguous(), xs.contiguous(), w, r)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def _bank_expression(phase, x, omegas, hi, lo, step):
    """``mix_bank``'s body as it stood before the kernel."""
    c, n = phase.shape[0], x.shape[-1]
    two_pi = float(np.float32(2.0 * np.pi))
    new_phase = torch.remainder(phase + step, two_pi)
    ph = phase[:, None, None] + hi[:, :, None] + lo[:, None, :]
    ph = torch.remainder(ph, two_pi).reshape(c, n)
    return new_phase, x * torch.complex(torch.cos(ph), torch.sin(ph))


class _Mesh:
    """A one-dim mesh of 4 ranks seen from rank 2 (what ``local_rows``
    reads of a DeviceMesh)."""
    shape, mesh_dim_names = (4,), ("chip",)

    @staticmethod
    def get_local_rank(name):
        return 2


@pytest.mark.parametrize("case", ["shared", "rows", "shard", "odd", "c100"])
def test_mix_bank_cpu_is_the_plain_expression(case):
    """``c100``: the FM band's 100 channels, six 16-channel groups and a
    partial seventh of 4 on the card."""
    rng = np.random.default_rng(11)
    c, n = (100 if case == "c100" else 8), (3 * 1001 if case == "odd"
                                            else 6000)
    omegas = rng.uniform(-np.pi, np.pi, c)
    tables = MX.mix_bank_tables(n, omegas, "cpu")
    hi, lo, step = tables
    shape = (c, n) if case == "rows" else (n,)
    x = torch.from_numpy((rng.standard_normal(shape)
                          + 1j * rng.standard_normal(shape)
                          ).astype(np.complex64))
    phase = torch.from_numpy(rng.uniform(0, 2 * np.pi, c).astype(np.float32))
    before = MX.mix_bank.launches
    if case == "shard":
        rows = slice(4, 6)  # rank 2 of 4 holds rows 4 and 5
        with channel_shard("chip", _Mesh()):
            got = MX.mix_bank(phase[rows], x, omegas, tables)
        want = _bank_expression(phase[rows], x, omegas, hi[rows], lo[rows],
                                step[rows])
    else:
        want = _bank_expression(phase, x, omegas, *tables)
        got = MX.mix_bank(phase, x, omegas, tables)
        # a second block from the carried phase, the tables built inside
        want2 = _bank_expression(want[0], x, omegas, *tables)
        got2 = MX.mix_bank(got[0], x, omegas)
        for u, v in zip(want2, got2):
            assert torch.equal(u, v)
    for u, v in zip(want, got):
        assert u.dtype == v.dtype and torch.equal(u, v)
    assert MX.mix_bank.launches == before


def test_mix_bank_kernel_wrap_is_remainder():
    """csrc/mix.cu's wrap_2pi, in numpy float32: fmodf plus 2pi where
    negative; equal to torch.remainder bit for bit (ties at k 2pi, -0.0,
    large and negative angles)."""
    two = np.float32(2.0 * np.pi)
    rng = np.random.default_rng(5)
    steps = two * np.arange(5, dtype=np.float32)
    s = np.concatenate([
        rng.uniform(0, 4 * two, 200000), rng.uniform(-1e4, 1e4, 20000),
        steps, np.nextafter(steps, np.float32(-1)),
        np.nextafter(steps, np.float32(99)), [-0.0, 1e30, -1e30]
    ]).astype(np.float32)
    r = np.fmod(s, two)
    r = np.where(r < 0, r + two, r).astype(np.float32)
    want = torch.remainder(torch.from_numpy(s), float(two)).numpy()
    np.testing.assert_array_equal(r.view(np.int32), want.view(np.int32))


def test_mix_bank_wrapper_raises_and_never_falls_back():
    c, n = 4, 64
    omegas = np.linspace(-1, 1, c)
    hi, lo, step = MX.mix_bank_tables(n, omegas, "cpu")
    x = torch.zeros(n, dtype=torch.complex64)
    phase = torch.zeros(c)
    before = MX.mix_bank.launches
    with pytest.raises(ValueError, match="complex64 x"):
        MX.mix_bank(phase, x.to(torch.complex128), omegas, (hi, lo, step))
    with pytest.raises(ValueError, match="complex64 x"):
        MX.mix_bank(phase, x.real.contiguous(), omegas, (hi, lo, step))
    with pytest.raises(ValueError, match="float32 phase"):
        MX.mix_bank(phase.double(), x, omegas, (hi, lo, step))
    with pytest.raises(ValueError, match="float32 lo"):
        MX.mix_bank(phase, x, omegas, (hi, lo.double(), step))
    with pytest.raises(ValueError, match="shapes"):
        MX.mix_bank(phase, x[:-1], omegas, (hi, lo, step))
    with pytest.raises(ValueError, match="shapes"):
        MX.mix_bank(phase, torch.zeros((c + 1, n), dtype=torch.complex64),
                    omegas, (hi, lo, step))
    with pytest.raises(ValueError, match="shapes"):
        MX.mix_bank(phase[:2], x, omegas, (hi, lo, step))
    with pytest.raises(ValueError, match="phase"):
        MX.mix_bank(phase[None], x, omegas, (hi, lo, step))
    with pytest.raises(ValueError, match="phase"):
        MX.mix_bank(phase, x[None, None], omegas, (hi, lo, step))
    with pytest.raises(ValueError, match="shapes"):  # K = 12
        MX.mix_bank(phase, x[:48], omegas, (torch.zeros((c, 4)),
                                            torch.zeros((c, 12)), step))
    with pytest.raises(ValueError, match="one device"):
        MX.mix_bank(phase.to("meta"), x, omegas, (hi, lo, step))
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        MX.mix_bank(phase.to("meta"), x.to("meta"), omegas,
                    tuple(t.to("meta") for t in (hi, lo, step)))
    assert MX.mix_bank.launches == before


def test_cuda_lib_bind_sets_the_types_once(monkeypatch):
    libc = ctypes.CDLL(None)
    monkeypatch.setattr(cuda_lib, "load", lambda name: libc)
    monkeypatch.setattr(cuda_lib, "_bound", {})
    fn = cuda_lib.bind("libc", "abs", [ctypes.c_int])
    assert fn.restype is ctypes.c_int and fn.argtypes == [ctypes.c_int]
    assert fn(-5) == 5
    assert cuda_lib.bind("libc", "abs", [ctypes.c_double]) is fn
    assert fn.argtypes == [ctypes.c_int]


def test_cuda_lib_compiles_once_and_raises_on_a_failed_build(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    src = tmp_path / "k.cpp"
    src.write_text("int k;")
    runs = []

    def tool(out):
        runs.append(out)
        return [sys.executable, "-c",
                f"open({str(out)!r}, 'w').write('lib'); print('built')"]

    lib = tmp_path / "k-0.so"
    assert cuda_lib._compile(src, lib, tool, "tool") == lib
    assert lib.read_text() == "lib"
    assert "built" in lib.with_suffix(".log").read_text()
    assert cuda_lib._compile(src, lib, tool, "tool") == lib and len(runs) == 1
    bad = tmp_path / "k-1.so"
    with pytest.raises(RuntimeError, match=r"tool failed on .*k\.cpp"):
        cuda_lib._compile(src, bad, lambda out: [
            sys.executable, "-c", "import sys; sys.exit('no')"], "tool")
    assert not bad.exists() and not list(tmp_path.glob("*.tmp"))
