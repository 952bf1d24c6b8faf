"""The compiled host path's argument checks against the Python ones.

``csrc/kernels_host.cpp`` repeats, in C++, the checks of
``scans_kernels._check`` (lane_scan / single_scan),
``fir_kernels._check`` (decimating_fir), ``fec_kernels._check_acs`` /
``_check_traceback`` (the Viterbi entries), and
``clock_recovery_kernels._check`` / ``_check_fd`` and
``clock_recovery_chunked._check`` (mm_symbols, fd_symbols, the chunked
M&M), in their order and with their messages: on the card it is the only check a call gets. Here it is built
without CUDA (``cuda_lib.load_host(..., cuda=False)``: the same checks,
no launch) and both validators get the same wrong arguments on CPU
tensors: each case must raise ValueError with the same message from both.
Arguments both accept must pass the Python check and stop in C++ at the
kernel's own condition, a CUDA tensor. Needs the host C++ compiler (g++,
as the card's build does); the build takes about 20 s.
"""

import pytest
import torch

from sdrpp_tpu_torch.ops import clock_recovery_chunked as CC
from sdrpp_tpu_torch.ops import clock_recovery_kernels as MK
from sdrpp_tpu_torch.ops import fec_kernels as FK
from sdrpp_tpu_torch.ops import fir_kernels as F
from sdrpp_tpu_torch.ops import scans_kernels as K
from sdrpp_tpu_torch.utils import cuda_lib


@pytest.fixture(scope="module")
def host():
    return cuda_lib.load_host("kernels_host", cuda=False)


def _message(fn, *args):
    """The ValueError message of fn(*args), or None when it returns."""
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


AGC = K.agc_body(1.0, 50.0 / 48000.0, 5.0 / 48000.0, 10e6, 10.0)
PLL = K.pll_body(0.14, 0.0055, 0.49, 0.51)


def _lanes(n=100, c=4):
    x = torch.rand((n, c), generator=torch.Generator().manual_seed(3))
    return [x, K.suffix_max(x.T).T.contiguous()], torch.ones((2, c))


def _loop_cases():
    """(id, body, state, streams, single, valid, out, skip, side)."""
    s, st = _lanes()
    s1, st1 = [x[:, 0] for x in s], st[:, 0]
    s3 = [x.reshape(100, 2, 2) for x in s]
    z = torch.zeros
    return [
        ("stream count", AGC, st, s[:1], False, None, None, 0, None),
        ("stream count pll", PLL, st, s, False, None, None, 0, None),
        ("state dtype", AGC, st.double(), s, False, None, None, 0, None),
        ("stream dtype", AGC, st, [s[0], s[1].double()], False, None, None,
         0, None),
        ("stream device", AGC, st, [s[0], s[1].to("meta")], False, None,
         None, 0, None),
        ("4-D streams", AGC, st[..., None, None],
         [x[..., None, None] for x in s], False, None, None, 0, None),
        ("1-D lanes", AGC, st1, s1, False, None, None, 0, None),
        ("2-D single", AGC, st, s, True, None, None, 0, None),
        ("shapes differ", AGC, st, [s[0], s[1][:50]], False, None, None, 0,
         None),
        ("state shape", AGC, st[:, :3], s, False, None, None, 0, None),
        ("state shape 3-D", AGC, st, s3, False, None, None, 0, None),
        ("valid high", AGC, st, s, False, 101, None, 0, None),
        ("valid low", AGC, st, s, False, -1, None, 0, None),
        ("skip high", AGC, st, s, False, None, None, 101, None),
        ("skip low", AGC, st, s, False, None, None, -2, None),
        ("out dtype", AGC, st, s, False, None, z((100, 4)).double(), 0, None),
        ("out device", AGC, st, s, False, None, z((100, 4), device="meta"),
         0, None),
        ("out rows", AGC, st, s, False, None, z((100, 4)), 10, None),
        ("out lanes", AGC, st, s, False, None, z((100, 3)), 0, None),
        ("out dims", AGC, st, s, False, None, z((100, 2, 2)), 0, None),
        ("out broadcast", AGC, st, s, False, None, z((1, 4)).expand(100, 4),
         0, None),
        ("out zero stride", AGC, st, s, False, None,
         z(8).as_strided((100, 4), (0, 2)), 0, None),
        ("out strides overlap", AGC, st, s, False, None,
         z(400).as_strided((100, 4), (2, 1)), 0, None),
        ("side rows", AGC, st, s, False, None, None, 3, z((5, 4))),
        ("side lanes", AGC, st, s, False, None, None, 10, z((5, 2))),
        ("side dtype", AGC, st, s, False, None, None, 10,
         z((5, 4), dtype=torch.int32)),
        ("side broadcast", AGC, st, s, False, None, None, 90,
         z((1, 4)).expand(5, 4)),
        ("out before side", AGC, st, s, False, None,
         z((1, 4)).expand(90, 4), 10, z((5, 1))),
        # accepted by both: the C++ check stops at the CUDA condition
        ("accepted lanes", AGC, st, s, False, 60, None, 0, None),
        ("accepted 3-D", AGC, st.reshape(2, 2, 2), s3, False, None,
         z((90, 2, 2)), 10, z((4, 2, 2))),
        ("accepted strided", AGC, st.T.contiguous().T,
         [x.T.contiguous().T for x in s], False, None,
         z((4, 100)).T, 0, None),
        ("accepted single", AGC, st1, s1, True, 99, None, 0, None),
    ]


@pytest.mark.parametrize("case", _loop_cases(), ids=lambda c: c[0])
def test_loop_scan_checks_match_python(host, case):
    _, body, state, streams, single, valid, out, skip, side = case
    want = _message(K._check, body, state, streams, single, valid, out, skip,
                    side)
    got = _message(host.loop_scan, K._BODY_IDS[body.name], body.params,
                   state, streams, valid, out, skip, side, None, single)
    if want is None:
        assert case[0].startswith("accepted")
        assert got == "the compiled loop scan takes CUDA tensors"
    else:
        assert got == want


def test_loop_scan_host_checks_its_own_arguments(host):
    s, st = _lanes()
    with pytest.raises(ValueError, match="agc takes 7 parameters, got 4"):
        host.loop_scan(K._BODY_IDS["agc"], PLL.params, st, s, None, None, 0,
                       None, None, False)
    with pytest.raises(ValueError, match="unknown body 7"):
        host.loop_scan(7, AGC.params, st, s, None, None, 0, None, None, False)
    with pytest.raises(TypeError):
        host.loop_scan(1, AGC.params, st, s, None, None, 0, None, None)
    with pytest.raises(TypeError):
        host.loop_scan(1, AGC.params, st, [s[0], 1.0], None, None, 0, None,
                       None, False)
    with pytest.raises(ValueError, match="null entry"):
        host.bind_loop_scan(0)
    with pytest.raises(ValueError, match="null entry"):
        host.bind_decim_fir(1, 0)
    with pytest.raises(ValueError, match="null entry"):
        host.bind_viterbi(1, 0, 1)
    with pytest.raises(ValueError, match="null entry"):
        host.bind_viterbi(1, 1, 0)   # the traceback's scratch-size entry
    with pytest.raises(TypeError, match="traceback_scratch_entry"):
        host.bind_viterbi(1, 1)


def _fir_cases():
    """(id, tail, x, taps, r)."""
    g = torch.Generator().manual_seed(4)
    c64 = torch.complex64
    x = torch.randn((2, 64), dtype=c64, generator=g)
    taps = torch.rand(9, generator=g)
    tail = torch.zeros((2, 8), dtype=c64)
    return [
        ("x dtype", tail, x.to(torch.complex128), taps, 8),
        ("x int", tail, torch.zeros((2, 64), dtype=torch.int32), taps, 8),
        ("taps dtype", tail, x, taps.double(), 8),
        ("taps 2-D", tail, x, taps[None], 8),
        ("taps empty", tail, x, taps[:0], 8),
        ("tail dtype", tail.to(torch.complex128), x, taps, 8),
        ("tail float32", tail.real.contiguous(), x, taps, 8),
        ("tail length", tail[:, :7], x, taps, 8),
        ("tail rows", tail[:1], x, taps, 8),
        ("tail dims", tail[0], x, taps, 8),
        ("tail 3-D rows", torch.zeros((2, 3, 8), dtype=c64),
         x.reshape(2, 2, 32), taps, 8),
        ("f32 tail c64", tail, x.real.contiguous(), taps, 8),
        ("tail device", tail.to("meta"), x, taps, 8),
        ("taps device", tail, x, taps.to("meta"), 8),
        ("r not a divisor", tail, x, taps, 5),
        ("r zero", tail, x, taps, 0),
        ("r negative", tail, x, taps, -8),
        ("accepted c64", tail, x, taps, 8),
        ("accepted f32", tail.real.contiguous(), x.real.contiguous(), taps,
         16),
        ("accepted 1-D", tail[0], x[0], taps, 4),
    ]


@pytest.mark.parametrize("case", _fir_cases(), ids=lambda c: c[0])
def test_decim_fir_checks_match_python(host, case):
    _, tail, x, taps, r = case
    want = _message(F._check, tail, x, taps, r)
    got = _message(host.decim_fir, tail, x, taps, r)
    if want is None:
        assert case[0].startswith("accepted")
        assert got == "the compiled decimating_fir takes CUDA tensors"
    else:
        assert got == want



def _viterbi_acs_cases():
    """(id, soft, starts, T, expected)."""
    s = torch.zeros((50, 2), dtype=torch.uint8)
    st = torch.zeros(2, dtype=torch.int32)
    e = torch.zeros((128, 2))
    return [
        ("soft dtype", s.double(), st, 10, e),
        ("soft dims", s[None], st, 10, e),
        ("rate", torch.zeros((50, 33), dtype=torch.uint8), st, 10,
         torch.zeros((128, 33))),
        ("rate one", torch.zeros((50, 1), dtype=torch.uint8), st, 10,
         torch.zeros((128, 1))),
        ("rate zero", torch.zeros((50, 0), dtype=torch.uint8), st, 10,
         torch.zeros((128, 0))),
        ("expected rows", s, st, 10, e[:96]),
        ("expected rate", s, st, 10, torch.zeros((128, 4))),
        ("expected dtype", s, st, 10, e.double()),
        ("starts dtype", s, st.long(), 10, e),
        ("starts 2-D", s, st[None], 10, e),
        ("starts empty", s, st[:0], 10, e),
        ("starts device", s, st.to("meta"), 10, e),
        ("expected device", s, st, 10, e.to("meta")),
        ("T zero", s, st, 0, e),
        ("T long", s, st, 51, e),
        ("accepted u8", s, st, 10, e),
        ("accepted f32 rate 4", torch.zeros((50, 4)), st, 50,
         torch.zeros((128, 4))),
        ("accepted strided", s.T.contiguous().T, st[::1], 1, e.T.contiguous().T),
        ("accepted rate 5", torch.zeros((50, 5), dtype=torch.uint8), st, 10,
         torch.zeros((128, 5))),
        ("accepted 256 states", s, st, 10, torch.zeros((512, 2))),
        ("expected rows 2S + 2", s, st, 10, torch.zeros((130, 2))),
    ]


@pytest.mark.parametrize("case", _viterbi_acs_cases(), ids=lambda c: c[0])
def test_viterbi_acs_checks_match_python(host, case):
    _, soft, starts, T, expected = case
    want = _message(FK._check_acs, soft, starts, T, expected)
    got = _message(host.viterbi_acs, soft, starts, T, expected, None)
    if want is None:
        assert case[0].startswith("accepted")
        assert got == "the compiled Viterbi ACS takes CUDA tensors"
    else:
        assert got == want


@pytest.mark.parametrize("dec", [
    torch.zeros((2, 3), dtype=torch.int32), torch.zeros(3, dtype=torch.int64),
    torch.zeros((0, 3), dtype=torch.int64),
    torch.zeros((2, 0), dtype=torch.int64),
    torch.zeros((2, 3), dtype=torch.int64)],
    ids=["dtype", "1-D", "no windows", "no steps", "accepted"])
def test_viterbi_traceback_checks_match_python(host, dec):
    want = _message(FK._check_traceback, dec)
    got = _message(host.viterbi_traceback, dec, None)
    if want is None:
        assert got == "the compiled Viterbi traceback takes CUDA tensors"
    else:
        assert got == want


def test_viterbi_host_checks_its_own_arguments(host):
    s = torch.zeros((50, 2), dtype=torch.uint8)
    st = torch.zeros(2, dtype=torch.int32)
    e = torch.zeros((128, 2))
    with pytest.raises(TypeError):
        host.viterbi_acs(s, st, 10, e)
    with pytest.raises(TypeError):
        host.viterbi_acs(s, st, 10.0, e, None)
    with pytest.raises(TypeError):
        host.viterbi_traceback(torch.zeros((2, 3), dtype=torch.int64))


# ---------------------------------------------------------------------------
# mm_symbols / fd_symbols / the chunked M&M (csrc/mm_clock.cu)
# ---------------------------------------------------------------------------

BANK = torch.zeros((128, 8))
MM_PARAMS = (0.01, 0.001, 2.0, 2.2)


def _walk_cases(cplx):
    """(id, buf, offset, fstate, bank) for mm_symbols (cplx None: the FD
    walker's float rows and [C, 2] state)."""
    fd = cplx is None
    dt = torch.complex64 if cplx else torch.float32
    kf = 2 if fd else (10 if cplx else 3)
    buf = torch.zeros((2, 107), dtype=dt)
    off = torch.zeros(2, dtype=torch.int32)
    fst = torch.zeros((2, kf))
    cases = [
        ("buf 1-D", buf[0], off, fst, BANK),
        ("buf dtype", buf.to(torch.complex128 if cplx else torch.float64),
         off, fst, BANK),
        ("buf int", buf.real.int(), off, fst, BANK),
        ("offset dtype", buf, off.long(), fst, BANK),
        ("offset length", buf, off[:1], fst, BANK),
        ("fstate width", buf, off, fst[:, :1], BANK),
        ("fstate dtype", buf, off, fst.double(), BANK),
        ("bank dtype", buf, off, fst, BANK.double()),
        ("bank 1-D", buf, off, fst, BANK[0]),
        ("offset device", buf, off.to("meta"), fst, BANK),
        ("bank device", buf, off, fst, BANK.to("meta")),
        ("empty block", buf[:, :7], off, fst, BANK),
        ("accepted", buf, off, fst, BANK),
        ("accepted strided", torch.zeros((107, 2), dtype=dt).T, off,
         fst.T.contiguous().T, BANK),
    ]
    if fd:
        cases.append(("buf complex", buf.to(torch.complex64), off, fst, BANK))
    return cases


@pytest.mark.parametrize("cplx", [True, False])
@pytest.mark.parametrize("case", range(14))
def test_mm_symbols_checks_match_python(host, cplx, case):
    name, buf, off, fst, bank = _walk_cases(cplx)[case]
    want = _message(MK._check, buf, off, fst, bank)
    got = _message(host.mm_symbols, buf, off, fst, bank, 40, MM_PARAMS, None)
    if want is None:
        assert name.startswith("accepted")
        assert got == "the compiled mm_symbols takes CUDA tensors"
    else:
        assert got == want


@pytest.mark.parametrize("case", range(15))
def test_fd_symbols_checks_match_python(host, case):
    name, buf, off, fst, bank = _walk_cases(None)[case]
    want = _message(MK._check_fd, buf, off, fst, bank)
    got = _message(host.fd_symbols, buf, off, fst, bank, 40, MM_PARAMS)
    if want is None:
        assert name.startswith("accepted")
        assert got == "the compiled fd_symbols takes CUDA tensors"
    else:
        assert got == want


def _chunked_args(cplx=True):
    geom, _, _ = CC.chunk_geometry(2400, 4, 512, 8, 2.0, 2.2)
    K = geom.K
    ext = torch.zeros((K - 1) * geom.L + geom.cols,
                      dtype=torch.complex64 if cplx else torch.float32)
    i32 = torch.zeros(K, dtype=torch.int32)
    f32 = torch.zeros(K)
    return [ext, i32, f32, f32, f32, i32, f32, BANK, geom]


def _chunked_cases():
    """(id, index of the replaced argument, its replacement)."""
    a = _chunked_args()
    geom = a[8]
    return [
        ("ext dtype", 0, a[0].to(torch.complex128)),
        ("ext 2-D", 0, a[0][None]),
        ("ext short", 0, a[0][:-1]),
        ("bank dtype", 7, BANK.double()),
        ("bank one tap", 7, BANK[:, :1]),
        ("geometry K", 8, geom._replace(K=0)),
        ("geometry J", 8, geom._replace(J=7)),
        ("geometry cols", 8, geom._replace(cols=geom.R - 1)),
        ("geometry steps", 8, geom._replace(steps=0)),
        ("off0 dtype", 1, a[1].long()),
        ("ph0 length", 2, a[2][:3]),
        ("fr0 dtype", 3, a[3].double()),
        ("emit_lo dtype", 4, a[4].int()),
        ("emit_hi dtype", 5, a[5].float()),
        ("goff length", 6, a[6][:2]),
        ("off0 device", 1, a[1].to("meta")),
        ("bank device", 7, BANK.to("meta")),
        ("accepted", 0, a[0]),
        ("accepted float", 0, a[0].real.contiguous()),
    ]


@pytest.mark.parametrize("case", _chunked_cases(), ids=lambda c: c[0])
def test_mm_chunked_checks_match_python(host, case):
    name, i, v = case
    a = _chunked_args()
    a[i] = v
    want = _message(CC._check, *a)
    got = _message(host.mm_chunked, *a[:8], tuple(a[8]), MM_PARAMS + (1.0,))
    if want is None:
        assert name.startswith("accepted")
        assert got == "the compiled mm_symbols_chunked takes CUDA tensors"
    else:
        assert got == want


def test_mm_clock_host_checks_its_own_arguments(host):
    """The kernel's own conditions come before the device's: a bank other
    than [128, 8], more than 256 lanes, a group other than 8, 16 or 32;
    wrong argument kinds raise TypeError; null entries ValueError."""
    buf = torch.zeros((1, 107), dtype=torch.complex64)
    off = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[128, 8\] bank, not \[64, 8\]"):
        host.mm_symbols(buf, off, torch.zeros((1, 10)), BANK[:64], 40,
                        MM_PARAMS, None)
    with pytest.raises(ValueError, match=r"\[128, 8\] bank"):
        host.fd_symbols(buf.real.contiguous(), off, torch.zeros((1, 2)),
                        BANK[:, :6], 40, MM_PARAMS)
    a = _chunked_args()
    with pytest.raises(ValueError, match=r"\[128, 8\] bank"):
        host.mm_chunked(*a[:7], BANK[:64], tuple(a[8]), MM_PARAMS + (1.0,))
    with pytest.raises(ValueError, match="M = 8, 16 or 32, got 12"):
        host.mm_chunked(*a[:8], tuple(a[8]._replace(M=12)),
                        MM_PARAMS + (1.0,))
    K = 300
    g = a[8]._replace(K=K)
    big = [torch.zeros((K - 1) * g.L + g.cols, dtype=torch.complex64)] + [
        t.new_zeros(K) for t in a[1:7]]
    with pytest.raises(ValueError, match="at most 256 lanes, got 300"):
        host.mm_chunked(*big, BANK, tuple(g), MM_PARAMS + (1.0,))
    with pytest.raises(TypeError):
        host.mm_chunked(*a[:8], tuple(a[8])[:7], MM_PARAMS + (1.0,))
    with pytest.raises(TypeError):
        host.mm_symbols(buf, off, torch.zeros((1, 10)), BANK, 40, (1.0,),
                        None)
    with pytest.raises(TypeError):
        host.fd_symbols(buf, off, torch.zeros((1, 2)), BANK, 40)
    with pytest.raises(ValueError, match="null entry"):
        host.bind_mm_clock(1, 1, 1, 1, 0)


def _block_args(cplx=True):
    geom, _, pad = CC.chunk_geometry(2400, 4, 512, 8, 2.0, 2.2)
    dt = torch.complex64 if cplx else torch.float32
    return [torch.zeros(2400, dtype=dt), torch.zeros(512 + 7, dtype=dt),
            torch.zeros((), dtype=torch.int32), torch.zeros(()),
            torch.full((), 2.1), BANK, geom, 512, pad]


def _block_cases():
    """(id, index of the replaced argument, its replacement) for the
    chunked M&M's block entry."""
    a = _block_args()
    geom = a[6]
    return [
        ("x dtype", 0, a[0].to(torch.complex128)),
        ("x 2-D", 0, a[0][None]),
        ("bank dtype", 5, BANK.double()),
        ("bank one tap", 5, BANK[:, :1]),
        ("geometry J", 6, geom._replace(J=7)),
        ("geometry steps", 6, geom._replace(steps=0)),
        ("x short", 0, a[0][:-1]),
        ("W above L", 7, geom.L + 1),
        ("W zero", 7, 0),
        ("pad", 8, a[8] + 1),
        ("hist length", 1, a[1][:-1]),
        ("hist dtype", 1, a[1].real.contiguous()),
        ("offset0 dtype", 2, a[2].long()),
        ("phase0 two", 3, torch.zeros(2)),
        ("freq0 dtype", 4, a[4].double()),
        ("hist device", 1, a[1].to("meta")),
        ("freq0 device", 4, a[4].to("meta")),
        ("accepted", 0, a[0]),
    ]


def _block_call(host, a, cycles=None):
    return host.mm_chunked_block(*a[:6], tuple(a[6]), a[7], a[8],
                                 MM_PARAMS + (1.0, 0.8, 509.0), cycles)


@pytest.mark.parametrize("case", _block_cases(), ids=lambda c: c[0])
def test_mm_chunked_block_checks_match_python(host, case):
    name, i, v = case
    a = _block_args()
    a[i] = v
    want = _message(CC._check_block, *a)
    got = _message(_block_call, host, a)
    if want is None:
        assert name.startswith("accepted")
        assert got == "the compiled mm_symbols_chunked takes CUDA tensors"
    else:
        assert got == want


def test_mm_chunked_block_accepts_float_and_refuses_its_own(host):
    """The float block passes the checks; the block entry's own
    conditions (the bank, M) come before the device's, with the lanes
    entry's messages."""
    a = _block_args(cplx=False)
    assert CC._check_block(*a) is None
    assert (_message(_block_call, host, a)
            == "the compiled mm_symbols_chunked takes CUDA tensors")
    with pytest.raises(ValueError, match=r"\[128, 8\] bank, not \[64, 8\]"):
        _block_call(host, [*a[:5], BANK[:64], *a[6:]])
    with pytest.raises(ValueError, match="M = 8, 16 or 32, got 12"):
        _block_call(host, [*a[:6], a[6]._replace(M=12), *a[7:]])
    with pytest.raises(TypeError):
        host.mm_chunked_block(*a[:6], tuple(a[6]), a[7], a[8], MM_PARAMS)


@pytest.mark.parametrize("cplx", [True, False])
def test_mm_chunked_takes_any_symbol_period(host, cplx):
    """128 lanes of 2,048-sample windows (a 250-sample symbol period, 2.4
    Msps at 9,600 Bd), more than a CTA's shared memory holds whole: both
    entries pass every check and stop only at the device, the kernel
    copying each window in pieces (kernel_layout)."""
    n = 262144
    geom, _, pad = CC.chunk_geometry(n, 128, 512, 8, 247.5, 252.5)
    assert geom.R == 2048 and CC.kernel_layout(geom, cplx)[2] > 1
    dt = torch.complex64 if cplx else torch.float32
    ext = torch.zeros((geom.K - 1) * geom.L + geom.cols, dtype=dt)
    i32, f32 = torch.zeros(128, dtype=torch.int32), torch.zeros(128)
    params = (0.01, 6.25e-6, 247.5, 252.5, 125.0)
    lanes = _message(host.mm_chunked, ext, i32, f32, f32, f32, i32, f32,
                     BANK, tuple(geom), params)
    block = _message(host.mm_chunked_block, torch.zeros(n, dtype=dt),
                     torch.zeros(519, dtype=dt),
                     torch.zeros((), dtype=torch.int32), torch.zeros(()),
                     torch.full((), 250.0), BANK, tuple(geom), 512, pad,
                     params + (100.0, 262.0), None)
    assert lanes == block == "the compiled mm_symbols_chunked takes CUDA tensors"
