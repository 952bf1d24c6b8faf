"""Port parity: windows, tap designers and the decimation tables.

sdrpp_tpu_torch.ops.{windows,taps} are NumPy-only copies of the JAX
package's host-side designers (whose ``ops`` package imports jax), so the
tolerance is bit-exact: the same float64 math and the same final casts.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's modules below import it)

from sdrpp_tpu.ops import resample as jresample
from sdrpp_tpu.ops import taps as jtaps
from sdrpp_tpu.ops import windows as jwin
from sdrpp_tpu_torch.ops import resample as tresample
from sdrpp_tpu_torch.ops import taps as ttaps
from sdrpp_tpu_torch.ops import windows as twin

torch.set_num_threads(1)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", [w.name for w in jwin.Window])
@pytest.mark.parametrize("size,centered", [(1024, False), (1023, True),
                                           (65536, True)])
def test_windows_bit_exact(kind, size, centered):
    _same(jwin.create_window(jwin.Window[kind], size, centered),
          twin.create_window(twin.Window[kind], size, centered))


TAP_CASES = {
    "low_pass": lambda m: m.low_pass(15000.0, 4000.0, 240000.0),
    "low_pass_odd": lambda m: m.low_pass(1350.0, 135.0, 48000.0,
                                         odd_tap_count=True),
    "budget_low_pass": lambda m: m.budget_low_pass(500.0, 50.0, 48000.0, 2049),
    "high_pass": lambda m: m.high_pass(300.0, 100.0, 48000.0),
    "band_pass_complex": lambda m: m.band_pass(18750.0, 19250.0, 3000.0,
                                               240000.0, complex_taps=True,
                                               odd_tap_count=True),
    "band_pass_real": lambda m: m.band_pass(300.0, 6250.0, 100.0, 48000.0,
                                            complex_taps=False),
    "rrc": lambda m: m.root_raised_cosine(31, 0.35, 4.0),
    "rc": lambda m: m.raised_cosine(31, 0.35, 4.0),
}


@pytest.mark.parametrize("case", list(TAP_CASES))
def test_taps_bit_exact(case):
    _same(TAP_CASES[case](jtaps), TAP_CASES[case](ttaps))


@pytest.mark.parametrize("ratio", [2, 4, 8, 32, 64, 256, 8192])
def test_decim_plan_bit_exact(ratio):
    jp, tp = jresample.decim_plan(ratio), tresample.decim_plan(ratio)
    assert [r for r, _ in jp] == [r for r, _ in tp]
    for (_, a), (_, b) in zip(jp, tp):
        _same(a, b)


@pytest.mark.parametrize("fin,fout", [(2.4e6, 240e3), (2.4e6, 48e3),
                                      (2.4e6, 24e3), (240e3, 48e3),
                                      (24e3, 48e3), (250e3, 5e3)])
def test_rational_plan_bit_exact(fin, fout):
    jp = jresample.plan_rational_resampler(fin, fout)
    tp = tresample.plan_rational_resampler(fin, fout)
    assert {k: v for k, v in jp.items() if k != "taps"} == \
        {k: v for k, v in tp.items() if k != "taps"}
    _same(jp["taps"], tp["taps"])
    _same(jresample.build_polyphase_bank(jp["taps"], jp["interp"]),
          tresample.build_polyphase_bank(tp["taps"], tp["interp"]))
