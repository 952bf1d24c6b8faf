"""The broadcast-FM band's pieces (``wfm-band-20m``): its channel plan,
the reference's designs against SDR++'s (and the port's, which must
agree), the new readers on synthetic traces, and whole runs of the
harness on the CPU at a small size (6 channels at 2.5 Msps): the port
agrees with the reference, planted faults make ``correct`` false (among
them faults of the pilot loop alone, which ``pilot_side_err`` sees), and
the control fails where the program passes."""

import copy
import math
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.control import control_readings
from benchmark.harness import run_cell
from benchmark.spec import load_cell
from benchmark.test_bench_runs import (_half_batch, _stale_state,  # noqa: F401
                                       few_threads)
from benchmark.trace import BLOCK, Trace

CELL = "wfm-band-20m"
SMALL = dict(block=250_000, pool_blocks=3, check_blocks=2)
READERS = ("wfm_demod.pilot.device_ms", "wfm_demod.stereo.device_ms",
           "af.device_ms", "pilot_pll_roofline")


def small_cell():
    cell = load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["bank"].update(channels=6, samplerate=2.5e6,
                               first_hz=97.5e6)
    return cell


def test_the_band_is_47_cfr_73_201_about_98_mhz():
    cell = load_cell(CELL)
    fs, offs = cell.system().band(cell.config)
    assert fs == 20e6 and offs.shape == (100,)
    mhz = (offs + 98.0e6) / 1e6
    assert mhz[0] == pytest.approx(88.1) and mhz[-1] == pytest.approx(107.9)
    assert np.allclose(np.diff(offs), 200e3)
    assert np.abs(offs).max() + 100e3 <= fs / 2   # every channel inside
    assert np.allclose(offs, cell.reference().channel_offsets(cell.config))


def test_the_reference_designs_agree_with_the_port():
    """Designed again from SDR++'s headers, the reference's plan and taps
    equal the port's: the rational plan, the polyphase taps and bank, the
    pilot band-pass, the cascade's frozen tables."""
    from sdrpp_tpu_torch.ops import resample, taps

    ref = load_cell(CELL).reference()
    for a, b in ((20e6, 240e3), (2.5e6, 240e3), (240e3, 48e3)):
        plan = resample.plan_rational_resampler(a, b)
        pre, interp, decim = ref.rate_plan(a, b)
        assert (pre, interp, decim) == (plan["pre_ratio"], plan["interp"],
                                        plan["decim"])
        t = ref.resampler_taps(a, b)
        assert np.array_equal(t, plan["taps"])
        assert np.array_equal(ref.polyphase_bank(t, interp),
                              resample.build_polyphase_bank(t, interp))
        for r, stage in zip(ref.decim_stages(pre), resample.decim_plan(pre)):
            assert r[0] == stage[0] and np.array_equal(r[1], stage[1])
    assert ref.rate_plan(20e6, 240e3) == (64, 96, 125)
    want = taps.band_pass(18750.0, 19250.0, 3000.0, 240e3,
                          complex_taps=True, odd_tap_count=True)
    got = ref.band_pass(18750.0, 19250.0, 3000.0, 240e3)
    assert got.shape == want.shape == (305,)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    g = ref.geometry(load_cell(CELL).config, 20_000_000)
    assert g == {"channels": 100, "n_if": 240_000, "n_audio": 48_000,
                 "ratio": 64, "interp": 96, "decim": 125}


def _ctx(trace=None, platform="gpu"):
    cell = load_cell(CELL)
    ref = cell.reference()
    return SimpleNamespace(
        cell=cell, trace=trace, card={"platform": platform,
                                      "kind": "NVIDIA H100 80GB HBM3"},
        geometry=ref.geometry(cell.config, 40_000), ref_mod=ref,
        per_block_s=lambda s: s, peak=lambda: {"bytes_per_s": 3.35e12})


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("where", ["no trace", "cpu"])
def test_the_new_readers_read_nothing_without_a_card_trace(name, where):
    ctx = _ctx(None) if where == "no trace" else _ctx(
        Trace([], layers=["demod"]), platform="cpu")
    assert load_cell(CELL).reader(name).read(ctx) is None


def _trace(launches_per_block):
    """Two blocks; each launches ``launches_per_block`` loop scans of 40
    us inside the ``demod`` range and one outside it."""
    ev, corr = [], 0
    for b, t in enumerate((0.0, 1000.0)):
        ev.append({"ph": "X", "cat": "user_annotation", "name": BLOCK,
                   "ts": t, "dur": 900})
        ev.append({"ph": "X", "cat": "user_annotation", "name": "demod",
                   "ts": t + 100, "dur": 100})
        for i, at in enumerate([t + 110] * launches_per_block + [t + 300]):
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                       "ts": at + i, "dur": 1,
                       "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "kernel",
                       "name": "void loop_scan_kernel<PllBody>",
                       "ts": t + 400 + 50 * i, "dur": 40,
                       "args": {"correlation": corr}})
    return Trace(ev, layers=["demod"])


def test_pilot_pll_roofline_counts_the_loops_least_bytes():
    """At 40,000 input samples a block: 100 lanes of 480 IF samples, one
    float32 phase read and one written a step, phase and frequency read
    and written: 4 (100 (480 x 2 + 2 x 2)) bytes a block."""
    read = load_cell(CELL).reader("pilot_pll_roofline").read
    ctx = _ctx(_trace(1))
    assert ctx.geometry["n_if"] == 480
    least = 4 * 100 * (480 * 2 + 2 * 2)
    assert read(ctx) == pytest.approx(100 * least / 3.35e12 / 40e-6)
    assert read(_ctx(_trace(2))) is None   # not one loop scan a block


def test_the_cascade_readers_take_this_geometry():
    """``decim_fir_roofline`` and ``vfo_bank_roofline``, not listed for
    this cell, read its geometry as they read the scanner banks': the /64
    cascade's one stage of decimation >= 8 (/8, 36 taps) on [100, n]
    complex64, and [100, n_if] IF written after the polyphase stage."""
    from benchmark.check import Context
    from benchmark.test_bench_metrics import _events

    cell = load_cell(CELL)
    n = 40_000
    ctx = Context(cell, n, {"kind": "NVIDIA H100 80GB HBM3"},
                  Trace(_events(), layers=["vfo_bank", "demod"]),
                  {}, cell.reference())
    assert ctx.geometry["ratio"] == 64 and ctx.geometry["n_if"] == 480
    read = lambda m: cell.reader(m).read(ctx)  # noqa: E731
    bw = 3.35e12
    want = 8 * 100 * (n + 2 * 35 + n // 8) + 4 * 36
    assert read("decim_fir_roofline") == pytest.approx(
        100 * want / bw / 100e-6)
    assert read("vfo_bank_roofline") == pytest.approx(
        100 * 8 * (n + 100 * 480) / bw / 400e-6)


def _run(seed=2 ** 33 + 77, wrap_step=None, seconds=1.5):
    return run_cell(small_cell(), seed, seconds, False, device="cpu",
                    log=lambda s: None, wrap_step=wrap_step, **SMALL)


def test_the_port_agrees_with_the_reference():
    res, info = _run()
    assert res["correct"], res["checks"]
    for k in ("audio_err", "pilot_side_err"):
        assert res["checks"][k]["value"] < load_cell(CELL).config["check"][k]
    assert info["blocks_in_window"] == res["attempted"] > 0


def _one_answer(bank, step):
    def f(st, x):
        st, y = step(st, x)
        y = y.clone()
        y[0, 100, 0] += 0.05
        return st, y
    return f


@pytest.mark.parametrize("fault", [_stale_state, _half_batch, _one_answer],
                         ids=["state-unchanged", "half-batch",
                              "answer-altered"])
def test_a_planted_fault_makes_correct_false(fault):
    res, _ = _run(wrap_step=fault)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


class _Turned:
    """A pilot loop whose output phasor is turned by ``angle`` rad."""

    def __init__(self, pll, angle):
        self.pll, self.turn = pll, complex(math.cos(angle), math.sin(angle))

    def init_state(self):
        return self.pll.init_state()

    def __call__(self, state, x):
        state, y = self.pll(state, x)
        return state, y * self.turn


def _loop_turned(bank, step):
    bank.demod.pilot_pll = _Turned(bank.demod.pilot_pll, math.pi / 4)
    return step


def _loop_frozen(bank, step):
    """The loop never corrects: it free-runs at its initial 19 kHz."""
    bank.demod.pilot_pll.alpha = bank.demod.pilot_pll.beta = 0.0
    return step


def _loop_clamped(bank, step):
    """The loop's frequency clamped 50 Hz below the pilot (its upper
    limit 18,950 Hz in place of 19,250), so it trails the pilot's phase."""
    pll = bank.demod.pilot_pll
    pll.max_freq = pll.max_freq - 2 * math.pi * 300.0 / 240e3
    return step


@pytest.mark.parametrize("fault", [_loop_turned, _loop_frozen,
                                   _loop_clamped],
                         ids=["loop-turned-pi/4", "loop-frozen",
                              "loop-clamped"])
def test_a_planted_loop_fault_fails_the_pilot_side_check(fault):
    """Faults of the pilot loop alone, which leave L+R and the mute
    decisions as they were: the pilot channels' L-R, over its own RMS,
    reads above ``pilot_side_err``'s limit."""
    res, _ = _run(wrap_step=fault)
    c = res["checks"]["pilot_side_err"]
    assert c["value"] > c["limit"], res["checks"]
    assert not res["correct"] and res["failed"] > 0


def test_the_control_fails_where_the_program_passes():
    cell = small_cell()
    ctl = control_readings(cell, [7], 6, device="cpu", log=lambda s: None,
                           **SMALL)
    res, _ = _run(seed=7)
    assert ctl[0]["failing"] > 0
    for k in ("audio_err", "pilot_side_err"):
        limit = cell.config["check"][k]
        assert ctl[0][k] > limit
        assert res["checks"][k]["value"] < limit
