"""The metric arithmetic on synthetic timelines: a rate and a p95 over
every block of the window, the device trace's busy share, layers and
kernels, and the roofline bytes from shapes."""

import statistics

import numpy as np
import pytest

from benchmark import roofline, stats
from benchmark.check import Context
from benchmark.spec import load_cell
from benchmark.trace import BLOCK, Trace


def test_rate_and_p95_take_every_block_of_the_window():
    ask = {j: 0.1 * j for j in range(20)}
    done = {j: 0.1 * j + 0.02 + 0.001 * j for j in range(20)}
    win = stats.in_window(done, 0.5, 1.5)
    assert win == [j for j in range(20) if 0.5 <= done[j] <= 1.5]
    assert stats.input_msps(win, 2 ** 21, 1.0) == len(win) * 2 ** 21 / 1e6
    lat = sorted(done[j] - ask[j] for j in win)
    assert stats.p95_ms(lat) == pytest.approx(1e3 * np.percentile(lat, 95))
    # one stalled block moves the p95, not the mean alone
    done[10] += 0.5
    assert stats.p95_ms([done[j] - ask[j] for j in win]) > 1e3 * max(lat)
    assert stats.p95_ms([]) is None


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == (q3 - q1) / med


def _events():
    """Two blocks; each launches a mix kernel in vfo_bank, a decim_fir
    kernel in vfo_bank and a scan in demod; a copy on another stream."""
    ev = []
    corr = 0

    def launch(t, name, start, dur, cat="kernel"):
        nonlocal corr
        corr += 1
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                   "ts": t, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": start,
                   "dur": dur, "args": {"correlation": corr}})

    for b, t in enumerate((0.0, 1000.0)):
        ev.append({"ph": "X", "cat": "user_annotation", "name": BLOCK,
                   "ts": t, "dur": 900})
        ev.append({"ph": "X", "cat": "user_annotation", "name": "vfo_bank",
                   "ts": t + 10, "dur": 100})
        ev.append({"ph": "X", "cat": "user_annotation", "name": "demod",
                   "ts": t + 200, "dur": 100})
        launch(t + 20, "elementwise_mix", t + 100, 300)
        launch(t + 30, "void decim_fir_kernel<2, 0>", t + 400, 100)
        launch(t + 210, "void loop_scan_kernel<Agc>", t + 500, 50)
        launch(t + 400, "Memcpy DtoH", t + 560, 40, cat="gpu_memcpy")
    # a kernel outside every block (before the trace's blocks)
    launch(-50.0, "stray", -40.0, 10)
    return ev


def test_trace_splits_device_time_by_block_layer_and_kernel():
    tr = Trace(_events(), layers=["vfo_bank", "demod", "squelch"])
    assert tr.blocks == 2
    assert tr.layer_s("vfo_bank") == pytest.approx(2 * 400e-6)
    assert tr.layer_s("demod") == pytest.approx(2 * 50e-6)
    assert tr.layer_s("squelch") is None
    assert tr.kernels("decim_fir") == (2, pytest.approx(200e-6))
    assert tr.kernels("loop_scan_kernel", layer="demod")[0] == 2
    # window: first device activity of block 0 to the last of block 1
    assert tr.window_s == pytest.approx((1600 - 100) * 1e-6)
    busy = 2 * (300 + 100 + 50 + 40) * 1e-6
    assert tr.busy_s == pytest.approx(busy)
    ops = dict(tr.top_ops())
    assert ops["elementwise_mix"] == pytest.approx(600e-6)
    assert "stray" not in ops
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(500e-6)  # 600 -> 1100
    assert gaps[0][0].startswith("host: ")


def test_readers_from_a_synthetic_trace():
    cell = load_cell("ssb64-16m")
    tr = Trace(_events(), layers=["vfo_bank", "demod"])
    n = 2 ** 21
    ctx = Context(cell, n, {"kind": "NVIDIA H100 80GB HBM3"}, tr,
                  {"read": [0.001, 0.003], "call": [0.002, 0.002],
                   "push": [0.004, 0.006]}, cell.reference())
    read = lambda m: cell.reader(m).read(ctx)  # noqa: E731
    assert read("pipeline.read_ms") == pytest.approx(2.0)
    assert read("pipeline.write_wait_ms") == pytest.approx(5.0)
    assert read("entry.enqueue_ms") == pytest.approx(2.0)
    assert read("vfo_bank.device_ms") == pytest.approx(0.4)
    assert read("demod.device_ms") == pytest.approx(0.05)
    bw = 3.35e12
    assert read("vfo_bank_roofline") == pytest.approx(
        100 * 8 * (n + 64 * n // 128) / bw / 400e-6)
    # the /128 plan's one stage of decimation >= 8 (16, 72 taps) on
    # [64, n] complex64: one launch a block
    want = 8 * 64 * (n + 2 * 71 + n // 16) + 4 * 72
    assert roofline.decim_fir_bytes(64, n, 72, 16) == want
    assert read("decim_fir_roofline") == pytest.approx(
        100 * want / bw / 100e-6)
    assert read("lane_scan_roofline") == pytest.approx(
        100 * 4 * 64 * (16384 * 3 + 4) / bw / 50e-6)
    assert read("device.idle_pct") == pytest.approx(
        100 * (1 - tr.busy_s / tr.window_s))
    # no trace, nothing read: never a 0 for a share
    ctx.trace = None
    for m in ("vfo_bank.device_ms", "vfo_bank_roofline",
              "decim_fir_roofline", "lane_scan_roofline", "device.idle_pct"):
        assert read(m) is None


def test_audio_gap_takes_the_widest_gap_against_each_channel_rms():
    audio_gap = load_cell("ssb64-16m").reference().audio_gap
    want = np.zeros((4, 100))
    want[0] = np.sin(np.arange(100))
    want[2] = 2 * np.cos(np.arange(100))
    got = want.copy()
    got[2, 7] += 0.02
    e, m = audio_gap(got, want)
    rms2 = np.sqrt(np.mean(want[2] ** 2))
    assert e == pytest.approx(0.02 / rms2) and m == 0
    got[1, 3] = 1e-9   # a muted channel that is not
    e, m = audio_gap(got, want)
    assert m == 1 and e > 0
