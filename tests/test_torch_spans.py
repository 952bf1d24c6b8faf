"""The port's spans (utils.tracing.annotate) at the scanner path's stage
boundaries: nothing recorded and no profiler range opened with no
profiler running; under one, the bank's, the Prefetcher's and the
DeferredWriter's spans with their parents and block ids, in the ring and
in the exported Chrome trace; the ring's bound; the bank's output
unchanged by them; timing events on the device spans alone, from a
pool; the summary by name; and StreamMonitor counting a block when its
output reaches the host.

CPU only: the spans' device ms (CUDA events) are None here and are read
on the card by the benchmark's program-span metrics.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdrpp_tpu_torch import cli
from sdrpp_tpu_torch.parallel.vfo_bank import ScannerBank
from sdrpp_tpu_torch.utils import tracing
from sdrpp_tpu_torch.utils.pipeline import DeferredWriter, Prefetcher
from sdrpp_tpu_torch.utils.tracing import (StreamMonitor, annotate, spans,
                                           summary)

FS = 768000.0
N = 16384
BANK = ("bank", "bank.vfo", "vfo.mix", "vfo.resample", "vfo.filter",
        "bank.squelch", "bank.demod")
PARENT = {"bank": None, "bank.vfo": "bank", "vfo.mix": "bank.vfo",
          "vfo.resample": "bank.vfo", "vfo.filter": "bank.vfo",
          "bank.squelch": "bank", "bank.demod": "bank"}
# the ranges the benchmark's harness opens around its own calls
HARNESS = {"bench.block", "pipeline.read", "entry", "pipeline.push",
           "vfo_bank", "squelch", "demod", "af"}


@pytest.fixture(autouse=True)
def empty_ring():
    tracing._ring.clear()
    yield
    tracing._ring.clear()


def _bank():
    return ScannerBank([-100e3, 100e3], FS, mode="nfm", if_rate=48000.0,
                       bandwidth=12500.0, squelch_level=-50.0, device="cpu")


def _input(k, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(k * N) / FS
    x = 0.3 * np.exp(2j * np.pi * 100e3 * t) + 1e-3 * (
        rng.standard_normal(k * N) + 1j * rng.standard_normal(k * N))
    return x.astype(np.complex64)


def _run(bank, x, k):
    st, out = bank.init_state(), []
    for j in range(k):
        st, y = bank(st, torch.from_numpy(x[j * N:(j + 1) * N]))
        out.append(y)
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = fn()
    return prof, r


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    _run(_bank(), _input(2), 2)
    with annotate("x", 3):
        pass
    assert annotate("y") is annotate("z", 1)  # one shared null context
    assert spans() == []


def test_bank_spans_parents_and_block_ids(tmp_path):
    prof, _ = _profiled(lambda: _run(_bank(), _input(3), 3))
    recs = spans()
    by_id = {r["id"]: r for r in recs}
    assert sorted({r["name"] for r in recs}) == sorted(BANK)
    for b in range(3):
        mine = [r for r in recs if r["block"] == b]
        assert sorted(r["name"] for r in mine) == sorted(BANK)
        for r in mine:
            parent = by_id.get(r["parent"])
            assert (parent and parent["name"]) == (PARENT[r["name"]] or None)
            if parent:
                assert parent["block"] == b
                assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                    <= parent["end_ns"]
            assert r["device_ms"] is None  # no CUDA events off a card
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e.get("name") for e in
             json.loads(path.read_text())["traceEvents"]]
    for name in BANK:
        assert names.count(name) == 3


def test_wfm_bank_spans_pilot_stereo_and_deemphasis():
    """A de-emphasised WFM bank adds ``wfm.pilot`` and ``wfm.stereo``
    under ``bank.demod``, and ``af.deemph`` under ``bank.af``, once a
    block each."""
    fs, n = 2.5e6, 50000
    bank = ScannerBank([-300e3, 300e3], fs, mode="wfm", if_rate=240e3,
                       bandwidth=200e3, deemphasis="75us", device="cpu")
    rng = np.random.default_rng(2)
    x = (1e-2 * (rng.standard_normal(2 * n) + 1j * rng.standard_normal(
        2 * n))).astype(np.complex64)

    def run():
        st = bank.init_state()
        for j in range(2):
            st, _ = bank(st, torch.from_numpy(x[j * n:(j + 1) * n]))

    _profiled(run)
    recs = spans()
    by_id = {r["id"]: r for r in recs}
    parent = {"wfm.pilot": "bank.demod", "wfm.stereo": "bank.demod",
              "af.deemph": "bank.af", "bank.af": "bank"}
    for name, up in parent.items():
        mine = [r for r in recs if r["name"] == name]
        assert sorted(r["block"] for r in mine) == [0, 1], name
        assert all(by_id[r["parent"]]["name"] == up for r in mine), name


def test_pipeline_spans_share_the_blocks_ids():
    class Src:
        samplerate = FS

        def __init__(self, x):
            self.x, self.pos = x, 0

        def read(self, n):
            self.pos += n
            return self.x[self.pos - n:self.pos]

    bank, got = _bank(), []
    pre = Prefetcher(Src(_input(3)), N, device="cpu")
    writer = DeferredWriter(got.append)

    def loop():
        st = bank.init_state()
        for _ in range(3):
            st, y = bank(st, pre.read(N))
            writer.push(y)
        writer.flush()

    try:
        _profiled(loop)
    finally:
        pre.close()
    recs = spans()
    assert len(got) == 3
    for name in ("prefetch.wait", "writer.d2h", "writer.wait", "bank"):
        assert [r["block"] for r in recs if r["name"] == name] == [0, 1, 2]
    assert all((0 <= r["value"] <= 2) == (r["name"] == "prefetch.wait")
               for r in recs if r["value"] is not None)
    assert all(r["value"] is not None for r in recs
               if r["name"] == "prefetch.wait")


def test_the_ring_keeps_the_newest_ring_records():
    def many():
        for i in range(tracing.RING + 5):
            with annotate("ring", i):
                pass

    _profiled(many)
    recs = spans()
    assert len(recs) == tracing.RING
    assert recs[0]["block"] == 5 and recs[-1]["block"] == tracing.RING + 4


def test_the_bank_is_bit_identical_with_spans_on_and_off():
    x = _input(3, seed=4)
    off = _run(_bank(), x, 3)
    _, on = _profiled(lambda: _run(_bank(), x, 3))
    assert spans()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_no_span_is_named_as_a_harness_range():
    root = Path(cli.__file__).parent
    names = set()
    for p in root.rglob("*.py"):
        names |= set(re.findall(r'annotate\("([^"]+)"', p.read_text()))
    assert {"bank", "vfo.mix", "writer.d2h", "prefetch.h2d"} <= names
    assert not names & HARNESS


class _Event:
    """A stand-in for a timing CUDA event: the n-th recorded reads n ms;
    ``done`` says whether the card has passed it."""
    made = clock = 0
    done = True

    def __init__(self, enable_timing=False):
        _Event.made += 1
        self.at = None

    def record(self, stream=None):
        _Event.clock += 1
        self.at = _Event.clock

    def query(self):
        return _Event.done

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.mark.parametrize("done, pairs", [(True, 2), (False, 16)])
def test_device_spans_alone_take_events_from_a_pool(monkeypatch, done,
                                                    pairs):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(tracing, "_pool", tracing.collections.defaultdict(
        list))
    monkeypatch.setattr(_Event, "done", done)
    _Event.made = _Event.clock = 0

    def loop():
        for b in range(8):
            with annotate("bank", b, device=True):
                with annotate("vfo.mix", device=True):
                    pass
            with annotate("writer.wait", b):
                pass

    _profiled(loop)
    recs = spans()
    assert len(recs) == 24 and [r["block"] for r in recs[::3]] == list(
        range(8))
    for r in recs:
        if r["name"] == "writer.wait":
            assert r["device_ms"] is None
        else:  # the mix: its two records; the bank: those and the mix's
            assert r["device_ms"] == {"vfo.mix": 1.0, "bank": 3.0}[r["name"]]
    # a block's two pairs go back to the pool as its bank span closes on
    # a card that has passed them; else each span takes a new pair
    assert _Event.made == 2 * pairs
    assert not tracing._pending


def test_summary_means_by_name_a_span():
    def rec(i, name, parent, block, t0, t1, dev, value=None):
        return {"id": i, "name": name, "parent": parent, "block": block,
                "value": value, "start_ns": t0, "end_ns": t1,
                "device_ms": dev}

    recs = [rec(0, "bank", None, 0, 0, 4_000_000, 10.0),
            rec(1, "vfo.mix", 0, 0, 0, 1_000_000, 6.0),
            rec(2, "vfo.filter", 0, 0, 1_000_000, 2_000_000, 3.0),
            rec(3, "bank", None, 1, 0, 2_000_000, 12.0),
            rec(4, "vfo.mix", 3, 1, 0, 1_000_000, 8.0),
            # two writers numbering their own blocks from 0
            rec(5, "writer.d2h", None, 0, 0, 1_000_000, 0.5),
            rec(6, "writer.d2h", None, 0, 0, 1_000_000, 0.7),
            rec(7, "prefetch.wait", None, 0, 0, 3_000_000, None, 2),
            rec(8, "prefetch.wait", None, 1, 0, 1_000_000, None, 1)]
    s = summary(recs)
    assert s["bank"] == {"count": 2, "host_ms": 3.0, "device_ms": 11.0,
                         "self_device_ms": 2.5, "value": None}
    assert s["vfo.mix"]["device_ms"] == 7.0
    assert s["vfo.filter"]["self_device_ms"] == 3.0
    assert s["writer.d2h"]["device_ms"] == pytest.approx(0.6)
    assert s["prefetch.wait"] == {"count": 2, "host_ms": 2.0,
                                  "device_ms": None, "self_device_ms": None,
                                  "value": 1.5}


def test_stream_monitor_counts_delivered_blocks():
    mon = StreamMonitor(samplerate=FS)
    mon.start()
    mon.start()
    mon.done(100)
    assert mon.blocks == 1 and mon.samples == 100
    mon.done(100)
    assert mon.blocks == 2 and mon.ema_block_s > 0
    with pytest.raises(IndexError):
        mon.done(100)  # more blocks done than started


def test_stream_counts_each_block_when_its_output_arrives():
    mon, seen = StreamMonitor(samplerate=FS), []
    bank = _bank()

    def write(a):
        seen.append(mon.blocks)  # the monitor counts after the write

    cli._stream(bank, bank.init_state(), cli._make_source("test:768000"),
                N, 3, torch.device("cpu"), write, monitor=mon)
    assert seen == [0, 1, 2] and mon.blocks == 3 and mon.samples == 3 * N


def test_cli_bank_trace_logs_the_spans(tmp_path, caplog):
    import logging

    with caplog.at_level(logging.INFO, logger="sdrpp_tpu_torch"):
        assert cli.main(["bank", "--source", "test:768000",
                         "--offsets=-100e3,100e3", "--mode", "nfm",
                         "--squelch", "-50", "--blocks", "2",
                         "--block-size", str(N), "--device", "cpu",
                         "--out-dir", str(tmp_path / "a"),
                         "--trace", str(tmp_path / "tr")]) == 0
    assert len(list((tmp_path / "tr").glob("*.pt.trace.json"))) == 1
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("span ")]
    assert sorted(l.split()[1] for l in lines) == sorted(
        BANK + ("prefetch.wait", "writer.d2h", "writer.wait"))
    assert all(l.split()[2] == "2" for l in lines)
    for l in lines:  # the value column: prefetch.wait's blocks ready
        assert (l.split()[-1] == "n/a") == (l.split()[1] != "prefetch.wait")
