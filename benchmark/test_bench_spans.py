"""The program-span reader (``benchmark/spans.py``) over synthetic
records: the mean device ms a block of one span name, and nothing
without a trace, on the CPU, or without records."""

from types import SimpleNamespace

import pytest

from benchmark.spans import device_ms, program_spans


def _rec(i, name, parent, block, dev):
    return {"id": i, "name": name, "parent": parent, "block": block,
            "value": None, "start_ns": 0, "end_ns": 1, "device_ms": dev}


# two blocks; the bank's vfo span holds the mix, the cascade and the
# filter; block 1's filter ran twice
RECORDS = [_rec(0, "bank.vfo", None, 0, 31.0),
           _rec(1, "vfo.mix", 0, 0, 25.0),
           _rec(2, "vfo.resample", 0, 0, 4.0),
           _rec(3, "vfo.filter", 0, 0, 1.5),
           _rec(4, "bank.vfo", None, 1, 33.0),
           _rec(5, "vfo.mix", 4, 1, 27.0),
           _rec(6, "vfo.resample", 4, 1, 4.4),
           _rec(7, "vfo.filter", 4, 1, 0.5),
           _rec(8, "vfo.filter", 4, 1, 1.0),
           _rec(9, "writer.d2h", None, 1, 0.7)]


def _ctx(trace=True, platform="gpu"):
    return SimpleNamespace(trace=object() if trace else None,
                           card={"platform": platform})


@pytest.mark.parametrize("name, want", [
    ("vfo.mix", 26.0), ("vfo.resample", 4.2), ("vfo.filter", 1.5),
    ("bank.vfo", 32.0), ("writer.d2h", 0.7)])
def test_the_mean_a_block_over_the_blocks_a_span_ran_in(name, want):
    assert device_ms(_ctx(), name, RECORDS) == pytest.approx(want)


@pytest.mark.parametrize("ctx, records", [
    (_ctx(trace=False), RECORDS), (_ctx(platform="cpu"), RECORDS),
    (_ctx(), []), (_ctx(), [_rec(0, "vfo.mix", None, 0, None)])])
def test_nothing_without_a_trace_a_card_or_records(ctx, records):
    assert device_ms(ctx, "vfo.mix", records) is None


def test_the_program_keeps_span_records():
    assert isinstance(program_spans(), list)


def test_nothing_from_a_program_without_span_records(monkeypatch):
    # the readers also run over a checkout whose program keeps no spans
    import sys
    import types

    monkeypatch.setitem(sys.modules, "sdrpp_tpu_torch.utils.tracing",
                        types.ModuleType("sdrpp_tpu_torch.utils.tracing"))
    assert program_spans() is None
    assert device_ms(_ctx(), "vfo.mix") is None
