"""A short soak of the port's live receiver on the CPU, through
tools/soak_ui_torch.py's ``soak``: every mode of ALL_MODES set once on
the selected VFO (each waited for on a deadline until its chain runs and,
for an analog mode, writes audio), then the random control mix for the
rest of the time. The engine must be running at the end with no problem
recorded; the engine's host time a block and the actions are counted."""

import sys
from pathlib import Path

import torch

from sdrpp_tpu_torch.io.sources import TestSource
from sdrpp_tpu_torch.misc.webui import ALL_MODES, ReceiverEngine

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from soak_ui_torch import soak  # noqa: E402

torch.set_num_threads(1)

SOAK_S = 12.0  # the modes take ~10 s on an idle CPU; the mix the rest


def test_soak_sets_every_mode_and_keeps_the_engine_alive():
    src = TestSource(1e6, tones=[(100000.0, -20.0), (-250000.0, -40.0)],
                     noise_dbfs=-60.0)
    eng = ReceiverEngine(src, mode="nfm", offset=100000.0, realtime=False,
                         fft_size=1024, base_block=65536, device="cpu")
    lines = []
    try:
        res = soak(eng, SOAK_S, 0, modes_first=True, log=lines.append)
        running = eng.snapshot()["running"]
    finally:
        eng.stop()
    assert res["problems"] == [] and res["ok"], res
    assert running and res["running"]
    assert list(res["modes"]) == ALL_MODES
    assert res["actions"] >= len(ALL_MODES)
    assert res["blocks"] > 2 * len(ALL_MODES)
    assert 0 < res["block_ms_p50"] <= res["block_ms_p99"]
