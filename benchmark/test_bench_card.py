"""The output check on the card, at each cell's own size: the program
passes on fresh seeds and the control (the reference in TF32 put in the
program's place) fails; and one whole run of the command. Skips without
a CUDA card."""

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark.control import control_readings, program_readings
from benchmark.spec import ROOT, load_cell, load_index

CELLS = [w["name"] for w in load_index()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(card, name):
    cell = load_cell(name)
    prog = program_readings(cell, [901, 902, 903], 3.0, log=lambda s: None)
    assert all(p["correct"] for p in prog), prog
    span = int(np.median([p["blocks"] for p in prog]))
    ctl = control_readings(cell, [901, 902, 903], span, log=lambda s: None)
    assert all(c["failing"] > 0 for c in ctl), ctl


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_the_command_prints_a_correct_result(card, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "3000000001", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    cell = load_cell(CELLS[0])
    want = cell.per_layer if trace else cell.end_to_end
    assert {m["name"] for m in want} <= set(res["metrics"])
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
