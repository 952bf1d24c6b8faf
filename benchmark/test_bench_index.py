"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by name from its own file, so that a configuration, a cell or
a per-layer metric is added by new files and entries alone."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.spec import ROOT, Cell, load_cell, load_index

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_index_keeps_to_the_contract():
    idx = load_index()
    assert set(idx) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(idx["paths"]) <= 16
    for p in idx["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(idx["command"]) <= 32
    assert all(_line(w) for w in idx["command"])
    assert 1 <= idx["run_seconds"] <= 51
    for c in idx["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in idx["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
    files = [c["file"] for c in idx["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in idx["workloads"]}
    assert used == {c["name"] for c in idx["configs"]}
    pairs = set()
    for w in idx["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in idx["workloads"])
    assert four <= max(1, len(idx["workloads"]) // 4)
    names = [m["name"] for m in idx["end_to_end"] + idx["per_layer"]]
    names += [w["name"] for w in idx["workloads"]]
    names += [c["name"] for c in idx["configs"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in idx["end_to_end"]}
    assert "setup_s" in e2e
    for m in idx["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in idx["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in idx["end_to_end"] + idx["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in idx["workloads"]:
        cell = Cell(idx, w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", [w["name"] for w in
                                  load_index()["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(name):
    cell = load_cell(name)
    system, ref = cell.system(), cell.reference()
    for f in ("band", "source", "build", "init_state", "layers",
              "counters"):
        assert callable(getattr(system, f))
    for f in ("Reference", "compare", "geometry"):
        assert callable(getattr(ref, f))
    assert cell.traffic["block"] % 128 == 0
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)


def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_config_a_cell_and_a_metric_are_added_by_new_files(tmp_path):
    """A later PR's addition, made in a copy: new files and new entries,
    no edit to a file that is there."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    idx = load_index()
    before = _digest(tmp_path / "benchmark")
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "nfm-bank64.json").read_text())
    cfg.update(name="nfm-bank32", reduced=["channels"])
    cfg["bank"]["channels"] = 32
    (bench / "configs" / "nfm-bank32.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "workloads" / "nfm64-16m.json").read_text())
    tr["block"] = 1 << 18
    (bench / "workloads" / "nfm32-256k.json").write_text(json.dumps(tr))
    (bench / "metrics" / "entry.blocks.py").write_text(
        "def read(ctx):\n    return float(len(ctx.host['call']))\n")
    idx["configs"].append({"name": "nfm-bank32", "source": "https://x",
                           "file": "benchmark/configs/nfm-bank32.json",
                           "reduced": ["channels"], "why": "fewer"})
    idx["workloads"].append({"name": "nfm32-256k", "config": "nfm-bank32",
                             "traffic": "nfm32-256k", "chips": 1,
                             "why": "smaller"})
    idx["per_layer"].append({"name": "entry.blocks", "unit": "blocks",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry", "moves": "input_msps",
                             "workloads": ["nfm32-256k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(idx))
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    cell = load_cell("nfm32-256k", tmp_path)
    assert cell.config["bank"]["channels"] == 32
    assert cell.traffic["block"] == 1 << 18
    assert [m["name"] for m in cell.per_layer] == ["entry.blocks"]

    class Ctx:
        host = {"call": [0.1, 0.2]}

    assert cell.reader("entry.blocks").read(Ctx) == 2.0
    assert load_cell("ssb64-16m", tmp_path).config["bank"]["channels"] == 64


def test_no_result_without_the_program_or_a_card(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files the command fails and prints no result (no port to run; here,
    without a card, it stops before that)."""
    import subprocess
    import sys

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ssb64-16m",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


STUB_SYSTEM = '''
import numpy as np
import torch

from benchmark.traffic import Replay


class Gain:
    def __init__(self, g):
        self.g = g

    def __call__(self, state, x):
        return state + 1, (x * self.g).real.reshape(1, -1)


def band(config):
    return float(config["samplerate"]), np.array([1e5])


def source(recording, config):
    return Replay(recording, band(config)[0])


def build(config, device, n):
    return Gain(float(config["gain"]))


def init_state(entry):
    return 0


def layers(entry):
    return {}


def counters():
    return {}
'''

STUB_REFERENCE = '''
import numpy as np


def geometry(config, n):
    return {"n": n}


class Reference:
    def __init__(self, config, n, *, device, control=False):
        self.g = float(config["gain"])
        self.dtype = np.float16 if control else np.float64

    def run(self, pool, blocks):
        return {k: (pool[k % pool.shape[0]].real.astype(np.float64)
                    * self.g).astype(self.dtype)[None] for k in blocks}


def compare(config, got, want):
    gaps = [float(np.max(np.abs(got[k] - want[k]))) for k in sorted(got)]
    lim = config["limit"]
    return ({"gap": {"value": max(gaps, default=0.0), "limit": lim}},
            sum(g > lim for g in gaps))
'''


def test_a_new_system_is_added_by_new_files(tmp_path):
    """A later PR's system of another kind, made in a copy: its system
    and reference modules, configuration, traffic and metric are new
    files, and the harness runs it on the CPU with no edit to a file
    that is there; a planted fault still makes ``correct`` false."""
    from benchmark.harness import run_cell

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    before = _digest(bench)
    (bench / "systems" / "stub_gain.py").write_text(STUB_SYSTEM)
    (bench / "reference" / "stub_gain.py").write_text(STUB_REFERENCE)
    (bench / "configs" / "stub-gain.json").write_text(json.dumps(
        {"name": "stub-gain", "system": "stub_gain",
         "reference": "stub_gain", "gain": 2.0, "samplerate": 1e6,
         "limit": 1e-6, "reduced": []}))
    (bench / "workloads" / "stub-tone.json").write_text(json.dumps(
        {"block": 4096, "pool_blocks": 2, "noise": 0.1, "check_blocks": 2,
         "signals": [{"kind": "tone", "every": 1, "amplitude": 0.5,
                      "offset_hz": 1000.0}]}))
    (bench / "metrics" / "stub.calls.py").write_text(
        "def read(ctx):\n    return float(len(ctx.host['call'])) or None\n")
    idx = load_index()
    idx["configs"].append({"name": "stub-gain", "source": "https://x",
                           "file": "benchmark/configs/stub-gain.json",
                           "reduced": [], "why": "a gain"})
    idx["workloads"].append({"name": "stub-tone", "config": "stub-gain",
                             "traffic": "stub-tone", "chips": 1,
                             "why": "a tone"})
    idx["per_layer"].append({"name": "stub.calls", "unit": "blocks",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry", "moves": "input_msps",
                             "workloads": ["stub-tone"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(idx))
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before

    cell = load_cell("stub-tone", tmp_path)
    quiet = dict(device="cpu", log=lambda s: None)
    res, _ = run_cell(cell, 2 ** 33 + 5, 0.5, False, **quiet)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in idx["end_to_end"]}
    assert set(res["checks"]) == {"gap", "none_checked", "blocks_missing"}
    res, _ = run_cell(cell, 6, 0.5, True, **quiet)
    assert res["correct"] and res["metrics"]["stub.calls"]["value"] > 0

    def off_by_one(entry, step):
        return lambda st, x: (lambda s, y: (s, y + 1))(*step(st, x))

    res, _ = run_cell(cell, 7, 0.5, False, wrap_step=off_by_one, **quiet)
    assert not res["correct"] and res["failed"] > 0
