"""Whole runs of the harness on the CPU at small sizes (fewer channels,
shorter blocks), the look for a card skipped: the reference against the
port's CPU path, the planted faults that must make ``correct`` false,
the control that must fail where the program passes, and no JAX in the
process."""

import copy
import json
import subprocess
import sys

import pytest

from benchmark.control import control_readings
from benchmark.harness import FORBIDDEN, run_cell
from benchmark.spec import ROOT, load_cell

# (channels, block, pool blocks): the SSB channel filter's 1,351 taps
# want an IF block several times longer, or its start-up decides the
# squelch; the NFM bank settles within 1,024 IF samples
SMALL = {"nfm64-16m": (16, 1 << 17, 3), "ssb64-16m": (4, 1 << 20, 2)}


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads a run: the tests' workers share the host's
    cores, and a window of a few seconds fills with no block where each
    worker's pool takes them all."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def small_cell(name, inp=None):
    cell = load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["bank"]["channels"] = SMALL[name][0]
    if inp is not None:
        cell.traffic = dict(cell.traffic, input=inp)
    return cell


def run_small(name, seed=20240901, seconds=2.0, inp=None, **kw):
    _, block, pool = SMALL[name]
    return run_cell(small_cell(name, inp), seed, seconds, False,
                    device="cpu", block=block, pool_blocks=pool,
                    check_blocks=2, log=lambda s: None, **kw)


@pytest.mark.parametrize("inp", ["card", "host"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_port_agrees_with_the_reference(name, inp):
    """Through either input: the recording resident on the device, or in
    host memory through the program's Prefetcher."""
    res, info = run_small(name, inp=inp)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["checks"]["audio_err"]["value"] < \
        load_cell(name).config["check"]["audio_err"]
    assert info["blocks_in_window"] == res["attempted"] > 0


def _stale_state(bank, step):
    return lambda st, x: (st, step(st, x)[1])


def _half_batch(bank, step):
    def f(st, x):
        st, y = step(st, x)
        y = y.clone()
        h = y.shape[0] // 2
        y[h:] = y[:h].mean(dim=0, keepdim=True)
        return st, y
    return f


def _one_answer(bank, step):
    def f(st, x):
        st, y = step(st, x)
        y = y.clone()
        i = int(y[0].abs().argmax())
        y[0, i] = -y[0, i]
        return st, y
    return f


@pytest.mark.parametrize("fault", [_stale_state, _half_batch, _one_answer],
                         ids=["state-unchanged", "half-batch",
                              "answer-altered"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_planted_fault_makes_correct_false(name, fault):
    res, _ = run_small(name, wrap_step=fault)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_where_the_program_passes(name):
    cell = small_cell(name)
    limit = cell.config["check"]["audio_err"]
    _, block, pool = SMALL[name]
    ctl = control_readings(cell, [7], 8, device="cpu", log=lambda s: None,
                           block=block, pool_blocks=pool, check_blocks=2)
    assert ctl[0]["audio_err"] > limit
    res, _ = run_small(name, seed=7)
    assert res["checks"]["audio_err"]["value"] < limit


def test_no_jax_in_a_run():
    """The process that runs a cell holds no JAX, jaxlib, flax or JAX
    package module (top-level names compared whole: the port's name
    begins with the JAX package's)."""
    code = (
        "import copy, json, sys\n"
        "import benchmark.run, benchmark.control\n"
        "from benchmark.harness import run_cell\n"
        "from benchmark.spec import load_cell\n"
        "cell = load_cell('ssb64-16m')\n"
        "cell.config = copy.deepcopy(cell.config)\n"
        "cell.config['bank']['channels'] = 4\n"
        "run_cell(cell, 3, 0.3, True, device='cpu', block=1 << 16,\n"
        "         pool_blocks=2, check_blocks=1, log=lambda s: None)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"                         if m.split('.')[0] in {FORBIDDEN!r})))\n"
        "print('sdrpp_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == [] and lines[-1] == "True"
