"""The port engine's recovery ladder, its supervisor and its background
preheater (sdrpp_tpu_torch/misc/webui.py, sdrpp_tpu_torch/cli.py), on
the CPU: the counterparts of the ladder, supervisor and preheat cases of
tests/test_webui.py, beside tests/test_torch_webui.py.

Where the port repairs a fault of the reference, the repair is asserted
in place of the JAX behaviour:

1. a supervised fatal exit runs serve_ui's pre-exit save, so the session
   holds the controls applied just before
   (``test_supervised_fatal_exit_saves_the_session``);
2. rung 4 (fatal, and exit under supervision) needs a failed probe of the
   device after the ladder; a streak of plain exceptions keeps backing
   off, in or out of supervision, and a CPU engine never exits
   (``test_ladder_rung4_only_on_a_poisoned_device``,
   ``test_supervised_engine_survives_plain_failures``);
3. a poisoned state is planted from the engine thread at a block
   boundary, not raced against the step in flight
   (``test_ladder_recovers_from_poisoned_device_state``; the JAX test's
   unsteadiness);
4. every wait has a deadline; no test sleeps a fixed time.

The ladder's own backoff (0.5 s more a failure) sets most of this file's
time.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from sdrpp_tpu_torch.io.sources import TestSource
from sdrpp_tpu_torch.misc.webui import ReceiverEngine

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _engine(**kw):
    src = TestSource(1000000.0, tones=[(100000.0, -20.0)], noise_dbfs=-90.0)
    kw.setdefault("mode", "nfm")
    kw.setdefault("offset", 100000.0)
    kw.setdefault("fft_size", 4096)
    kw.setdefault("base_block", 65536)
    kw.setdefault("realtime", False)
    kw.setdefault("device", "cpu")
    return ReceiverEngine(src, **kw)


def _wait(pred, timeout=180.0):
    """Poll ``pred`` until it holds or the deadline passes."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _settle(eng, timeout=180.0):
    """Wait until no background rebuild is pending or building and the
    engine has streamed a block on the adopted chain."""
    ok = _wait(lambda: not eng.snapshot()["switching"], timeout)
    b0 = eng.blocks
    return ok and _wait(lambda: eng.blocks > b0, timeout)


def test_engine_survives_step_failure():
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        real_step = eng._step
        boom = {"left": 2}

        def flaky(state, x):
            if boom["left"] > 0:
                boom["left"] -= 1
                raise RuntimeError("CUDA error: an illegal memory access")
            return real_step(state, x)

        eng._step = flaky
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 3), eng.error
        assert eng.failures >= 1
        assert eng._thread.is_alive()
        st = eng.snapshot()
        assert st["running"] and st["failures"] >= 1
    finally:
        eng.stop()


class _Broken:
    def __init__(self, *a, **kw):
        raise RuntimeError("synthetic meteor build failure")


def test_engine_reverts_bad_mode_switch(monkeypatch):
    import sdrpp_tpu_torch.models.lrpt as lrpt

    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        monkeypatch.setattr(lrpt, "MeteorChannel", _Broken)
        eng.control("set_mode", "meteor")
        assert _wait(lambda: eng.failures >= 1, timeout=60)
        assert _wait(lambda: eng.vfos["vfo0"]["mode"] == "nfm", timeout=60)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        assert eng._thread.is_alive()
        a0 = eng.audio_written("vfo0")
        assert _wait(lambda: eng.audio_written("vfo0") > a0)
    finally:
        eng.stop()


def test_background_preheat_warms_next_modes(monkeypatch):
    from sdrpp_tpu_torch.misc import webui as webui_mod

    monkeypatch.setattr(webui_mod, "ALL_MODES", ["nfm", "am"])
    eng = _engine(background_preheat=True)
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        assert _wait(lambda: len(eng._preheated) >= 2, timeout=300), \
            eng._preheated
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks > b0)
        eng.control("set_mode", "am")
        assert _settle(eng, timeout=240)
        assert eng._built_cfgs["vfo0"]["mode"] == "am"
        assert eng.error is None and eng.failures == 0
        assert eng._preheater is not None and eng._preheater.is_alive()
    finally:
        eng.stop()


def test_preheat_retries_after_transient_failure(monkeypatch):
    from sdrpp_tpu_torch.misc import webui as webui_mod

    monkeypatch.setattr(webui_mod, "ALL_MODES", ["nfm"])
    eng = _engine(background_preheat=True)
    real_warm = eng.warm_plan
    boom = {"left": 1, "calls": 0}

    def flaky_warm(cfgs):
        boom["calls"] += 1
        if boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("synthetic preheat blip")
        return real_warm(cfgs)

    eng.warm_plan = flaky_warm
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        assert _wait(lambda: len(eng._preheated) >= 1, timeout=300)
        assert boom["calls"] >= 2
        assert eng.failures == 0 and eng._thread.is_alive()
    finally:
        eng.stop()


def test_preheat_gives_up_after_repeated_failures(monkeypatch):
    from sdrpp_tpu_torch.misc import webui as webui_mod

    monkeypatch.setattr(webui_mod, "ALL_MODES", ["nfm"])
    eng = _engine(background_preheat=True)
    calls = {"n": 0}

    def always_fail(cfgs):
        calls["n"] += 1
        raise RuntimeError("synthetic permanent preheat failure")

    eng.warm_plan = always_fail
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        assert _wait(lambda: len(eng._preheated) >= 1, timeout=120)
        assert calls["n"] == 3
        assert eng.failures == 0 and eng._thread.is_alive()
    finally:
        eng.stop()


def test_failed_plan_before_first_promotion_reverts_to_running(monkeypatch):
    import sdrpp_tpu_torch.models.lrpt as lrpt

    monkeypatch.setattr(lrpt, "MeteorChannel", _Broken)
    eng = _engine()
    eng.control("set_mode", "meteor")
    try:
        eng.start()
        assert _wait(lambda: eng.failures >= 1, timeout=120)
        assert _wait(lambda: eng.vfos["vfo0"]["mode"] == "nfm", timeout=120)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks > b0 + 1), eng.error
        assert eng._thread.is_alive()
        assert _wait(lambda: not eng.snapshot()["switching"])
    finally:
        eng.stop()


def test_error_clears_after_recovery():
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        eng.error = "RuntimeError: synthetic stale blip"
        assert _wait(lambda: eng.error is None, timeout=60)
        assert eng._thread.is_alive()
    finally:
        eng.stop()


def test_ladder_recovers_from_poisoned_device_state():
    """A structurally wrong carried state must not survive the ladder's
    rebuild on fresh state (consecutive == 2). The bad state is planted
    from the engine thread, at a block boundary: written from the test's
    thread (as tests/test_webui.py does) it races the step in flight,
    which may overwrite it with its result — the JAX test's unsteadiness."""
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        f0 = eng.failures
        real_apply = eng._apply_controls

        def plant():
            eng._apply_controls = real_apply
            fe_st, ch_st = eng._state
            bad = dict(ch_st)
            bad["vfo0"] = ()  # structurally wrong channel state
            eng._state = (fe_st, bad)
            real_apply()

        eng._apply_controls = plant
        assert _wait(lambda: eng.failures > f0, timeout=60)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 3, timeout=120), eng.error
        a0 = eng.audio_written("vfo0")
        assert _wait(lambda: eng.audio_written("vfo0") > a0, timeout=60)
        assert _wait(lambda: eng.error is None, timeout=60)
        assert eng._thread.is_alive()
        assert eng.failures <= f0 + 3
    finally:
        eng.stop()


def _boom(*a, **kw):
    raise RuntimeError("synthetic step failure")


def test_ladder_rung4_only_on_a_poisoned_device(monkeypatch):
    """Fix 2: a streak of failures through the whole ladder (retry,
    rebuild, revert, grace) on a device that still runs does NOT declare
    fatal: the engine keeps backing off and the surface stays alive. Only
    when the device probe fails is the backend declared fatal.

    The streak starts in the engine thread, at a block boundary (the step,
    the plan and the probe swapped there, the streak's first failure count
    read there), and the probe records the failure it runs for: the
    engine counts a failure before it probes for it, so a test that reads
    the count alone can find the 6th failure counted and its probe not yet
    run."""
    monkeypatch.delenv("SDRPP_TPU_SUPERVISED", raising=False)
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        assert eng._device_poisoned() is False  # the CPU never is
        probes = []
        streak = {}
        real_probe = eng._device_poisoned
        real_apply = eng._apply_controls

        def probe():
            probes.append(eng.failures - streak["f0"])
            return real_probe()

        def start_streak():
            eng._apply_controls = real_apply
            streak["f0"] = eng.failures
            eng._device_poisoned = probe
            eng._step = _boom
            monkeypatch.setattr(type(eng), "_plan", _boom)
            real_apply()

        eng._apply_controls = start_streak
        assert _wait(lambda: "f0" in streak, timeout=60)
        f0 = streak["f0"]
        assert _wait(lambda: eng.failures >= f0 + 6 and len(probes) >= 2,
                     timeout=120)
        assert len(probes) >= 2  # probed from the 5th failure of the streak
        assert probes[:2] == [5, 6], probes
        assert not eng.fatal and eng._thread.is_alive()
        assert "restart required" not in (eng.error or "")

        def poison():
            eng._apply_controls = real_apply
            eng._device_poisoned = lambda: True
            real_apply()

        eng._apply_controls = poison
        assert _wait(lambda: eng.fatal, timeout=120)
        assert eng.error and "restart required" in eng.error
        assert eng._thread.is_alive()  # HTTP surface stays serviceable
        snap = eng.snapshot()
        assert snap["fatal"] is True and snap["error"] == eng.error
    finally:
        eng.stop()


def _child(script, tmp_path, supervised=True, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    env.pop("SDRPP_TPU_SUPERVISED", None)
    if supervised:
        env["SDRPP_TPU_SUPERVISED"] = "1"
    return subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


_CHILD_HEAD = r"""
import json, sys, time
import torch
from sdrpp_tpu_torch.io.sources import TestSource
from sdrpp_tpu_torch.misc.webui import ReceiverEngine, serve_ui
torch.set_num_threads(1)

def wait(pred, timeout=120):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)

def boom(*a, **kw):
    raise RuntimeError("synthetic step failure")

src = TestSource(250000.0, tones=[(50000.0, -20.0)], noise_dbfs=-90.0)
eng = ReceiverEngine(src, mode="nfm", offset=50000.0, realtime=False,
                     base_block=65536, fft_size=4096, device="cpu")
"""


def test_supervised_fatal_exit_saves_the_session(tmp_path):
    """Fix 1 and the exit itself: under SDRPP_TPU_SUPERVISED a poisoned
    device after the full ladder exits BACKEND_FATAL_EXIT from the engine
    thread, and serve_ui's pre-exit hook has saved the session with the
    controls applied just before; a new engine restores it and streams."""
    from sdrpp_tpu_torch.cli import BACKEND_FATAL_EXIT
    from sdrpp_tpu_torch.misc.webui import load_session

    cfg = tmp_path / "ui.json"
    script = _CHILD_HEAD + rf"""
srv = serve_ui(eng, port=0, forever=False, config_path={str(cfg)!r})
wait(lambda: eng.blocks >= 1)
eng.control("add_vfo", {{"name": "keep", "mode": "am", "offset": -60000.0}})
eng.control("set_volume", 0.3)
# promoted to last-good (a clean block on the new chain), so the
# ladder's revert (rung 3) keeps it
wait(lambda: "keep" in (eng._last_good_vfos or {{}}))
eng._step = boom
type(eng)._plan = boom
eng._device_poisoned = lambda: True
eng._thread.join(120)
print("ENGINE THREAD RETURNED WITHOUT EXIT", flush=True)
sys.exit(3)
"""
    r = _child(script, tmp_path)
    assert r.returncode == BACKEND_FATAL_EXIT, \
        (r.returncode, r.stdout[-500:], r.stderr[-2000:])
    saved = json.loads(cfg.read_text())
    assert saved["vfos"]["keep"]["mode"] == "am"
    assert saved["vfos"]["keep"]["offset"] == -60000.0
    assert saved["volume"] == 0.3 and saved["selected"] == "keep"

    eng = _engine()
    load_session(eng, cfg)
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        assert set(eng._built_cfgs) == {"vfo0", "keep"}
        assert eng.error is None and eng.volume == 0.3
    finally:
        eng.stop()


def test_supervised_engine_survives_plain_failures(tmp_path):
    """Fix 2 under supervision: a streak of plain Python exceptions runs
    the whole ladder and keeps backing off; the process does not exit."""
    script = _CHILD_HEAD + r"""
eng.start()
wait(lambda: eng.blocks >= 1)
eng._step = boom
type(eng)._plan = boom
wait(lambda: eng.failures >= 6)  # the ladder, the probe, one more
assert not eng.fatal and eng._thread.is_alive(), eng.error
print("ALIVE", eng.failures, flush=True)
eng.stop()
"""
    r = _child(script, tmp_path)
    assert r.returncode == 0, (r.returncode, r.stderr[-2000:])
    assert "ALIVE" in r.stdout


def test_supervisor_restarts_on_backend_fatal(monkeypatch):
    from sdrpp_tpu_torch import cli
    from sdrpp_tpu_torch.cli import BACKEND_FATAL_EXIT, _supervise

    codes = [BACKEND_FATAL_EXIT, BACKEND_FATAL_EXIT, 0]
    calls = {"n": 0}

    def spawn():
        rc = codes[calls["n"]]
        calls["n"] += 1
        return rc

    monkeypatch.setattr(cli.time, "sleep", lambda s: None)
    assert _supervise(["unused"], _spawn=spawn) == 0
    assert calls["n"] == 3

    calls["n"] = 0
    codes[:] = [3]
    assert _supervise(["unused"], _spawn=spawn) == 3
    assert calls["n"] == 1


def test_cli_ui_supervise_strips_the_flag(monkeypatch):
    """``ui --supervise`` runs ``python -m sdrpp_tpu_torch ui`` without the
    flag (or an abbreviation of it) under the supervisor, and refuses to
    nest inside a supervised child."""
    from sdrpp_tpu_torch import cli

    seen = []
    monkeypatch.delenv("SDRPP_TPU_SUPERVISED", raising=False)
    monkeypatch.setattr(cli, "_supervise", lambda cmd: seen.append(cmd) or 0)
    argv = ["--source", "test:1000000", "--sup", "--device", "cpu"]
    assert cli.main(["ui"] + argv) == 0
    assert seen == [[sys.executable, "-m", "sdrpp_tpu_torch", "ui",
                     "--source", "test:1000000", "--device", "cpu"]]
    monkeypatch.setenv("SDRPP_TPU_SUPERVISED", "1")
    with pytest.raises(SystemExit):
        cli.main(["ui", "--source", "test:1000000", "--supervise"])


def test_rebuild_failure_error_stays_until_next_control(monkeypatch):
    import sdrpp_tpu_torch.models.lrpt as lrpt

    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        monkeypatch.setattr(lrpt, "MeteorChannel", _Broken)
        eng.control("set_mode", "meteor")
        assert _wait(lambda: eng.failures >= 1, timeout=120)
        assert _wait(lambda: eng.vfos["vfo0"]["mode"] == "nfm", timeout=120)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 3), eng.error
        assert eng.error is not None and "build failure" in eng.error
        assert eng.snapshot()["error"] == eng.error
        eng.control("set_offset", 90000.0)
        assert _wait(lambda: eng.error is None, timeout=60)
    finally:
        eng.stop()


def test_runtime_scalars_survive_ladder_revert():
    eng = _engine(squelch=-50.0)
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        assert _wait(lambda: eng._last_good_vfos is not None)
        eng.control("set_squelch", -70.0)
        eng.control("set_offset", 120000.0)
        assert _wait(lambda: eng.vfos["vfo0"]["squelch"] == -70.0
                     and eng.vfos["vfo0"]["offset"] == 120000.0)
        assert _wait(lambda: eng._last_good_vfos["vfo0"]["squelch"]
                     == -70.0)
        assert eng._last_good_vfos["vfo0"]["offset"] == 120000.0
    finally:
        eng.stop()
