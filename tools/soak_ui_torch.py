"""Soak the live receiver of the PyTorch/CUDA port (sdrpp_tpu_torch): a
long session of random control over the whole control surface while the
engine must never stop and audio must keep flowing.

The counterpart of tools/soak_ui.py for ``sdrpp_tpu_torch.misc.webui``,
with its action mix, its 60-s audio-liveness rule and its per-VFO
counters: retune, bandwidth, squelch, deemphasis, add/delete VFO, select
VFO, scanner start/stop, volume, zoom, and cycling through every mode of
``ALL_MODES``, digital included. ``soak`` drives an engine directly
through ``ReceiverEngine.control`` / ``snapshot`` (the calls the HTTP
handlers make) and returns a summary: actions, blocks, failures the
engine survived, the wall ms a block (p50, p99: the gap between the
engine loop's source reads, device time included) and its longest gap
between two blocks, each mode's set-up time, and any problem. When it
records an audio stall it dumps every thread's stack (``faulthandler``)
to stderr.

Usage: python tools/soak_ui_torch.py [--device cuda|cpu] [--seconds 600]
           [--seed 0] [--modes-first] [--port 0]
Serves the page on --port while it runs (0: a free port, printed), prints
a status line a minute and a final PASS/FAIL line with the summary; exit
0 iff the engine survived every action with audio still flowing.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STALL_S = 60.0        # an analog VFO must write audio within this
FIRST_BLOCK_S = 900.0  # the first block may wait for the kernels' builds
MODE_S = 300.0        # a set_mode's chain must run within this


class _TimedSource:
    """The engine's source with the time of each read kept: the engine
    loop reads once a block, so the gaps are its host time a block."""

    def __init__(self, source):
        self._source = source
        self.stamps: list[float] = []

    def __getattr__(self, name):
        return getattr(self._source, name)

    def read(self, n):
        self.stamps.append(time.monotonic())
        return self._source.read(n)


def _wait(pred, timeout: float, what: str):
    """Poll ``pred`` until it is true; raises TimeoutError at the
    deadline."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} not within {timeout:.0f} s")
        time.sleep(0.05)


def soak(engine, seconds: float, seed: int, modes_first: bool = False,
         log=print) -> dict:
    """Soak ``engine`` (started here if it is not running) for ``seconds``
    of random control, seeded by ``seed``. With ``modes_first`` it first
    sets every mode of ALL_MODES once on the selected VFO, each waited
    for until its chain runs (and, for an analog mode, writes audio). The
    engine is left running. Returns the summary; ``ok`` is true iff the
    engine ran to the end with no problem."""
    from sdrpp_tpu_torch.misc.webui import ALL_MODES, DIGITAL_MODES

    rng = np.random.default_rng(seed)
    half = engine.samplerate / 2.0
    timed = engine.source = _TimedSource(engine.source)
    problems: list[str] = []
    modes: dict[str, float] = {}
    extra_vfos: list[str] = []
    vfo_serial = 0  # names unique for the session: deletes are queued and
    #                 apply at the next block, so a reused name could race
    #                 its own pending delete
    mode_i = 0
    actions = 0

    def control(action, value=None):
        nonlocal actions
        actions += 1
        try:
            engine.control(action, value)
        except ValueError as e:
            problems.append(f"control {action}={value!r} refused: {e}")

    def rand_action():
        nonlocal mode_i, vfo_serial
        roll = rng.integers(0, 10)
        if roll == 0:  # every mode in turn, digital included
            control("set_mode", ALL_MODES[mode_i % len(ALL_MODES)])
            mode_i += 1
        elif roll == 1:
            control("set_offset", float(rng.uniform(-half * 0.8, half * 0.8)))
        elif roll == 2:  # any bandwidth: a state write for analog VFOs
            control("set_bandwidth", float(np.exp(rng.uniform(
                np.log(1000.0), np.log(200000.0)))))
        elif roll == 3:
            control("set_squelch", float(rng.uniform(-90.0, -30.0))
                    if rng.random() < 0.7 else None)
        elif roll == 4:
            control("set_deemphasis",
                    [None, "22us", "50us", "75us"][int(rng.integers(0, 4))])
        elif roll == 5:
            if len(extra_vfos) < 2:
                name = f"soak{vfo_serial}"
                vfo_serial += 1
                control("add_vfo", {
                    "name": name,
                    "mode": ALL_MODES[int(rng.integers(0, len(ALL_MODES)))],
                    "offset": float(rng.uniform(-half * 0.8, half * 0.8))})
                extra_vfos.append(name)
            else:
                control("delete_vfo", extra_vfos.pop())
        elif roll == 6:
            st = engine.snapshot()
            # only VFOs this soak has not deleted (a queued delete is not
            # in the snapshot yet)
            others = [v for v in st["vfos"] if v != st["selected"]
                      and (v == "vfo0" or v in extra_vfos)]
            if others:
                control("select_vfo", others[0])
        elif roll == 7:
            if rng.random() < 0.5:
                control("scan_start", {"start": -half * 0.5,
                                       "stop": half * 0.5,
                                       "interval": 25000.0, "level": -50.0})
            else:
                control("scan_stop")
        elif roll == 8:
            control("set_volume", float(rng.uniform(0.2, 1.0)))
        else:
            zoom = float(rng.uniform(0.1, 1.0))
            control("set_view", [0.0, engine.samplerate * zoom])

    def running():
        return engine.snapshot()["running"]

    if not running():
        engine.start()
    t_first = time.monotonic()
    _wait(lambda: engine.snapshot()["blocks"] > 0 or not running(),
          FIRST_BLOCK_S, "first block")
    first_block_s = time.monotonic() - t_first
    t0 = time.monotonic()

    def adopted(mode):
        st = engine.snapshot()
        return st["mode"] == mode and not st["switching"]

    def streaming(name, blocks, audio, digital):
        return (engine.snapshot()["blocks"] >= blocks + 2
                and (digital or engine.audio_written(name) > audio))

    if modes_first:
        for mode in ALL_MODES:
            t_mode = time.monotonic()
            control("set_mode", mode)
            try:
                _wait(lambda: adopted(mode) or not running(), MODE_S,
                      f"set_mode {mode}")
                name = engine.snapshot()["selected"]
                blocks = engine.snapshot()["blocks"]
                audio = engine.audio_written(name)
                _wait(lambda: streaming(name, blocks, audio,
                                        mode in DIGITAL_MODES)
                      or not running(), MODE_S,
                      f"{mode}'s blocks and audio")
            except TimeoutError as e:
                problems.append(str(e))
            modes[mode] = time.monotonic() - t_mode
            if not running():
                break
        mode_i = len(ALL_MODES)

    last_audio_t = time.monotonic()
    prev: dict[str, int] = {}
    next_report = t0 + 60.0
    while time.monotonic() - t0 < seconds and running():
        rand_action()
        time.sleep(float(rng.uniform(0.2, 1.5)))
        st = engine.snapshot()
        if not st["running"]:
            break
        # audio liveness, per VFO: a deleted VFO frees its ring, so a sum
        # of counters can drop and read as a stall while audio flows; a
        # new VFO counts once it has written something
        analog = [v for v, c in st["vfos"].items()
                  if c["mode"] not in DIGITAL_MODES]
        counts = {v: engine.audio_written(v) for v in analog}
        advanced = any(counts[v] > prev[v] if v in prev else counts[v] > 0
                       for v in counts)
        now = time.monotonic()
        if analog and advanced:
            last_audio_t = now
        elif analog and now - last_audio_t > STALL_S:
            problems.append(
                f"audio stalled > {STALL_S:.0f} s at action {actions} "
                f"(modes {[c['mode'] for c in st['vfos'].values()]}, "
                f"blocks {st['blocks']})")
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            last_audio_t = now
        prev = counts
        if now >= next_report:
            next_report += 60.0
            log(f"[{now - t0:6.0f} s] actions={actions} "
                f"blocks={st['blocks']} failures={st['failures']} "
                f"vfos={[c['mode'] for c in st['vfos'].values()]} "
                f"err={st['error']}")

    st = engine.snapshot()
    engine.source = timed._source
    if not st["running"]:
        problems.append(f"engine died after {actions} actions: "
                        f"{st['error']}")
    gaps = np.diff(np.asarray(timed.stamps)) * 1e3
    return {"ok": not problems and st["running"],
            "seconds": time.monotonic() - t0,
            "first_block_s": first_block_s,
            "actions": actions, "blocks": st["blocks"],
            "failures": st["failures"], "running": st["running"],
            "error": st["error"], "problems": problems, "modes": modes,
            "vfos": {v: c["mode"] for v, c in st["vfos"].items()},
            "block_ms_p50": float(np.percentile(gaps, 50)) if len(gaps)
            else None,
            "block_ms_p99": float(np.percentile(gaps, 99)) if len(gaps)
            else None,
            "max_block_gap_s": float(gaps.max() / 1e3) if len(gaps)
            else None}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--modes-first", action="store_true",
                    help="set every mode once before the random mix")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--bg-preheat", action="store_true",
                    help="run the engine's background mode-switch "
                         "preheater during the soak")
    args = ap.parse_args()

    from sdrpp_tpu_torch.io.sources import TestSource
    from sdrpp_tpu_torch.misc.webui import ReceiverEngine, WebUIServer

    src = TestSource(1000000.0, tones=[(100000.0, -20.0),
                                             (-250000.0, -40.0)],
                     noise_dbfs=-60.0)
    eng = ReceiverEngine(src, mode="nfm", offset=100000.0, realtime=False,
                         fft_size=4096, base_block=262144,
                         background_preheat=args.bg_preheat,
                         device=args.device)
    srv = WebUIServer(eng, port=args.port)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(f"device {args.device}; page at "
          f"http://127.0.0.1:{srv.server_address[1]}/", flush=True)
    try:
        res = soak(eng, args.seconds, args.seed, args.modes_first,
                   log=lambda m: print(m, flush=True))
    finally:
        eng.stop()
        srv.shutdown()
        srv.server_close()
    print(f"{'PASS' if res['ok'] else 'FAIL'} soak: {json.dumps(res)}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
