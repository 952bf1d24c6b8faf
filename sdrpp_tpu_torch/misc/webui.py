"""Web panadapter: the reference GUI's role, served over HTTP.

The counterpart of ``sdrpp_tpu.misc.webui`` (reference: MainWindow wires
the waterfall widget, VFO drag-tuning, demod menu and audio sink into one
GUI loop, core/src/gui/main_window.cpp:31-709, widgets/waterfall.cpp). A
headless GPU host serves the same surface to a browser:

- ``ReceiverEngine``: the DSP thread. Each block goes source -> the
  ``IQFrontEnd`` -> every VFO's ``RadioChannel`` or ``MeteorChannel`` in
  one plain step on the engine's device (CUDA unless the caller names
  another); FFT lines feed a ``WaterfallDisplay`` (misc/waterfall.py, the
  widget's data plane), audio a ring per VFO for HTTP streaming, a digital
  VFO's symbols a constellation ring. Offset, squelch level and analog
  bandwidth are written into the channels' state between blocks; a mode
  switch, an added or deleted VFO or a digital bandwidth builds a new
  chain on a builder thread while the stream runs on, and the engine swaps
  at a block boundary (the functional analog of tempStop/tempStart
  rewiring, core/src/dsp/block.h:47-65).
- ``WebUIServer``: stdlib ThreadingHTTPServer with a JSON control API
  (the SmGui remote-menu role, core/src/gui/smgui.h:8-60), binary
  spectrum/waterfall endpoints, and a progressive stereo PCM16 WAV audio
  stream (the audio_sink role, sink_modules/audio_sink). The page is the
  JAX package's, its script unchanged.

Nothing is compiled: a "warm" step (the builder's, the preheater's and
``cli preheat``'s unit of work) runs one block of a planned chain on
throwaway state, which builds the CUDA kernels at their first use and
pays the chain's first allocations. Every thread launches on the device's
default stream.

Where the port's engine differs from the JAX one, it repairs a fault of
the reference: the recovery ladder's last rung declares the backend fatal
only when a probe of the device fails (on CUDA a device-side fault
poisons the context until the process exits; any other failure streak
keeps the backoff loop, and a CPU engine never exits the process), a
supervised fatal exit saves the session first (``serve_ui`` registers
the save as ``pre_exit``), and ``set_bandwidth`` on an analog VFO that is
not built yet clamps the value to the mode's range and records it for
the pending build.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..utils.log import get_logger
from .waterfall import WaterfallDisplay

__all__ = ["ReceiverEngine", "WebUIServer", "serve_ui"]

log = get_logger("webui")

MODES = ["wfm", "nfm", "am", "usb", "lsb", "dsb", "cw", "raw"]
# digital modes: no audio; symbols feed the constellation endpoint
# (the reference's constellation_diagram for the meteor demodulator,
# decoder_modules/meteor_demodulator/src/main.cpp:70-77)
DIGITAL_MODES = ["meteor"]
ALL_MODES = MODES + DIGITAL_MODES

# child exit code meaning "backend unrecoverable in-process, restart me"
# — shared with the cli supervisor (cli.BACKEND_FATAL_EXIT re-exports)
BACKEND_FATAL_EXIT = 86

# Digital/raw VFO bandwidths snap to this log grid (sqrt(2) steps,
# 10 kHz .. ~453 kHz): their bandwidth keys the chain (a rebuild), so
# they take the JAX engine's grid (analog bandwidth is runtime state and
# takes any value in the mode's range)
_DIGITAL_BW_GRID = [10000.0 * 2.0 ** (i / 2.0) for i in range(12)]
CONSTELLATION_RING = 4096  # symbols kept per digital VFO


class ReceiverEngine:
    """Background receive chain feeding the web UI.

    N simultaneous VFOs demodulated in one step per block (the
    reference's N radio-module instances, here a dict of RadioChannels
    over the same front-end IQ — receiver.py's pattern), a spectrum
    branch, and a per-VFO audio ring, on ``device`` (default ``cuda``).
    Thread-safe: control via :meth:`control`, reads via
    :meth:`snapshot`/:meth:`read_fft`/:meth:`read_waterfall_rows`/
    :meth:`read_audio`.
    """

    AUDIO_RING_SECONDS = 4.0

    def __init__(self, source, mode: str = "wfm", offset: float = 0.0,
                 bandwidth: float | None = None, squelch: float | None = None,
                 audio_rate: float = 48000.0, fft_size: int = 16384,
                 fft_rate: float = 20.0, base_block: int = 262144,
                 waterfall_width: int = 1024, waterfall_height: int = 512,
                 realtime: bool = True, background_preheat: bool = False,
                 device="cuda"):
        self.device = torch.device(device)
        self.source = source
        self.samplerate = float(source.samplerate)
        self.audio_rate = float(audio_rate)
        self.fft_size = int(fft_size)
        self.fft_rate = float(fft_rate)
        self.base_block = int(base_block)
        self.realtime = realtime
        self.center_freq = float(getattr(source, "center_freq", 0.0) or 0.0)

        self.vfos: dict[str, dict] = {
            "vfo0": dict(mode=mode, offset=float(offset), bandwidth=bandwidth,
                         squelch=squelch, deemphasis=None, rds=False)}
        self._rds: dict[str, object] = {}  # name -> RDSReceiver
        self.selected = "vfo0"
        self.volume = 1.0
        self.muted = False

        self.lock = threading.Lock()
        self.waterfall = WaterfallDisplay(
            self.fft_size, data_width=waterfall_width,
            waterfall_height=waterfall_height,
            whole_bandwidth=self.samplerate)
        self.waterfall.select_vfo(self.vfos[self.selected]["offset"],
                                  self._effective_bandwidth(self.selected))

        self._audio: dict[str, dict] = {}
        self._audio_event = threading.Condition(self.lock)
        self._ensure_audio_ring("vfo0")

        self.bookmarks = None  # FrequencyManager, see attach_bookmarks
        self._scanner = None  # misc/scanner.Scanner while sweeping
        self._digital: set[str] = set()
        # per-digital-VFO constellation ring (latest symbols, complex64)
        self._const: dict[str, dict] = {}
        self._wf_total = 0  # monotonic count of FFT lines pushed
        self._controls: list[tuple[str, object]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.blocks = 0
        self.samples = 0
        self.error: str | None = None
        self.fatal = False  # rung 4: the device context is poisoned
        # called (best effort) before a supervised fatal exit; serve_ui
        # registers the session save here
        self.pre_exit = None
        # rebuild-failure errors stay visible until the NEXT control
        # arrives: the engine streams a clean block on the reverted
        # chain immediately, so clearing on clean steps would hide the
        # failed set_mode from /api/state polling
        self._error_sticky = False
        self.failures = 0  # total engine-step failures survived
        # config revert points for the recovery ladder: _pending_good is
        # the config a fresh _build ran under; one clean step promotes it
        self._last_good_vfos: dict | None = None
        self._pending_good: dict | None = None
        # background builder (non-blocking reconfig): the engine streams
        # the old chain while a new one is built and warmed
        self._builder: threading.Thread | None = None
        self._builder_active = False  # owned by self.lock
        self._want_cfgs: dict | None = None
        self._ready_plan: dict | None = None
        # background mode-switch preheat (start() spawns it when
        # enabled): warms the chains a set_mode on the selected VFO would
        # produce, so the user's first switch finds its kernels built
        self.background_preheat = bool(background_preheat)
        self._preheater: threading.Thread | None = None
        self._preheated: set[str] = set()
        self._preheat_attempts: dict[str, int] = {}
        self._build()

    # ---- chain construction ----

    def _ensure_audio_ring(self, name: str):
        ring = int(self.AUDIO_RING_SECONDS * self.audio_rate)
        self._audio.setdefault(
            name, {"ring": np.zeros((ring, 2), np.int16), "written": 0})

    @staticmethod
    def _mode_default_bandwidth(mode: str) -> float:
        from ..models.radio import DEMOD_DEFAULTS
        d = DEMOD_DEFAULTS.get(mode)
        if d is None:
            return 140000.0  # digital (meteor) default VFO bandwidth
        return float(d["bandwidth"] or d["if_rate"] or 48000.0)

    def _effective_bandwidth(self, name: str) -> float:
        from ..models.radio import DEMOD_DEFAULTS
        cfg = self.vfos[name]
        if cfg["bandwidth"]:
            return float(cfg["bandwidth"])
        if cfg["mode"] in DIGITAL_MODES:
            return 140000.0  # meteor module default VFO bandwidth
        d = DEMOD_DEFAULTS[cfg["mode"]]
        return float(d["bandwidth"] or d["if_rate"] or self.audio_rate)

    @staticmethod
    def _graph_cfg(c):
        # offsets, squelch LEVELS, and (for analog modes) BANDWIDTH live
        # in STATE (dynamic VFOs / runtime squelch level / runtime-taps
        # FIRs), so they don't take part in the "did this channel's chain
        # change" comparison — a carried state at a different offset,
        # threshold or bandwidth is still the right state; only squelch
        # PRESENCE (None vs number) is structural. Digital (meteor)
        # channels still key their chain on bandwidth, and so does RAW:
        # it is built with dynamic_bandwidth OFF (no bandwidth-dependent
        # stage to retarget), so a raw bandwidth change is a structural
        # rebuild and must not carry a shape-mismatched state.
        drop = ("offset", "squelch")
        if c.get("mode") not in DIGITAL_MODES and c.get("mode") != "raw":
            drop = ("offset", "squelch", "bandwidth")
        d = {k: v for k, v in c.items() if k not in drop}
        d["has_squelch"] = c.get("squelch") is not None
        return d

    def _plan(self, cfgs):
        """Host-side chain construction for ``cfgs``: channels, block
        size, front end and the step (a plain function over them). The
        blocks' constants (taps, tables) go to the device here; no block
        runs."""
        import math

        from ..models.lrpt import MeteorChannel
        from ..models.radio import RadioChannel
        from ..signal_path import IQFrontEnd

        dev = self.device
        channels = {}
        for name, cfg in cfgs.items():
            if cfg["mode"] in DIGITAL_MODES:
                channels[name] = MeteorChannel(
                    self.samplerate, offset=cfg["offset"],
                    bandwidth=cfg["bandwidth"], dynamic_offset=True,
                    device=dev)
            else:
                channels[name] = RadioChannel(
                    cfg["mode"], self.samplerate, offset=cfg["offset"],
                    bandwidth=cfg["bandwidth"], audio_rate=self.audio_rate,
                    squelch_level=cfg["squelch"],
                    deemphasis=cfg["deemphasis"], rds=bool(cfg.get("rds")),
                    dynamic_offset=True, dynamic_bandwidth=True, device=dev)
        bm = 1
        for chan in channels.values():
            bm = math.lcm(bm, int(chan.block_multiple))
        block = max(bm, (self.base_block // bm) * bm)
        frontend = IQFrontEnd(self.samplerate, fft_size=self.fft_size,
                              fft_rate=self.fft_rate, block_size=block,
                              device=dev)
        digital = {name for name, cfg in cfgs.items()
                   if cfg["mode"] in DIGITAL_MODES}

        def step(state, x):
            fe, (iq, fft) = frontend(state[0], x)
            new_cs, outs = {}, {}
            for name, chan in channels.items():
                new_cs[name], outs[name] = chan(state[1][name], iq)
            return (fe, new_cs), (outs, fft)

        return {"cfgs": {k: dict(v) for k, v in cfgs.items()},
                "channels": channels, "block": block,
                "frontend": frontend, "digital": digital,
                "step": step, "t0": time.monotonic()}

    def _adopt(self, plan):
        """Switch the engine onto a planned chain. Channels whose config
        did NOT change keep their carried DSP state (PLL/AGC/filter
        tails) — retuning one VFO must not pop or re-lock the others
        (the reference restarts only the touched module under
        tempStop/tempStart). Runs in the engine thread (or before it
        starts)."""
        from ..models.rds_chain import RDSReceiver

        cfgs = plan["cfgs"]
        channels = plan["channels"]
        block = plan["block"]
        old_cfgs = getattr(self, "_built_cfgs", {})
        old_state = getattr(self, "_state", None)
        same_block = getattr(self, "_block", None) == block
        chan_states = {}
        for name, chan in channels.items():
            if (old_state is not None and name in old_cfgs
                    and name in old_state[1]
                    and self._graph_cfg(old_cfgs[name])
                    == self._graph_cfg(cfgs[name])):
                chan_states[name] = old_state[1][name]
            else:
                chan_states[name] = chan.init_state()
        fe_state = (old_state[0] if old_state is not None and same_block
                    else plan["frontend"].init_state())

        # RDS group decoders: keep a locked receiver when its channel's
        # cfg is unchanged; (re)create when rds turns on / cfg changes
        new_rds = {}
        for name, chan in channels.items():
            if not getattr(chan, "rds", False):
                continue
            if (name in self._rds and name in old_cfgs
                    and self._graph_cfg(old_cfgs[name])
                    == self._graph_cfg(cfgs[name])):
                new_rds[name] = self._rds[name]
            else:
                new_rds[name] = RDSReceiver(device=self.device)

        with self.lock:
            # controls that landed while the plan was built (retunes /
            # squelch knob / bandwidth) are already live in self.vfos —
            # resync the planned states so the swap doesn't roll them back
            for name, chan in channels.items():
                live = self.vfos.get(name)
                if live is None:
                    continue
                if live["offset"] != cfgs[name]["offset"] and \
                        hasattr(chan, "retune_state"):
                    chan_states[name] = chan.retune_state(
                        chan_states[name], live["offset"])
                    cfgs[name]["offset"] = live["offset"]
                lvl = live.get("squelch")
                if lvl is not None and lvl != cfgs[name].get("squelch") \
                        and getattr(chan, "squelch", None) is not None:
                    chan_states[name] = chan.set_squelch_state(
                        chan_states[name], lvl)
                    cfgs[name]["squelch"] = lvl
                bwv = live.get("bandwidth")
                if bwv != cfgs[name].get("bandwidth") \
                        and getattr(chan, "dynamic_bandwidth", False):
                    eff = (float(bwv) if bwv else
                           self._mode_default_bandwidth(live["mode"]))
                    chan_states[name] = chan.set_bandwidth_state(
                        chan_states[name], eff)
                    cfgs[name]["bandwidth"] = bwv
            self._rds = new_rds
            self._channels = channels
            self._block = block
            self._step = plan["step"]
            self._state = (fe_state, chan_states)
            self._built_cfgs = cfgs
            self._digital = plan["digital"]
            self._pending_good = {k: dict(v) for k, v in cfgs.items()}
        # the reference logs each demod-switch latency
        # (radio_module.h:322-336); ours = the host build + the first
        # block's kernel builds and allocations, logged at the first step
        # unless the background builder warmed the plan
        self._build_t0 = plan["t0"]
        self._compile_pending = True

    def _build(self):
        """Synchronous (re)build: plan + adopt. Used at construction and
        by the failure-recovery ladder; interactive rebuilds go through
        _request_rebuild so audio keeps flowing during the build."""
        with self.lock:
            cfgs = {name: dict(cfg) for name, cfg in self.vfos.items()}
        self._adopt(self._plan(cfgs))

    # -- background builder: mode switches must not stall the stream ----

    def _request_rebuild(self):
        """Queue an asynchronous rebuild for the CURRENT vfo configs.
        The engine keeps streaming the old chain; a builder thread plans
        the new one and runs a warm step on throwaway state, and the
        engine swaps at the next block boundary once ready (the
        reference's DSP loop never blocks on a reconfig —
        main_window.cpp:258-709)."""
        with self.lock:
            self._want_cfgs = {name: dict(cfg)
                               for name, cfg in self.vfos.items()}
            # NOT is_alive(): a builder that already decided to exit
            # (read want=None, hasn't died yet) still reports alive and
            # would orphan this request — _builder_active flips False
            # under the lock at the moment that decision is made
            if not self._builder_active:
                self._builder_active = True
                self._builder = threading.Thread(
                    target=self._builder_run, daemon=True,
                    name="webui-builder")
                self._builder.start()

    def _builder_run(self):
        try:
            self._builder_loop()
        except BaseException:
            # abnormal death (normal exit clears the flag in-loop):
            # release builder ownership so the next request can start a
            # fresh thread instead of queueing forever
            with self.lock:
                if self._builder is threading.current_thread():
                    self._builder_active = False
            raise

    def _builder_loop(self):
        while True:
            with self.lock:
                want = self._want_cfgs
                self._want_cfgs = None
                if want is None:
                    # exit decision and the active flag flip are one
                    # atomic step: a request arriving after this point
                    # sees inactive and starts a fresh builder
                    self._builder_active = False
                    return
            try:
                plan = self._plan(want)
            except Exception as e:
                # the chain cannot even be constructed (bad config):
                # deliver the failure so the engine runs its revert
                # policy
                log.error(f"builder: plan failed: "
                          f"{type(e).__name__}: {e}")
                with self.lock:
                    if self._want_cfgs is None:
                        self._ready_plan = {
                            "failed": f"{type(e).__name__}: {e}"}
                continue
            try:
                # warm step on throwaway state so the engine's swap pays
                # ~nothing (kernel builds, first allocations); it shares
                # the device with the engine's streaming steps
                t0 = time.monotonic()
                self._warm_compile(plan)
                dt = time.monotonic() - t0
                if dt > 5.0:
                    log.info("builder: warmed %s in %.1f s",
                             [c["mode"] for c in plan["cfgs"].values()],
                             dt)
            except Exception as e:
                # a warm-step blip: hand the plan over anyway — the
                # engine's recovery ladder owns step-time failures
                log.error(f"builder: warm step failed: "
                          f"{type(e).__name__}: {e}")
            with self.lock:
                if self._want_cfgs is None:
                    self._ready_plan = plan
            # if cfgs changed while building, loop and re-plan

    @staticmethod
    def _warm_compile(plan):
        """Run a plan's step once on throwaway state, and its RDS chains
        on their basebands (shared by the builder thread, the preheater
        and `cli preheat`): builds the kernels the chain launches and pays
        its first allocations. Ends in a synchronize on CUDA."""
        from ..models.rds_chain import RDSChain

        fe = plan["frontend"]
        st0 = (fe.init_state(),
               {name: chan.init_state()
                for name, chan in plan["channels"].items()})
        x0 = torch.zeros(plan["block"], dtype=torch.complex64,
                         device=fe.device)
        _, (outs, _) = plan["step"](st0, x0)
        for name, chan in plan["channels"].items():
            if getattr(chan, "rds", False):
                rds = RDSChain(device=fe.device)
                rds(rds.init_state(), outs[name][1])
        if fe.device.type == "cuda":
            torch.cuda.synchronize(fe.device)

    def warm_plan(self, cfgs) -> tuple[int, float]:
        """Plan ``cfgs`` and run its warm step (`cli preheat`'s unit of
        work): the kernels its chain launches are built and loaded, so a
        session in this process that asks for it starts warm.
        Returns (block_size, wall_seconds)."""
        t0 = time.monotonic()
        plan = self._plan(cfgs)
        self._warm_compile(plan)
        return plan["block"], time.monotonic() - t0

    def _preheater_run(self):
        """Low-priority warm steps of the likely NEXT chains: for each
        mode, the current VFO set with the selected VFO switched to it —
        exactly what a `set_mode` control would build. Runs concurrently
        with the streaming engine, on the same device."""
        while not self._stop.is_set():
            # streaming first: never compete with the initial build
            if self.blocks < 1:
                self._stop.wait(0.5)
                continue
            with self.lock:
                cfgs = {n: dict(c) for n, c in self.vfos.items()}
                sel = self.selected if self.selected in cfgs else None
            todo = None
            if sel is not None:
                for m in ALL_MODES:
                    want = {n: dict(c) for n, c in cfgs.items()}
                    # mirror set_mode exactly (_apply_controls resets
                    # bandwidth to the mode default) so the preheated
                    # chain IS the one the switch builds
                    want[sel] = dict(want[sel], mode=m, bandwidth=None)
                    key = json.dumps(
                        {n: self._graph_cfg(c) for n, c in want.items()},
                        sort_keys=True)
                    if key not in self._preheated:
                        todo = (key, want)
                        break
            if todo is None:
                self._stop.wait(2.0)  # idle: watch for config changes
                continue
            key, want = todo
            try:
                _, secs = self.warm_plan(want)
                log.info("preheat: %s ready in %.2f s",
                         [c["mode"] for c in want.values()], secs)
                self._preheated.add(key)
            except Exception as e:  # never disturb the session
                log.warning(f"preheat: {type(e).__name__}: {e}")
                # do NOT mark done on a transient blip: back off and let
                # a later pass retry. After 3 failed attempts the config
                # is treated as unwarmable so one bad mode cannot starve
                # the rest of the corpus.
                n = self._preheat_attempts.get(key, 0) + 1
                self._preheat_attempts[key] = n
                if n >= 3:
                    self._preheated.add(key)
                self._stop.wait(5.0)

    def attach_bookmarks(self, config_path=None):
        """Enable the frequency manager (misc_modules/frequency_manager):
        bookmarks persist to ``config_path`` (session file) or stay
        in-memory when None."""
        from ..utils.config import ConfigManager
        from .frequency_manager import FrequencyManager

        if config_path is None:
            import tempfile
            from pathlib import Path

            # in-memory store: auto_save=False means this path is never
            # actually written
            config_path = Path(tempfile.gettempdir()) \
                / f"sdrpp_tpu_torch_bm_{os.getpid()}.json"
            cm = ConfigManager(config_path, auto_save=False)
        else:
            cm = ConfigManager(config_path)
        self.bookmarks = FrequencyManager(cm)
        return self.bookmarks

    # ---- control plane ----

    def control(self, action: str, value=None):
        """Queue a control change; applied between blocks."""
        if action in ("set_volume", "set_muted"):
            with self.lock:
                if action == "set_volume":
                    self.volume = float(np.clip(value, 0.0, 1.0))
                else:
                    self.muted = bool(value)
            return
        if action in ("set_view", "auto_range", "set_range",
                      "set_fft_hold", "set_fft_smoothing"):
            with self.lock:
                wf = self.waterfall
                if action == "set_view":
                    wf.set_view(float(value[0]), float(value[1]))
                elif action == "auto_range":
                    wf.auto_range()
                elif action == "set_range":
                    wf.waterfall_min = float(value[0])
                    wf.waterfall_max = float(value[1])
                elif action == "set_fft_hold":
                    wf.set_fft_hold(bool(value))
                else:
                    wf.set_fft_smoothing(bool(value))
            return
        if action == "tune":
            # hardware retune (SourceManager.tune, signal_path/source.cpp)
            if hasattr(self.source, "tune"):
                self.source.tune(float(value))
                self.center_freq = float(value)
            return
        if action in ("add_bookmark", "delete_bookmark", "apply_bookmark"):
            if self.bookmarks is None:
                raise ValueError("bookmarks not enabled")
            if action == "add_bookmark":
                if not isinstance(value, dict) or not value.get("name"):
                    raise ValueError("add_bookmark needs {name, ...}")
                with self.lock:
                    sel = self.vfos[self.selected]
                    bw = self._effective_bandwidth(self.selected)
                self.bookmarks.add(
                    str(value["name"]),
                    float(value.get("frequency", sel["offset"])),
                    float(value.get("bandwidth", bw)),
                    str(value.get("mode", sel["mode"])))
                return
            bm = self.bookmarks.get(str(value))
            if action == "delete_bookmark":
                self.bookmarks.remove(str(value))
                return
            if bm is None:
                raise ValueError(f"unknown bookmark {value!r}")
            # apply: retune the SELECTED vfo (the reference's double-click)
            self.control("set_mode", bm.mode)
            self.control("set_bandwidth", bm.bandwidth)
            self.control("set_offset", bm.frequency)
            return
        valid = {"set_offset", "set_mode", "set_bandwidth", "set_squelch",
                 "set_deemphasis", "set_rds", "add_vfo", "delete_vfo",
                 "select_vfo", "scan_start", "scan_stop"}
        if action not in valid:
            raise ValueError(f"unknown action {action!r}")
        if action == "set_mode" and value not in ALL_MODES:
            raise ValueError(f"unknown mode {value!r}")
        if action == "set_deemphasis" and value not in (None, "", "22us",
                                                        "50us", "75us"):
            raise ValueError(f"unknown deemphasis {value!r}")
        if action in ("set_offset", "set_bandwidth", "set_squelch"):
            if value is not None:
                value = float(value)  # reject garbage NOW, not in the
                #                       engine thread (a bad value there
                #                       would kill every VFO's stream)
            if value is None and action == "set_offset":
                raise ValueError("set_offset needs a number")
        if action == "scan_start":
            if not isinstance(value, dict):
                raise ValueError("scan_start needs {start, stop, interval, "
                                 "level?}")
            value = dict(start=float(value["start"]),
                         stop=float(value["stop"]),
                         interval=float(value["interval"]),
                         level=float(value.get("level", -50.0)))
            if value["stop"] <= value["start"] or value["interval"] <= 0:
                raise ValueError("need stop > start and interval > 0")
        if action in ("add_vfo", "delete_vfo", "select_vfo"):
            # validate against the EFFECTIVE vfo set (current state with
            # the queued add/delete controls applied): controls apply at
            # the next block boundary, so an add immediately followed by
            # a delete/select of the same name must validate in request
            # order, not against the stale pre-queue state
            with self.lock:
                effective = set(self.vfos)
                for qa, qv in self._controls:
                    if qa == "add_vfo":
                        effective.add(qv["name"])
                    elif qa == "delete_vfo" and len(effective) > 1:
                        effective.discard(qv)
        if action == "add_vfo":
            if not isinstance(value, dict) or not value.get("name"):
                raise ValueError("add_vfo needs {name, mode?, offset?}")
            if value.get("mode", "nfm") not in ALL_MODES:
                raise ValueError(f"unknown mode {value.get('mode')!r}")
            if value["name"] in effective:
                raise ValueError(f"vfo {value['name']!r} already exists")
            value = dict(value, offset=float(value.get("offset", 0.0)),
                         bandwidth=(None if value.get("bandwidth") is None
                                    else float(value["bandwidth"])),
                         squelch=(None if value.get("squelch") is None
                                  else float(value["squelch"])))
        if action in ("delete_vfo", "select_vfo"):
            if value not in effective:
                raise ValueError(f"unknown vfo {value!r}")
            if action == "delete_vfo" and len(effective) == 1:
                raise ValueError("cannot delete the last vfo")
        # select_vfo queues with the rest so 'tune then switch vfo' applies
        # in request order at the next block boundary
        with self.lock:
            self._controls.append((action, value))
            # a new structural control supersedes a sticky rebuild-failure
            # error: the client has had its chance to observe it
            self._error_sticky = False

    def _apply_controls(self):
        with self.lock:
            pending, self._controls = self._controls, []
            if not pending:
                return
            # mutations happen UNDER the lock (HTTP threads read
            # vfos/selected in snapshot()); only _build stays outside,
            # and by then the dicts are consistent and this engine
            # thread is the sole writer.
            retunes: dict[str, float] = {}
            squelch_sets: dict[str, float] = {}
            bandwidth_sets: dict[str, float] = {}
            rebuild = False
            for action, value in pending:
                cfg = self.vfos[self.selected]
                if action == "set_offset":
                    half = self.samplerate / 2.0
                    cfg["offset"] = float(np.clip(value, -half, half))
                    # dynamic VFO: a state-scalar write, NOT a rebuild
                    retunes[self.selected] = cfg["offset"]
                    continue
                if action == "set_squelch" and value is not None and \
                        self._built_cfgs.get(self.selected,
                                             {}).get("squelch") is not None:
                    # squelch KNOB: threshold lives in Squelch state
                    # (reference setLevel, squelch.h:63-66) — a scalar
                    # write; only None<->number (block on/off) rebuilds
                    cfg["squelch"] = float(value)
                    squelch_sets[self.selected] = float(value)
                    continue
                if action == "set_bandwidth":
                    chan = self._channels.get(self.selected)
                    structural = (cfg["mode"] in DIGITAL_MODES
                                  or cfg["mode"] == "raw")
                    if structural and value is not None:
                        # digital/raw bandwidth is still a chain key
                        # (a rebuild), so snap to a log grid
                        value = float(min(
                            _DIGITAL_BW_GRID,
                            key=lambda g: abs(g - float(value))))
                    if chan is not None and getattr(chan,
                                                    "dynamic_bandwidth",
                                                    False):
                        # bandwidth is runtime STATE (taps/deviation/
                        # translation in the state tree): ANY value —
                        # preset or not — is a host tap design + state
                        # write, the reference's FIR::setTaps hot-swap
                        # (fir.h:31-52). Only digital VFOs rebuild.
                        bw = chan.clamp_bandwidth(
                            float(value) if value is not None
                            else self._mode_default_bandwidth(cfg["mode"]))
                        cfg["bandwidth"] = None if value is None else bw
                        bandwidth_sets[self.selected] = bw
                        continue
                    if not structural:
                        # an analog VFO whose channel is not built yet
                        # (its add or mode switch is still with the
                        # builder): clamp to the mode's range and record
                        # it; the pending build's _adopt resync writes it
                        # into the new state, no rebuild of its own
                        from ..models.radio import (DEMOD_DEFAULTS,
                                                    clamp_bandwidth)

                        if_rate = (DEMOD_DEFAULTS[cfg["mode"]]["if_rate"]
                                   or self.audio_rate)
                        cfg["bandwidth"] = (None if value is None else
                                            clamp_bandwidth(cfg["mode"],
                                                            value, if_rate))
                        continue
                if action == "select_vfo":
                    if value in self.vfos:
                        self.selected = str(value)
                    continue
                if action == "scan_start":
                    from .scanner import Scanner

                    self._scanner = Scanner(value["start"], value["stop"],
                                            value["interval"],
                                            level_db=value["level"])
                    self._scanner.current = self.vfos[self.selected]["offset"]
                    continue
                if action == "scan_stop":
                    self._scanner = None
                    continue
                rebuild = True
                if action == "set_mode":
                    cfg["mode"] = str(value)
                    cfg["bandwidth"] = None  # back to the mode default
                elif action == "set_bandwidth":
                    cfg["bandwidth"] = value
                elif action == "set_squelch":
                    cfg["squelch"] = value
                elif action == "set_deemphasis":
                    cfg["deemphasis"] = value or None
                elif action == "set_rds":
                    cfg["rds"] = bool(value)  # RadioChannel ignores it
                    #                           outside wfm mode
                elif action == "add_vfo":
                    name = str(value["name"])
                    self.vfos[name] = dict(
                        mode=value.get("mode", "nfm"),
                        offset=value["offset"], bandwidth=value["bandwidth"],
                        squelch=value["squelch"], deemphasis=None,
                        rds=bool(value.get("rds")))
                    self._ensure_audio_ring(name)
                    self.selected = name
                elif action == "delete_vfo":
                    if value in self.vfos and len(self.vfos) > 1:
                        del self.vfos[value]
                        self._audio.pop(value, None)  # free the ring;
                        # open /audio.wav streams for it end (see handler)
                        if self.selected == value:
                            self.selected = next(iter(self.vfos))
            self.waterfall.select_vfo(self.vfos[self.selected]["offset"],
                                      self._effective_bandwidth(self.selected))
        if rebuild:
            # mode/add/delete (and digital bandwidth): the chain changed —
            # build it in the BACKGROUND and keep streaming the old one
            # until the new one is ready (swap at a block boundary)
            self._request_rebuild()
        if retunes or squelch_sets or bandwidth_sets:
            fe, chans = self._state
            chans = dict(chans)

            def _sync(name, key, val):
                # runtime scalars live in DEVICE state; mirror them into
                # every host-side cfg snapshot INCLUDING the revert
                # targets — a ladder revert restores the last good CHAIN
                # but must not roll the knobs back (the carried state
                # keeps the current offset/threshold, so a stale revert
                # cfg would desync the UI from the device)
                for d in (self._built_cfgs, self._last_good_vfos,
                          self._pending_good):
                    if d is not None and name in d:
                        d[name][key] = val

            for name, off in retunes.items():
                if name in self._channels:
                    chans[name] = self._channels[name].retune_state(
                        chans[name], off)
                    _sync(name, "offset", off)
            for name, lvl in squelch_sets.items():
                chan = self._channels.get(name)
                if chan is not None and getattr(chan, "squelch",
                                                None) is not None:
                    chans[name] = chan.set_squelch_state(chans[name], lvl)
                    _sync(name, "squelch", lvl)
            for name, bw in bandwidth_sets.items():
                chan = self._channels.get(name)
                if chan is not None and getattr(chan, "dynamic_bandwidth",
                                                False):
                    chans[name] = chan.set_bandwidth_state(chans[name], bw)
                    _sync(name, "bandwidth", self.vfos[name]["bandwidth"])
            self._state = (fe, chans)

    # ---- data plane ----

    def _revert_vfos(self, cfgs):
        """Restore ``self.vfos`` to ``cfgs`` (a revert target) and
        rebuild synchronously. Runs in the engine thread."""
        with self.lock:
            self.vfos = {k: dict(v) for k, v in cfgs.items()}
            if self.selected not in self.vfos:
                self.selected = next(iter(self.vfos))
            self._controls.clear()
        self._build()

    def _device_poisoned(self) -> bool:
        """True when the engine's device can no longer run anything
        (``utils.watchdog.device_poisoned``: on CUDA a tiny launch and a
        synchronize; any other device: never)."""
        from ..utils.watchdog import device_poisoned

        return device_poisoned(self.device)

    def _fatal_exit(self):
        """The supervised rung-4 exit: the registered pre-exit hook (the
        session save) first, best effort, then BACKEND_FATAL_EXIT."""
        if self.pre_exit is not None:
            try:
                self.pre_exit()
            except Exception as e:
                log.error(f"engine: pre-exit save failed: "
                          f"{type(e).__name__}: {e}")
        log.error("engine: exiting for supervisor restart "
                  f"(code {BACKEND_FATAL_EXIT})")
        os._exit(BACKEND_FATAL_EXIT)

    def _run(self):
        t_start = time.monotonic()
        sent = 0.0
        consecutive = 0
        while not self._stop.is_set():
            try:
                self._apply_controls()
                with self.lock:
                    plan, self._ready_plan = self._ready_plan, None
                if plan is not None and "failed" not in plan:
                    # staleness guard: a ladder revert or rapid config
                    # churn may have changed the target since this plan
                    # was built — adopt only if it still matches (the
                    # builder owns delivering the newest want)
                    with self.lock:
                        fresh = ({n: self._graph_cfg(c) for n, c in
                                  plan["cfgs"].items()}
                                 == {n: self._graph_cfg(c) for n, c in
                                     self.vfos.items()})
                    if not fresh:
                        plan = None
                if plan is not None:
                    if "failed" in plan:
                        # the requested config cannot be built: count it
                        # and revert to the last-good config — falling
                        # back to the currently-RUNNING config when no
                        # step has been promoted yet (the engine itself
                        # never ran the bad chain, so what it streams is
                        # a valid revert target)
                        self.failures += 1
                        self.error = plan["failed"]
                        self._error_sticky = True
                        log.error(f"engine: rebuild failed: {self.error}")
                        self._revert_vfos(self._last_good_vfos
                                          or self._built_cfgs)
                    else:
                        self._adopt(plan)
                iq = self.source.read(self._block)
                if len(iq) < self._block:
                    break
                x = torch.from_numpy(np.ascontiguousarray(
                    iq, np.complex64)).to(self.device)
                self._state, (audio, fft) = self._step(self._state, x)
                if self._compile_pending:
                    self._compile_pending = False
                    log.info(
                        "set-mode/rebuild ready in %.2f s (modes=%s)",
                        time.monotonic() - self._build_t0,
                        [c["mode"] for c in self._built_cfgs.values()])
                outs = {}
                for name, a in audio.items():
                    if name in self._digital:
                        # (symbols [max_syms] complex64, valid mask);
                        # no audio for digital modes
                        syms, valid = a
                        self._write_constellation(
                            name, syms[valid].cpu().numpy())
                        continue
                    out = (a[0] if isinstance(a, tuple) else a).float()
                    out = out.cpu().numpy()
                    if out.ndim == 1:
                        out = np.stack([out, out], -1)
                    outs[name] = out
                    if isinstance(a, tuple) and name in self._rds:
                        # a[1] = 5 kHz RDS baseband, on the device
                        self._rds[name].process(a[1])
                fft = fft.cpu().numpy()
                consecutive = 0
                if self.fatal:  # a clean step disproves the diagnosis
                    self.fatal = False
                    self._error_sticky = False
                # a clean step means the stream is healthy again: clear
                # the surfaced error (failures stays as the history) —
                # EXCEPT rebuild-failure errors, which stay visible
                # until the next control arrives
                if not self._error_sticky:
                    self.error = None
                if self._pending_good is not None:
                    # the rebuilt/reconfigured chain survived a full
                    # step: promote it to last-known-good
                    self._last_good_vfos = self._pending_good
                    self._pending_good = None
            except Exception as e:
                # Resilience (reference: the render/DSP loop never dies,
                # main_window.cpp:258-709): a failed block or a bad mode
                # switch must degrade gracefully, not kill every VFO.
                # Ladder: retry -> rebuild on fresh state -> revert to
                # last-good config -> keep retrying with backoff. Never
                # break on failure.
                consecutive += 1
                self.failures += 1
                if not self.fatal:
                    # once fatal is declared, the advisory error (naming
                    # --supervise as the recovery) must survive later
                    # backoff-cycle failures
                    self.error = f"{type(e).__name__}: {e}"
                    self._error_sticky = False  # step errors clear on
                    #                             recovery
                log.error(f"engine (failure {consecutive}): "
                          f"{type(e).__name__}: {e}")
                if self._stop.is_set():
                    break
                try:
                    if consecutive == 2:
                        # Drop the carried device state BEFORE the
                        # rebuild: with an unchanged config, _adopt would
                        # faithfully carry a POISONED state tree into the
                        # new chain and the failure would loop forever.
                        # Fresh init states lose nothing: runtime knobs
                        # (offset/squelch/bandwidth) live in self.vfos
                        # and are re-applied by the channel
                        # constructors/resync in _adopt.
                        log.warning("engine: rebuilding the chain "
                                    "(fresh state)")
                        self._state = None
                        self._build()
                    elif consecutive == 3 and self._last_good_vfos \
                            is not None:
                        log.warning("engine: reverting to last-good VFO "
                                    "config")
                        self._state = None
                        self._revert_vfos(self._last_good_vfos)
                except Exception as e2:  # rebuild itself failed: backoff
                    if not self.fatal:
                        self.error = f"{type(e2).__name__}: {e2}"
                        self._error_sticky = True
                    log.error(f"engine: rebuild failed: "
                              f"{type(e2).__name__}: {e2}")
                if consecutive >= 5 and not self.fatal \
                        and self._device_poisoned():
                    # Rung 4: the whole ladder (retry, fresh-state
                    # rebuild, last-good revert, one grace pass) failed
                    # on the SAME streak AND the device itself fails a
                    # tiny launch — the poisoned-context signature (a
                    # device-side fault on CUDA lasts until the process
                    # exits). Hand recovery to the process level: under
                    # `cli ui --supervise` the supervisor restarts us
                    # (session saved first, restored from --config);
                    # standalone, the HTTP surface stays alive serving
                    # state/history with a sticky fatal error. Any other
                    # streak stays in the backoff loop.
                    self.fatal = True
                    self.error = ("device unrecoverable after full "
                                  f"ladder ({self.error}); process "
                                  "restart required — run `cli ui "
                                  "--supervise` for automatic recovery")
                    self._error_sticky = True
                    log.error(f"engine FATAL: {self.error}")
                    if os.environ.get("SDRPP_TPU_SUPERVISED"):
                        self._fatal_exit()
                # interruptible: a fatal engine parked on its 30 s
                # backoff must still stop() promptly
                self._stop.wait(30.0 if self.fatal
                                else min(0.5 * consecutive, 5.0))
                t_start = time.monotonic() - sent  # resync realtime clock
                continue
            with self.lock:
                vol = 0.0 if self.muted else self.volume ** 2  # sink.cpp gain
            pcms = {name: np.clip(out * (vol * 32767.0), -32768,
                                  32767).astype(np.int16)
                    for name, out in outs.items()}
            with self.lock:
                for line in fft:
                    self.waterfall.push_fft(line)
                self._wf_total += len(fft)
                for name, pcm in pcms.items():
                    self._write_audio(name, pcm)
                self.blocks += 1
                self.samples += self._block
            if self._scanner is not None and len(fft):
                # the reference scanner's 10 Hz tick, driven per block:
                # latest raw FFT line, offset-domain frequencies
                with self.lock:
                    bw = self._effective_bandwidth(self.selected)
                    cur = self.vfos[self.selected]["offset"]
                sc = self._scanner
                sc.current = cur
                target = sc.step(fft[-1], bw, 0.0, self.samplerate,
                                 time.monotonic())
                if target != cur:
                    self.control("set_offset", target)
            if self.realtime:
                sent += self._block / self.samplerate
                lag = sent - (time.monotonic() - t_start)
                if lag > 0.0:
                    time.sleep(lag)
                elif lag < -2.0:  # fell behind (a build hitch): resync
                    t_start = time.monotonic() - sent

    def _write_audio(self, name: str, pcm: np.ndarray):
        st = self._audio.get(name)
        if st is None:  # vfo added this block; ring created in apply
            return
        ring = st["ring"]
        n = len(pcm)
        if n >= len(ring):
            pcm = pcm[-len(ring):]
            n = len(pcm)
        pos = st["written"] % len(ring)
        first = min(n, len(ring) - pos)
        ring[pos:pos + first] = pcm[:first]
        ring[:n - first] = pcm[first:]
        st["written"] += n
        self._audio_event.notify_all()

    def _write_constellation(self, name: str, syms: np.ndarray):
        with self.lock:
            st = self._const.setdefault(
                name, {"ring": np.zeros(CONSTELLATION_RING, np.complex64),
                       "written": 0})
            ring = st["ring"]
            n = len(syms)
            if n >= len(ring):
                syms = syms[-len(ring):]
                n = len(syms)
            pos = st["written"] % len(ring)
            first = min(n, len(ring) - pos)
            ring[pos:pos + first] = syms[:first]
            ring[:n - first] = syms[first:]
            st["written"] += n

    def read_constellation(self, name: str, max_points: int = 1024):
        """Latest demodulated symbols of a digital VFO (complex64, newest
        last) — the constellation_diagram data plane."""
        with self.lock:
            st = self._const.get(name)
            if st is None:
                return np.zeros(0, np.complex64)
            ring, end = st["ring"], st["written"]
            n = min(end, len(ring), max_points)
            if end <= len(ring):
                out = ring[end - n:end]
            else:
                pos = end % len(ring)
                idx = (pos - n) % len(ring)
                out = ring[idx:pos] if idx < pos else \
                    np.concatenate([ring[idx:], ring[:pos]])
            return out.copy()

    def audio_written(self, name: str) -> int:
        with self.lock:
            st = self._audio.get(name)
            return st["written"] if st else 0

    def read_audio(self, name: str, cursor: int, max_frames: int = 48000,
                   timeout: float = 1.0) -> tuple[np.ndarray, int]:
        """Read stereo i16 frames from ``name``'s ring starting at
        ``cursor`` (a frame counter); blocks until data or timeout.
        Lagging cursors skip forward. Returns (frames, new_cursor)."""
        with self._audio_event:
            st = self._audio.get(name)
            if st is None:
                return np.zeros((0, 2), np.int16), cursor
            if cursor >= st["written"]:
                self._audio_event.wait(timeout)
                st = self._audio.get(name)
                if st is None:
                    return np.zeros((0, 2), np.int16), cursor
            ring = st["ring"]
            end = st["written"]
            cursor = max(cursor, end - len(ring))
            n = min(end - cursor, max_frames)
            if n <= 0:
                return np.zeros((0, 2), np.int16), cursor
            pos = cursor % len(ring)
            first = min(n, len(ring) - pos)
            out = np.concatenate([ring[pos:pos + first], ring[:n - first]])
            return out, cursor + n

    def read_fft(self):
        with self.lock:
            wf = self.waterfall
            return (wf.latest_fft.copy(),
                    wf.latest_fft_hold.copy() if wf.fft_hold else None,
                    wf.fft_lines)

    def read_waterfall_rows(self, since: int, max_rows: int = 256):
        """Framebuffer rows newer than line-counter ``since`` (newest
        first, matching the scrolling framebuffer). Returns
        (rows_abgr_u32, monotonic_line_counter)."""
        with self.lock:
            wf = self.waterfall
            rows = min(max(self._wf_total - since, 0), wf.waterfall_height,
                       max_rows)
            return wf.framebuffer[:rows].copy(), self._wf_total

    def _rds_snapshot(self, name: str):
        rx = self._rds.get(name)
        if rx is None:
            return None
        d = rx.decoder
        return {
            "pi": f"{d.pi_code:04X}" if d.pi_code is not None else None,
            "ps_name": d.ps_name.strip() or None,
            "radio_text": d.radio_text_str.strip() or None,
            "callsign": d.callsign,
            "program_type": d.program_type,
            "groups": d.groups_decoded,
        }

    def snapshot(self) -> dict:
        with self.lock:
            wf = self.waterfall
            sel = self.vfos[self.selected]
            return {
                "samplerate": self.samplerate,
                "center_freq": self.center_freq,
                "audio_rate": self.audio_rate,
                "selected": self.selected,
                "vfos": {name: {**cfg,
                                "bandwidth": self._effective_bandwidth(name),
                                "rds_data": self._rds_snapshot(name)}
                         for name, cfg in self.vfos.items()},
                "mode": sel["mode"],
                "offset": sel["offset"],
                "bandwidth": self._effective_bandwidth(self.selected),
                "squelch": sel["squelch"],
                "deemphasis": sel["deemphasis"],
                "volume": self.volume,
                "muted": self.muted,
                "modes": ALL_MODES,
                "fft_size": self.fft_size,
                "waterfall_width": wf.data_width,
                "waterfall_min": wf.waterfall_min,
                "waterfall_max": wf.waterfall_max,
                "view_offset": wf.view_offset,
                "view_bandwidth": wf.view_bandwidth,
                "vfo_level": wf.vfo_level,
                "vfo_snr": wf.vfo_snr,
                "scanning": self._scanner is not None,
                "scan_receiving": bool(self._scanner.receiving
                                       if self._scanner else False),
                "blocks": self.blocks,
                "samples": self.samples,
                "running": self._thread is not None
                           and self._thread.is_alive(),
                "error": self.error,
                "failures": self.failures,
                "fatal": self.fatal,
                # a reconfig is pending or building in the background;
                # the stream keeps running on the previous chain until
                # the new one is adopted. True through EVERY stage of
                # the pipeline: queued controls -> requested cfgs ->
                # builder working -> plan ready -> adopted (running
                # chain finally matches the requested config).
                "switching": (bool(self._controls)
                              or self._want_cfgs is not None
                              or self._ready_plan is not None
                              or (self._builder is not None
                                  and self._builder.is_alive())
                              or {n: self._graph_cfg(c) for n, c in
                                  self._built_cfgs.items()}
                              != {n: self._graph_cfg(c) for n, c in
                                  self.vfos.items()}),
            }

    # ---- lifecycle ----

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="webui-engine")
        self._thread.start()
        if self.background_preheat:
            self._preheater = threading.Thread(
                target=self._preheater_run, daemon=True,
                name="webui-preheater")
            self._preheater.start()

    def stop(self):
        self._stop.set()
        with self.lock:
            self._want_cfgs = None  # builder drains after current plan
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if self._builder is not None:
            # a daemon builder killed mid-step at interpreter exit could
            # leave the device mid-launch; give it a moment
            self._builder.join(timeout=15.0)
        if self._preheater is not None:
            self._preheater.join(timeout=15.0)
        with self._audio_event:
            self._audio_event.notify_all()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "sdrpp_tpu_torch"

    # silence default stderr access log
    def log_message(self, fmt, *args):
        pass

    @property
    def engine(self) -> ReceiverEngine:
        return self.server.engine  # type: ignore[attr-defined]

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _bytes(self, body: bytes, ctype="application/octet-stream",
               headers=()):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        try:
            if url.path in ("/", "/index.html"):
                self._bytes(HTML_PAGE.encode(), "text/html; charset=utf-8")
            elif url.path == "/api/state":
                self._json(self.engine.snapshot())
            elif url.path == "/api/bookmarks":
                bms = self.engine.bookmarks
                self._json({"enabled": bms is not None,
                            "list": bms.selected_list if bms else None,
                            "lists": bms.lists() if bms else [],
                            "bookmarks": ({k: dict(v) for k, v in
                                           bms.bookmarks().items()}
                                          if bms else {})})
            elif url.path == "/api/fft":
                self._get_fft()
            elif url.path == "/api/waterfall":
                self._get_waterfall(url)
            elif url.path == "/api/constellation":
                self._get_constellation(url)
            elif url.path == "/audio.wav":
                self._stream_audio(url)
            else:
                self._json({"error": "not found"}, 404)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _get_fft(self):
        line, hold, lines = self.engine.read_fft()
        body = line.astype("<f4").tobytes()
        hdrs = [("X-Lines", lines)]
        if hold is not None:
            body += hold.astype("<f4").tobytes()
            hdrs.append(("X-Hold", 1))
        self._bytes(body, headers=hdrs)

    def _get_waterfall(self, url):
        qs = parse_qs(url.query)
        try:
            since = int(qs.get("since", ["0"])[0])
        except ValueError:
            self._json({"error": "bad 'since' parameter"}, 400)
            return
        buf, counter = self.engine.read_waterfall_rows(since)
        self._bytes(buf.astype("<u4").tobytes(),
                    headers=[("X-Line", counter), ("X-Rows", len(buf)),
                             ("X-Width", self.engine.waterfall.data_width)])

    def _get_constellation(self, url):
        """Latest symbols of a digital VFO as interleaved int8 I/Q pairs,
        the reference meteor module's s8 x84 soft-symbol convention
        (decoder_modules/meteor_demodulator/src/main.cpp:268-276)."""
        eng = self.engine
        qs = parse_qs(url.query)
        vfo = qs.get("vfo", [eng.selected])[0]
        if vfo not in eng.vfos:
            self._json({"error": f"unknown vfo {vfo!r}"}, 404)
            return
        try:
            n = int(qs.get("n", ["1024"])[0])
        except ValueError:
            self._json({"error": "bad 'n' parameter"}, 400)
            return
        syms = eng.read_constellation(vfo, max_points=max(1, min(n, 4096)))
        iq = np.empty(2 * len(syms), np.int8)
        iq[0::2] = np.clip(syms.real * 84.0, -127, 127).astype(np.int8)
        iq[1::2] = np.clip(syms.imag * 84.0, -127, 127).astype(np.int8)
        self._bytes(iq.tobytes(), headers=[("X-Count", len(syms))])

    def _stream_audio(self, url):
        eng = self.engine
        qs = parse_qs(url.query)
        vfo = qs.get("vfo", [eng.selected])[0]
        if vfo not in eng.vfos:
            self._json({"error": f"unknown vfo {vfo!r}"}, 404)
            return
        rate = int(eng.audio_rate)
        # progressive WAV: RIFF/data sizes set to the 4 GB max so players
        # treat it as a live stream (the wavreader in the reference
        # tolerates broken sizes the same way, wavreader.h)
        hdr = b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
        hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, rate, rate * 4,
                                     4, 16)
        hdr += b"data" + struct.pack("<I", 0xFFFFFFFF)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Cache-Control", "no-store")
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(hdr)
        cursor = max(0, eng.audio_written(vfo) - rate // 4)
        while not eng._stop.is_set() and vfo in eng.vfos:
            frames, cursor = eng.read_audio(vfo, cursor)
            if len(frames):
                self.wfile.write(frames.astype("<i2").tobytes())
                self.wfile.flush()
        # vfo deleted (its ring is freed) or engine stopped: end the stream

    def do_POST(self):
        url = urlparse(self.path)
        if url.path != "/api/control":
            self._json({"error": "not found"}, 404)
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n) or b"{}")
            self.engine.control(req["action"], req.get("value"))
            self._json({"ok": True})
        except (KeyError, ValueError, TypeError) as e:
            self._json({"error": str(e)}, 400)


class WebUIServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, engine: ReceiverEngine, addr="127.0.0.1", port=0):
        self.engine = engine
        super().__init__((addr, port), _Handler)


def load_session(engine: ReceiverEngine, config_path) -> None:
    """Restore a saved UI session (VFOs/volume/range) into the engine —
    the reference's per-module ConfigManager persistence role."""
    from ..utils.config import ConfigManager

    cm = ConfigManager(config_path, auto_save=False)
    vfos = cm.get("vfos")
    if isinstance(vfos, dict) and vfos:
        clean = {}
        for name, cfg in vfos.items():
            # ALL_MODES, not MODES: digital (meteor) VFOs are saved by
            # save_session and must survive a restart too
            if cfg.get("mode") in ALL_MODES:
                clean[name] = dict(
                    mode=cfg["mode"], offset=float(cfg.get("offset", 0.0)),
                    bandwidth=cfg.get("bandwidth"),
                    squelch=cfg.get("squelch"),
                    deemphasis=cfg.get("deemphasis"),
                    rds=bool(cfg.get("rds")))
        if clean:
            with engine.lock:
                engine.vfos = clean
                engine.selected = (cm.get("selected")
                                   if cm.get("selected") in clean
                                   else next(iter(clean)))
                for name in clean:
                    engine._ensure_audio_ring(name)
                engine.volume = float(cm.get("volume", default=1.0))
                wf = engine.waterfall
                wf.waterfall_min = float(cm.get("waterfall_min",
                                                default=wf.waterfall_min))
                wf.waterfall_max = float(cm.get("waterfall_max",
                                                default=wf.waterfall_max))
            engine._build()


def save_session(engine: ReceiverEngine, config_path) -> None:
    from ..utils.config import ConfigManager

    cm = ConfigManager(config_path, auto_save=False)
    snap = engine.snapshot()
    with engine.lock:
        vfos = {name: {k: v for k, v in cfg.items()}
                for name, cfg in engine.vfos.items()}
    cm.set("vfos", vfos)
    cm.set("selected", snap["selected"])
    cm.set("volume", snap["volume"])
    cm.set("waterfall_min", snap["waterfall_min"])
    cm.set("waterfall_max", snap["waterfall_max"])
    cm.save()


def serve_ui(engine: ReceiverEngine, addr="127.0.0.1", port=8080,
             forever=True, config_path=None):
    """Serve ``engine`` on http://addr:port/ and start it. With
    ``config_path`` the session is restored from it first, saved to it
    when the server stops, and saved before a supervised fatal exit
    (``engine.pre_exit``)."""
    if config_path is not None:
        load_session(engine, config_path)
        engine.pre_exit = lambda: save_session(engine, config_path)
    engine.attach_bookmarks(config_path)
    srv = WebUIServer(engine, addr, port)
    engine.start()
    log.info(f"web panadapter on http://{addr}:{srv.server_address[1]}/")
    if forever:
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            engine.stop()
            srv.server_close()
            if config_path is not None:
                save_session(engine, config_path)
                log.info(f"session saved -> {config_path}")
    return srv


HTML_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>sdrpp_tpu</title><style>
body{background:#101014;color:#ddd;font:13px system-ui,sans-serif;margin:0}
#bar{display:flex;gap:10px;align-items:center;padding:6px 10px;background:#18181e;flex-wrap:wrap}
#bar label{color:#9aa}
select,input,button{background:#24242c;color:#ddd;border:1px solid #444;border-radius:4px;padding:3px 6px}
button{cursor:pointer} canvas{display:block;width:100%}
#freq{font-size:18px;color:#7ec8ff;font-variant-numeric:tabular-nums}
#meter{color:#8f8}
</style></head><body>
<div id="bar">
 <span id="freq">--</span>
 <label>vfo <select id="vfo"></select></label>
 <button id="addvfo">+</button><button id="delvfo">&#x2212;</button>
 <label>mode <select id="mode"></select></label>
 <label>BW <input id="bw" type="number" style="width:90px" step="1000"></label>
 <label>de-emph <select id="deemph"><option value="">off</option>
  <option>22us</option><option>50us</option><option>75us</option></select></label>
 <label>squelch <input id="sq" type="range" min="-100" max="0" value="-100" style="width:110px"></label>
 <label>vol <input id="vol" type="range" min="0" max="100" value="100" style="width:90px"></label>
 <button id="audio">&#9654; audio</button>
 <button id="auto">auto range</button>
 <button id="scan" title="sweep the visible span, stop on signals above the squelch level">scan</button>
 <label><input id="hold" type="checkbox"> hold</label>
 <label><input id="rds" type="checkbox"> RDS</label>
 <label>bm <select id="bmsel"><option value="">—</option></select></label>
 <button id="bmadd" title="bookmark the selected VFO">&#9733;</button>
 <button id="bmdel" title="delete bookmark">&#x2717;</button>
 <span id="meter">SNR -- dB</span>
 <span id="rdsinfo" style="color:#fc6"></span>
 <span id="switching" style="color:#fc6"></span>
 <span id="err" style="color:#f66"></span>
</div>
<canvas id="spec" height="220"></canvas>
<canvas id="wf" height="512"></canvas>
<canvas id="constel" width="220" height="220" style="display:none;position:fixed;right:10px;top:48px;width:220px;border:1px solid #345;background:rgba(10,10,16,0.9)"></canvas>
<script>
const $=id=>document.getElementById(id);
let st=null, wfLine=0, wfImg=null;
async function getState(){st=await (await fetch('/api/state')).json();
 $('freq').textContent=((st.center_freq+st.offset)/1e6).toFixed(6)+' MHz';
 if(!$('mode').options.length) st.modes.forEach(m=>{const o=document.createElement('option');o.value=o.textContent=m;$('mode').append(o);});
 const names=Object.keys(st.vfos),vsel=$('vfo');
 if([...vsel.options].map(o=>o.value).join()!==names.join()){
  vsel.innerHTML='';names.forEach(n=>{const o=document.createElement('option');o.value=o.textContent=n;vsel.append(o);});}
 if(document.activeElement!==vsel) vsel.value=st.selected;
 if(document.activeElement!==$('mode')) $('mode').value=st.mode;
 if(document.activeElement!==$('bw')) $('bw').value=st.bandwidth;
 if(document.activeElement!==$('deemph')) $('deemph').value=st.deemphasis||'';
 $('meter').textContent='SNR '+st.vfo_snr.toFixed(1)+' dB  L '+st.vfo_level.toFixed(1)+' dBFS';
 const sel=st.vfos[st.selected]||{};
 if(document.activeElement!==$('rds')) $('rds').checked=!!sel.rds;
 const rd=sel.rds_data;
 $('rdsinfo').textContent=rd?('RDS '+[rd.pi?('PI '+rd.pi):null,rd.ps_name,
  rd.callsign,rd.radio_text].filter(Boolean).join(' | ')):'';
 $('scan').textContent=st.scanning?(st.scan_receiving?'⏹ receiving':'⏹ scanning'):'scan';
 $('err').textContent=st.error||'';
 $('switching').textContent=st.switching?'\u23f3 switching\u2026':'';}
async function ctl(action,value){await fetch('/api/control',{method:'POST',body:JSON.stringify({action,value})});getState();}
const spec=$('spec'),wf=$('wf');
function resize(){spec.width=wf.width=document.body.clientWidth;}
window.addEventListener('resize',resize);resize();
async function drawSpec(){if(!st)return;
 const r=await fetch('/api/fft'),buf=await r.arrayBuffer();
 const hold=r.headers.get('X-Hold');let a=new Float32Array(buf);
 let h=null; if(hold){h=a.subarray(a.length/2);a=a.subarray(0,a.length/2);}
 const g=spec.getContext('2d'),W=spec.width,H=spec.height;
 g.fillStyle='#0a0a10';g.fillRect(0,0,W,H);
 const lo=st.waterfall_min,hi=st.waterfall_max,y=v=>H-(Math.min(Math.max(v,lo),hi)-lo)/(hi-lo)*H;
 g.strokeStyle='#223';g.beginPath();for(let d=Math.ceil(lo/10)*10;d<hi;d+=10){g.moveTo(0,y(d));g.lineTo(W,y(d));}g.stroke();
 g.strokeStyle='#4af';g.beginPath();for(let i=0;i<a.length;i++){const x=i/a.length*W;i?g.lineTo(x,y(a[i])):g.moveTo(x,y(a[i]));}g.stroke();
 if(h){g.strokeStyle='#fa4';g.beginPath();for(let i=1;i<h.length;i++){const x=i/h.length*W;i>1?g.lineTo(x,y(h[i])):g.moveTo(x,y(h[i]));}g.stroke();}
 for(const [name,cfg] of Object.entries(st.vfos)){
  const vx=((cfg.offset-st.view_offset)/st.view_bandwidth+0.5)*W,vw=cfg.bandwidth/st.view_bandwidth*W;
  const sel=name===st.selected;
  g.fillStyle=sel?'rgba(120,200,255,0.15)':'rgba(160,160,160,0.10)';g.fillRect(vx-vw/2,0,vw,H);
  g.strokeStyle=sel?'#7ec8ff':'#888';g.beginPath();g.moveTo(vx,0);g.lineTo(vx,H);g.stroke();
  g.fillStyle=sel?'#7ec8ff':'#888';g.fillText(name,vx+3,12);}
 drawBookmarks(g,W,H);}
async function drawWf(){if(!st)return;
 const r=await fetch('/api/waterfall?since='+wfLine),buf=await r.arrayBuffer();
 const rows=+r.headers.get('X-Rows'),width=+r.headers.get('X-Width');wfLine=+r.headers.get('X-Line');
 if(!rows)return;const g=wf.getContext('2d');
 if(!wfImg||wfImg.width!==width){wfImg=new ImageData(width,1);}
 g.drawImage(wf,0,0,wf.width,wf.height-rows,0,rows,wf.width,wf.height-rows);
 const px=new Uint8ClampedArray(buf);
 const tmp=document.createElement('canvas');tmp.width=width;tmp.height=rows;
 tmp.getContext('2d').putImageData(new ImageData(px,width,rows),0,0);
 g.drawImage(tmp,0,0,width,rows,0,0,wf.width,rows);}
spec.addEventListener('click',e=>{if(!st)return;
 const f=st.view_offset+(e.offsetX/spec.clientWidth-0.5)*st.view_bandwidth;
 ctl('set_offset',Math.round(f));});
function zoom(e,el){if(!st)return;e.preventDefault();
 const cf=st.view_offset+(e.offsetX/el.clientWidth-0.5)*st.view_bandwidth;
 const bw=Math.min(st.samplerate,Math.max(st.samplerate/256,
  st.view_bandwidth*(e.deltaY>0?1.5:1/1.5)));
 let off=cf-(e.offsetX/el.clientWidth-0.5)*bw;
 off=Math.max(-(st.samplerate-bw)/2,Math.min((st.samplerate-bw)/2,off));
 ctl('set_view',[off,bw]);}
spec.addEventListener('wheel',e=>zoom(e,spec),{passive:false});
wf.addEventListener('wheel',e=>zoom(e,wf),{passive:false});
const unzoom=()=>{if(st)ctl('set_view',[0,st.samplerate]);};
spec.addEventListener('dblclick',unzoom);
wf.addEventListener('dblclick',unzoom);
$('freq').style.cursor='pointer';
$('freq').title='click to type a frequency';
$('freq').addEventListener('click',()=>{if(!st)return;
 const v=prompt('frequency (MHz)',((st.center_freq+st.offset)/1e6).toFixed(6));
 if(v===null)return;const f=parseFloat(v)*1e6;if(!isFinite(f))return;
 const off=f-st.center_freq;
 if(Math.abs(off)<=st.samplerate/2) ctl('set_offset',Math.round(off));
 else ctl('tune',Math.round(f-st.offset));});
wf.addEventListener('click',e=>{if(!st)return;
 const f=st.view_offset+(e.offsetX/wf.clientWidth-0.5)*st.view_bandwidth;
 ctl('set_offset',Math.round(f));});
$('vfo').addEventListener('change',()=>ctl('select_vfo',$('vfo').value));
$('addvfo').addEventListener('click',()=>{const n=prompt('new VFO name','vfo'+Object.keys(st.vfos).length);
 if(n)ctl('add_vfo',{name:n,mode:st.mode,offset:st.view_offset});});
$('delvfo').addEventListener('click',()=>ctl('delete_vfo',st.selected));
$('mode').addEventListener('change',()=>ctl('set_mode',$('mode').value));
$('bw').addEventListener('change',()=>ctl('set_bandwidth',+$('bw').value));
$('sq').addEventListener('change',()=>ctl('set_squelch',+$('sq').value<=-100?null:+$('sq').value));
$('vol').addEventListener('input',()=>ctl('set_volume',+$('vol').value/100));
$('auto').addEventListener('click',()=>ctl('auto_range'));
$('scan').addEventListener('click',()=>{if(!st)return;
 if(st.scanning){ctl('scan_stop');$('scan').textContent='scan';return;}
 const lo=st.view_offset-st.view_bandwidth/2,hi=st.view_offset+st.view_bandwidth/2;
 ctl('scan_start',{start:lo,stop:hi,interval:st.bandwidth,
  level:st.squelch!=null?st.squelch:-50});
 $('scan').textContent='⏹ scanning';});
$('hold').addEventListener('change',()=>ctl('set_fft_hold',$('hold').checked));
$('rds').addEventListener('change',()=>ctl('set_rds',$('rds').checked));
$('deemph').addEventListener('change',()=>ctl('set_deemphasis',$('deemph').value||null));
let player=null;
$('audio').addEventListener('click',()=>{if(player){player.pause();player=null;$('audio').textContent='\\u25b6 audio';}
 else{player=new Audio('/audio.wav?vfo='+st.selected+'&t='+Date.now());player.play();$('audio').textContent='\\u23f8 audio';}});
let bms={};
async function getBookmarks(){const r=await (await fetch('/api/bookmarks')).json();
 if(!r.enabled)return;bms=r.bookmarks;const sel=$('bmsel');const cur=sel.value;
 const names=Object.keys(bms);
 if([...sel.options].slice(1).map(o=>o.value).join()!==names.join()){
  sel.innerHTML='<option value="">—</option>';
  names.forEach(n=>{const o=document.createElement('option');o.value=o.textContent=n;sel.append(o);});
  sel.value=names.includes(cur)?cur:'';}}
$('bmsel').addEventListener('change',()=>{if($('bmsel').value)ctl('apply_bookmark',$('bmsel').value);});
$('bmadd').addEventListener('click',()=>{const n=prompt('bookmark name');
 if(n)ctl('add_bookmark',{name:n}).then(getBookmarks);});
$('bmdel').addEventListener('click',()=>{if($('bmsel').value)
 ctl('delete_bookmark',$('bmsel').value).then(getBookmarks);});
function drawBookmarks(g,W,H){if(!st)return;
 g.font='10px sans-serif';
 for(const [name,bm] of Object.entries(bms)){
  const x=((bm.frequency-st.view_offset)/st.view_bandwidth+0.5)*W;
  if(x<0||x>W)continue;
  g.strokeStyle='#fd5';g.setLineDash([2,3]);g.beginPath();g.moveTo(x,14);g.lineTo(x,H);g.stroke();g.setLineDash([]);
  g.fillStyle='#fd5';g.fillText('⚑ '+name,x+2,24);}}
const constel=$('constel');
async function drawConstel(){if(!st)return;
 const digital=st.mode==='meteor';
 constel.style.display=digital?'block':'none';
 if(!digital)return;
 const r=await fetch('/api/constellation?vfo='+st.selected+'&n=1024');
 const pts=new Int8Array(await r.arrayBuffer());
 const g=constel.getContext('2d'),W=constel.width,H=constel.height;
 g.fillStyle='rgba(10,10,16,0.9)';g.fillRect(0,0,W,H);
 g.strokeStyle='#234';g.beginPath();
 g.moveTo(W/2,0);g.lineTo(W/2,H);g.moveTo(0,H/2);g.lineTo(W,H/2);g.stroke();
 g.fillStyle='#6f6';
 for(let i=0;i+1<pts.length;i+=2){
  const x=(pts[i]/254+0.5)*W,y=(0.5-pts[i+1]/254)*H;
  g.fillRect(x-1,y-1,2,2);}
 g.fillStyle='#9aa';g.fillText('constellation',6,12);}
getState();setInterval(getState,1000);getBookmarks();setInterval(getBookmarks,3000);
setInterval(drawSpec,100);setInterval(drawWf,100);setInterval(drawConstel,250);
</script></body></html>
"""
