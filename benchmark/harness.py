"""One run of one cell: set-up, the measured window, the traced window,
the output check, and the result.

The window drives the system's entry as the program's own streaming
commands do (``cli._stream``): blocks come through the program's
``utils/pipeline.Prefetcher`` (a reader thread, a pinned ring, H2D copies
on a side stream), fed by the system's source, which hands out the
recording held in host memory; or, where the traffic's ``input`` is
``"card"``, straight from the recording resident on the card
(``traffic.CardRing``). Each block's output reaches the host one block
late through the program's ``DeferredWriter`` and goes to ``Sink``,
which stamps it and keeps the blocks the output check needs.
Blocks go back to back in a closed loop with the pipeline's own depth.
What is particular to a system (its entry, source, layers and kernel
counters) comes from its module ``systems/<system>.py``, and the check's
numbers from its reference module.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import check, stats, traffic
from benchmark.spec import Cell
from benchmark.trace import BLOCK, Trace

__all__ = ["Sink", "Span", "run_cell", "FORBIDDEN"]

FORBIDDEN = ("jax", "jaxlib", "flax", "sdrpp_tpu")
WARM_BLOCKS = 4        # set-up blocks through the whole loop before t0
TRACE_SECONDS = 3.0    # the traced run profiles this much of its window


class Sink:
    """The DeferredWriter's callback: stamps each block's arrival, keeps
    a sample of ``keep`` blocks drawn from ``rng`` among those that arrive
    inside ``window`` (reservoir sampling), drops the rest. A kept block
    is the writer's own host array, held, not copied: no copy in the
    timed loop."""

    def __init__(self, keep: int, rng: np.random.Generator):
        self.done: dict[int, float] = {}
        self.kept: dict[int, np.ndarray] = {}
        self.keep = int(keep)
        self.rng = rng
        self.window = (float("inf"), float("inf"))
        self._seen = 0
        self._sample: list[int] = []

    def __call__(self, audio: np.ndarray):
        t = time.perf_counter()
        j = len(self.done)
        self.done[j] = t
        if self.window[0] <= t <= self.window[1]:
            self._seen += 1
            if len(self._sample) < self.keep:
                self._sample.append(j)
                self.kept[j] = audio
            else:
                i = int(self.rng.integers(self._seen))
                if i < self.keep:
                    del self.kept[self._sample[i]]
                    self._sample[i] = j
                    self.kept[j] = audio


class Span:
    """A forwarding object: calls ``inner`` inside a profiler range."""

    def __init__(self, inner, name: str):
        self.inner = inner
        self.name = name

    def __call__(self, *args):
        with torch.profiler.record_function(self.name):
            return self.inner(*args)

    def __getattr__(self, item):
        return getattr(self.inner, item)


def _card(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0, "power_limit": "n/a"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=30)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "smi": smi.stdout.strip()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None, block=None,
             pool_blocks=None, check_blocks=None, log=print,
             wrap_step=None):
    """Run ``cell`` once; returns the result line's object. ``block``,
    ``pool_blocks`` and ``check_blocks`` override the traffic file (the
    tests run a small size on the CPU); ``wrap_step(entry, step)`` returns
    the step the loop calls (the tests plant faults with it). Returns
    (result, info): the result line's object, with the numbers compared
    last under ``checks``, and what the run prints on earlier lines."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    from sdrpp_tpu_torch.utils.pipeline import DeferredWriter, Prefetcher

    tr = cell.traffic
    n = int(block or tr["block"])
    keep = int(check_blocks or tr["check_blocks"])
    card = _card(device)
    log(f"cell {cell.name}: seed {seed}, {seconds} s, trace {int(trace)}, "
        f"{card['kind']} ({card.get('smi', '')})")

    system = cell.system()
    fs, offsets = system.band(cell.config)
    pool = traffic.make_recording(tr, fs, offsets, seed, device, block=n,
                                  pool_blocks=pool_blocks)
    entry = system.build(cell.config, device, n)
    layers = system.layers(entry)
    if trace:
        for rng_name, attr in layers.items():
            setattr(entry, attr, Span(getattr(entry, attr), rng_name))
    step = wrap_step(entry, entry) if wrap_step else entry
    state = system.init_state(entry)
    sink = Sink(keep, np.random.default_rng([seed, 2]))
    if tr.get("input", "host") == "card":
        pre = traffic.CardRing(torch.from_numpy(pool).to(device))
    else:
        pre = Prefetcher(system.source(pool, cell.config), n, device=device)
    writer = DeferredWriter(sink)
    ask, t_read, t_call, t_push = {}, {}, {}, {}
    out_like = []
    counters = system.counters()
    rng_ = (torch.profiler.record_function if trace
            else lambda name: contextlib.nullcontext())

    def one(j):
        with rng_(BLOCK):
            ask[j] = a = time.perf_counter()
            with rng_("pipeline.read"):
                x = pre.read(n)
            b = time.perf_counter()
            with rng_("entry"):
                nonlocal state
                state, y = step(state, x)
            out_like[:] = [y]
            c = time.perf_counter()
            with rng_("pipeline.push"):
                writer.push(y)
            t_read[j], t_call[j], t_push[j] = b - a, c - b, \
                time.perf_counter() - c

    prof = None
    tmp = tempfile.TemporaryDirectory(prefix="bench-trace-")
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        for j in range(WARM_BLOCKS):
            one(j)
        if device.type == "cuda":
            # the kept blocks hold the writer's pinned buffers: cache as
            # many more now, so that no push in the window allocates one
            spare = [torch.empty(out_like[0].shape, dtype=out_like[0].dtype,
                                 pin_memory=True) for _ in range(keep + 2)]
            del spare
        launches0 = {k: f.launches for k, f in counters.items()}
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        t1 = t0 + seconds
        sink.window = (t0, t1)
        j = WARM_BLOCKS
        t_stop = traced_last = None
        while True:
            now = time.perf_counter()
            if now >= t1:
                break
            if prof is not None and t_stop is None and \
                    now - t0 >= min(TRACE_SECONDS, seconds / 2):
                _sync(device)
                traced_last = j - 1
                t_stop = time.perf_counter()
                prof.stop()
            one(j)
            j += 1
        n_blocks = j
        launches = {k: f.launches - launches0[k]
                    for k, f in counters.items()}
        writer.flush()
        _sync(device)
        if prof is not None and t_stop is None:
            traced_last = j - 1
            prof.stop()
        pre.close()
        card["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else 0)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in FORBIDDEN)
        trace_obj = None
        if prof is not None:
            path = Path(tmp.name) / "trace.json"
            prof.export_chrome_trace(str(path))
            trace_obj = Trace.from_file(path, layers=list(layers))
            path.unlink()
    finally:
        tmp.cleanup()
    window = stats.in_window(sink.done, t0, t1)
    del entry, state, step, pre, writer
    out_like.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the output check -------------------------------------------------
    ref_mod = cell.reference()
    t_ref = time.perf_counter()
    numbers, failing = check.compare(cell, ref_mod, pool, sink.kept, n,
                                     device)
    log(f"check of blocks {sorted(sink.kept)} took "
        f"{time.perf_counter() - t_ref:.1f} s")
    missing = int(n_blocks - len(sink.done))
    numbers["blocks_missing"] = {"value": missing, "limit": 0}
    correct = all(v["value"] <= v["limit"] for v in numbers.values())

    result = {"correct": bool(correct), "attempted": len(window),
              "failed": failing + missing, "metrics": {},
              "device": {k: card[k] for k in ("platform", "kind", "count",
                                               "memory_peak_bytes")}}
    info = {"blocks_run": n_blocks, "blocks_in_window": len(window),
            "setup_s": setup_s, "jax_modules": loaded,
            "launches_per_block": {
                k: v / max(1, n_blocks - WARM_BLOCKS)
                for k, v in launches.items()},
            "power": card.get("smi", "")}
    if not trace:
        values = {"input_msps": stats.input_msps(window, n, seconds),
                  "block_ms_p95": stats.p95_ms([sink.done[j] - ask[j]
                                                for j in window]),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    else:
        # the host clock's readings come from the window's untraced part,
        # from the second block after the profiler stopped (the first
        # starts on a drained card)
        untraced = range(traced_last + 2, n_blocks)
        ctx = check.Context(cell, n, card, trace_obj, {
            "read": [t_read[i] for i in untraced],
            "call": [t_call[i] for i in untraced],
            "push": [t_push[i] for i in untraced]}, ref_mod)
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if trace_obj is not None:
            result["device"]["busy_s"] = trace_obj.busy_s
            result["device"]["window_s"] = trace_obj.window_s
            result["breakdown"] = {"device_ops": trace_obj.top_ops(),
                                   "idle_gaps": trace_obj.idle_gaps()}
            info["traced_blocks"] = trace_obj.blocks
            info["unattributed_device_events"] = trace_obj.unattributed
    result["checks"] = numbers
    return result, info
