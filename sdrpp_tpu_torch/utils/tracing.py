"""Tracing/profiling: torch.profiler traces, the program's spans, and
per-block throughput counters.

The counterpart of ``sdrpp_tpu.utils.tracing``, where ``trace`` is a
``jax.profiler`` trace. Here:

- ``trace(logdir)``: context manager profiling everything inside it with
  ``torch.profiler`` (CPU activity, and the CUDA activity when torch has a
  card: every kernel launched, the port's hand-written ones by their
  names) and writing a Chrome trace, ``<host>_<pid>.<ms>.pt.trace.json``,
  into ``logdir``.
- ``annotate(name, block, device=, value=)``: a span at a stage
  boundary. With no profiler running it costs one check and returns a
  shared null context. Under a profiler (``trace``, or any
  ``torch.profiler`` session) it opens a ``record_function`` range on the
  profiler's clock and keeps a record in a ring of ``RING``: name,
  parent, block id (the enclosing span's when not given), host start and
  end, and ``value``. A ``device`` span (a stage that enqueues work on
  the card) also records a pair of timing CUDA events on the current
  stream where CUDA is initialised, from a per-device pool: as a
  block's outermost span closes, the spans whose end event has passed
  on the card (``query``, which does not wait) get their device ms and
  give their events back. Each thread keeps its own stack of open
  spans. ``spans()`` reads the ring, waiting for the spans still on the
  card; ``summary()`` gives each name's mean a span. Nothing in the loop
  synchronises.
- ``StreamMonitor``: counts blocks/samples, EMA block latency, aggregate
  and instantaneous samples/s (a copy of the JAX class). ``block()``
  times the host's work inside it; ``start()`` and ``done()`` time a
  block from its step's start to its output reaching the host, which is
  what the pipelined CLI loops count (they read each block's output back
  one block late, so the host's enqueue alone says nothing of the card).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import socket
import threading
import time
from pathlib import Path

import torch

__all__ = ["trace", "annotate", "spans", "summary", "RING",
           "StreamMonitor"]

RING = 65536  # span records kept; the oldest go first
_ring: collections.deque = collections.deque(maxlen=RING)
_pending: collections.deque = collections.deque()  # spans timed, unread
_pool: dict = collections.defaultdict(list)  # device -> free event pairs
_lock = threading.Lock()  # _pending and _pool
_ids = itertools.count()
_local = threading.local()  # .stack: this thread's open spans
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block into a Chrome trace in
    ``logdir`` (created if missing); yields the profiler. Empties the span
    ring first, so that ``spans()`` after it reads this trace's spans."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    _ring.clear()
    with profile(activities=acts) as prof:
        yield prof
    name =(f"{socket.gethostname()}_{os.getpid()}."
            f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(str(out / name))


def annotate(name: str, block: int | None = None, *, device: bool = False,
             value: float | None = None):
    """A span: ``with annotate("vfo.mix", device=True): y = mix(x)``.
    ``block`` is the block id (None: the enclosing span's); ``device``
    times the span on the card's stream (for stages that enqueue the
    card's work); ``value`` is a number the span carries (the
    ``Prefetcher``'s: the blocks ready). With no profiler running it
    records nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, block, device, value)


def _read_events(wait: bool):
    """Device ms of the pending spans, oldest first, as far as their end
    events have passed (all of them with ``wait``); their events go back
    to the pool. Holds ``_lock``."""
    while _pending and (wait or _pending[0].events[1].query()):
        s = _pending.popleft()
        if wait:
            s.events[1].synchronize()
        s.device_ms = s.events[0].elapsed_time(s.events[1])
        _pool[s.device].append(s.events)
        s.events = None


class _Span:
    """One span under a profiler, and its record in the ring."""

    # device: asked for events; then, with them, the card they are on
    __slots__ = ("id", "name", "parent", "block", "value", "start_ns",
                 "end_ns", "device", "events", "device_ms", "_range")

    def __init__(self, name, block, device, value):
        self.id = next(_ids)
        self.name = name
        self.block = block
        self.value = value
        self.device = device
        self.parent = self.events = self.device_ms = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent = stack[-1].id
            if self.block is None:
                self.block = stack[-1].block
        self._range = torch.profiler.record_function(
            self.name, None if self.block is None else f"block {self.block}")
        self._range.__enter__()
        if self.device and torch.cuda.is_initialized():
            self.device = torch.cuda.current_device()
            with _lock:
                pool = _pool[self.device]
                self.events = pool.pop() if pool else None
            if self.events is None:
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        stack = _local.stack
        stack.pop()
        if self.events is not None:
            self.events[1].record()
            with _lock:
                _pending.append(self)
                if not stack:  # a block's outermost span: read what passed
                    _read_events(wait=False)
        self._range.__exit__(*exc)
        self._range = None
        _ring.append(self)
        return False


def spans() -> list[dict]:
    """The ring's records, oldest first: ``id``, ``name``, ``parent`` (the
    enclosing span's id, or None), ``block``, ``value``, ``start_ns`` and
    ``end_ns`` (``perf_counter_ns``), ``device_ms`` (a device span's time
    between its two CUDA events on its stream; None for a host span or
    off a card). Waits for the spans still on the card."""
    with _lock:
        _read_events(wait=True)
    return [{"id": s.id, "name": s.name, "parent": s.parent,
             "block": s.block, "value": s.value, "start_ns": s.start_ns,
             "end_ns": s.end_ns, "device_ms": s.device_ms}
            for s in list(_ring)]


def summary(records: list[dict] | None = None) -> dict:
    """{name: {"count", "host_ms", "device_ms", "self_device_ms",
    "value"}} over ``records`` (default ``spans()``): the spans of each
    name and their mean host ms, device ms, device ms less their child
    spans', and value, a span (None where no span of the name has one).
    The scanner path opens each name once a block, so a span's mean is
    a block's, however many banks or writers recorded."""
    records = spans() if records is None else records
    child_ms = collections.Counter()
    for r in records:
        if r["parent"] is not None and r["device_ms"] is not None:
            child_ms[r["parent"]] += r["device_ms"]
    sums = {}
    for r in records:
        s = sums.setdefault(r["name"], collections.defaultdict(list))
        s["host_ms"].append((r["end_ns"] - r["start_ns"]) * 1e-6)
        if r["device_ms"] is not None:
            s["device_ms"].append(r["device_ms"])
            s["self_device_ms"].append(r["device_ms"] - child_ms[r["id"]])
        if r["value"] is not None:
            s["value"].append(r["value"])
    return {name: {"count": len(s["host_ms"]),
                   **{k: sum(s[k]) / len(s[k]) if s[k] else None
                      for k in ("host_ms", "device_ms", "self_device_ms",
                                "value")}}
            for name, s in sums.items()}


class StreamMonitor:
    """Per-block throughput/latency counters for a streaming loop.

    >>> mon = StreamMonitor(samplerate=2.4e6)
    >>> with mon.block(n_samples=131072):
    ...     state, y = step(state, x)
    >>> mon.samples_per_sec

    A pipelined loop counts a block when its output reaches the host:
    ``mon.start()`` as the block's step starts, ``mon.done(n)`` in the
    output's callback (blocks are done in the order they start).
    """

    def __init__(self, samplerate: float | None = None, ema_alpha: float = 0.1):
        self.samplerate = samplerate
        self.ema_alpha = ema_alpha
        self.reset()

    def reset(self):
        self.blocks = 0
        self.samples = 0
        self.ema_block_s = None
        self._t_start = time.perf_counter()
        self._t_last = None
        self._started = collections.deque()

    @contextlib.contextmanager
    def block(self, n_samples: int):
        t0 = time.perf_counter()
        yield
        self._count(time.perf_counter() - t0, n_samples)

    def start(self):
        """Stamp a block's step starting; ``done`` counts it."""
        self._started.append(time.perf_counter())

    def done(self, n_samples: int):
        """Count the oldest started block as delivered, timed from its
        ``start``."""
        self._count(time.perf_counter() - self._started.popleft(), n_samples)

    def _count(self, dt: float, n_samples: int):
        self.blocks += 1
        self.samples += int(n_samples)
        self.ema_block_s = (dt if self.ema_block_s is None else
                            (1 - self.ema_alpha) * self.ema_block_s
                            + self.ema_alpha * dt)
        self._t_last = time.perf_counter()

    @property
    def elapsed(self) -> float:
        end = self._t_last if self._t_last is not None else time.perf_counter()
        return max(end - self._t_start, 1e-12)

    @property
    def samples_per_sec(self) -> float:
        """Aggregate input samples/s over the monitored span."""
        return self.samples / self.elapsed

    @property
    def realtime_factor(self) -> float | None:
        """samples_per_sec / samplerate; >1 means faster than real time."""
        if not self.samplerate:
            return None
        return self.samples_per_sec / self.samplerate

    def report(self) -> dict:
        r = {"blocks": self.blocks, "samples": self.samples,
             "elapsed_s": self.elapsed,
             "samples_per_sec": self.samples_per_sec,
             "ema_block_ms": (self.ema_block_s or 0.0) * 1e3}
        if self.samplerate:
            r["realtime_factor"] = self.realtime_factor
        return r

    def __str__(self):
        r = self.report()
        s = (f"{r['blocks']} blocks, {r['samples']} samples in "
             f"{r['elapsed_s']:.2f}s = {r['samples_per_sec'] / 1e6:.2f} Msamp/s"
             f" (EMA {r['ema_block_ms']:.2f} ms/block)")
        if "realtime_factor" in r:
            s += f", {r['realtime_factor']:.2f}x realtime"
        return s
