"""Tracing/profiling: torch.profiler traces + per-block throughput counters.

The counterpart of ``sdrpp_tpu.utils.tracing``, where ``trace`` is a
``jax.profiler`` trace. Here:

- ``trace(logdir)``: context manager profiling everything inside it with
  ``torch.profiler`` (CPU activity, and the CUDA activity when torch has a
  card: every kernel launched, the port's hand-written ones by their
  names) and writing a Chrome trace, ``<host>_<pid>.<ms>.pt.trace.json``,
  into ``logdir``.
- ``annotate(name)``: a named region inside the trace
  (``torch.profiler.record_function``).
- ``StreamMonitor``: counts blocks/samples, EMA block latency, aggregate
  and instantaneous samples/s (a copy of the JAX class). Host-side
  arithmetic only: no device synchronisation, so on the card a block's
  time is its enqueue plus whatever the loop waits on (the pipelined CLI
  loops read each block's output back one block late).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path

import torch

__all__ = ["trace", "annotate", "StreamMonitor"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block into a Chrome trace in
    ``logdir`` (created if missing); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    name =(f"{socket.gethostname()}_{os.getpid()}."
            f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(str(out / name))


def annotate(name: str):
    """Named trace region: ``with annotate("vfo_bank"): step(...)``."""
    return torch.profiler.record_function(name)


class StreamMonitor:
    """Per-block throughput/latency counters for a streaming loop.

    >>> mon = StreamMonitor(samplerate=2.4e6)
    >>> with mon.block(n_samples=131072):
    ...     state, y = step(state, x)
    >>> mon.samples_per_sec
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

    @contextlib.contextmanager
    def block(self, n_samples: int):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
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
