"""The metric arithmetic over a run's per-block timeline (host clock,
seconds)."""

from __future__ import annotations

import statistics

import numpy as np

__all__ = ["in_window", "input_msps", "p95_ms", "mean_ms", "spread"]


def in_window(done: dict, t0: float, t1: float) -> list[int]:
    """Blocks whose audio reached the sink inside [t0, t1]."""
    return sorted(j for j, t in done.items() if t0 <= t <= t1)


def input_msps(blocks: list[int], n: int, seconds: float) -> float:
    """Input samples of every block completed in the window, over the
    window's seconds, in Msamp/s."""
    return len(blocks) * n / seconds / 1e6


def p95_ms(seconds: list[float]) -> float | None:
    """The 95th percentile (linear between ranks) of ``seconds``, in
    ms."""
    if not len(seconds):
        return None
    return float(np.percentile(np.asarray(seconds, np.float64), 95.0)) * 1e3


def mean_ms(seconds: list[float]) -> float | None:
    return float(np.mean(seconds)) * 1e3 if len(seconds) else None


def spread(values) -> float:
    """(Q3 - Q1) / median by ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
