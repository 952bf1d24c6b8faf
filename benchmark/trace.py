"""Reading a ``torch.profiler`` trace of the traced run: which device
activity belongs to which block and layer, how busy the card was, and
where it sat idle.

The trace is the profiler's Chrome trace (``export_chrome_trace``), read
back as JSON. A kernel belongs to the host range in which it was
launched: its ``correlation`` id joins it to the runtime or driver call
that launched it, and that call's time falls inside the harness's ranges
(``bench.block`` around each block, the layers' ranges inside). Copies
and memsets count as device activity for the busy share like kernels.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

__all__ = ["Trace", "BLOCK"]

BLOCK = "bench.block"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")
_HOST = ("user_annotation", "cpu_op")
TOP = 10  # entries of each list of the breakdown


def short_name(name: str) -> str:
    """A kernel's name without namespaces and argument list, at most 160
    characters: what the breakdown prints."""
    for ns in ("(anonymous namespace)::", "at::native::", "c10::", "std::"):
        name = name.replace(ns, "")
    if name.startswith("void "):
        depth = 0
        for i, ch in enumerate(name):
            depth += (ch == "<") - (ch == ">")
            if ch == "(" and depth == 0:
                name = name[5:i]
                break
    return name[:160]


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The device activity of the traced blocks.

    ``events`` is the Chrome trace's ``traceEvents`` (times in us).
    ``layers`` are the range names whose kernels are summed by layer.
    Only blocks whose ``bench.block`` range lies wholly in the trace
    count; ``blocks`` is their number."""

    def __init__(self, events: list, layers=()):
        host = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in _HOST]
        blocks = sorted((e["ts"], e["ts"] + e["dur"]) for e in host
                        if e["name"] == BLOCK)
        self.blocks = len(blocks)
        self._block_starts = [b[0] for b in blocks]
        self._block_spans = blocks
        self._ranges = {name: sorted((e["ts"], e["ts"] + e["dur"])
                                     for e in host if e["name"] == name)
                        for name in layers}
        launch = {}
        for e in events:
            if e.get("cat") in _LAUNCH:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launch[c] = e["ts"]
        self.device = []   # (name, start, end, block index or None, layer)
        self.unattributed = 0
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in _DEVICE:
                continue
            c = (e.get("args") or {}).get("correlation")
            t = launch.get(c)
            if t is None:
                self.unattributed += 1
            blk = self._block_of(t) if t is not None else None
            layer = self._layer_of(t) if t is not None else None
            self.device.append((e["name"], e["ts"], e["ts"] + e["dur"], blk,
                                layer))
        mine = [d for d in self.device if d[3] is not None]
        if mine:
            self.t0 = min(d[1] for d in mine)
            self.t1 = max(d[2] for d in mine)
        else:
            self.t0 = self.t1 = 0.0
        self.host = host

    @classmethod
    def from_file(cls, path: Path, layers=()) -> "Trace":
        return cls(json.loads(Path(path).read_text())["traceEvents"], layers)

    def _block_of(self, t):
        i = bisect.bisect_right(self._block_starts, t) - 1
        if i >= 0 and t <= self._block_spans[i][1]:
            return i
        return None

    def _layer_of(self, t):
        for name, spans in self._ranges.items():
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                return name
        return None

    # ---- what the readers take ------------------------------------------

    @property
    def window_s(self) -> float:
        """From the first device activity of the traced blocks to the
        last one's end."""
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        """Seconds inside the window with a kernel, copy or memset running,
        any stream, any launcher."""
        spans = [(max(s, self.t0), min(e, self.t1)) for _, s, e, _, _ in
                 self.device if e > self.t0 and s < self.t1]
        return sum(e - s for s, e in _union(spans)) * 1e-6

    def layer_s(self, layer: str) -> float | None:
        """Device seconds of the activity launched inside ``layer``'s
        range in the traced blocks; None where the range never ran."""
        if not self._ranges.get(layer) or not self.device:
            return None
        return sum(e - s for _, s, e, b, l in self.device
                   if b is not None and l == layer) * 1e-6

    def kernels(self, part: str, layer: str | None = None):
        """(launches, device seconds) of the traced blocks' kernels whose
        name holds ``part`` (launched inside ``layer`` when given)."""
        hits = [(e - s) for n, s, e, b, l in self.device
                if b is not None and part in n
                and (layer is None or l == layer)]
        return len(hits), sum(hits) * 1e-6

    def top_ops(self):
        """[[name, seconds], ...]: the ``TOP`` device operations that took
        most time inside the window, summed by name."""
        tot = {}
        for n, s, e, _, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                n = short_name(n)
                tot[n] = tot.get(n, 0.0) + (e - s) * 1e-6
        return [[n, v] for n, v in sorted(tot.items(),
                                          key=lambda t: -t[1])[:TOP]]

    def idle_gaps(self):
        """[[what the host was doing, seconds], ...]: the ``TOP`` longest
        gaps in the window with nothing on the card, each named by the
        innermost host range or operator open when the gap began."""
        busy = _union([(max(s, self.t0), min(e, self.t1)) for _, s, e, _, _
                       in self.device if e > self.t0 and s < self.t1])
        gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1])
                for i in range(len(busy) - 1)]
        gaps.sort(reverse=True)
        out = []
        for dur, at in gaps[:TOP]:
            open_ = [e for e in self.host
                     if e["ts"] <= at <= e["ts"] + e["dur"]]
            name = (min(open_, key=lambda e: e["dur"])["name"] if open_
                    else "no host range")
            out.append([f"host: {name}", dur * 1e-6])
        return out
