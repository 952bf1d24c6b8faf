"""Scheduler: time-based task automation.

The port's own copy of ``sdrpp_tpu.misc.scheduler``.

Reference: misc_modules/scheduler (WIP in the reference — start/stop
actions at scheduled times, e.g. record a satellite pass). Tasks carry a
start/end time and callables; ``tick(now)`` drives them (composable with
the block receiver loop, like misc/scanner.py).
"""

from __future__ import annotations

import bisect

__all__ = ["Task", "Scheduler"]


class Task:
    def __init__(self, name: str, start: float, end: float | None,
                 on_start=None, on_end=None):
        self.name = name
        self.start = float(start)
        self.end = float(end) if end is not None else None
        self.on_start = on_start
        self.on_end = on_end
        self.started = False
        self.finished = False

    def __repr__(self):
        return f"Task({self.name!r}, {self.start}, {self.end})"


class Scheduler:
    def __init__(self):
        self._tasks: list[Task] = []

    def add(self, task: Task):
        bisect.insort(self._tasks, task, key=lambda t: t.start)

    def remove(self, name: str):
        self._tasks = [t for t in self._tasks if t.name != name]

    def tasks(self):
        return list(self._tasks)

    def tick(self, now: float) -> list[str]:
        """Fire due start/end actions; returns event strings."""
        events = []
        for t in self._tasks:
            if not t.started and now >= t.start:
                t.started = True
                if t.on_start:
                    t.on_start()
                events.append(f"start:{t.name}")
            if t.started and not t.finished and t.end is not None and now >= t.end:
                t.finished = True
                if t.on_end:
                    t.on_end()
                events.append(f"end:{t.name}")
        self._tasks = [t for t in self._tasks if not t.finished]
        return events
