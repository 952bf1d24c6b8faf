"""What a cell is made of, found by name: ``BENCHMARK.json`` at the
checkout's root indexes the cells, and each piece is a file of its own.

- a configuration ``<config>``: ``configs/<config>.json`` (the deployment,
  its source, what was assumed and reduced, and the limits of its output
  check); its ``system`` names the builder ``systems/<system>.py`` and its
  ``reference`` the plain reference ``reference/<reference>.py``;
- a traffic mix ``<traffic>``: ``workloads/<traffic>.json``, read by the
  one generator, ``traffic.py``;
- a per-layer metric ``<metric>``: the reader ``metrics/<metric>.py``,
  whose ``read(ctx)`` returns a number or None.

A later PR adds a cell, a configuration or a metric by adding files and
entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["load_index", "Cell", "load_cell", "load_module", "HERE", "ROOT"]


def load_index(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    """Import the file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and the
    metrics it reports, each read from its own file."""

    def __init__(self, index: dict, name: str, here: Path = HERE):
        cells = {w["name"]: w for w in index["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.here = here
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in index["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (here.parent / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (here / "workloads" / f"{self.entry['traffic']}.json").read_text())
        self.end_to_end = [m for m in index["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in index["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def system(self):
        return load_module(self.here / "systems" /
                           f"{self.config['system']}.py",
                           f"bench_system_{self.config['system']}")

    def reference(self):
        return load_module(self.here / "reference" /
                           f"{self.config['reference']}.py",
                           f"bench_reference_{self.config['reference']}")

    def reader(self, metric: str):
        return load_module(self.here / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_")
                           .replace("-", "_"))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    return Cell(load_index(root), name, root / "benchmark")
