"""JSON configuration with defaults-merge/repair and auto-save.

The port's own copy of ``sdrpp_tpu.utils.config``.

Reference: core/src/config.{h,cpp} — ConfigManager holds a JSON tree,
merges missing defaults in ("repair", core.cpp:277-351), and auto-saves on
release(true). Same contract here, minus the background thread: saves are
synchronous on mutation (cheap) or explicit.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

__all__ = ["ConfigManager"]


def _merge_defaults(conf: dict, defaults: dict) -> bool:
    """Recursively add missing keys from defaults; True if modified."""
    changed = False
    for k, v in defaults.items():
        if k not in conf:
            conf[k] = json.loads(json.dumps(v))
            changed = True
        elif isinstance(v, dict) and isinstance(conf[k], dict):
            changed |= _merge_defaults(conf[k], v)
    return changed


class ConfigManager:
    def __init__(self, path, defaults: dict | None = None,
                 auto_save: bool = True):
        self.path = Path(path)
        self.defaults = defaults or {}
        self.auto_save = auto_save
        self._lock = threading.RLock()
        self.conf: dict = {}
        self.load()

    def load(self):
        with self._lock:
            if self.path.exists():
                try:
                    self.conf = json.loads(self.path.read_text())
                except (json.JSONDecodeError, OSError):
                    # Corrupt config: reset to defaults (config repair,
                    # core.cpp:288-300 falls back on parse failure).
                    self.conf = {}
            if _merge_defaults(self.conf, self.defaults) and self.auto_save:
                self.save()

    def save(self):
        with self._lock:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(json.dumps(self.conf, indent=2, sort_keys=True))

    # acquire/release naming kept for parity with the reference API.
    def acquire(self):
        self._lock.acquire()
        return self.conf

    def release(self, modified: bool = False):
        try:
            if modified and self.auto_save:
                self.save()
        finally:
            self._lock.release()

    def get(self, *keys, default=None):
        with self._lock:
            node = self.conf
            for k in keys:
                if not isinstance(node, dict) or k not in node:
                    return default
                node = node[k]
            return node

    def set(self, *keys_and_value):
        *keys, value = keys_and_value
        with self._lock:
            node = self.conf
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = value
            if self.auto_save:
                self.save()
