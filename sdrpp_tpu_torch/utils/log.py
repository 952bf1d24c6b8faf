"""Structured leveled logging (the flog equivalent).

The port's own copy of ``sdrpp_tpu.utils.log``, rooted at the
``sdrpp_tpu_torch`` logger.

Reference: core/src/utils/flog.h:43-112 — timestamped leveled logger. Here
a thin wrapper over the stdlib with the same levels plus optional JSON
lines for machine consumption (observability plan, SURVEY §5).
"""

from __future__ import annotations

import json
import logging
import sys
import time

__all__ = ["get_logger", "set_json_output", "debug", "info", "warn", "error"]

_FORMAT = "[%(asctime)s.%(msecs)03d] [%(levelname)s] %(message)s"
_DATEFMT = "%d/%m/%Y %H:%M:%S"

_root = logging.getLogger("sdrpp_tpu_torch")
if not _root.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
    _root.addHandler(h)
    _root.setLevel(logging.INFO)

_json_mode = False


class _JsonHandler(logging.Handler):
    def emit(self, record):
        line = json.dumps({
            "ts": time.time(),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        })
        print(line, file=sys.stderr)


def set_json_output(enabled: bool):
    global _json_mode
    if enabled == _json_mode:
        return
    _json_mode = enabled
    for h in list(_root.handlers):
        _root.removeHandler(h)
    if enabled:
        _root.addHandler(_JsonHandler())
    else:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
        _root.addHandler(h)


def get_logger(name: str | None = None) -> logging.Logger:
    return _root if name is None else _root.getChild(name)


def debug(msg, *args):
    _root.debug(msg, *args)


def info(msg, *args):
    _root.info(msg, *args)


def warn(msg, *args):
    _root.warning(msg, *args)


def error(msg, *args):
    _root.error(msg, *args)
