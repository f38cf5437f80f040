"""Structured logging with a tag dict.

A trimmed copy of the reference package's ``utils/log.py``: stdlib
logging under the ``cadence_tpu_torch`` logger, with tags rendered as
key=value pairs after the message. The serving plane logs its warnings
through it."""

from __future__ import annotations

import logging
import sys
from typing import Any, Dict, Optional

_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"
_ROOT = "cadence_tpu_torch"


def _ensure_configured() -> None:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False


class Logger:
    def __init__(self, name: str = _ROOT,
                 tags: Optional[Dict[str, Any]] = None) -> None:
        _ensure_configured()
        self._log = logging.getLogger(name)
        self._tags = dict(tags or {})

    def _fmt(self, msg: str, tags: Dict[str, Any]) -> str:
        merged = dict(self._tags)
        merged.update(tags)
        if merged:
            kv = " ".join(f"{k}={v}" for k, v in merged.items())
            return f"{msg} | {kv}"
        return msg

    def warn(self, msg: str, **tags: Any) -> None:
        self._log.warning(self._fmt(msg, tags))


def get_logger(name: str = _ROOT, **tags: Any) -> Logger:
    return Logger(name, tags)
