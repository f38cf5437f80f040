"""Structured logging with a tag dict.

A trimmed copy of the reference package's ``utils/log.py``: stdlib
logging under the ``cadence_tpu_torch`` logger, with tags rendered as
key=value pairs after the message. The serving plane and the history
host log through it."""

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

    def with_tags(self, **tags: Any) -> "Logger":
        """A child logger carrying these tags beside its own."""
        merged = dict(self._tags)
        merged.update(tags)
        return Logger(self._log.name, merged)

    def _fmt(self, msg: str, tags: Dict[str, Any]) -> str:
        merged = dict(self._tags)
        merged.update(tags)
        if merged:
            kv = " ".join(f"{k}={v}" for k, v in merged.items())
            return f"{msg} | {kv}"
        return msg

    def debug(self, msg: str, **tags: Any) -> None:
        self._log.debug(self._fmt(msg, tags))

    def info(self, msg: str, **tags: Any) -> None:
        self._log.info(self._fmt(msg, tags))

    def warn(self, msg: str, **tags: Any) -> None:
        self._log.warning(self._fmt(msg, tags))

    def error(self, msg: str, **tags: Any) -> None:
        self._log.error(self._fmt(msg, tags))

    def exception(self, msg: str, **tags: Any) -> None:
        """``error`` with the current exception's traceback."""
        self._log.exception(self._fmt(msg, tags))


def get_logger(name: str = _ROOT, **tags: Any) -> Logger:
    return Logger(name, tags)
