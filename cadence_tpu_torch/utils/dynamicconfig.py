"""Dynamic config: hot-reloadable typed keys with constrained overrides.

The reference's dynamicconfig (Cadence common/service/
dynamicconfig/: 172 keys, file-watched YAML, per-domain / per-tasklist
filtered overrides) reduced to its essential contract:

  * a ``Client`` answers (key, filters) -> value;
  * typed property getters bind (client, key, default) into callables the
    runtime stores once and calls per use — so live file edits change
    behavior without restarts;
  * filters select the most specific matching override
    (domain+tasklist > domain > tasklist > unfiltered).

A copy of the reference package's ``utils/dynamicconfig.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

# filter attribute names (reference: dynamicconfig/constants.go filters)
DOMAIN = "domainName"
TASKLIST = "taskListName"
SHARD_ID = "shardID"


class Client:
    def get_value(self, key: str, filters: Dict[str, Any]) -> Optional[Any]:
        raise NotImplementedError


class InMemoryClient(Client):
    """Programmatic overrides — the test fixture and the autopilot's
    override plane."""

    def __init__(self) -> None:
        self._values: Dict[str, List[Tuple[Dict[str, Any], Any]]] = {}
        self._lock = threading.Lock()

    def set_value(
        self, key: str, value: Any, filters: Optional[Dict[str, Any]] = None
    ) -> None:
        """Set an override; an entry with EQUAL filters is replaced in
        place, so a controller retuning the same key every epoch stays
        O(1) per key instead of growing the entry list unboundedly (and
        `_best_match` never sees the stale value)."""
        fdict = dict(filters or {})
        with self._lock:
            entries = self._values.setdefault(key, [])
            for i, (entry_filters, _) in enumerate(entries):
                if entry_filters == fdict:
                    entries[i] = (fdict, value)
                    return
            entries.append((fdict, value))

    def remove_value(
        self, key: str, filters: Optional[Dict[str, Any]] = None
    ) -> bool:
        """Remove the override with EXACTLY these filters (None/{} means
        the unfiltered entry). Returns True if an entry was removed."""
        fdict = dict(filters or {})
        with self._lock:
            entries = self._values.get(key)
            if not entries:
                return False
            for i, (entry_filters, _) in enumerate(entries):
                if entry_filters == fdict:
                    del entries[i]
                    if not entries:
                        del self._values[key]
                    return True
        return False

    def get_value(self, key: str, filters: Dict[str, Any]) -> Optional[Any]:
        with self._lock:
            entries = list(self._values.get(key, ()))
        return _best_match(entries, filters)


class FileBasedClient(Client):
    """JSON file polled for changes (reference: fileBasedClient.go).

    File format: {key: [{"filters": {...}, "value": ...}, ...], ...}
    """

    def __init__(self, path: str, poll_interval_s: float = 5.0) -> None:
        self.path = path
        self.poll_interval_s = poll_interval_s
        self._mtime = 0.0
        self._last_check = 0.0
        self._values: Dict[str, List[Tuple[Dict[str, Any], Any]]] = {}
        self._lock = threading.Lock()
        self._load()

    def _load(self) -> None:
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return
        if mtime == self._mtime:
            return
        try:
            with open(self.path) as f:
                raw = json.load(f)
            values = {
                key: [
                    (dict(e.get("filters", {})), e["value"])
                    for e in entries
                ]
                for key, entries in raw.items()
            }
        except Exception:
            # malformed / partially-written file: keep serving the last
            # good snapshot (reference fileBasedClient behavior)
            from ..utils.log import get_logger

            get_logger("cadence_tpu_torch.dynamicconfig").exception(
                f"failed to load {self.path}; keeping previous values"
            )
            return
        with self._lock:
            self._values = values
            self._mtime = mtime

    def get_value(self, key: str, filters: Dict[str, Any]) -> Optional[Any]:
        now = time.monotonic()
        if now - self._last_check > self.poll_interval_s:
            self._last_check = now
            self._load()
        with self._lock:
            entries = list(self._values.get(key, ()))
        return _best_match(entries, filters)


class LayeredClient(Client):
    """Programmatic overrides layered over a base client.

    The capacity autopilot (and tests) write through ``overrides`` —
    an :class:`InMemoryClient` — while operator-managed values keep
    coming from the base (file) client. An override, when present for
    the key+filters, ALWAYS wins over the base; ``remove_value`` on the
    override layer falls back to the base value, which is the
    autopilot's revert-to-operator-config path."""

    def __init__(
        self, overrides: InMemoryClient, base: Optional[Client] = None
    ) -> None:
        self.overrides = overrides
        self.base = base

    def get_value(self, key: str, filters: Dict[str, Any]) -> Optional[Any]:
        v = self.overrides.get_value(key, filters)
        if v is not None:
            return v
        if self.base is not None:
            return self.base.get_value(key, filters)
        return None


def _best_match(
    entries: List[Tuple[Dict[str, Any], Any]], filters: Dict[str, Any]
) -> Optional[Any]:
    """Most-specific match wins: domain+tasklist > domain > tasklist >
    unfiltered; equal specificity resolves to the LAST entry so a
    later set_value overrides an earlier one."""
    best, best_score = None, -1
    for entry_filters, value in entries:
        if all(filters.get(k) == v for k, v in entry_filters.items()):
            score = 2 * ("domain" in entry_filters) + (
                "task_list" in entry_filters
            ) + len(entry_filters)
            if score >= best_score:
                best, best_score = value, score
    return best


class Collection:
    """Typed getters bound to a client (reference: dynamicconfig/config.go)."""

    def __init__(self, client: Optional[Client] = None) -> None:
        self.client = client or InMemoryClient()

    def _getter(self, key: str, default: Any, cast: Callable[[Any], Any]):
        def get(**filters: Any) -> Any:
            v = self.client.get_value(key, filters)
            return default if v is None else cast(v)

        return get

    def int_property(self, key: str, default: int) -> Callable[..., int]:
        return self._getter(key, default, int)

    def float_property(self, key: str, default: float) -> Callable[..., float]:
        return self._getter(key, default, float)

    def bool_property(self, key: str, default: bool) -> Callable[..., bool]:
        return self._getter(key, default, bool)

    def duration_property(
        self, key: str, default_ns: int
    ) -> Callable[..., int]:
        """Durations stored as seconds in config, returned as ns."""
        return self._getter(key, default_ns, lambda v: int(v * 1_000_000_000))

    def string_property(self, key: str, default: str) -> Callable[..., str]:
        return self._getter(key, default, str)

    def map_property(self, key: str, default: dict) -> Callable[..., dict]:
        return self._getter(key, default, dict)
