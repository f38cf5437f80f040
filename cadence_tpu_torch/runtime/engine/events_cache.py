"""Shard-level LRU of individual history events.

Reference: service/history/eventsCache.go:66-148 — events whose details
are needed again after their transaction (the activity-scheduled event
for poll responses, the child-initiated event for the transfer queue's
start-child processing) are cached per (domain, workflow, run,
event_id) at write time; a miss pages the history branch.

The mutable state's ``cached_events`` staging list (the transition
surface writes there, mutableStateBuilder eventsCache analog) is
drained into this cache when the transaction persists — keeping the
per-workflow state bounded regardless of history length.

A copy of the reference package's ``runtime/engine/events_cache.py``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

from ...core.events import HistoryEvent

Key = Tuple[str, str, str, int]


class EventsCache:
    def __init__(self, max_entries: int = 4096) -> None:
        self._max = max_entries
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Key, HistoryEvent]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def put(
        self, domain_id: str, workflow_id: str, run_id: str,
        event: HistoryEvent,
    ) -> None:
        key = (domain_id, workflow_id, run_id, event.event_id)
        with self._lock:
            self._entries[key] = event
            self._entries.move_to_end(key)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)

    def get(
        self, domain_id: str, workflow_id: str, run_id: str, event_id: int,
    ) -> Optional[HistoryEvent]:
        key = (domain_id, workflow_id, run_id, event_id)
        with self._lock:
            event = self._entries.get(key)
            if event is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return event

    def delete_workflow(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> None:
        prefix = (domain_id, workflow_id, run_id)
        with self._lock:
            for key in [k for k in self._entries if k[:3] == prefix]:
                del self._entries[key]

    def size(self) -> int:
        with self._lock:
            return len(self._entries)
