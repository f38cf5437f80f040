"""In-process pub/sub for workflow history progress (long-poll).

Reference: service/history/historyEventNotifier.go — GetHistory with
wait-for-new-event subscribes on the workflow identifier; every persisted
transaction publishes (next_event_id, is_running) so blocked pollers
wake as soon as new events land instead of busy-polling persistence.

A copy of the reference package's ``runtime/engine/notifier.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

_Identifier = Tuple[str, str, str]  # (domain_id, workflow_id, run_id)


class _Subscription:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._latest: Optional[Tuple[int, bool]] = None

    def publish(self, next_event_id: int, is_running: bool) -> None:
        with self._cond:
            self._latest = (next_event_id, is_running)
            self._cond.notify_all()

    def wait_for(
        self, min_next_event_id: int, timeout_s: float
    ) -> Optional[Tuple[int, bool]]:
        """Block until next_event_id > min (or the run closes)."""
        import time

        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                if self._latest is not None:
                    next_id, running = self._latest
                    if next_id > min_next_event_id or not running:
                        return self._latest
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)


class HistoryEventNotifier:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._subs: Dict[_Identifier, List[_Subscription]] = {}

    def subscribe(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> _Subscription:
        sub = _Subscription()
        with self._lock:
            self._subs.setdefault(
                (domain_id, workflow_id, run_id), []
            ).append(sub)
        return sub

    def unsubscribe(
        self, domain_id: str, workflow_id: str, run_id: str,
        sub: _Subscription,
    ) -> None:
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            subs = self._subs.get(key, [])
            if sub in subs:
                subs.remove(sub)
            if not subs:
                self._subs.pop(key, None)

    def notify(
        self, domain_id: str, workflow_id: str, run_id: str,
        next_event_id: int, is_running: bool,
    ) -> None:
        with self._lock:
            subs = list(self._subs.get((domain_id, workflow_id, run_id), []))
        for sub in subs:
            sub.publish(next_event_id, is_running)
