"""Recent-poller identity cache for DescribeTaskList.

Reference: Cadence service/matching/pollerHistory.go.

A copy of the reference package's ``matching/poller_history.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List


class PollerHistory:
    def __init__(self, ttl_s: float = 300.0, max_size: int = 1000) -> None:
        self._lock = threading.Lock()
        self._pollers: Dict[str, float] = {}  # identity → last access (monotonic)
        self._ttl = ttl_s
        self._max = max_size

    def record(self, identity: str) -> None:
        if not identity:
            return
        now = time.monotonic()
        with self._lock:
            self._pollers[identity] = now
            if len(self._pollers) > self._max:
                oldest = min(self._pollers, key=self._pollers.get)
                del self._pollers[oldest]

    def get(self) -> List[dict]:
        now = time.monotonic()
        with self._lock:
            expired = [k for k, t in self._pollers.items() if now - t > self._ttl]
            for k in expired:
                del self._pollers[k]
            return [
                {"identity": k, "last_access_time_s_ago": now - t}
                for k, t in sorted(self._pollers.items())
            ]
