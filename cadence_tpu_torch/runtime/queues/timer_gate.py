"""Timer gates: wake the timer pump when the next deadline arrives.

Reference: Cadence service/history/timerGate.go — LocalTimerGate
(:91) wraps a local clock.

A copy of the reference package's ``runtime/queues/timer_gate.py``
without ``RemoteTimerGate``, the standby processors' gate.
"""

from __future__ import annotations

import threading
from typing import Optional

from ...utils.clock import RealTimeSource, TimeSource


class LocalTimerGate:
    """Fires when the local clock passes the earliest update()d deadline."""

    def __init__(self, time_source: Optional[TimeSource] = None) -> None:
        self._time = time_source or RealTimeSource()
        self._cond = threading.Condition()
        self._deadline_ns: Optional[int] = None
        self._fired = threading.Event()

    def update(self, deadline_ns: int) -> bool:
        """Arm (or re-arm earlier); True if this became the next deadline."""
        with self._cond:
            if self._deadline_ns is None or deadline_ns < self._deadline_ns:
                self._deadline_ns = deadline_ns
                self._cond.notify_all()
                return True
            return False

    def wait(self, max_wait_s: float = 0.1) -> bool:
        """Block until the deadline passes (True) or max_wait_s (False)."""
        with self._cond:
            deadline = self._deadline_ns
            now = self._time.now()
            if deadline is not None and now >= deadline:
                self._deadline_ns = None
                return True
            wait_s = max_wait_s
            if deadline is not None:
                wait_s = min(max_wait_s, (deadline - now) / 1e9)
            self._cond.wait(max(0.0, min(wait_s, max_wait_s)))
            now = self._time.now()
            if self._deadline_ns is not None and now >= self._deadline_ns:
                self._deadline_ns = None
                return True
            return False

    def fire_after(self) -> Optional[int]:
        with self._cond:
            return self._deadline_ns
