"""TimeSource abstraction — real and fake clocks.

Mirrors the reference's clock.TimeSource
(Cadence common/clock/time_source.go): every runtime component
takes a TimeSource so tests can drive timer queues deterministically.
All times are int nanoseconds since epoch (the unit the event model and
tensor packer already use).

A copy of the reference package's ``utils/clock.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Tuple

SECOND = 1_000_000_000
MILLISECOND = 1_000_000


class TimeSource:
    def now(self) -> int:
        """Nanoseconds since epoch."""
        raise NotImplementedError

    def sleep(self, duration_ns: int) -> None:
        raise NotImplementedError


class RealTimeSource(TimeSource):
    def now(self) -> int:
        return time.time_ns()

    def sleep(self, duration_ns: int) -> None:
        if duration_ns > 0:
            time.sleep(duration_ns / SECOND)


class FakeTimeSource(TimeSource):
    """Manually-advanced clock; wakes sleepers whose deadline passed."""

    def __init__(self, start_ns: int = 1_700_000_000 * SECOND) -> None:
        self._now = start_ns
        self._cond = threading.Condition()

    def now(self) -> int:
        with self._cond:
            return self._now

    def sleep(self, duration_ns: int) -> None:
        deadline = self.now() + duration_ns
        with self._cond:
            while self._now < deadline:
                self._cond.wait(timeout=1.0)

    def advance(self, duration_ns: int) -> None:
        with self._cond:
            self._now += duration_ns
            self._cond.notify_all()

    def set(self, now_ns: int) -> None:
        with self._cond:
            self._now = max(self._now, now_ns)
            self._cond.notify_all()
