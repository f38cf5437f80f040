"""TaskMatcher: zero-buffer rendezvous of task producers and pollers.

Reference: Cadence service/matching/matcher.go:86-348 — producers
(Offer/MustOffer) and consumers (Poll) meet on unbuffered channels with a
rate limiter in between. Here the rendezvous is a deque of waiting poller
slots guarded by one lock: a producer hands its task directly to a
waiting slot (sync match) or, for MustOffer, parks until a slot arrives.

A copy of the reference package's ``matching/matcher.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from ..utils.locks import make_lock
from ..utils.quotas import TokenBucket


class _PollSlot:
    """One waiting poller; fulfilled at most once."""

    __slots__ = ("cv", "task", "done", "cancelled")

    def __init__(self, lock: threading.Lock) -> None:
        self.cv = threading.Condition(lock)
        self.task = None
        self.done = False
        self.cancelled = False

    def fulfill(self, task) -> None:
        self.task = task
        self.done = True
        self.cv.notify()


class TaskMatcher:
    def __init__(
        self,
        rate_limiter: Optional[TokenBucket] = None,
        forward_offer: Optional[Callable[[object, float], bool]] = None,
        forward_poll: Optional[Callable[[float], object]] = None,
    ) -> None:
        self._lock = make_lock("TaskMatcher._lock")
        self._slots: deque[_PollSlot] = deque()
        self._limiter = rate_limiter
        # forwarder hooks (child partition → parent partition); see
        # forwarder.go:123-281. Either may be None for the root partition.
        self._forward_offer = forward_offer
        self._forward_poll = forward_poll
        self._shutdown = threading.Event()

    # -- producer side -------------------------------------------------

    def _try_handoff(self, task) -> bool:
        """Hand task to a waiting poller. Caller holds the lock."""
        while self._slots:
            slot = self._slots.popleft()
            if slot.cancelled:
                continue
            slot.fulfill(task)
            return True
        return False

    def offer(self, task, timeout: float = 0.0) -> bool:
        """Sync match: succeed only if a poller takes the task now (or
        within ``timeout``). Reference matcher.Offer. ``timeout`` is ONE
        budget across the local and forwarded attempts — not one each."""
        if self._limiter is not None and not self._limiter.allow():
            return False
        deadline = time.monotonic() + timeout
        with self._lock:
            if self._try_handoff(task):
                return True
        if self._forward_offer is not None and self._forward_offer(
            task, max(0.0, deadline - time.monotonic())
        ):
            return True
        while time.monotonic() < deadline and not self._shutdown.is_set():
            with self._lock:
                if self._try_handoff(task):
                    return True
            time.sleep(min(0.005, timeout))
        return False

    def must_offer(self, task, poll_interval: float = 0.02) -> bool:
        """Backlog dispatch: block until some poller takes the task (or
        shutdown). Reference matcher.MustOffer."""
        while not self._shutdown.is_set():
            with self._lock:
                if self._try_handoff(task):
                    return True
            if self._forward_offer is not None and self._forward_offer(
                task, poll_interval
            ):
                return True
            time.sleep(poll_interval)
        return False

    # -- consumer side -------------------------------------------------

    def poll(self, timeout: float):
        """Wait up to ``timeout`` seconds for a task; None on timeout or
        shutdown. Reference matcher.Poll.

        With a forwarder, the budget is SPLIT: half parked on the local
        slot list, the remainder parked on the parent partition — a
        zero-budget forward could never match (the parent-side slot
        would be created and cancelled inside one lock hold, invisible
        to any producer). The reference selects on both channels
        simultaneously; the sequential split is the single-lock
        equivalent and bounds added dispatch latency at timeout/2."""
        deadline = time.monotonic() + timeout
        local_budget = (
            timeout if self._forward_poll is None else timeout / 2
        )
        slot = _PollSlot(self._lock)
        with self._lock:
            self._slots.append(slot)
            local_deadline = time.monotonic() + local_budget
            while not slot.done and not self._shutdown.is_set():
                remaining = local_deadline - time.monotonic()
                if remaining <= 0:
                    break
                slot.cv.wait(remaining)
            if slot.done:
                return slot.task
            slot.cancelled = True
            # remove now (O(active pollers)): abandoned slots must not
            # accumulate on an idle task list that is long-polled
            try:
                self._slots.remove(slot)
            except ValueError:
                pass  # a producer already popped it mid-handoff scan
        # local miss: park the remaining budget on the parent partition
        # (matcher polls the parent when the local backlog is dry)
        if self._forward_poll is not None and not self._shutdown.is_set():
            return self._forward_poll(
                max(0.0, deadline - time.monotonic())
            )
        return None

    def poller_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if not s.cancelled)

    def interrupt_all(self) -> None:
        """Wake every waiting poller empty-handed (CancelOutstandingPoll)."""
        with self._lock:
            while self._slots:
                slot = self._slots.popleft()
                if not slot.cancelled:
                    slot.fulfill(None)

    @property
    def is_shutdown(self) -> bool:
        return self._shutdown.is_set()

    def shutdown(self) -> None:
        self._shutdown.set()
        self.interrupt_all()
