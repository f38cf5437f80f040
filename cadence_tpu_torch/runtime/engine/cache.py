"""Per-workflow execution contexts with canonical identity.

Reference: service/history/historyCache.go — an LRU of
workflowExecutionContext; callers pin an entry, take its lock, mutate,
release. Eviction only removes unpinned, unlocked entries.

Here pinning is implemented by IDENTITY rather than refcount: the LRU
bounds how many contexts stay strongly cached, while a
WeakValueDictionary guarantees that as long as ANY caller still holds a
context for a run, get_or_create returns that same object — eviction
can drop the strong reference but can never mint a second live context
(two contexts would mean two locks, and two writers could interleave
appends under the same next_event_id condition and corrupt history).

A copy of the reference package's ``runtime/engine/cache.py``.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, Tuple

from ...utils.locks import make_lock

from .context import WorkflowExecutionContext


class HistoryCache:
    def __init__(self, make_context: Callable[..., WorkflowExecutionContext],
                 max_size: int = 1024) -> None:
        self._make = make_context
        self._max = max_size
        self._lock = make_lock("HistoryCache._lock")
        self._entries: "OrderedDict[Tuple[str, str, str], WorkflowExecutionContext]" = (
            OrderedDict()
        )
        # every LIVE context, strongly cached or not
        self._live: "weakref.WeakValueDictionary[Tuple[str, str, str], WorkflowExecutionContext]" = (
            weakref.WeakValueDictionary()
        )

    def get_or_create(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> WorkflowExecutionContext:
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            ctx = self._entries.get(key) or self._live.get(key)
            if ctx is None:
                ctx = self._make(domain_id, workflow_id, run_id)
                self._live[key] = ctx
            self._entries[key] = ctx
            self._entries.move_to_end(key)
            while len(self._entries) > self._max:
                old_key, old_ctx = next(iter(self._entries.items()))
                if old_ctx.lock.acquire(blocking=False):
                    old_ctx.lock.release()
                    del self._entries[old_key]
                else:
                    break  # oldest is busy; skip eviction this round
            return ctx

    def evict(self, domain_id: str, workflow_id: str, run_id: str) -> None:
        """Forget the run's cached state (retention/zombification). The
        context object stays canonical for existing holders via the
        weak map, so a concurrent holder keeps a consistent lock; its
        next load() re-reads durable state because the caller clears
        the context's cached mutable state."""
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            ctx = self._entries.pop(key, None) or self._live.get(key)
        if ctx is not None:
            ctx.clear()
