"""Consistent-query registry: buffered → started → completed.

Reference: service/history/queryRegistry.go + queryStateMachine.go:40-77
— queries against a workflow with a pending decision task are buffered
and piggybacked on the next decision task dispatch
(RecordDecisionTaskStarted response carries them); the worker answers
them in RespondDecisionTaskCompleted.query_results. Queries against an
idle workflow dispatch directly to matching (sync query task).

A copy of the reference package's ``runtime/engine/query.py``.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple


class QueryStateName:
    BUFFERED = 0
    STARTED = 1
    COMPLETED = 2


class QueryState:
    """One in-flight query's 3-state machine."""

    def __init__(self, query_type: str, query_args: bytes) -> None:
        self.id = str(uuid.uuid4())
        self.query_type = query_type
        self.query_args = query_args
        self.state = QueryStateName.BUFFERED
        self.result: Optional[bytes] = None
        self.error: Optional[str] = None
        self._done = threading.Event()

    def start(self) -> None:
        if self.state == QueryStateName.BUFFERED:
            self.state = QueryStateName.STARTED

    def complete(self, result: Optional[bytes], error: Optional[str]) -> None:
        self.state = QueryStateName.COMPLETED
        self.result = result
        self.error = error
        self._done.set()

    def wait(self, timeout_s: float) -> bool:
        return self._done.wait(timeout_s)


class QueryRegistry:
    """Per-shard registry keyed by workflow run."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._queries: Dict[Tuple[str, str, str], List[QueryState]] = {}

    def buffer(
        self, domain_id: str, workflow_id: str, run_id: str,
        query_type: str, query_args: bytes,
    ) -> QueryState:
        q = QueryState(query_type, query_args)
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            self._queries.setdefault(key, []).append(q)
        return q

    def take_buffered(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> List[QueryState]:
        """Queries to attach to a decision task dispatch: buffered ones
        move to started; already-started-but-unanswered ones are
        RE-attached (the worker that first carried them may have died —
        re-delivery keeps them answerable until the caller times out)."""
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            out = [
                q
                for q in self._queries.get(key, [])
                if q.state != QueryStateName.COMPLETED
            ]
            for q in out:
                q.start()
        return out

    def buffered_count(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> int:
        """Queries not yet attached to any decision dispatch — the count
        that justifies scheduling a fresh decision task."""
        with self._lock:
            return sum(
                1
                for q in self._queries.get(
                    (domain_id, workflow_id, run_id), []
                )
                if q.state == QueryStateName.BUFFERED
            )

    def complete(
        self, domain_id: str, workflow_id: str, run_id: str,
        results: Dict[str, Dict[str, Any]],
    ) -> int:
        """Complete queries by id from a worker's query_results map
        ({query_id: {"result": bytes} | {"error": str}})."""
        key = (domain_id, workflow_id, run_id)
        done = 0
        with self._lock:
            pending = self._queries.get(key, [])
            by_id = {q.id: q for q in pending}
            for qid, res in results.items():
                q = by_id.get(qid)
                if q is None:
                    continue
                q.complete(res.get("result"), res.get("error"))
                done += 1
            self._queries[key] = [
                q for q in pending if q.state != QueryStateName.COMPLETED
            ]
            if not self._queries[key]:
                del self._queries[key]
        return done

    def fail(
        self, domain_id: str, workflow_id: str, run_id: str,
        query: QueryState, error: str,
    ) -> None:
        """Fail ONE query (e.g. its caller's timeout) without touching
        other callers' pending queries on the same run."""
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            pending = self._queries.get(key, [])
            if query in pending:
                pending.remove(query)
                if not pending:
                    del self._queries[key]
        query.complete(None, error)

    def fail_all(
        self, domain_id: str, workflow_id: str, run_id: str, error: str
    ) -> None:
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            for q in self._queries.pop(key, []):
                q.complete(None, error)

    def pending_count(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> int:
        with self._lock:
            return len(self._queries.get((domain_id, workflow_id, run_id), []))
