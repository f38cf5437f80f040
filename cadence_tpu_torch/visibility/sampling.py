"""Visibility write sampling.

Reference: common/persistence/visibilitySamplingClient.go — per-domain
token buckets shed visibility writes under load; closed-workflow records
are prioritized over started/upserts (losing an open record is
recoverable, losing a close is not).

A copy of the reference package's ``visibility/sampling.py``.
"""

from __future__ import annotations

from typing import Dict

from ..runtime.persistence.interfaces import VisibilityManager
from ..utils.quotas import TokenBucket


class SamplingVisibilityClient(VisibilityManager):
    def __init__(
        self,
        base: VisibilityManager,
        open_rps: float = 300.0,
        closed_rps: float = 300.0,
    ) -> None:
        self.base = base
        self._open_rps = open_rps
        self._closed_rps = closed_rps
        self._open_buckets: Dict[str, TokenBucket] = {}
        self._closed_buckets: Dict[str, TokenBucket] = {}
        self.dropped = {"open": 0, "closed": 0}

    def _allow(self, buckets, rps, domain_id: str) -> bool:
        b = buckets.get(domain_id)
        if b is None:
            b = buckets[domain_id] = TokenBucket(rps)
        return b.allow()

    # -- sampled writes ------------------------------------------------

    def record_workflow_execution_started(self, rec) -> None:
        if self._allow(self._open_buckets, self._open_rps, rec.domain_id):
            self.base.record_workflow_execution_started(rec)
        else:
            self.dropped["open"] += 1

    def upsert_workflow_execution(self, rec) -> None:
        if self._allow(self._open_buckets, self._open_rps, rec.domain_id):
            self.base.upsert_workflow_execution(rec)
        else:
            self.dropped["open"] += 1

    def record_workflow_execution_closed(self, rec) -> None:
        if self._allow(self._closed_buckets, self._closed_rps, rec.domain_id):
            self.base.record_workflow_execution_closed(rec)
        else:
            self.dropped["closed"] += 1

    # -- reads / deletes pass through ----------------------------------

    def list_open_workflow_executions(self, *a, **kw):
        return self.base.list_open_workflow_executions(*a, **kw)

    def list_closed_workflow_executions(self, *a, **kw):
        return self.base.list_closed_workflow_executions(*a, **kw)

    def get_closed_workflow_execution(self, *a, **kw):
        return self.base.get_closed_workflow_execution(*a, **kw)

    def count_workflow_executions(self, *a, **kw):
        return self.base.count_workflow_executions(*a, **kw)

    def delete_workflow_execution(self, *a, **kw):
        return self.base.delete_workflow_execution(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.base, name)
