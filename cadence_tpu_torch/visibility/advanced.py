"""Advanced visibility store: query-language reads over any base store.

Reference: common/persistence/elasticsearch/esVisibilityStore.go — the
ES-backed store serving ListWorkflowExecutions(query)/Scan/Count. Here
the base is any VisibilityManager (memory/sqlite); advanced reads pull
the domain's records and apply the compiled predicate, keeping the
five-manager contract unchanged.

A copy of the reference package's ``visibility/advanced.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..runtime.persistence.interfaces import VisibilityManager
from ..runtime.persistence.records import VisibilityRecord

from .query import compile_query


class AdvancedVisibilityStore(VisibilityManager):
    """Decorator adding query-language reads to a base store."""

    def __init__(self, base: VisibilityManager) -> None:
        self.base = base

    # -- writes delegate -----------------------------------------------

    def record_workflow_execution_started(self, rec) -> None:
        self.base.record_workflow_execution_started(rec)

    def record_workflow_execution_closed(self, rec) -> None:
        self.base.record_workflow_execution_closed(rec)

    def upsert_workflow_execution(self, rec) -> None:
        self.base.upsert_workflow_execution(rec)

    def delete_workflow_execution(self, domain_id, workflow_id, run_id):
        self.base.delete_workflow_execution(domain_id, workflow_id, run_id)

    # -- basic reads delegate ------------------------------------------

    def list_open_workflow_executions(self, *a, **kw):
        return self.base.list_open_workflow_executions(*a, **kw)

    def list_closed_workflow_executions(self, *a, **kw):
        return self.base.list_closed_workflow_executions(*a, **kw)

    def get_closed_workflow_execution(self, *a, **kw):
        return self.base.get_closed_workflow_execution(*a, **kw)

    def count_workflow_executions(self, *a, **kw):
        return self.base.count_workflow_executions(*a, **kw)

    # -- advanced reads ------------------------------------------------

    def _all_records(self, domain_id: str) -> List[VisibilityRecord]:
        open_recs, _ = self.base.list_open_workflow_executions(
            domain_id, page_size=1 << 30
        )
        closed_recs, _ = self.base.list_closed_workflow_executions(
            domain_id, page_size=1 << 30
        )
        return list(open_recs) + list(closed_recs)

    def list_workflow_executions(
        self,
        domain_id: str,
        query: str = "",
        page_size: int = 100,
        next_token: int = 0,
    ) -> Tuple[List[VisibilityRecord], int]:
        if page_size <= 0:
            page_size = 100  # a non-positive size would loop the
            # caller forever on the same token with empty pages
        compiled = compile_query(query)
        matched = compiled.apply(self._all_records(domain_id))
        if not compiled.order_field:
            matched.sort(key=lambda r: -r.start_time)  # newest first
        page = matched[next_token : next_token + page_size]
        new_token = next_token + len(page)
        return page, (new_token if new_token < len(matched) else 0)

    def scan_workflow_executions(
        self, domain_id: str, query: str = "",
        page_size: int = 100, next_token: int = 0,
    ) -> Tuple[List[VisibilityRecord], int]:
        return self.list_workflow_executions(
            domain_id, query, page_size, next_token
        )

    def count_workflow_executions_by_query(
        self, domain_id: str, query: str = ""
    ) -> int:
        compiled = compile_query(query)
        return len(compiled.apply(self._all_records(domain_id)))
