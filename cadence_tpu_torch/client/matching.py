"""Matching client: thin routed wrapper over MatchingEngine hosts.

Reference: Cadence client/matching/client.go — routes by task
list name through the membership ring; the in-process transport keeps a
host registry and a load-balancer hook mirroring
client/matching/loadbalancer.go.

A copy of the reference package's ``client/matching.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..runtime.membership import Monitor


class MatchingClient:
    def __init__(self, engines, monitor: Optional[Monitor] = None) -> None:
        """``engines``: MatchingEngine, or {host identity → engine}."""
        if not isinstance(engines, dict):
            engines = {"matching": engines}
        self._engines: Dict[str, object] = dict(engines)
        # public: routing AND best-effort ring-owner decoration by
        # callers (RoutedMatchingClient overwrites with its own)
        self.monitor = monitor

    def _engine_for(self, task_list: str):
        if len(self._engines) == 1 or self.monitor is None:
            return next(iter(self._engines.values()))
        host = self.monitor.resolver("matching").lookup(task_list).identity
        return self._engines.get(host) or next(iter(self._engines.values()))

    def _invoke(self, task_list: str, method: str, *args, **kwargs):
        """Single routing hook every public method funnels through —
        RoutedMatchingClient overrides it with a ring-re-resolving
        retry loop (reference client/matching/retryableClient.go)."""
        return getattr(self._engine_for(task_list), method)(*args, **kwargs)

    def add_decision_task(self, domain_id, workflow_id, run_id, task_list,
                          schedule_id, schedule_to_start_timeout_seconds=0):
        return self._invoke(
            task_list, "add_decision_task", domain_id, workflow_id, run_id,
            task_list, schedule_id, schedule_to_start_timeout_seconds,
        )

    def add_activity_task(self, domain_id, workflow_id, run_id, task_list,
                          schedule_id, schedule_to_start_timeout_seconds=0):
        return self._invoke(
            task_list, "add_activity_task", domain_id, workflow_id, run_id,
            task_list, schedule_id, schedule_to_start_timeout_seconds,
        )

    def poll_for_decision_task(self, request):
        return self._invoke(
            request.task_list, "poll_for_decision_task", request
        )

    def poll_for_activity_task(self, request):
        return self._invoke(
            request.task_list, "poll_for_activity_task", request
        )

    def describe_task_list(self, domain_id, name, task_type):
        return self._invoke(
            name, "describe_task_list", domain_id, name, task_type
        )

    def list_task_list_partitions(self, domain_id, name):
        return self._invoke(
            name, "list_task_list_partitions", domain_id, name
        )

    def cancel_outstanding_polls(self, domain_id, name, task_type):
        return self._invoke(
            name, "cancel_outstanding_polls", domain_id, name, task_type
        )

    def query_workflow(self, domain_id, task_list, workflow_id, run_id,
                       query_type, query_args=b"", timeout_s=10.0):
        return self._invoke(
            task_list, "query_workflow", domain_id, task_list, workflow_id,
            run_id, query_type, query_args, timeout_s,
        )

    def respond_query_task_completed(self, task_list, query_id,
                                     result=b"", error=""):
        return self._invoke(
            task_list, "respond_query_task_completed", query_id, result,
            error
        )
