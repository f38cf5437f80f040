"""History client: workflowID → shard → owning host → engine.

Reference: Cadence client/history/client.go (GetClientForKey
routing :844-846) + clientBean. Every call resolves the target shard's
engine at call time, so shard movement between calls is handled by the
receiving controller (ShardOwnershipLostError surfaces to the caller,
which retries after the ring settles — retryableClient.go).

A copy of the reference package's ``client/history.py``.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, Optional

from ..runtime.api import ServiceBusyError
from ..runtime.controller import (
    ShardController,
    ShardOwnershipLostError,
)
from ..runtime.persistence.errors import (
    ShardOwnershipLostError as PersistenceShardOwnershipLost,
)
from ..utils.metrics import NOOP, Scope
from ..utils.quotas import RetryBudget

# Bounded ownership-lost retry (reference retryableClient.go): every
# attempt re-resolves through the controllers, so a shard mid-move —
# reshard handoff or plain membership churn — is found at its new
# owner once the routing epoch flips. Jittered exponential backoff
# decorrelates the thundering herd of callers all retrying the same
# moved shard.
_OWNERSHIP_RETRY = 6
_OWNERSHIP_BACKOFF_S = 0.05
_OWNERSHIP_BACKOFF_MAX_S = 1.0

# ServiceBusy retries are BUDGETED, not merely bounded: a
# saturated server shedding load must not see every rejection come
# straight back N more times — that multiplies the overload it is
# shedding. The budget refills on successes, so a healthy client
# retries transient sheds freely while a client facing sustained
# overload converges to ~offered × (1 + ratio).
_BUSY_RETRY = 3
_BUSY_BACKOFF_MAX_S = 2.0


def _ownership_backoff_s(attempt: int, rng=random) -> float:
    base = min(
        _OWNERSHIP_BACKOFF_S * (2 ** (attempt - 1)), _OWNERSHIP_BACKOFF_MAX_S
    )
    return base * rng.uniform(0.5, 1.5)


def _busy_backoff_s(e: ServiceBusyError, attempt: int) -> float:
    """Honor the shed response's retry-after hint; fall back to the
    ownership backoff schedule when the server sent none."""
    hint = getattr(e, "retry_after_s", 0.0) or 0.0
    if hint > 0:
        return min(hint, _BUSY_BACKOFF_MAX_S)
    return _ownership_backoff_s(attempt)


class HistoryClient:
    """Routes engine calls through one or more in-process controllers.

    ``controllers`` maps host identity → ShardController; the owning
    host for a shard is whichever controller claims it. A single-host
    deployment passes one controller.
    """

    def __init__(
        self,
        controllers,
        retry_budget: Optional[RetryBudget] = None,
        metrics: Scope = NOOP,
    ) -> None:
        if isinstance(controllers, ShardController):
            controllers = {controllers.identity: controllers}
        self._controllers: Dict[str, ShardController] = dict(controllers)
        # per-client ServiceBusy retry budget (token bucket refilled by
        # successes); pass a shared instance to make several clients
        # share one budget, or None for the default
        self.retry_budget = retry_budget or RetryBudget()
        self._client_metrics = metrics.tagged(layer="client")

    def add_host(self, controller: ShardController) -> None:
        self._controllers[controller.identity] = controller

    def remove_host(self, identity: str) -> None:
        self._controllers.pop(identity, None)

    def _engine_for(self, workflow_id: str):
        """ONE ring/shard-map pass over the controllers (retry policy
        lives in _call, wrapping the engine invocation too)."""
        last_err = None
        for controller in self._controllers.values():
            try:
                return controller.get_engine(workflow_id)
            except ShardOwnershipLostError as e:
                last_err = e
        raise last_err or ShardOwnershipLostError(-1, "<unknown>")

    def _call(self, workflow_id: str, method: str, *args, **kwargs):
        """Dispatch under the ServiceBusy retry budget: a shed response
        (retryable, carries retry-after) is re-offered after its hint
        — but each re-offer WITHDRAWS a budget token, and the budget
        refills only on successes. Exhausted budget (or attempts) ⇒
        the shed surfaces to the caller; ``retry_budget_exhausted``
        counts the former — the retry-storm breaker observable."""
        attempt = 0
        while True:
            try:
                out = self._call_inner(
                    workflow_id, method, *args, **kwargs
                )
                self.retry_budget.record_success()
                return out
            except ServiceBusyError as e:
                attempt += 1
                if attempt > _BUSY_RETRY:
                    raise
                if not self.retry_budget.can_retry():
                    self._client_metrics.inc("retry_budget_exhausted")
                    raise
                time.sleep(_busy_backoff_s(e, attempt))

    def _call_inner(self, workflow_id: str, method: str, *args, **kwargs):
        """Resolve + invoke under a bounded ownership-lost retry: BOTH
        shapes — the controller's (no local handle) and the persistence
        rangeID-fencing sibling raised mid-call by a fenced/stolen
        shard — re-resolve and retry instead of surfacing to callers
        (frontends saw the raw error during any ownership change).
        Retried attempts ride the active trace as ``retry`` spans
        (utils/tracing.py), so a chaos/reshard run's recovery path is
        readable off the flight recorder instead of correlated from
        logs."""
        from ..utils.tracing import TRACER

        last_err = None
        for attempt in range(_OWNERSHIP_RETRY):
            if attempt:
                time.sleep(_ownership_backoff_s(attempt))
            try:
                if attempt == 0:
                    engine = self._engine_for(workflow_id)
                    return getattr(engine, method)(*args, **kwargs)
                with TRACER.span(
                    f"retry.{method}", service="history_client",
                    attempt=attempt,
                ) as span:
                    span.annotate(
                        f"ownership_lost retry attempt={attempt} "
                        f"({type(last_err).__name__})"
                    )
                    engine = self._engine_for(workflow_id)
                    return getattr(engine, method)(*args, **kwargs)
            except (ShardOwnershipLostError,
                    PersistenceShardOwnershipLost) as e:
                last_err = e
        raise last_err

    # -- workflow mutations (routed by workflow_id) --------------------

    def start_workflow_execution(self, request, **kwargs):
        return self._call(
            request.workflow_id, "start_workflow_execution", request, **kwargs
        )

    def signal_workflow_execution(self, request):
        return self._call(
            request.workflow_id, "signal_workflow_execution", request
        )

    def signal_with_start_workflow_execution(self, request):
        return self._call(
            request.start.workflow_id,
            "signal_with_start_workflow_execution",
            request,
        )

    def terminate_workflow_execution(self, domain_name, workflow_id, run_id="",
                                     **kwargs):
        return self._call(
            workflow_id, "terminate_workflow_execution", domain_name,
            workflow_id, run_id, **kwargs
        )

    def request_cancel_workflow_execution(self, domain_name, workflow_id,
                                          run_id="", **kwargs):
        return self._call(
            workflow_id, "request_cancel_workflow_execution", domain_name,
            workflow_id, run_id, **kwargs
        )

    def record_decision_task_started(self, domain_id, workflow_id, run_id,
                                     schedule_id, request_id, identity=""):
        return self._call(
            workflow_id, "record_decision_task_started", domain_id,
            workflow_id, run_id, schedule_id, request_id, identity,
        )

    def record_activity_task_started(self, domain_id, workflow_id, run_id,
                                     schedule_id, request_id, identity=""):
        return self._call(
            workflow_id, "record_activity_task_started", domain_id,
            workflow_id, run_id, schedule_id, request_id, identity,
        )

    def respond_decision_task_completed(self, task_token, decisions, **kwargs):
        return self._call(
            task_token["workflow_id"], "respond_decision_task_completed",
            task_token, decisions, **kwargs
        )

    def respond_decision_task_failed(self, task_token, **kwargs):
        return self._call(
            task_token["workflow_id"], "respond_decision_task_failed",
            task_token, **kwargs
        )

    def respond_activity_task_completed(self, task_token, **kwargs):
        return self._call(
            task_token["workflow_id"], "respond_activity_task_completed",
            task_token, **kwargs
        )

    def respond_activity_task_failed(self, task_token, **kwargs):
        return self._call(
            task_token["workflow_id"], "respond_activity_task_failed",
            task_token, **kwargs
        )

    def respond_activity_task_canceled(self, task_token, **kwargs):
        return self._call(
            task_token["workflow_id"], "respond_activity_task_canceled",
            task_token, **kwargs
        )

    def record_activity_task_heartbeat(self, task_token, **kwargs):
        return self._call(
            task_token["workflow_id"], "record_activity_task_heartbeat",
            task_token, **kwargs
        )

    def record_child_execution_completed(self, domain_id, workflow_id, run_id,
                                         initiated_id, close_event_type,
                                         **close_attrs):
        return self._call(
            workflow_id, "record_child_execution_completed", domain_id,
            workflow_id, run_id, initiated_id, close_event_type,
            **close_attrs
        )

    # -- reads ---------------------------------------------------------

    def get_workflow_execution_history(self, domain_name, workflow_id,
                                       run_id="", **kwargs):
        return self._call(
            workflow_id, "get_workflow_execution_history", domain_name,
            workflow_id, run_id, **kwargs
        )

    def describe_workflow_execution(self, domain_name, workflow_id, run_id=""):
        return self._call(
            workflow_id, "describe_workflow_execution", domain_name,
            workflow_id, run_id,
        )

    def query_workflow(self, domain_name, workflow_id, run_id="", **kwargs):
        return self._call(
            workflow_id, "query_workflow", domain_name, workflow_id, run_id,
            **kwargs
        )

    def reset_workflow_execution(self, domain_name, workflow_id, run_id="",
                                 **kwargs):
        return self._call(
            workflow_id, "reset_workflow_execution", domain_name,
            workflow_id, run_id, **kwargs
        )

    def reset_sticky_task_list(self, domain_name, workflow_id, run_id="",
                               **kwargs):
        return self._call(
            workflow_id, "reset_sticky_task_list", domain_name, workflow_id,
            run_id, **kwargs
        )
