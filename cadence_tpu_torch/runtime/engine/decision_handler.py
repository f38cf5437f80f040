"""Decision application: the 13-type client instruction set.

Reference: service/history/decisionTaskHandler.go (the switch at
:137-173) + decisionChecker.go attribute validation. Each decision
translates into ActiveTransaction adds; validation failures fail the
whole decision task with a typed cause, exactly like the reference's
handleDecisionTaskCompleted failure path.

A copy of the reference package's
``runtime/engine/decision_handler.py``.
"""

from __future__ import annotations

import uuid
from typing import List, Optional, Tuple

from ...core.active_transaction import (
    ActiveTransaction,
    WorkflowStateError,
)
from ...core.enums import (
    ContinueAsNewInitiator,
    DecisionType,
    ParentClosePolicy,
)

from ..api import BadRequestError, Decision


class DecisionFailure(Exception):
    def __init__(self, cause: int, message: str) -> None:
        super().__init__(message)
        self.cause = cause


# DecisionTaskFailedCause values (core.enums.DecisionTaskFailedCause)
_CAUSE_BAD_SCHEDULE_ACTIVITY = 1
_CAUSE_BAD_REQUEST_CANCEL_ACTIVITY = 2
_CAUSE_BAD_START_TIMER = 3
_CAUSE_BAD_CANCEL_TIMER = 4
_CAUSE_BAD_RECORD_MARKER = 5
_CAUSE_BAD_COMPLETE_WORKFLOW = 6
_CAUSE_BAD_FAIL_WORKFLOW = 7
_CAUSE_BAD_CANCEL_WORKFLOW = 8
_CAUSE_BAD_REQUEST_CANCEL_EXTERNAL = 9
_CAUSE_BAD_CONTINUE_AS_NEW = 10
_CAUSE_BAD_START_CHILD = 12
_CAUSE_BAD_SIGNAL_EXTERNAL = 14
_CAUSE_UNHANDLED_DECISION = 15
_CAUSE_BAD_UPSERT_SEARCH_ATTR = 22


class DecisionTaskHandler:
    """Applies one RespondDecisionTaskCompleted's decisions to a txn."""

    def __init__(
        self,
        txn: ActiveTransaction,
        completed_event_id: int,
        now: int,
        identity: str = "",
        had_buffered_events: bool = False,
        started_event_fn=None,
    ) -> None:
        self.txn = txn
        self.completed_id = completed_event_id
        self.now = now
        self.identity = identity
        # lazily fetches the run's WorkflowExecutionStarted event (via
        # the shard events cache) — cron/retry restarts need its input
        self.started_event_fn = started_event_fn
        # captured BEFORE the completion event flushed the buffer — the
        # reference computes hasUnhandledEvents before applying decisions
        self.had_buffered_events = had_buffered_events
        self.workflow_closed = False
        # set when a close decision was dropped because unhandled
        # (buffered) events exist — caller schedules a new decision
        self.unhandled_close_dropped = False

    def handle(self, decisions: List[Decision]) -> None:
        for d in decisions:
            if self.workflow_closed:
                raise DecisionFailure(
                    _CAUSE_UNHANDLED_DECISION,
                    "decision after workflow close decision",
                )
            handler = _HANDLERS.get(d.decision_type)
            if handler is None:
                raise DecisionFailure(
                    _CAUSE_UNHANDLED_DECISION,
                    f"unknown decision type {d.decision_type}",
                )
            handler(self, d.attributes)

    # -- helpers ------------------------------------------------------

    def _require(self, cond: bool, cause: int, msg: str) -> None:
        if not cond:
            raise DecisionFailure(cause, msg)

    def _close_allowed(self) -> bool:
        """A close decision is dropped when buffered events exist — the
        workflow has unhandled work (reference: handleDecisionTaskCompleted
        UnhandledDecision path)."""
        if self.had_buffered_events or self.txn.has_buffered_events():
            self.unhandled_close_dropped = True
            return False
        return True

    # -- per-type handlers --------------------------------------------

    def _schedule_activity(self, a: dict) -> None:
        self._require(
            bool(a.get("activity_id")), _CAUSE_BAD_SCHEDULE_ACTIVITY,
            "activityId is not set",
        )
        self._require(
            bool(a.get("activity_type")), _CAUSE_BAD_SCHEDULE_ACTIVITY,
            "activityType is not set",
        )
        s2c = a.get("schedule_to_close_timeout_seconds", 0)
        s2s = a.get("schedule_to_start_timeout_seconds", 0)
        c2c = a.get("start_to_close_timeout_seconds", 0)
        if s2c:
            s2s = s2s or s2c
            c2c = c2c or s2c
        elif s2s and c2c:
            s2c = s2s + c2c
        else:
            raise DecisionFailure(
                _CAUSE_BAD_SCHEDULE_ACTIVITY,
                "a valid timeout combination is required",
            )
        for v in (s2c, s2s, c2c, a.get("heartbeat_timeout_seconds", 0)):
            self._require(
                v >= 0, _CAUSE_BAD_SCHEDULE_ACTIVITY, "negative timeout"
            )
        retry_policy = a.get("retry_policy")
        if isinstance(retry_policy, dict):
            from ...core.events import RetryPolicy

            retry_policy = RetryPolicy.from_dict(retry_policy)
        if retry_policy is not None:
            from ...utils.backoff import validate_retry_policy

            try:
                validate_retry_policy(retry_policy)
            except (ValueError, TypeError) as e:
                # TypeError covers non-numeric fields from loose JSON
                # ("1" <= 0): every malformed attribute must fail the
                # DECISION, not 500 the respond call into a crash loop
                raise DecisionFailure(_CAUSE_BAD_SCHEDULE_ACTIVITY, str(e))
        try:
            self.txn.add_activity_task_scheduled(
                self.completed_id, self.now,
                activity_id=a["activity_id"],
                activity_type=a.get("activity_type", ""),
                task_list=a.get("task_list", "")
                or self.txn.ms.execution_info.task_list,
                schedule_to_close_timeout_seconds=s2c,
                schedule_to_start_timeout_seconds=s2s,
                start_to_close_timeout_seconds=c2c,
                heartbeat_timeout_seconds=a.get("heartbeat_timeout_seconds", 0),
                input=a.get("input", b""),
                retry_policy=retry_policy,
            )
        except WorkflowStateError as e:
            raise DecisionFailure(_CAUSE_BAD_SCHEDULE_ACTIVITY, str(e))

    def _request_cancel_activity(self, a: dict) -> None:
        activity_id = a.get("activity_id", "")
        self._require(
            bool(activity_id), _CAUSE_BAD_REQUEST_CANCEL_ACTIVITY,
            "activityId is not set",
        )
        event, ai = self.txn.add_activity_task_cancel_requested(
            self.completed_id, activity_id, self.now
        )
        from ...core.ids import EMPTY_EVENT_ID

        if ai is not None and ai.started_id == EMPTY_EVENT_ID:
            # never started: cancel completes immediately
            # (reference: decisionTaskHandler RequestCancelActivity —
            # unstarted activities short-circuit to Canceled)
            self.txn.add_activity_task_canceled(
                ai.schedule_id, event.event_id, self.now
            )

    def _start_timer(self, a: dict) -> None:
        self._require(
            bool(a.get("timer_id")), _CAUSE_BAD_START_TIMER,
            "timerId is not set",
        )
        self._require(
            a.get("start_to_fire_timeout_seconds", 0) > 0,
            _CAUSE_BAD_START_TIMER,
            "a valid StartToFireTimeoutSeconds is not set",
        )
        try:
            self.txn.add_timer_started(
                self.completed_id, a["timer_id"],
                a["start_to_fire_timeout_seconds"], self.now,
            )
        except WorkflowStateError as e:
            raise DecisionFailure(_CAUSE_BAD_START_TIMER, str(e))

    def _cancel_timer(self, a: dict) -> None:
        self._require(
            bool(a.get("timer_id")), _CAUSE_BAD_CANCEL_TIMER,
            "timerId is not set",
        )
        self.txn.add_timer_canceled(
            self.completed_id, a["timer_id"], self.now, identity=self.identity
        )

    def _complete_workflow(self, a: dict) -> None:
        if not self._close_allowed():
            return
        if self._restart_after_close("complete"):
            return
        self.txn.add_workflow_execution_completed(
            self.completed_id, self.now, result=a.get("result", b"")
        )
        self.workflow_closed = True

    def _fail_workflow(self, a: dict) -> None:
        if not self._close_allowed():
            return
        if self._restart_after_close("fail", a.get("reason", "")):
            return
        self.txn.add_workflow_execution_failed(
            self.completed_id, self.now,
            reason=a.get("reason", ""), details=a.get("details", b""),
        )
        self.workflow_closed = True

    def _restart_after_close(self, close: str, reason: str = "") -> bool:
        """Cron/retry continue-as-new instead of closing (reference
        workflowExecutionContext retryWorkflow/cronWorkflow)."""
        from .cron_retry import try_continue_after_close

        try:
            restarted = try_continue_after_close(
                self.txn, self.txn.ms, self.started_event_fn, close,
                self.now, error_reason=reason,
                decision_completed_id=self.completed_id,
            )
        except WorkflowStateError as e:
            raise DecisionFailure(_CAUSE_BAD_CONTINUE_AS_NEW, str(e))
        if restarted:
            self.workflow_closed = True
        return restarted

    def _cancel_workflow(self, a: dict) -> None:
        if not self._close_allowed():
            return
        self._require(
            self.txn.ms.execution_info.cancel_requested,
            _CAUSE_BAD_CANCEL_WORKFLOW,
            "workflow cancellation was not requested",
        )
        self.txn.add_workflow_execution_canceled(
            self.completed_id, self.now, details=a.get("details", b"")
        )
        self.workflow_closed = True

    def _request_cancel_external(self, a: dict) -> None:
        self._require(
            bool(a.get("workflow_id")), _CAUSE_BAD_REQUEST_CANCEL_EXTERNAL,
            "workflowId is not set",
        )
        self.txn.add_request_cancel_external_initiated(
            self.completed_id,
            a.get("domain", "") or self.txn.domain_id,
            a["workflow_id"], a.get("run_id", ""),
            a.get("child_workflow_only", False), self.now,
        )

    def _record_marker(self, a: dict) -> None:
        self._require(
            bool(a.get("marker_name")), _CAUSE_BAD_RECORD_MARKER,
            "markerName is not set",
        )
        self.txn.add_marker_recorded(
            self.completed_id, a["marker_name"], self.now,
            details=a.get("details", b""),
        )

    def _continue_as_new(self, a: dict) -> None:
        if not self._close_allowed():
            return
        ei = self.txn.ms.execution_info
        try:
            self.txn.add_continued_as_new(
                self.completed_id, self.now, str(uuid.uuid4()),
                workflow_type=a.get("workflow_type")
                or ei.workflow_type_name,
                task_list=a.get("task_list", "") or ei.task_list,
                execution_start_to_close_timeout_seconds=a.get(
                    "execution_start_to_close_timeout_seconds", 0
                )
                or ei.workflow_timeout,
                task_start_to_close_timeout_seconds=a.get(
                    "task_start_to_close_timeout_seconds", 0
                )
                or ei.decision_timeout_value,
                input=a.get("input", b""),
                backoff_start_interval_seconds=a.get(
                    "backoff_start_interval_seconds", 0
                ),
                initiator=a.get(
                    "initiator", int(ContinueAsNewInitiator.Decider)
                ),
                cron_schedule=ei.cron_schedule,
            )
        except WorkflowStateError as e:
            raise DecisionFailure(_CAUSE_BAD_CONTINUE_AS_NEW, str(e))
        self.workflow_closed = True

    def _start_child(self, a: dict) -> None:
        self._require(
            bool(a.get("workflow_id")), _CAUSE_BAD_START_CHILD,
            "workflowId is not set",
        )
        self._require(
            bool(a.get("workflow_type")), _CAUSE_BAD_START_CHILD,
            "workflowType is not set",
        )
        self.txn.add_start_child_initiated(
            self.completed_id, self.now,
            domain=a.get("domain", "") or self.txn.domain_id,
            workflow_id=a["workflow_id"],
            workflow_type=a.get("workflow_type", ""),
            task_list=a.get("task_list", "")
            or self.txn.ms.execution_info.task_list,
            input=a.get("input", b""),
            execution_start_to_close_timeout_seconds=a.get(
                "execution_start_to_close_timeout_seconds", 0
            )
            or self.txn.ms.execution_info.workflow_timeout,
            task_start_to_close_timeout_seconds=a.get(
                "task_start_to_close_timeout_seconds", 0
            )
            or self.txn.ms.execution_info.decision_timeout_value,
            parent_close_policy=ParentClosePolicy(
                a.get("parent_close_policy", int(ParentClosePolicy.Terminate))
            ),
        )

    def _signal_external(self, a: dict) -> None:
        self._require(
            bool(a.get("workflow_id")), _CAUSE_BAD_SIGNAL_EXTERNAL,
            "workflowId is not set",
        )
        self._require(
            bool(a.get("signal_name")), _CAUSE_BAD_SIGNAL_EXTERNAL,
            "signalName is not set",
        )
        self.txn.add_signal_external_initiated(
            self.completed_id,
            a.get("domain", "") or self.txn.domain_id,
            a["workflow_id"], a.get("run_id", ""),
            a["signal_name"], a.get("input", b""), a.get("control", b""),
            a.get("child_workflow_only", False), self.now,
        )

    def _upsert_search_attributes(self, a: dict) -> None:
        self._require(
            bool(a.get("search_attributes")), _CAUSE_BAD_UPSERT_SEARCH_ATTR,
            "searchAttributes is not set",
        )
        self.txn.add_upsert_search_attributes(
            self.completed_id, a["search_attributes"], self.now
        )


_HANDLERS = {
    DecisionType.ScheduleActivityTask: DecisionTaskHandler._schedule_activity,
    DecisionType.RequestCancelActivityTask: (
        DecisionTaskHandler._request_cancel_activity
    ),
    DecisionType.StartTimer: DecisionTaskHandler._start_timer,
    DecisionType.CompleteWorkflowExecution: DecisionTaskHandler._complete_workflow,
    DecisionType.FailWorkflowExecution: DecisionTaskHandler._fail_workflow,
    DecisionType.CancelTimer: DecisionTaskHandler._cancel_timer,
    DecisionType.CancelWorkflowExecution: DecisionTaskHandler._cancel_workflow,
    DecisionType.RequestCancelExternalWorkflowExecution: (
        DecisionTaskHandler._request_cancel_external
    ),
    DecisionType.RecordMarker: DecisionTaskHandler._record_marker,
    DecisionType.ContinueAsNewWorkflowExecution: DecisionTaskHandler._continue_as_new,
    DecisionType.StartChildWorkflowExecution: DecisionTaskHandler._start_child,
    DecisionType.SignalExternalWorkflowExecution: DecisionTaskHandler._signal_external,
    DecisionType.UpsertWorkflowSearchAttributes: (
        DecisionTaskHandler._upsert_search_attributes
    ),
}
