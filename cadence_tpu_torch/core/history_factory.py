"""Constructors for every history event type.

The attribute vocabulary here is the framework-wide contract: MutableState
transitions, the tensor packer (ops/pack.py), the active-side
HistoryBuilder, and the test event-graph generator all speak it.

Modeled on the reference's historyBuilder Add*Event constructors
(Cadence service/history/historyBuilder.go) and the per-type
*EventAttributes in the IDL.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .enums import EventType, ParentClosePolicy, TimeoutType
from .events import HistoryEvent, RetryPolicy
from .ids import EMPTY_EVENT_TASK_ID


def _ev(
    event_id: int,
    event_type: EventType,
    version: int,
    timestamp: int,
    attributes: Dict[str, Any],
    task_id: int = EMPTY_EVENT_TASK_ID,
) -> HistoryEvent:
    return HistoryEvent(
        event_id=event_id,
        event_type=event_type,
        version=version,
        timestamp=timestamp,
        task_id=task_id,
        attributes={k: v for k, v in attributes.items() if v is not None},
    )


def workflow_execution_started(
    event_id: int, version: int, timestamp: int, *,
    workflow_type: str = "wf",
    task_list: str = "tl",
    execution_start_to_close_timeout_seconds: int = 60,
    task_start_to_close_timeout_seconds: int = 10,
    input: bytes = b"",
    identity: str = "",
    parent_workflow_domain: Optional[str] = None,
    parent_workflow_id: Optional[str] = None,
    parent_run_id: Optional[str] = None,
    parent_initiated_event_id: Optional[int] = None,
    retry_policy: Optional[RetryPolicy] = None,
    attempt: int = 0,
    expiration_timestamp: int = 0,
    cron_schedule: str = "",
    first_decision_task_backoff_seconds: int = 0,
    initiator: int = 0,
    continued_execution_run_id: str = "",
    memo: Optional[Dict[str, bytes]] = None,
    search_attributes: Optional[Dict[str, bytes]] = None,
) -> HistoryEvent:
    return _ev(event_id, EventType.WorkflowExecutionStarted, version, timestamp, {
        "workflow_type": workflow_type,
        "task_list": task_list,
        "execution_start_to_close_timeout_seconds": execution_start_to_close_timeout_seconds,
        "task_start_to_close_timeout_seconds": task_start_to_close_timeout_seconds,
        "input": input,
        "identity": identity,
        "parent_workflow_domain": parent_workflow_domain,
        "parent_workflow_id": parent_workflow_id,
        "parent_run_id": parent_run_id,
        "parent_initiated_event_id": parent_initiated_event_id,
        "retry_policy": retry_policy.to_dict() if retry_policy else None,
        "attempt": attempt,
        "expiration_timestamp": expiration_timestamp,
        "cron_schedule": cron_schedule,
        "first_decision_task_backoff_seconds": first_decision_task_backoff_seconds,
        "initiator": initiator,
        "continued_execution_run_id": continued_execution_run_id,
        "memo": memo,
        "search_attributes": search_attributes,
    })


def decision_task_scheduled(
    event_id: int, version: int, timestamp: int, *,
    task_list: str = "tl",
    start_to_close_timeout_seconds: int = 10,
    attempt: int = 0,
) -> HistoryEvent:
    return _ev(event_id, EventType.DecisionTaskScheduled, version, timestamp, {
        "task_list": task_list,
        "start_to_close_timeout_seconds": start_to_close_timeout_seconds,
        "attempt": attempt,
    })


def decision_task_started(
    event_id: int, version: int, timestamp: int, *,
    scheduled_event_id: int,
    identity: str = "",
    request_id: str = "",
) -> HistoryEvent:
    return _ev(event_id, EventType.DecisionTaskStarted, version, timestamp, {
        "scheduled_event_id": scheduled_event_id,
        "identity": identity,
        "request_id": request_id,
    })


def decision_task_completed(
    event_id: int, version: int, timestamp: int, *,
    scheduled_event_id: int,
    started_event_id: int,
    identity: str = "",
    binary_checksum: str = "",
) -> HistoryEvent:
    return _ev(event_id, EventType.DecisionTaskCompleted, version, timestamp, {
        "scheduled_event_id": scheduled_event_id,
        "started_event_id": started_event_id,
        "identity": identity,
        "binary_checksum": binary_checksum,
    })


def decision_task_timed_out(
    event_id: int, version: int, timestamp: int, *,
    scheduled_event_id: int,
    started_event_id: int = 0,
    timeout_type: TimeoutType = TimeoutType.StartToClose,
) -> HistoryEvent:
    return _ev(event_id, EventType.DecisionTaskTimedOut, version, timestamp, {
        "scheduled_event_id": scheduled_event_id,
        "started_event_id": started_event_id,
        "timeout_type": int(timeout_type),
    })


def decision_task_failed(
    event_id: int, version: int, timestamp: int, *,
    scheduled_event_id: int,
    started_event_id: int = 0,
    cause: int = 0,
    identity: str = "",
    reason: str = "",
    details: bytes = b"",
    base_run_id: str = "",
    new_run_id: str = "",
    fork_event_version: int = 0,
) -> HistoryEvent:
    return _ev(event_id, EventType.DecisionTaskFailed, version, timestamp, {
        "scheduled_event_id": scheduled_event_id,
        "started_event_id": started_event_id,
        "cause": cause,
        "identity": identity,
        "reason": reason,
        "details": details,
        "base_run_id": base_run_id,
        "new_run_id": new_run_id,
        "fork_event_version": fork_event_version,
    })


def activity_task_scheduled(
    event_id: int, version: int, timestamp: int, *,
    activity_id: str,
    activity_type: str = "act",
    task_list: str = "tl",
    decision_task_completed_event_id: int = 0,
    schedule_to_start_timeout_seconds: int = 10,
    schedule_to_close_timeout_seconds: int = 20,
    start_to_close_timeout_seconds: int = 10,
    heartbeat_timeout_seconds: int = 0,
    input: bytes = b"",
    retry_policy: Optional[RetryPolicy] = None,
) -> HistoryEvent:
    return _ev(event_id, EventType.ActivityTaskScheduled, version, timestamp, {
        "activity_id": activity_id,
        "activity_type": activity_type,
        "task_list": task_list,
        "decision_task_completed_event_id": decision_task_completed_event_id,
        "schedule_to_start_timeout_seconds": schedule_to_start_timeout_seconds,
        "schedule_to_close_timeout_seconds": schedule_to_close_timeout_seconds,
        "start_to_close_timeout_seconds": start_to_close_timeout_seconds,
        "heartbeat_timeout_seconds": heartbeat_timeout_seconds,
        "input": input,
        "retry_policy": retry_policy.to_dict() if retry_policy else None,
    })


def activity_task_started(
    event_id: int, version: int, timestamp: int, *,
    scheduled_event_id: int,
    identity: str = "",
    request_id: str = "",
    attempt: int = 0,
) -> HistoryEvent:
    return _ev(event_id, EventType.ActivityTaskStarted, version, timestamp, {
        "scheduled_event_id": scheduled_event_id,
        "identity": identity,
        "request_id": request_id,
        "attempt": attempt,
    })


def activity_task_completed(
    event_id: int, version: int, timestamp: int, *,
    scheduled_event_id: int,
    started_event_id: int,
    result: bytes = b"",
    identity: str = "",
) -> HistoryEvent:
    return _ev(event_id, EventType.ActivityTaskCompleted, version, timestamp, {
        "scheduled_event_id": scheduled_event_id,
        "started_event_id": started_event_id,
        "result": result,
        "identity": identity,
    })


def activity_task_failed(
    event_id: int, version: int, timestamp: int, *,
    scheduled_event_id: int,
    started_event_id: int,
    reason: str = "",
    details: bytes = b"",
    identity: str = "",
) -> HistoryEvent:
    return _ev(event_id, EventType.ActivityTaskFailed, version, timestamp, {
        "scheduled_event_id": scheduled_event_id,
        "started_event_id": started_event_id,
        "reason": reason,
        "details": details,
        "identity": identity,
    })


def activity_task_timed_out(
    event_id: int, version: int, timestamp: int, *,
    scheduled_event_id: int,
    started_event_id: int,
    timeout_type: TimeoutType = TimeoutType.StartToClose,
    details: bytes = b"",
) -> HistoryEvent:
    return _ev(event_id, EventType.ActivityTaskTimedOut, version, timestamp, {
        "scheduled_event_id": scheduled_event_id,
        "started_event_id": started_event_id,
        "timeout_type": int(timeout_type),
        "details": details,
    })


def activity_task_cancel_requested(
    event_id: int, version: int, timestamp: int, *,
    activity_id: str,
    decision_task_completed_event_id: int = 0,
) -> HistoryEvent:
    return _ev(event_id, EventType.ActivityTaskCancelRequested, version, timestamp, {
        "activity_id": activity_id,
        "decision_task_completed_event_id": decision_task_completed_event_id,
    })


def request_cancel_activity_task_failed(
    event_id: int, version: int, timestamp: int, *,
    activity_id: str,
    cause: str = "ACTIVITY_ID_UNKNOWN",
    decision_task_completed_event_id: int = 0,
) -> HistoryEvent:
    return _ev(event_id, EventType.RequestCancelActivityTaskFailed, version, timestamp, {
        "activity_id": activity_id,
        "cause": cause,
        "decision_task_completed_event_id": decision_task_completed_event_id,
    })


def activity_task_canceled(
    event_id: int, version: int, timestamp: int, *,
    scheduled_event_id: int,
    started_event_id: int,
    latest_cancel_requested_event_id: int = 0,
    details: bytes = b"",
    identity: str = "",
) -> HistoryEvent:
    return _ev(event_id, EventType.ActivityTaskCanceled, version, timestamp, {
        "scheduled_event_id": scheduled_event_id,
        "started_event_id": started_event_id,
        "latest_cancel_requested_event_id": latest_cancel_requested_event_id,
        "details": details,
        "identity": identity,
    })


def timer_started(
    event_id: int, version: int, timestamp: int, *,
    timer_id: str,
    start_to_fire_timeout_seconds: int,
    decision_task_completed_event_id: int = 0,
) -> HistoryEvent:
    return _ev(event_id, EventType.TimerStarted, version, timestamp, {
        "timer_id": timer_id,
        "start_to_fire_timeout_seconds": start_to_fire_timeout_seconds,
        "decision_task_completed_event_id": decision_task_completed_event_id,
    })


def timer_fired(
    event_id: int, version: int, timestamp: int, *,
    timer_id: str,
    started_event_id: int,
) -> HistoryEvent:
    return _ev(event_id, EventType.TimerFired, version, timestamp, {
        "timer_id": timer_id,
        "started_event_id": started_event_id,
    })


def cancel_timer_failed(
    event_id: int, version: int, timestamp: int, *,
    timer_id: str,
    cause: str = "TIMER_ID_UNKNOWN",
    decision_task_completed_event_id: int = 0,
    identity: str = "",
) -> HistoryEvent:
    return _ev(event_id, EventType.CancelTimerFailed, version, timestamp, {
        "timer_id": timer_id,
        "cause": cause,
        "decision_task_completed_event_id": decision_task_completed_event_id,
        "identity": identity,
    })


def timer_canceled(
    event_id: int, version: int, timestamp: int, *,
    timer_id: str,
    started_event_id: int,
    decision_task_completed_event_id: int = 0,
    identity: str = "",
) -> HistoryEvent:
    return _ev(event_id, EventType.TimerCanceled, version, timestamp, {
        "timer_id": timer_id,
        "started_event_id": started_event_id,
        "decision_task_completed_event_id": decision_task_completed_event_id,
        "identity": identity,
    })


def workflow_execution_cancel_requested(
    event_id: int, version: int, timestamp: int, *,
    cause: str = "",
    identity: str = "",
    cancel_request_id: str = "",
    external_initiated_event_id: Optional[int] = None,
    external_workflow_id: Optional[str] = None,
    external_run_id: Optional[str] = None,
) -> HistoryEvent:
    return _ev(event_id, EventType.WorkflowExecutionCancelRequested, version, timestamp, {
        "cause": cause,
        "identity": identity,
        "cancel_request_id": cancel_request_id,
        "external_initiated_event_id": external_initiated_event_id,
        "external_workflow_id": external_workflow_id,
        "external_run_id": external_run_id,
    })


def workflow_execution_signaled(
    event_id: int, version: int, timestamp: int, *,
    signal_name: str = "signal",
    input: bytes = b"",
    identity: str = "",
) -> HistoryEvent:
    return _ev(event_id, EventType.WorkflowExecutionSignaled, version, timestamp, {
        "signal_name": signal_name,
        "input": input,
        "identity": identity,
    })


def marker_recorded(
    event_id: int, version: int, timestamp: int, *,
    marker_name: str = "marker",
    details: bytes = b"",
    decision_task_completed_event_id: int = 0,
    identity: str = "",
) -> HistoryEvent:
    return _ev(event_id, EventType.MarkerRecorded, version, timestamp, {
        "marker_name": marker_name,
        "details": details,
        "decision_task_completed_event_id": decision_task_completed_event_id,
        "identity": identity,
    })


def workflow_execution_completed(
    event_id: int, version: int, timestamp: int, *,
    decision_task_completed_event_id: int = 0,
    result: bytes = b"",
) -> HistoryEvent:
    return _ev(event_id, EventType.WorkflowExecutionCompleted, version, timestamp, {
        "decision_task_completed_event_id": decision_task_completed_event_id,
        "result": result,
    })


def workflow_execution_failed(
    event_id: int, version: int, timestamp: int, *,
    decision_task_completed_event_id: int = 0,
    reason: str = "",
    details: bytes = b"",
) -> HistoryEvent:
    return _ev(event_id, EventType.WorkflowExecutionFailed, version, timestamp, {
        "decision_task_completed_event_id": decision_task_completed_event_id,
        "reason": reason,
        "details": details,
    })


def workflow_execution_timed_out(
    event_id: int, version: int, timestamp: int, *,
    timeout_type: TimeoutType = TimeoutType.StartToClose,
) -> HistoryEvent:
    return _ev(event_id, EventType.WorkflowExecutionTimedOut, version, timestamp, {
        "timeout_type": int(timeout_type),
    })


def workflow_execution_canceled(
    event_id: int, version: int, timestamp: int, *,
    decision_task_completed_event_id: int = 0,
    details: bytes = b"",
) -> HistoryEvent:
    return _ev(event_id, EventType.WorkflowExecutionCanceled, version, timestamp, {
        "decision_task_completed_event_id": decision_task_completed_event_id,
        "details": details,
    })


def workflow_execution_terminated(
    event_id: int, version: int, timestamp: int, *,
    reason: str = "",
    details: bytes = b"",
    identity: str = "",
) -> HistoryEvent:
    return _ev(event_id, EventType.WorkflowExecutionTerminated, version, timestamp, {
        "reason": reason,
        "details": details,
        "identity": identity,
    })


def workflow_execution_continued_as_new(
    event_id: int, version: int, timestamp: int, *,
    new_execution_run_id: str,
    workflow_type: str = "wf",
    task_list: str = "tl",
    decision_task_completed_event_id: int = 0,
    execution_start_to_close_timeout_seconds: int = 60,
    task_start_to_close_timeout_seconds: int = 10,
    input: bytes = b"",
    initiator: int = 0,
    backoff_start_interval_in_seconds: int = 0,
) -> HistoryEvent:
    return _ev(event_id, EventType.WorkflowExecutionContinuedAsNew, version, timestamp, {
        "new_execution_run_id": new_execution_run_id,
        "workflow_type": workflow_type,
        "task_list": task_list,
        "decision_task_completed_event_id": decision_task_completed_event_id,
        "execution_start_to_close_timeout_seconds": execution_start_to_close_timeout_seconds,
        "task_start_to_close_timeout_seconds": task_start_to_close_timeout_seconds,
        "input": input,
        "initiator": initiator,
        "backoff_start_interval_in_seconds": backoff_start_interval_in_seconds,
    })


def request_cancel_external_initiated(
    event_id: int, version: int, timestamp: int, *,
    domain: str,
    workflow_id: str,
    run_id: str = "",
    child_workflow_only: bool = False,
    decision_task_completed_event_id: int = 0,
    control: bytes = b"",
) -> HistoryEvent:
    return _ev(
        event_id, EventType.RequestCancelExternalWorkflowExecutionInitiated,
        version, timestamp, {
            "domain": domain,
            "workflow_id": workflow_id,
            "run_id": run_id,
            "child_workflow_only": child_workflow_only,
            "decision_task_completed_event_id": decision_task_completed_event_id,
            "control": control,
        })


def request_cancel_external_failed(
    event_id: int, version: int, timestamp: int, *,
    initiated_event_id: int,
    domain: str = "",
    workflow_id: str = "",
    run_id: str = "",
    cause: int = 0,
    decision_task_completed_event_id: int = 0,
) -> HistoryEvent:
    return _ev(
        event_id, EventType.RequestCancelExternalWorkflowExecutionFailed,
        version, timestamp, {
            "initiated_event_id": initiated_event_id,
            "domain": domain,
            "workflow_id": workflow_id,
            "run_id": run_id,
            "cause": cause,
            "decision_task_completed_event_id": decision_task_completed_event_id,
        })


def external_workflow_execution_cancel_requested(
    event_id: int, version: int, timestamp: int, *,
    initiated_event_id: int,
    domain: str = "",
    workflow_id: str = "",
    run_id: str = "",
) -> HistoryEvent:
    return _ev(
        event_id, EventType.ExternalWorkflowExecutionCancelRequested,
        version, timestamp, {
            "initiated_event_id": initiated_event_id,
            "domain": domain,
            "workflow_id": workflow_id,
            "run_id": run_id,
        })


def signal_external_initiated(
    event_id: int, version: int, timestamp: int, *,
    domain: str,
    workflow_id: str,
    run_id: str = "",
    signal_name: str = "signal",
    input: bytes = b"",
    child_workflow_only: bool = False,
    decision_task_completed_event_id: int = 0,
    control: bytes = b"",
) -> HistoryEvent:
    return _ev(
        event_id, EventType.SignalExternalWorkflowExecutionInitiated,
        version, timestamp, {
            "domain": domain,
            "workflow_id": workflow_id,
            "run_id": run_id,
            "signal_name": signal_name,
            "input": input,
            "child_workflow_only": child_workflow_only,
            "decision_task_completed_event_id": decision_task_completed_event_id,
            "control": control,
        })


def signal_external_failed(
    event_id: int, version: int, timestamp: int, *,
    initiated_event_id: int,
    domain: str = "",
    workflow_id: str = "",
    run_id: str = "",
    cause: int = 0,
    decision_task_completed_event_id: int = 0,
) -> HistoryEvent:
    return _ev(
        event_id, EventType.SignalExternalWorkflowExecutionFailed,
        version, timestamp, {
            "initiated_event_id": initiated_event_id,
            "domain": domain,
            "workflow_id": workflow_id,
            "run_id": run_id,
            "cause": cause,
            "decision_task_completed_event_id": decision_task_completed_event_id,
        })


def external_workflow_execution_signaled(
    event_id: int, version: int, timestamp: int, *,
    initiated_event_id: int,
    domain: str = "",
    workflow_id: str = "",
    run_id: str = "",
    control: bytes = b"",
) -> HistoryEvent:
    return _ev(
        event_id, EventType.ExternalWorkflowExecutionSignaled,
        version, timestamp, {
            "initiated_event_id": initiated_event_id,
            "domain": domain,
            "workflow_id": workflow_id,
            "run_id": run_id,
            "control": control,
        })


def upsert_workflow_search_attributes(
    event_id: int, version: int, timestamp: int, *,
    search_attributes: Optional[Dict[str, bytes]] = None,
    decision_task_completed_event_id: int = 0,
) -> HistoryEvent:
    return _ev(
        event_id, EventType.UpsertWorkflowSearchAttributes, version, timestamp, {
            "search_attributes": search_attributes or {},
            "decision_task_completed_event_id": decision_task_completed_event_id,
        })


def start_child_initiated(
    event_id: int, version: int, timestamp: int, *,
    domain: str,
    workflow_id: str,
    workflow_type: str = "child_wf",
    task_list: str = "tl",
    decision_task_completed_event_id: int = 0,
    parent_close_policy: ParentClosePolicy = ParentClosePolicy.Terminate,
    input: bytes = b"",
    execution_start_to_close_timeout_seconds: int = 60,
    task_start_to_close_timeout_seconds: int = 10,
) -> HistoryEvent:
    return _ev(
        event_id, EventType.StartChildWorkflowExecutionInitiated,
        version, timestamp, {
            "domain": domain,
            "workflow_id": workflow_id,
            "workflow_type": workflow_type,
            "task_list": task_list,
            "decision_task_completed_event_id": decision_task_completed_event_id,
            "parent_close_policy": int(parent_close_policy),
            "input": input,
            "execution_start_to_close_timeout_seconds": execution_start_to_close_timeout_seconds,
            "task_start_to_close_timeout_seconds": task_start_to_close_timeout_seconds,
        })


def start_child_failed(
    event_id: int, version: int, timestamp: int, *,
    initiated_event_id: int,
    domain: str = "",
    workflow_id: str = "",
    workflow_type: str = "",
    cause: int = 0,
    decision_task_completed_event_id: int = 0,
) -> HistoryEvent:
    return _ev(
        event_id, EventType.StartChildWorkflowExecutionFailed,
        version, timestamp, {
            "initiated_event_id": initiated_event_id,
            "domain": domain,
            "workflow_id": workflow_id,
            "workflow_type": workflow_type,
            "cause": cause,
            "decision_task_completed_event_id": decision_task_completed_event_id,
        })


def child_execution_started(
    event_id: int, version: int, timestamp: int, *,
    initiated_event_id: int,
    domain: str = "",
    workflow_id: str = "",
    run_id: str = "",
    workflow_type: str = "",
) -> HistoryEvent:
    return _ev(
        event_id, EventType.ChildWorkflowExecutionStarted, version, timestamp, {
            "initiated_event_id": initiated_event_id,
            "domain": domain,
            "workflow_id": workflow_id,
            "run_id": run_id,
            "workflow_type": workflow_type,
        })


def _child_closed(
    et: EventType, event_id: int, version: int, timestamp: int,
    initiated_event_id: int, started_event_id: int, extra: Dict[str, Any],
) -> HistoryEvent:
    base = {
        "initiated_event_id": initiated_event_id,
        "started_event_id": started_event_id,
    }
    base.update(extra)
    return _ev(event_id, et, version, timestamp, base)


def child_execution_completed(
    event_id: int, version: int, timestamp: int, *,
    initiated_event_id: int, started_event_id: int, result: bytes = b"",
) -> HistoryEvent:
    return _child_closed(
        EventType.ChildWorkflowExecutionCompleted, event_id, version, timestamp,
        initiated_event_id, started_event_id, {"result": result})


def child_execution_failed(
    event_id: int, version: int, timestamp: int, *,
    initiated_event_id: int, started_event_id: int,
    reason: str = "", details: bytes = b"",
) -> HistoryEvent:
    return _child_closed(
        EventType.ChildWorkflowExecutionFailed, event_id, version, timestamp,
        initiated_event_id, started_event_id, {"reason": reason, "details": details})


def child_execution_canceled(
    event_id: int, version: int, timestamp: int, *,
    initiated_event_id: int, started_event_id: int, details: bytes = b"",
) -> HistoryEvent:
    return _child_closed(
        EventType.ChildWorkflowExecutionCanceled, event_id, version, timestamp,
        initiated_event_id, started_event_id, {"details": details})


def child_execution_timed_out(
    event_id: int, version: int, timestamp: int, *,
    initiated_event_id: int, started_event_id: int,
    timeout_type: TimeoutType = TimeoutType.StartToClose,
) -> HistoryEvent:
    return _child_closed(
        EventType.ChildWorkflowExecutionTimedOut, event_id, version, timestamp,
        initiated_event_id, started_event_id, {"timeout_type": int(timeout_type)})


def child_execution_terminated(
    event_id: int, version: int, timestamp: int, *,
    initiated_event_id: int, started_event_id: int,
) -> HistoryEvent:
    return _child_closed(
        EventType.ChildWorkflowExecutionTerminated, event_id, version, timestamp,
        initiated_event_id, started_event_id, {})
