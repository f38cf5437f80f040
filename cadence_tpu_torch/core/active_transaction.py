"""Active-side event creation: one RPC = one ActiveTransaction.

The reference splits the active path across historyBuilder (44 Add*Event
constructors), mutableStateBuilder (92 Add*/Replicate* methods) and
mutableStateTaskGenerator (Cadence service/history/
historyBuilder.go, mutableStateBuilder.go, mutableStateTaskGenerator.go).
Here the active path is "create events, then replay them through the
SAME StateBuilder the passive/rebuild path uses" — state mutation and
task generation are never implemented twice, so active and replay
semantics cannot diverge (the property the reference maintains by
hand-mirroring stateBuilder and taskGenerator).

Buffered events (reference mutableStateBuilder.go:95-97): while a
decision task is in flight, externally-caused events (signals, activity
results, timer fires, child/external resolutions) are held in
``ms.buffered_events`` with no event IDs and flushed — IDs assigned —
into the batch right after the decision-close event, so history reads
DecisionTaskStarted … DecisionTaskCompleted, Signal, … exactly as the
reference orders it.

Transient decisions (reference mutableStateDecisionTaskManager.go):
after a decision fails/times out, subsequent attempts are tracked
in-memory only; their Scheduled/Started events materialize at the front
of the completion batch. Activity Started events are likewise lazy
(reference RecordActivityTaskStarted writes no event): started info
lives in ActivityInfo until the activity closes, when the Started event
materializes immediately before the close event.

A copy of the reference package's ``core/active_transaction.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import history_factory as F
from . import tasks as T
from .enums import (
    CloseStatus,
    ContinueAsNewInitiator,
    EventType,
    ParentClosePolicy,
    TimeoutType,
)
from .events import HistoryEvent, RetryPolicy
from .ids import (
    BUFFERED_EVENT_ID,
    EMPTY_EVENT_ID,
    EMPTY_UUID,
    TRANSIENT_EVENT_ID,
)
from .mutable_state import ActivityInfo, DecisionInfo, MutableState, SECOND
from .state_builder import StateBuilder


class WorkflowStateError(Exception):
    """The operation is illegal in the workflow's current state
    (reference: BadRequestError / mutable-state-mutability failures)."""


@dataclasses.dataclass
class TransactionResult:
    """Everything a closed transaction hands to persistence."""

    events: List[HistoryEvent]
    transfer_tasks: List[T.TransferTask]
    timer_tasks: List[T.TimerTask]
    new_run_events: List[HistoryEvent] = dataclasses.field(default_factory=list)
    new_run_ms: Optional[MutableState] = None
    new_run_transfer_tasks: List[T.TransferTask] = dataclasses.field(default_factory=list)
    new_run_timer_tasks: List[T.TimerTask] = dataclasses.field(default_factory=list)


# event types held back while a decision is in flight
# (reference: mutableStateBuilder.shouldBufferEvent)
_BUFFERABLE = frozenset(
    {
        EventType.ActivityTaskStarted,
        EventType.ActivityTaskCompleted,
        EventType.ActivityTaskFailed,
        EventType.ActivityTaskTimedOut,
        EventType.ActivityTaskCanceled,
        EventType.TimerFired,
        EventType.WorkflowExecutionSignaled,
        EventType.StartChildWorkflowExecutionFailed,
        EventType.ChildWorkflowExecutionStarted,
        EventType.ChildWorkflowExecutionCompleted,
        EventType.ChildWorkflowExecutionFailed,
        EventType.ChildWorkflowExecutionCanceled,
        EventType.ChildWorkflowExecutionTimedOut,
        EventType.ChildWorkflowExecutionTerminated,
        EventType.ExternalWorkflowExecutionCancelRequested,
        EventType.ExternalWorkflowExecutionSignaled,
        EventType.RequestCancelExternalWorkflowExecutionFailed,
        EventType.SignalExternalWorkflowExecutionFailed,
    }
)


class ActiveTransaction:
    def __init__(
        self,
        ms: MutableState,
        domain_id: str,
        workflow_id: str,
        run_id: str,
        version: int,
        request_id: str = "",
        domain_resolver: Callable[[str], str] = lambda name: name,
        id_generator: Callable[[], str] = None,
        retention_days: int = 1,
    ) -> None:
        import uuid as _uuid

        self.ms = ms
        self.domain_id = domain_id
        self.workflow_id = workflow_id
        self.run_id = run_id
        self.version = version
        self.request_id = request_id
        self.id_generator = id_generator or (lambda: str(_uuid.uuid4()))
        self.domain_resolver = domain_resolver
        self.retention_days = retention_days
        self.batch: List[HistoryEvent] = []
        # batch-local dedup sets (state only updates at close-replay)
        self._batch_activity_ids: set = set()
        self._batch_timer_ids: set = set()
        self._batch_canceled_timers: set = set()
        self._closed_in_batch = False
        self._decision_closed_in_batch = False
        self._extra_transfer: List[T.TransferTask] = []
        self._extra_timer: List[T.TimerTask] = []
        self._new_run_events: List[HistoryEvent] = []

    # -- plumbing -----------------------------------------------------

    def schedule_transfer_task(self, task: T.TransferTask) -> None:
        """Stage an out-of-band transfer task (queue processors)."""
        self._extra_transfer.append(task)

    def schedule_timer_task(self, task: T.TimerTask) -> None:
        """Stage an out-of-band timer task (timer re-arm, retry timers)."""
        self._extra_timer.append(task)

    def _next_id(self) -> int:
        return self.ms.next_event_id + len(self.batch)

    def _require_running(self) -> None:
        if self._closed_in_batch or not self.ms.is_workflow_execution_running():
            raise WorkflowStateError(
                f"workflow {self.workflow_id} is not running"
            )

    def _add(self, make: Callable[[int], HistoryEvent]) -> HistoryEvent:
        """Create an event; route to batch or buffer."""
        probe = make(BUFFERED_EVENT_ID)
        if (
            probe.event_type in _BUFFERABLE
            and self.ms.has_inflight_decision()
            # a decision closed earlier in this batch clears the
            # in-flight state at close-replay; nothing to buffer behind
            and not self._decision_closed_in_batch
        ):
            self.ms.buffered_events.append(probe)
            return probe
        event = make(self._next_id())
        self.batch.append(event)
        return event

    def _flush_buffered(self) -> None:
        """Assign IDs to buffered events and append them to the batch
        (called right after a decision-close event enters the batch).

        Cross-references are patched the way the reference's
        assignEventIDToBufferedEvents does: a close event buffered
        before its lazily-materialized started event carries a sentinel
        ``started_event_id`` — once the started event gets its real id,
        every sibling referencing the same scheduled/initiated event is
        rewritten to it."""
        started_by_sched: dict = {}   # scheduled_event_id → started id
        started_by_init: dict = {}    # initiated_event_id → started id
        for event in self.ms.buffered_events:
            event.event_id = self._next_id()
            self.batch.append(event)
            a = event.attributes
            if event.event_type == EventType.ActivityTaskStarted:
                started_by_sched[a.get("scheduled_event_id")] = (
                    event.event_id
                )
            elif event.event_type == EventType.ChildWorkflowExecutionStarted:
                started_by_init[a.get("initiated_event_id")] = (
                    event.event_id
                )
        for event in self.batch:
            a = event.attributes
            sid = a.get("started_event_id")
            if sid is None or sid >= 0:
                continue
            real = started_by_sched.get(a.get("scheduled_event_id"))
            if real is None:
                real = started_by_init.get(a.get("initiated_event_id"))
            if real is not None:
                a["started_event_id"] = real
        self.ms.buffered_events = []

    def _buffered(self, event_type: EventType, **attr_match: Any) -> bool:
        for e in self.ms.buffered_events:
            if e.event_type == event_type and all(
                e.attributes.get(k) == v for k, v in attr_match.items()
            ):
                return True
        return False

    def has_buffered_events(self) -> bool:
        return bool(self.ms.buffered_events)

    # -- workflow start ----------------------------------------------

    def add_workflow_execution_started(
        self, now: int, **attrs: Any
    ) -> HistoryEvent:
        if self.ms.execution_info.start_timestamp or self.batch:
            raise WorkflowStateError("workflow already started")
        event = F.workflow_execution_started(
            self._next_id(), self.version, now, **attrs
        )
        self.batch.append(event)
        return event

    # -- decision lifecycle ------------------------------------------

    def add_decision_task_scheduled(
        self, now: int, task_list: str = "", timeout_seconds: int = 0
    ) -> DecisionInfo:
        """Schedule a decision; transient (in-memory) when attempt > 0."""
        self._require_running()
        # a decision closed earlier in this batch only clears from ms at
        # close-replay; treat it as already cleared (attempt resets too)
        if not self._decision_closed_in_batch and self.ms.has_pending_decision():
            raise WorkflowStateError("decision already scheduled")
        ei = self.ms.execution_info
        # during the start transaction ms is still empty (replay is
        # deferred to close) — read defaults off the in-batch started
        # event (reference: scheduling reads mutableState populated
        # eagerly; our deferred replay needs the batch fallback)
        started_attrs: Dict[str, Any] = {}
        for ev in self.batch:
            if ev.event_type == EventType.WorkflowExecutionStarted:
                started_attrs = ev.attributes
                break
        task_list = (
            ei.sticky_task_list or task_list or ei.task_list
            or started_attrs.get("task_list", "")
        )
        timeout = (
            timeout_seconds
            or ei.decision_timeout_value
            or started_attrs.get("task_start_to_close_timeout_seconds", 0)
        )
        if ei.decision_attempt > 0 and not self._decision_closed_in_batch:
            # transient: no event until completion materializes it
            decision = self.ms.replicate_transient_decision_task_scheduled(now)
            self._extra_transfer.append(
                T.decision_transfer_task(
                    self.domain_id, task_list, decision.schedule_id
                )
            )
            return decision
        event = self._add(
            lambda eid: F.decision_task_scheduled(
                eid, self.version, now,
                task_list=task_list,
                start_to_close_timeout_seconds=timeout,
                attempt=0,
            )
        )
        return DecisionInfo(
            version=self.version,
            schedule_id=event.event_id,
            started_id=EMPTY_EVENT_ID,
            task_list=task_list,
            decision_timeout=timeout,
            scheduled_timestamp=now,
        )

    def add_decision_task_started(
        self, schedule_id: int, request_id: str, identity: str, now: int
    ) -> DecisionInfo:
        self._require_running()
        ms = self.ms
        ei = ms.execution_info
        if (
            ei.decision_schedule_id != schedule_id
            or ei.decision_started_id != EMPTY_EVENT_ID
        ):
            raise WorkflowStateError(
                f"decision {schedule_id} not scheduled or already started"
            )
        if ei.decision_attempt > 0:
            # transient: in-memory started; events materialize at close.
            # Pass the decision explicitly — the decision=None path is the
            # replication-correction path that resets the attempt.
            return ms.replicate_decision_task_started_event(
                ms.get_decision_info(), self.version, schedule_id,
                schedule_id + 1, request_id, now,
            )
        event = self._add(
            lambda eid: F.decision_task_started(
                eid, self.version, now,
                scheduled_event_id=schedule_id,
                identity=identity, request_id=request_id,
            )
        )
        return DecisionInfo(
            version=self.version,
            schedule_id=schedule_id,
            started_id=event.event_id,
            request_id=request_id,
            started_timestamp=now,
        )

    def _materialize_transient_decision(self, now: int) -> None:
        """Write the scheduled+started pair for an attempt>0 decision at
        the front of the close batch (IDs match the in-memory shadow IDs
        because nothing else was persisted while it was pending)."""
        ei = self.ms.execution_info
        scheduled = F.decision_task_scheduled(
            self._next_id(), self.version, ei.decision_scheduled_timestamp or now,
            task_list=self.ms.execution_info.task_list,
            start_to_close_timeout_seconds=ei.decision_timeout,
            attempt=ei.decision_attempt,
        )
        if scheduled.event_id != ei.decision_schedule_id:
            raise WorkflowStateError(
                f"transient decision id drift: {scheduled.event_id} != "
                f"{ei.decision_schedule_id}"
            )
        self.batch.append(scheduled)
        started = F.decision_task_started(
            self._next_id(), self.version, ei.decision_started_timestamp or now,
            scheduled_event_id=ei.decision_schedule_id,
            request_id=ei.decision_request_id,
        )
        self.batch.append(started)

    def _check_inflight_decision(self, schedule_id: int, started_id: int) -> None:
        ei = self.ms.execution_info
        if (
            ei.decision_schedule_id != schedule_id
            or ei.decision_started_id != started_id
        ):
            raise WorkflowStateError(
                f"decision ({schedule_id},{started_id}) not in flight "
                f"(have {ei.decision_schedule_id},{ei.decision_started_id})"
            )

    def add_decision_task_completed(
        self, schedule_id: int, started_id: int, now: int,
        identity: str = "", binary_checksum: str = "",
    ) -> HistoryEvent:
        self._require_running()
        self._check_inflight_decision(schedule_id, started_id)
        if self.ms.execution_info.decision_attempt > 0:
            self._materialize_transient_decision(now)
        event = F.decision_task_completed(
            self._next_id(), self.version, now,
            scheduled_event_id=schedule_id, started_event_id=started_id,
            identity=identity, binary_checksum=binary_checksum,
        )
        self.batch.append(event)
        self._decision_closed_in_batch = True
        self._flush_buffered()
        return event

    def add_decision_task_failed(
        self, schedule_id: int, started_id: int, now: int,
        cause: int = 0, identity: str = "", details: bytes = b"",
    ) -> HistoryEvent:
        self._require_running()
        self._check_inflight_decision(schedule_id, started_id)
        if self.ms.execution_info.decision_attempt > 0:
            self._materialize_transient_decision(now)
        event = F.decision_task_failed(
            self._next_id(), self.version, now,
            scheduled_event_id=schedule_id, started_event_id=started_id,
            cause=cause, identity=identity, details=details,
        )
        self.batch.append(event)
        self._decision_closed_in_batch = True
        self._flush_buffered()
        return event

    def add_decision_task_timed_out(
        self, schedule_id: int, started_id: int, now: int,
        timeout_type: TimeoutType = TimeoutType.StartToClose,
    ) -> HistoryEvent:
        self._require_running()
        if timeout_type == TimeoutType.StartToClose:
            self._check_inflight_decision(schedule_id, started_id)
            if self.ms.execution_info.decision_attempt > 0:
                self._materialize_transient_decision(now)
        event = F.decision_task_timed_out(
            self._next_id(), self.version, now,
            scheduled_event_id=schedule_id, started_event_id=started_id,
            timeout_type=timeout_type,
        )
        self.batch.append(event)
        self._decision_closed_in_batch = True
        self._flush_buffered()
        return event

    # -- activities ---------------------------------------------------

    def add_activity_task_scheduled(
        self, decision_completed_id: int, now: int, *, activity_id: str,
        **attrs: Any,
    ) -> HistoryEvent:
        self._require_running()
        if (
            activity_id in self.ms.activity_by_id
            or activity_id in self._batch_activity_ids
        ):
            raise WorkflowStateError(f"duplicate activity id {activity_id}")
        self._batch_activity_ids.add(activity_id)
        event = F.activity_task_scheduled(
            self._next_id(), self.version, now,
            activity_id=activity_id,
            decision_task_completed_event_id=decision_completed_id,
            **attrs,
        )
        self.batch.append(event)
        return event

    def record_activity_task_started(
        self, ai: ActivityInfo, request_id: str, identity: str, now: int
    ) -> None:
        """State-only (no event until the activity closes — reference
        RecordActivityTaskStarted, historyEngine.go)."""
        self._require_running()
        if ai.started_id != EMPTY_EVENT_ID:
            raise WorkflowStateError(
                f"activity {ai.schedule_id} already started"
            )
        ai.started_id = TRANSIENT_EVENT_ID
        ai.request_id = request_id
        ai.started_identity = identity
        ai.started_time = now
        ai.version = self.version

    def _materialize_activity_started(self, ai: ActivityInfo) -> int:
        """Create the lazy Started event; returns its (possibly buffered)
        id for the close event's started_event_id linkage."""
        event = self._add(
            lambda eid: F.activity_task_started(
                eid, ai.version, ai.started_time,
                scheduled_event_id=ai.schedule_id,
                identity=ai.started_identity,
                request_id=ai.request_id,
                attempt=ai.attempt,
            )
        )
        return event.event_id

    def _activity_for_close(self, schedule_id: int) -> ActivityInfo:
        ai = self.ms.get_activity_info(schedule_id)
        if ai is None or self._buffered_activity_close(schedule_id):
            raise WorkflowStateError(f"activity {schedule_id} not pending")
        return ai

    def _buffered_activity_close(self, schedule_id: int) -> bool:
        return any(
            self._buffered(et, scheduled_event_id=schedule_id)
            for et in (
                EventType.ActivityTaskCompleted,
                EventType.ActivityTaskFailed,
                EventType.ActivityTaskTimedOut,
                EventType.ActivityTaskCanceled,
            )
        )

    def add_activity_task_completed(
        self, schedule_id: int, now: int, result: bytes = b"", identity: str = ""
    ) -> HistoryEvent:
        self._require_running()
        ai = self._activity_for_close(schedule_id)
        if ai.started_id == EMPTY_EVENT_ID:
            raise WorkflowStateError(f"activity {schedule_id} not started")
        started_id = (
            self._materialize_activity_started(ai)
            if ai.started_id == TRANSIENT_EVENT_ID
            else ai.started_id
        )
        return self._add(
            lambda eid: F.activity_task_completed(
                eid, self.version, now,
                scheduled_event_id=schedule_id, started_event_id=started_id,
                result=result, identity=identity,
            )
        )

    def add_activity_task_failed(
        self, schedule_id: int, now: int, reason: str = "",
        details: bytes = b"", identity: str = "",
    ) -> HistoryEvent:
        self._require_running()
        ai = self._activity_for_close(schedule_id)
        if ai.started_id == EMPTY_EVENT_ID:
            raise WorkflowStateError(f"activity {schedule_id} not started")
        started_id = (
            self._materialize_activity_started(ai)
            if ai.started_id == TRANSIENT_EVENT_ID
            else ai.started_id
        )
        return self._add(
            lambda eid: F.activity_task_failed(
                eid, self.version, now,
                scheduled_event_id=schedule_id, started_event_id=started_id,
                reason=reason, details=details, identity=identity,
            )
        )

    def add_activity_task_timed_out(
        self, schedule_id: int, now: int, timeout_type: TimeoutType,
        details: bytes = b"",
    ) -> HistoryEvent:
        self._require_running()
        ai = self._activity_for_close(schedule_id)
        started_id = ai.started_id
        if started_id == TRANSIENT_EVENT_ID:
            started_id = self._materialize_activity_started(ai)
        return self._add(
            lambda eid: F.activity_task_timed_out(
                eid, self.version, now,
                scheduled_event_id=schedule_id,
                started_event_id=(
                    started_id if started_id != EMPTY_EVENT_ID else EMPTY_EVENT_ID
                ),
                timeout_type=timeout_type, details=details,
            )
        )

    def add_activity_task_cancel_requested(
        self, decision_completed_id: int, activity_id: str, now: int
    ) -> Tuple[Optional[HistoryEvent], Optional[ActivityInfo]]:
        """Returns (event, activity) or (failed_event, None) when the
        activity id is unknown (reference: AddActivityTaskCancelRequestedEvent
        + RequestCancelActivityTaskFailed)."""
        self._require_running()
        schedule_id = self.ms.activity_by_id.get(activity_id)
        ai = (
            self.ms.get_activity_info(schedule_id)
            if schedule_id is not None
            else None
        )
        if ai is None or self._buffered_activity_close(schedule_id):
            event = F.request_cancel_activity_task_failed(
                self._next_id(), self.version, now,
                activity_id=activity_id,
                decision_task_completed_event_id=decision_completed_id,
            )
            self.batch.append(event)
            return event, None
        event = F.activity_task_cancel_requested(
            self._next_id(), self.version, now,
            activity_id=activity_id,
            decision_task_completed_event_id=decision_completed_id,
        )
        self.batch.append(event)
        return event, ai

    def add_activity_task_canceled(
        self, schedule_id: int, cancel_request_id: int, now: int,
        details: bytes = b"", identity: str = "",
    ) -> HistoryEvent:
        self._require_running()
        ai = self._activity_for_close(schedule_id)
        started_id = ai.started_id
        if started_id == TRANSIENT_EVENT_ID:
            started_id = self._materialize_activity_started(ai)
        return self._add(
            lambda eid: F.activity_task_canceled(
                eid, self.version, now,
                scheduled_event_id=schedule_id, started_event_id=started_id,
                latest_cancel_requested_event_id=cancel_request_id,
                details=details, identity=identity,
            )
        )

    # -- timers -------------------------------------------------------

    def add_timer_started(
        self, decision_completed_id: int, timer_id: str,
        fire_timeout_seconds: int, now: int,
    ) -> HistoryEvent:
        self._require_running()
        if (
            timer_id in self.ms.pending_timers
            or timer_id in self._batch_timer_ids
        ):
            raise WorkflowStateError(f"duplicate timer id {timer_id}")
        self._batch_timer_ids.add(timer_id)
        event = F.timer_started(
            self._next_id(), self.version, now,
            timer_id=timer_id,
            start_to_fire_timeout_seconds=fire_timeout_seconds,
            decision_task_completed_event_id=decision_completed_id,
        )
        self.batch.append(event)
        return event

    def add_timer_fired(self, timer_id: str, now: int) -> HistoryEvent:
        self._require_running()
        ti = self.ms.get_user_timer(timer_id)
        if ti is None or self._buffered(EventType.TimerFired, timer_id=timer_id):
            raise WorkflowStateError(f"timer {timer_id} not pending")
        return self._add(
            lambda eid: F.timer_fired(
                eid, self.version, now,
                timer_id=timer_id, started_event_id=ti.started_id,
            )
        )

    def add_timer_canceled(
        self, decision_completed_id: int, timer_id: str, now: int,
        identity: str = "",
    ) -> HistoryEvent:
        """Cancel a pending timer; emits CancelTimerFailed if unknown."""
        self._require_running()
        ti = self.ms.get_user_timer(timer_id)
        known = (
            ti is not None
            and timer_id not in self._batch_canceled_timers
            and not self._buffered(EventType.TimerFired, timer_id=timer_id)
        )
        if not known:
            event = F.cancel_timer_failed(
                self._next_id(), self.version, now,
                timer_id=timer_id, cause="TIMER_ID_UNKNOWN",
                decision_task_completed_event_id=decision_completed_id,
            )
            self.batch.append(event)
            return event
        self._batch_canceled_timers.add(timer_id)
        event = F.timer_canceled(
            self._next_id(), self.version, now,
            timer_id=timer_id, started_event_id=ti.started_id,
            decision_task_completed_event_id=decision_completed_id,
            identity=identity,
        )
        self.batch.append(event)
        return event

    # -- signals / cancel --------------------------------------------

    def add_workflow_execution_signaled(
        self, name: str, input: bytes, identity: str, now: int
    ) -> HistoryEvent:
        self._require_running()
        return self._add(
            lambda eid: F.workflow_execution_signaled(
                eid, self.version, now,
                signal_name=name, input=input, identity=identity,
            )
        )

    def add_workflow_execution_cancel_requested(
        self, cause: str, identity: str, now: int,
        external_workflow_id: str = "", external_run_id: str = "",
        request_id: str = "",
    ) -> HistoryEvent:
        self._require_running()
        if self.ms.execution_info.cancel_requested:
            raise WorkflowStateError("cancellation already requested")
        event = F.workflow_execution_cancel_requested(
            self._next_id(), self.version, now,
            cause=cause, identity=identity,
            cancel_request_id=request_id,
            external_workflow_id=external_workflow_id,
            external_run_id=external_run_id,
        )
        self.batch.append(event)
        return event

    # -- markers / search attributes ---------------------------------

    def add_marker_recorded(
        self, decision_completed_id: int, marker_name: str, now: int,
        details: bytes = b"",
    ) -> HistoryEvent:
        self._require_running()
        event = F.marker_recorded(
            self._next_id(), self.version, now,
            marker_name=marker_name, details=details,
            decision_task_completed_event_id=decision_completed_id,
        )
        self.batch.append(event)
        return event

    def add_upsert_search_attributes(
        self, decision_completed_id: int, search_attributes: Dict[str, bytes],
        now: int,
    ) -> HistoryEvent:
        self._require_running()
        event = F.upsert_workflow_search_attributes(
            self._next_id(), self.version, now,
            search_attributes=search_attributes,
            decision_task_completed_event_id=decision_completed_id,
        )
        self.batch.append(event)
        return event

    # -- external workflows ------------------------------------------

    def add_request_cancel_external_initiated(
        self, decision_completed_id: int, domain: str, workflow_id: str,
        run_id: str, child_workflow_only: bool, now: int,
    ) -> HistoryEvent:
        self._require_running()
        event = F.request_cancel_external_initiated(
            self._next_id(), self.version, now,
            domain=domain, workflow_id=workflow_id, run_id=run_id,
            child_workflow_only=child_workflow_only,
            decision_task_completed_event_id=decision_completed_id,
        )
        self.batch.append(event)
        return event

    def add_external_cancel_requested(
        self, initiated_id: int, domain: str, workflow_id: str, run_id: str,
        now: int,
    ) -> HistoryEvent:
        self._require_running()
        if self.ms.get_request_cancel_info(initiated_id) is None:
            raise WorkflowStateError(
                f"request-cancel {initiated_id} not pending"
            )
        return self._add(
            lambda eid: F.external_workflow_execution_cancel_requested(
                eid, self.version, now,
                initiated_event_id=initiated_id, domain=domain,
                workflow_id=workflow_id, run_id=run_id,
            )
        )

    def add_request_cancel_external_failed(
        self, initiated_id: int, domain: str, workflow_id: str, run_id: str,
        cause: int, now: int,
    ) -> HistoryEvent:
        self._require_running()
        if self.ms.get_request_cancel_info(initiated_id) is None:
            raise WorkflowStateError(
                f"request-cancel {initiated_id} not pending"
            )
        return self._add(
            lambda eid: F.request_cancel_external_failed(
                eid, self.version, now,
                initiated_event_id=initiated_id, domain=domain,
                workflow_id=workflow_id, run_id=run_id, cause=cause,
                decision_task_completed_event_id=EMPTY_EVENT_ID,
            )
        )

    def add_signal_external_initiated(
        self, decision_completed_id: int, domain: str, workflow_id: str,
        run_id: str, signal_name: str, input: bytes, control: bytes,
        child_workflow_only: bool, now: int,
    ) -> HistoryEvent:
        self._require_running()
        event = F.signal_external_initiated(
            self._next_id(), self.version, now,
            domain=domain, workflow_id=workflow_id, run_id=run_id,
            signal_name=signal_name, input=input, control=control,
            child_workflow_only=child_workflow_only,
            decision_task_completed_event_id=decision_completed_id,
        )
        self.batch.append(event)
        return event

    def add_external_signaled(
        self, initiated_id: int, domain: str, workflow_id: str, run_id: str,
        control: bytes, now: int,
    ) -> HistoryEvent:
        self._require_running()
        if self.ms.get_signal_info(initiated_id) is None:
            raise WorkflowStateError(f"external signal {initiated_id} not pending")
        return self._add(
            lambda eid: F.external_workflow_execution_signaled(
                eid, self.version, now,
                initiated_event_id=initiated_id, domain=domain,
                workflow_id=workflow_id, run_id=run_id, control=control,
            )
        )

    def add_signal_external_failed(
        self, initiated_id: int, domain: str, workflow_id: str, run_id: str,
        cause: int, now: int,
    ) -> HistoryEvent:
        self._require_running()
        if self.ms.get_signal_info(initiated_id) is None:
            raise WorkflowStateError(f"external signal {initiated_id} not pending")
        return self._add(
            lambda eid: F.signal_external_failed(
                eid, self.version, now,
                initiated_event_id=initiated_id, domain=domain,
                workflow_id=workflow_id, run_id=run_id, cause=cause,
                decision_task_completed_event_id=EMPTY_EVENT_ID,
            )
        )

    # -- child workflows ---------------------------------------------

    def add_start_child_initiated(
        self, decision_completed_id: int, now: int, *, domain: str,
        workflow_id: str, **attrs: Any,
    ) -> HistoryEvent:
        self._require_running()
        event = F.start_child_initiated(
            self._next_id(), self.version, now,
            domain=domain, workflow_id=workflow_id,
            decision_task_completed_event_id=decision_completed_id,
            **attrs,
        )
        self.batch.append(event)
        return event

    def _check_pending_child(self, initiated_id: int) -> None:
        if self.ms.get_child_execution_info(initiated_id) is None:
            raise WorkflowStateError(f"child {initiated_id} not pending")

    def add_child_started(
        self, initiated_id: int, domain: str, workflow_id: str, run_id: str,
        workflow_type: str, now: int,
    ) -> HistoryEvent:
        self._require_running()
        self._check_pending_child(initiated_id)
        return self._add(
            lambda eid: F.child_execution_started(
                eid, self.version, now,
                initiated_event_id=initiated_id, domain=domain,
                workflow_id=workflow_id, run_id=run_id,
                workflow_type=workflow_type,
            )
        )

    def add_start_child_failed(
        self, initiated_id: int, domain: str, workflow_id: str,
        workflow_type: str, cause: int, now: int,
    ) -> HistoryEvent:
        self._require_running()
        self._check_pending_child(initiated_id)
        return self._add(
            lambda eid: F.start_child_failed(
                eid, self.version, now,
                initiated_event_id=initiated_id, domain=domain,
                workflow_id=workflow_id, workflow_type=workflow_type,
                cause=cause, decision_task_completed_event_id=EMPTY_EVENT_ID,
            )
        )

    def add_child_closed(
        self, initiated_id: int, close_type: EventType, now: int, **attrs: Any
    ) -> HistoryEvent:
        self._require_running()
        ci = self.ms.get_child_execution_info(initiated_id)
        if ci is None:
            raise WorkflowStateError(f"child {initiated_id} not pending")
        factory = {
            EventType.ChildWorkflowExecutionCompleted: F.child_execution_completed,
            EventType.ChildWorkflowExecutionFailed: F.child_execution_failed,
            EventType.ChildWorkflowExecutionCanceled: F.child_execution_canceled,
            EventType.ChildWorkflowExecutionTimedOut: F.child_execution_timed_out,
            EventType.ChildWorkflowExecutionTerminated: F.child_execution_terminated,
        }[close_type]
        return self._add(
            lambda eid: factory(
                eid, self.version, now,
                initiated_event_id=initiated_id,
                started_event_id=ci.started_id,
                **attrs,
            )
        )

    # -- workflow close ----------------------------------------------

    def _close_event(self, make: Callable[[int], HistoryEvent]) -> HistoryEvent:
        self._require_running()
        event = make(self._next_id())
        self.batch.append(event)
        self._closed_in_batch = True
        return event

    def add_workflow_execution_completed(
        self, decision_completed_id: int, now: int, result: bytes = b""
    ) -> HistoryEvent:
        return self._close_event(
            lambda eid: F.workflow_execution_completed(
                eid, self.version, now, result=result,
                decision_task_completed_event_id=decision_completed_id,
            )
        )

    def add_workflow_execution_failed(
        self, decision_completed_id: int, now: int, reason: str = "",
        details: bytes = b"",
    ) -> HistoryEvent:
        return self._close_event(
            lambda eid: F.workflow_execution_failed(
                eid, self.version, now, reason=reason, details=details,
                decision_task_completed_event_id=decision_completed_id,
            )
        )

    def add_workflow_execution_canceled(
        self, decision_completed_id: int, now: int, details: bytes = b""
    ) -> HistoryEvent:
        return self._close_event(
            lambda eid: F.workflow_execution_canceled(
                eid, self.version, now, details=details,
                decision_task_completed_event_id=decision_completed_id,
            )
        )

    def add_workflow_execution_terminated(
        self, now: int, reason: str = "", details: bytes = b"",
        identity: str = "",
    ) -> HistoryEvent:
        # terminate flushes the buffer into its own batch so no external
        # results are lost (terminate is legal with a decision in flight)
        self._require_running()
        self._flush_buffered()
        return self._close_event(
            lambda eid: F.workflow_execution_terminated(
                eid, self.version, now, reason=reason, details=details,
                identity=identity,
            )
        )

    def add_workflow_execution_timed_out(self, now: int) -> HistoryEvent:
        self._require_running()
        self._flush_buffered()
        return self._close_event(
            lambda eid: F.workflow_execution_timed_out(
                eid, self.version, now,
                timeout_type=TimeoutType.StartToClose,
            )
        )

    def add_continued_as_new(
        self, decision_completed_id: int, now: int, new_run_id: str, *,
        workflow_type: str, task_list: str,
        execution_start_to_close_timeout_seconds: int,
        task_start_to_close_timeout_seconds: int,
        input: bytes = b"",
        backoff_start_interval_seconds: int = 0,
        initiator: int = int(ContinueAsNewInitiator.Decider),
        schedule_new_decision: bool = True,
        **new_run_attrs: Any,
    ) -> HistoryEvent:
        """Close this run continued-as-new and stage the new run's first
        events (reference: retry/cron/decider continue-as-new,
        workflowExecutionContext.go continueAsNewWorkflowExecution)."""
        event = self._close_event(
            lambda eid: F.workflow_execution_continued_as_new(
                eid, self.version, now,
                new_execution_run_id=new_run_id,
                workflow_type=workflow_type, task_list=task_list,
                execution_start_to_close_timeout_seconds=(
                    execution_start_to_close_timeout_seconds
                ),
                task_start_to_close_timeout_seconds=(
                    task_start_to_close_timeout_seconds
                ),
                input=input,
                backoff_start_interval_in_seconds=backoff_start_interval_seconds,
                initiator=initiator,
                decision_task_completed_event_id=decision_completed_id,
            )
        )
        started = F.workflow_execution_started(
            1, self.version, now,
            workflow_type=workflow_type, task_list=task_list,
            execution_start_to_close_timeout_seconds=(
                execution_start_to_close_timeout_seconds
            ),
            task_start_to_close_timeout_seconds=(
                task_start_to_close_timeout_seconds
            ),
            input=input,
            continued_execution_run_id=self.run_id,
            first_decision_task_backoff_seconds=backoff_start_interval_seconds,
            initiator=initiator,
            **new_run_attrs,
        )
        self._new_run_events = [started]
        if schedule_new_decision and not backoff_start_interval_seconds:
            self._new_run_events.append(
                F.decision_task_scheduled(
                    2, self.version, now,
                    task_list=task_list,
                    start_to_close_timeout_seconds=(
                        task_start_to_close_timeout_seconds
                    ),
                )
            )
        return event

    # -- close --------------------------------------------------------

    def close(self) -> TransactionResult:
        """Replay the batch through the shared StateBuilder: mutates ms,
        generates transfer/timer tasks, handles the new run."""
        if not self.batch:
            return TransactionResult(
                events=[],
                transfer_tasks=self._extra_transfer,
                timer_tasks=self._extra_timer,
            )
        sb = StateBuilder(
            self.ms,
            domain_resolver=self.domain_resolver,
            id_generator=self.id_generator,
            retention_days=self.retention_days,
            # active path: the engine manages stickiness explicitly
            # (set on completion, cleared on decision failure/timeout)
            preserve_stickiness=True,
        )
        _, _, new_run_ms = sb.apply_events(
            self.domain_id,
            self.request_id,
            self.workflow_id,
            self.run_id,
            self.batch,
            new_run_history=self._new_run_events or None,
        )
        # replay auto-schedules transient retry decisions with a stale
        # schedule ID (the reference documents this is wrong on the
        # replica and corrected on the active side —
        # mutableStateDecisionTaskManager.go:174-183); we ARE the active
        # side, so correct it before anything observes it
        ei = self.ms.execution_info
        if (
            ei.decision_attempt > 0
            and ei.decision_schedule_id != EMPTY_EVENT_ID
            and ei.decision_started_id == EMPTY_EVENT_ID
            and ei.decision_schedule_id != self.ms.next_event_id
        ):
            stale = ei.decision_schedule_id
            ei.decision_schedule_id = self.ms.next_event_id
            for task in sb.transfer_tasks:
                if (
                    task.task_type == T.TransferTaskType.DecisionTask
                    and task.schedule_id == stale
                ):
                    task.schedule_id = ei.decision_schedule_id
        return TransactionResult(
            events=self.batch,
            transfer_tasks=self._extra_transfer + sb.transfer_tasks,
            timer_tasks=self._extra_timer + sb.timer_tasks,
            new_run_events=self._new_run_events,
            new_run_ms=new_run_ms,
            new_run_transfer_tasks=sb.new_run_transfer_tasks,
            new_run_timer_tasks=sb.new_run_timer_tasks,
        )
