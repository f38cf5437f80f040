"""StateBuilder: replay a history-event stream into MutableState + tasks.

Host-side oracle twin of the reference's ``stateBuilderImpl.applyEvents``
(Cadence service/history/stateBuilder.go:112-613: the 42-case
event-type switch, the per-event version-history preamble :134-155, and the
task-scheduling helpers :620-800). The CUDA kernel
(ops/csrc/replay_fsm.cu) vectorizes exactly this function; the rebuild
path's tests (tests/test_torch_rebuild.py) hold the two equal.

This is also the production replayer on paths where a single workflow must
be rebuilt host-side (active-side recovery, resets with host-only state).
"""

from __future__ import annotations

import uuid
from typing import Callable, List, Optional, Tuple

from .enums import EventType, TimeoutType, TimerTaskType, WorkflowBackoffType
from .events import HistoryEvent
from .ids import EMPTY_EVENT_ID
from .mutable_state import DecisionInfo, MutableState, SECOND
from . import tasks as T
from .timer_sequence import TimerSequence


class StateBuilder:
    """Applies event batches to a MutableState, accumulating queue tasks."""

    def __init__(
        self,
        mutable_state: MutableState,
        domain_resolver: Callable[[str], str] = lambda name: name,
        id_generator: Callable[[], str] = lambda: str(uuid.uuid4()),
        retention_days: int = 1,
        preserve_stickiness: bool = False,
    ) -> None:
        self.ms = mutable_state
        self.domain_resolver = domain_resolver
        self.id_generator = id_generator
        self.retention_days = retention_days
        # the reference clears worker stickiness when a REPLICATED
        # batch applies (the remote worker's affinity means nothing
        # here, stateBuilder.go:130); the ACTIVE transaction path runs
        # through this same builder and must NOT wipe the affinity the
        # engine just recorded
        self.preserve_stickiness = preserve_stickiness
        self.transfer_tasks: List[T.TransferTask] = []
        self.timer_tasks: List[T.TimerTask] = []
        self.new_run_transfer_tasks: List[T.TransferTask] = []
        self.new_run_timer_tasks: List[T.TimerTask] = []

    # ------------------------------------------------------------------

    def apply_batches(
        self,
        domain_id: str,
        request_id: str,
        workflow_id: str,
        run_id: str,
        batches: List[List[HistoryEvent]],
    ) -> None:
        """Replay a multi-batch history, one apply_events call per
        transaction batch (the caller-side loop the reference's rebuilder
        runs, nDCStateRebuilder.go:128-137)."""
        for batch in batches:
            self.apply_events(domain_id, request_id, workflow_id, run_id, batch)

    def apply_events(
        self,
        domain_id: str,
        request_id: str,
        workflow_id: str,
        run_id: str,
        history: List[HistoryEvent],
        new_run_history: Optional[List[HistoryEvent]] = None,
    ) -> Tuple[HistoryEvent, Optional[DecisionInfo], Optional[MutableState]]:
        """Apply ONE transaction batch of events.

        Contract: ``history`` is a single persisted transaction batch —
        batch-derived state (scheduled_event_batch_id,
        completion_event_batch_id, transient-decision schedule IDs, and the
        batch-end next_event_id update) all key off ``history[0]``. For a
        multi-batch stream use ``apply_batches``; passing a flat multi-
        transaction list treats it as one giant batch, which is legal but
        yields different batch IDs than per-batch replay.
        """
        if not history:
            raise ValueError("history size is zero")
        first_event = history[0]
        last_event = history[-1]
        last_decision: Optional[DecisionInfo] = None
        new_run_ms: Optional[MutableState] = None
        ms = self.ms

        # workflow turned passive for this apply — reference :130
        if not self.preserve_stickiness:
            ms.clear_stickiness()

        for event in history:
            # version-history preamble — reference :134-155
            if ms.version_histories is not None:
                ms.update_current_version(event.version, force=True)
                vh = ms.version_histories.get_current_version_history()
                vh.add_or_update_item(event.event_id, event.version)
            ms.execution_info.last_event_task_id = event.task_id

            et = event.event_type
            if et == EventType.WorkflowExecutionStarted:
                a = event.attributes
                parent_domain_id = None
                if a.get("parent_workflow_domain"):
                    parent_domain_id = self.domain_resolver(a["parent_workflow_domain"])
                ms.replicate_workflow_execution_started_event(
                    parent_domain_id, workflow_id, run_id, request_id, event
                )
                self.timer_tasks.extend(self._schedule_workflow_timer_tasks(event))
                self.transfer_tasks.append(T.record_workflow_started_task())

            elif et == EventType.DecisionTaskScheduled:
                a = event.attributes
                decision = ms.replicate_decision_task_scheduled_event(
                    event.version,
                    event.event_id,
                    a.get("task_list", ""),
                    a.get("start_to_close_timeout_seconds", 0),
                    a.get("attempt", 0),
                    event.timestamp,
                    event.timestamp,
                )
                self.transfer_tasks.append(
                    T.decision_transfer_task(
                        domain_id, ms.execution_info.task_list, decision.schedule_id
                    )
                )
                if ms.is_sticky_task_list_enabled():
                    # sticky dispatch gets a ScheduleToStart timer so a
                    # dead worker's decision falls back to the normal
                    # list (reference mutableStateTaskGenerator
                    # GenerateDecisionScheduleTasks sticky branch; the
                    # timer queue clears stickiness when it fires)
                    self.timer_tasks.append(
                        T.TimerTask(
                            task_type=TimerTaskType.DecisionTimeout,
                            visibility_timestamp=event.timestamp
                            + ms.execution_info.sticky_schedule_to_start_timeout
                            * SECOND,
                            timeout_type=int(TimeoutType.ScheduleToStart),
                            event_id=decision.schedule_id,
                            schedule_attempt=decision.attempt,
                        )
                    )
                last_decision = decision

            elif et == EventType.DecisionTaskStarted:
                a = event.attributes
                decision = ms.replicate_decision_task_started_event(
                    None,
                    event.version,
                    a.get("scheduled_event_id", EMPTY_EVENT_ID),
                    event.event_id,
                    a.get("request_id", ""),
                    event.timestamp,
                )
                self.timer_tasks.append(
                    T.TimerTask(
                        task_type=TimerTaskType.DecisionTimeout,
                        visibility_timestamp=event.timestamp
                        + decision.decision_timeout * SECOND,
                        timeout_type=int(TimeoutType.StartToClose),
                        event_id=decision.schedule_id,
                        schedule_attempt=decision.attempt,
                    )
                )
                last_decision = decision

            elif et == EventType.DecisionTaskCompleted:
                ms.replicate_decision_task_completed_event(event)

            elif et == EventType.DecisionTaskTimedOut:
                a = event.attributes
                ms.replicate_decision_task_timed_out_event(
                    TimeoutType(a.get("timeout_type", int(TimeoutType.StartToClose))),
                    now=event.timestamp,
                )
                last_decision = self._replicate_transient_decision(domain_id, event, last_decision)

            elif et == EventType.DecisionTaskFailed:
                ms.replicate_decision_task_failed_event(now=event.timestamp)
                last_decision = self._replicate_transient_decision(domain_id, event, last_decision)

            elif et == EventType.ActivityTaskScheduled:
                ai = ms.replicate_activity_task_scheduled_event(
                    first_event.event_id, event
                )
                self.transfer_tasks.append(
                    T.activity_transfer_task(
                        domain_id, ms.execution_info.task_list, ai.schedule_id
                    )
                )
                self._maybe_activity_timer_task()

            elif et == EventType.ActivityTaskStarted:
                ms.replicate_activity_task_started_event(event)
                self._maybe_activity_timer_task()

            elif et == EventType.ActivityTaskCompleted:
                ms.replicate_activity_task_completed_event(event)
                self._maybe_activity_timer_task()

            elif et == EventType.ActivityTaskFailed:
                ms.replicate_activity_task_failed_event(event)
                self._maybe_activity_timer_task()

            elif et == EventType.ActivityTaskTimedOut:
                ms.replicate_activity_task_timed_out_event(event)
                self._maybe_activity_timer_task()

            elif et == EventType.ActivityTaskCancelRequested:
                ms.replicate_activity_task_cancel_requested_event(event)

            elif et == EventType.ActivityTaskCanceled:
                ms.replicate_activity_task_canceled_event(event)
                self._maybe_activity_timer_task()

            elif et == EventType.RequestCancelActivityTaskFailed:
                pass  # no mutable-state action — reference :322

            elif et == EventType.TimerStarted:
                ms.replicate_timer_started_event(event)
                self._maybe_user_timer_task()

            elif et == EventType.TimerFired:
                ms.replicate_timer_fired_event(event)
                self._maybe_user_timer_task()

            elif et == EventType.TimerCanceled:
                ms.replicate_timer_canceled_event(event)
                self._maybe_user_timer_task()

            elif et == EventType.CancelTimerFailed:
                pass  # no mutable-state action — reference :356

            elif et == EventType.StartChildWorkflowExecutionInitiated:
                a = event.attributes
                ci = ms.replicate_start_child_initiated_event(
                    first_event.event_id, event, self.id_generator()
                )
                self.transfer_tasks.append(
                    T.start_child_transfer_task(
                        self.domain_resolver(a.get("domain", "")),
                        a.get("workflow_id", ""),
                        ci.initiated_id,
                    )
                )

            elif et == EventType.StartChildWorkflowExecutionFailed:
                ms.replicate_start_child_failed_event(event)

            elif et == EventType.ChildWorkflowExecutionStarted:
                ms.replicate_child_execution_started_event(event)

            elif et == EventType.ChildWorkflowExecutionCompleted:
                ms.replicate_child_execution_completed_event(event)

            elif et == EventType.ChildWorkflowExecutionFailed:
                ms.replicate_child_execution_failed_event(event)

            elif et == EventType.ChildWorkflowExecutionCanceled:
                ms.replicate_child_execution_canceled_event(event)

            elif et == EventType.ChildWorkflowExecutionTimedOut:
                ms.replicate_child_execution_timed_out_event(event)

            elif et == EventType.ChildWorkflowExecutionTerminated:
                ms.replicate_child_execution_terminated_event(event)

            elif et == EventType.RequestCancelExternalWorkflowExecutionInitiated:
                a = event.attributes
                rci = ms.replicate_request_cancel_external_initiated_event(
                    first_event.event_id, event, self.id_generator()
                )
                rci.target_domain_id = self.domain_resolver(
                    a.get("domain", ""))
                rci.target_workflow_id = a.get("workflow_id", "")
                rci.target_run_id = a.get("run_id", "")
                rci.target_child_workflow_only = a.get(
                    "child_workflow_only", False)
                # task fields come FROM the stored info so the two can
                # never silently diverge
                self.transfer_tasks.append(
                    T.cancel_external_transfer_task(
                        rci.target_domain_id,
                        rci.target_workflow_id,
                        rci.target_run_id,
                        rci.target_child_workflow_only,
                        rci.initiated_id,
                    )
                )

            elif et == EventType.RequestCancelExternalWorkflowExecutionFailed:
                ms.replicate_request_cancel_external_failed_event(event)

            elif et == EventType.ExternalWorkflowExecutionCancelRequested:
                ms.replicate_external_workflow_execution_cancel_requested(event)

            elif et == EventType.SignalExternalWorkflowExecutionInitiated:
                a = event.attributes
                si = ms.replicate_signal_external_initiated_event(
                    first_event.event_id, event, self.id_generator()
                )
                si.target_domain_id = self.domain_resolver(
                    a.get("domain", ""))
                si.target_workflow_id = a.get("workflow_id", "")
                si.target_run_id = a.get("run_id", "")
                si.target_child_workflow_only = a.get(
                    "child_workflow_only", False)
                self.transfer_tasks.append(
                    T.signal_external_transfer_task(
                        si.target_domain_id,
                        si.target_workflow_id,
                        si.target_run_id,
                        si.target_child_workflow_only,
                        si.initiated_id,
                    )
                )

            elif et == EventType.SignalExternalWorkflowExecutionFailed:
                ms.replicate_signal_external_failed_event(event)

            elif et == EventType.ExternalWorkflowExecutionSignaled:
                ms.replicate_external_workflow_execution_signaled(event)

            elif et == EventType.MarkerRecorded:
                pass  # no mutable-state action — reference :494

            elif et == EventType.WorkflowExecutionSignaled:
                ms.replicate_workflow_execution_signaled(event)

            elif et == EventType.WorkflowExecutionCancelRequested:
                ms.replicate_workflow_execution_cancel_requested_event(event)

            elif et == EventType.WorkflowExecutionCompleted:
                ms.replicate_workflow_execution_completed_event(
                    first_event.event_id, event
                )
                self._append_finished_execution_tasks(event)

            elif et == EventType.WorkflowExecutionFailed:
                ms.replicate_workflow_execution_failed_event(
                    first_event.event_id, event
                )
                self._append_finished_execution_tasks(event)

            elif et == EventType.WorkflowExecutionTimedOut:
                ms.replicate_workflow_execution_timedout_event(
                    first_event.event_id, event
                )
                self._append_finished_execution_tasks(event)

            elif et == EventType.WorkflowExecutionCanceled:
                ms.replicate_workflow_execution_canceled_event(
                    first_event.event_id, event
                )
                self._append_finished_execution_tasks(event)

            elif et == EventType.WorkflowExecutionTerminated:
                ms.replicate_workflow_execution_terminated_event(
                    first_event.event_id, event
                )
                self._append_finished_execution_tasks(event)

            elif et == EventType.UpsertWorkflowSearchAttributes:
                ms.replicate_upsert_workflow_search_attributes_event(event)
                self.transfer_tasks.append(T.upsert_search_attributes_task())

            elif et == EventType.WorkflowExecutionContinuedAsNew:
                if not new_run_history:
                    raise ValueError("continued-as-new requires new-run history")
                new_run_ms = MutableState(domain_id=domain_id)
                if ms.version_histories is not None:
                    new_run_ms.version_histories = type(ms.version_histories).new_empty()
                new_run_builder = StateBuilder(
                    new_run_ms, self.domain_resolver, self.id_generator, self.retention_days
                )
                new_run_id = event.attributes.get("new_execution_run_id", "")
                new_run_builder.apply_events(
                    domain_id, self.id_generator(), workflow_id, new_run_id,
                    new_run_history, None,
                )
                self.new_run_transfer_tasks.extend(new_run_builder.transfer_tasks)
                self.new_run_timer_tasks.extend(new_run_builder.timer_tasks)
                ms.replicate_workflow_execution_continued_as_new_event(
                    first_event.event_id, event
                )
                self._append_finished_execution_tasks(event)

            else:
                raise ValueError(f"unknown event type {et}")

        ms.execution_info.last_first_event_id = first_event.event_id
        ms.execution_info.next_event_id = last_event.event_id + 1
        return last_event, last_decision, new_run_ms

    # -- task scheduling helpers ---------------------------------------

    def _replicate_transient_decision(
        self, domain_id: str, event: HistoryEvent, last_decision: Optional[DecisionInfo]
    ) -> Optional[DecisionInfo]:
        # reference: stateBuilder.go:227-258 — after a decision failure or
        # timeout, a transient (attempt>0) decision is scheduled in memory.
        decision = self.ms.replicate_transient_decision_task_scheduled(event.timestamp)
        if decision is not None:
            self.transfer_tasks.append(
                T.decision_transfer_task(
                    domain_id, self.ms.execution_info.task_list, decision.schedule_id
                )
            )
            return decision
        return last_decision

    def _schedule_workflow_timer_tasks(self, event: HistoryEvent) -> List[T.TimerTask]:
        # reference: stateBuilder.go scheduleWorkflowTimerTask (:731-760)
        out: List[T.TimerTask] = []
        now = event.timestamp
        workflow_timeout_ts = now + self.ms.execution_info.workflow_timeout * SECOND
        backoff_s = event.attributes.get("first_decision_task_backoff_seconds", 0)
        if backoff_s:
            workflow_timeout_ts += backoff_s * SECOND
            is_cron = event.attributes.get("initiator", 0) == 2  # CronSchedule
            out.append(
                T.TimerTask(
                    task_type=TimerTaskType.WorkflowBackoffTimer,
                    visibility_timestamp=now + backoff_s * SECOND,
                    timeout_type=int(
                        WorkflowBackoffType.Cron if is_cron else WorkflowBackoffType.Retry
                    ),
                )
            )
        out.append(
            T.TimerTask(
                task_type=TimerTaskType.WorkflowTimeout,
                visibility_timestamp=workflow_timeout_ts,
            )
        )
        return out

    def _maybe_user_timer_task(self) -> None:
        task = TimerSequence(self.ms).user_timer_task_if_needed()
        if task is not None:
            self.timer_tasks.append(task)

    def _maybe_activity_timer_task(self) -> None:
        task = TimerSequence(self.ms).activity_timer_task_if_needed()
        if task is not None:
            self.timer_tasks.append(task)

    def _append_finished_execution_tasks(self, event: HistoryEvent) -> None:
        # reference: stateBuilder.go appendTasksForFinishedExecutions (:779-792)
        self.transfer_tasks.append(T.close_execution_transfer_task())
        self.timer_tasks.append(
            T.TimerTask(
                task_type=TimerTaskType.DeleteHistoryEvent,
                visibility_timestamp=event.timestamp
                + self.retention_days * 24 * 3600 * SECOND,
            )
        )
