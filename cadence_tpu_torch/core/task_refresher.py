"""Task refresher: regenerate all queue tasks from a state snapshot.

Host twin of the reference's ``mutableStateTaskRefresher.refreshTasks``
(Cadence service/history/mutableStateTaskRefresher.go): after a
rebuild/reset, per-replay task bookkeeping is discarded and the complete
set of outstanding transfer/timer tasks is a pure function of final state.
The rebuild path (``runtime/replication/rebuilder.py``) runs it on every
rebuilt state; tests hold it against the reference package's refresher.
"""

from __future__ import annotations

from typing import List, Tuple

from .enums import TimeoutType, TimerTaskType, TransferTaskType
from .ids import EMPTY_EVENT_ID
from .mutable_state import MutableState, SECOND
from . import tasks as T
from .timer_sequence import TimerSequence


def refresh_tasks(ms: MutableState) -> Tuple[List[T.TransferTask], List[T.TimerTask]]:
    """All outstanding tasks implied by ``ms``.

    Ordering is deterministic: transfer tasks by (kind, id); timer tasks by
    (visibility, id) — the device refresher emits the same order.
    """
    transfer: List[T.TransferTask] = []
    timer: List[T.TimerTask] = []
    ei = ms.execution_info

    if not ms.is_workflow_execution_running():
        transfer.append(T.close_execution_transfer_task())
        return transfer, timer

    # workflow timeout (refreshTasksForWorkflowStart); a pending
    # first-decision backoff extends the window exactly as the
    # StateBuilder does at start
    backoff_extra = 0
    if ei.first_decision_backoff_deadline:
        backoff_extra = max(
            0, ei.first_decision_backoff_deadline - ei.start_timestamp
        )
    timer.append(
        T.TimerTask(
            task_type=TimerTaskType.WorkflowTimeout,
            visibility_timestamp=ei.start_timestamp
            + ei.workflow_timeout * SECOND + backoff_extra,
        )
    )
    # cron/retry runs waiting on their first decision re-arm the
    # backoff timer (refreshTasksForWorkflowStart delayed-decision
    # branch); without it a rebuilt/staged run never schedules its
    # first decision after failover
    if (
        ei.first_decision_backoff_deadline
        and not ms.has_pending_decision()
        and ei.last_processed_event < 1
    ):
        timer.append(
            T.TimerTask(
                task_type=TimerTaskType.WorkflowBackoffTimer,
                visibility_timestamp=ei.first_decision_backoff_deadline,
            )
        )

    # decision (refreshTasksForDecision)
    if ms.has_pending_decision():
        transfer.append(
            T.decision_transfer_task(ei.domain_id, ei.task_list, ei.decision_schedule_id)
        )
        if ms.has_inflight_decision():
            timer.append(
                T.TimerTask(
                    task_type=TimerTaskType.DecisionTimeout,
                    visibility_timestamp=ei.decision_started_timestamp
                    + ei.decision_timeout * SECOND,
                    timeout_type=int(TimeoutType.StartToClose),
                    event_id=ei.decision_schedule_id,
                    schedule_attempt=ei.decision_attempt,
                )
            )

    # activities (refreshTasksForActivity): transfer for unstarted; timer
    # statuses reset then earliest timeout re-armed
    for sid in sorted(ms.pending_activities):
        ai = ms.pending_activities[sid]
        ai.timer_task_status = 0
        if ai.started_id == EMPTY_EVENT_ID:
            transfer.append(
                T.activity_transfer_task(ei.domain_id, ai.task_list, sid)
            )
    # user timers (refreshTasksForTimer): statuses reset, earliest re-armed
    for ti in ms.pending_timers.values():
        ti.task_status = 0
    seq = TimerSequence(ms)
    at = seq.activity_timer_task_if_needed()
    if at is not None:
        timer.append(at)
    ut = seq.user_timer_task_if_needed()
    if ut is not None:
        timer.append(ut)

    # children / external cancels / signals not yet acknowledged
    for cid in sorted(ms.pending_children):
        ci = ms.pending_children[cid]
        if ci.started_id == EMPTY_EVENT_ID:
            transfer.append(
                T.start_child_transfer_task(ci.domain_name, ci.started_workflow_id, cid)
            )
    for rid in sorted(ms.pending_request_cancels):
        rc = ms.pending_request_cancels[rid]
        transfer.append(
            T.cancel_external_transfer_task(
                rc.target_domain_id or ei.domain_id,
                rc.target_workflow_id,
                rc.target_run_id,
                rc.target_child_workflow_only,
                rid,
            )
        )
    for sid in sorted(ms.pending_signals):
        sg = ms.pending_signals[sid]
        transfer.append(
            T.signal_external_transfer_task(
                sg.target_domain_id or ei.domain_id,
                sg.target_workflow_id,
                sg.target_run_id,
                sg.target_child_workflow_only,
                sid,
            )
        )
    return transfer, timer
