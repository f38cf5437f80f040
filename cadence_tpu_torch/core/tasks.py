"""Transfer, timer and replication task records.

Model of the reference's persistence.Task hierarchy
(Cadence common/persistence/dataInterfaces.go:409+ — DecisionTask,
ActivityTask, CloseExecutionTask, CancelExecutionTask, SignalExecutionTask,
StartChildExecutionTask, RecordWorkflowStartedTask, Upsert...Task and the
timer family DecisionTimeoutTask/ActivityTimeoutTask/UserTimerTask/
WorkflowTimeoutTask/DeleteHistoryEventTask/ActivityRetryTimerTask/
WorkflowBackoffTimerTask, HistoryReplicationTask). The history host's
transactions emit replication tasks; the replication plane that ships
them waits for a later slice of the port.

These are host-side queue work items; after a rebuild the task refresher
(``core/task_refresher.py``) regenerates them from the final state. A copy
of the reference package's records, field for field.
"""

from __future__ import annotations

import dataclasses

from .enums import TimerTaskType, TransferTaskType


@dataclasses.dataclass
class TransferTask:
    task_type: TransferTaskType
    domain_id: str = ""
    workflow_id: str = ""
    run_id: str = ""
    task_id: int = 0
    version: int = 0
    # decision / activity dispatch
    task_list: str = ""
    schedule_id: int = 0
    # cross-workflow targets (cancel/signal/child-start)
    target_domain_id: str = ""
    target_workflow_id: str = ""
    target_run_id: str = ""
    target_child_workflow_only: bool = False
    initiated_id: int = 0
    record_visibility: bool = False
    visibility_timestamp: int = 0  # ns

    def sort_key(self):
        return (self.task_id,)


@dataclasses.dataclass
class TimerTask:
    task_type: TimerTaskType
    visibility_timestamp: int  # ns — when the timer fires
    domain_id: str = ""
    workflow_id: str = ""
    run_id: str = ""
    task_id: int = 0
    version: int = 0
    timeout_type: int = 0  # TimeoutType or WorkflowBackoffType
    event_id: int = 0
    schedule_attempt: int = 0

    def sort_key(self):
        return (self.visibility_timestamp, self.task_id)


def decision_transfer_task(domain_id: str, task_list: str, schedule_id: int) -> TransferTask:
    # reference: stateBuilder.go scheduleDecisionTransferTask
    return TransferTask(
        task_type=TransferTaskType.DecisionTask,
        domain_id=domain_id,
        task_list=task_list,
        schedule_id=schedule_id,
    )


def activity_transfer_task(domain_id: str, task_list: str, schedule_id: int) -> TransferTask:
    return TransferTask(
        task_type=TransferTaskType.ActivityTask,
        domain_id=domain_id,
        task_list=task_list,
        schedule_id=schedule_id,
    )


def close_execution_transfer_task() -> TransferTask:
    return TransferTask(task_type=TransferTaskType.CloseExecution)


def record_workflow_started_task() -> TransferTask:
    return TransferTask(task_type=TransferTaskType.RecordWorkflowStarted)


def upsert_search_attributes_task() -> TransferTask:
    return TransferTask(task_type=TransferTaskType.UpsertWorkflowSearchAttributes)


def start_child_transfer_task(
    target_domain_id: str, target_workflow_id: str, initiated_id: int
) -> TransferTask:
    return TransferTask(
        task_type=TransferTaskType.StartChildExecution,
        target_domain_id=target_domain_id,
        target_workflow_id=target_workflow_id,
        initiated_id=initiated_id,
    )


def cancel_external_transfer_task(
    target_domain_id: str,
    target_workflow_id: str,
    target_run_id: str,
    child_workflow_only: bool,
    initiated_id: int,
) -> TransferTask:
    return TransferTask(
        task_type=TransferTaskType.CancelExecution,
        target_domain_id=target_domain_id,
        target_workflow_id=target_workflow_id,
        target_run_id=target_run_id,
        target_child_workflow_only=child_workflow_only,
        initiated_id=initiated_id,
    )


def signal_external_transfer_task(
    target_domain_id: str,
    target_workflow_id: str,
    target_run_id: str,
    child_workflow_only: bool,
    initiated_id: int,
) -> TransferTask:
    return TransferTask(
        task_type=TransferTaskType.SignalExecution,
        target_domain_id=target_domain_id,
        target_workflow_id=target_workflow_id,
        target_run_id=target_run_id,
        target_child_workflow_only=child_workflow_only,
        initiated_id=initiated_id,
    )


@dataclasses.dataclass
class ReplicationTask:
    """History replication task (reference: ReplicationTaskInfo)."""

    domain_id: str = ""
    workflow_id: str = ""
    run_id: str = ""
    task_id: int = 0
    first_event_id: int = 0
    next_event_id: int = 0
    version: int = 0
    scheduled_id: int = 0
    branch_token: bytes = b""
    new_run_branch_token: bytes = b""
    reset_workflow: bool = False
