"""Transfer queue processor (active side).

Reference: Cadence service/history/transferQueueActiveProcessor.go
:238-1099 — per-shard pull pipeline over transfer tasks: push decision/
activity tasks to matching, record visibility, close-execution fan-out
(parent notification + parent-close policy), external cancel/signal,
child-workflow start.

A copy of the reference package's ``runtime/queues/transfer.py``.
Without the standby processors a task of a domain active elsewhere is
held (``DeferTask``); fault injection and the parallel executor's mode
wait for their planes.
"""

from __future__ import annotations

from typing import Optional

from ...core.enums import (
    CancelExternalWorkflowFailedCause,
    ChildWorkflowFailedCause,
    CloseStatus,
    EventType,
    ParentClosePolicy,
    SignalExternalWorkflowFailedCause,
    TransferTaskType,
)
from ...core.ids import EMPTY_EVENT_ID
from ...core.tasks import TransferTask
from ...runtime.api import (
    EntityNotExistsServiceError,
    SignalRequest,
    StartWorkflowRequest,
    WorkflowExecutionAlreadyStartedServiceError,
)
from ...runtime.persistence.records import VisibilityRecord
from ...utils.log import get_logger

from .ack import QueueAckManager
from .allocator import DeferTask, TaskAllocator
from .base import QueueProcessorBase

def open_visibility_record(task, ms) -> VisibilityRecord:
    """Open-execution visibility record from mutable state (shared by
    the active and standby transfer pipelines)."""
    ei = ms.execution_info
    return VisibilityRecord(
        domain_id=task.domain_id,
        workflow_id=task.workflow_id,
        run_id=task.run_id,
        workflow_type=ei.workflow_type_name,
        start_time=ei.start_timestamp,
        execution_time=ei.start_timestamp,
        memo=dict(ei.memo),
        search_attributes=dict(ei.search_attributes),
    )


# close status → the child-close event type recorded in the parent
_CLOSE_EVENT = {
    int(CloseStatus.Completed): EventType.ChildWorkflowExecutionCompleted,
    int(CloseStatus.Failed): EventType.ChildWorkflowExecutionFailed,
    int(CloseStatus.Canceled): EventType.ChildWorkflowExecutionCanceled,
    int(CloseStatus.Terminated): EventType.ChildWorkflowExecutionTerminated,
    int(CloseStatus.TimedOut): EventType.ChildWorkflowExecutionTimedOut,
}


class TransferQueueProcessor(QueueProcessorBase):
    def __init__(
        self,
        shard,
        engine,
        matching,  # MatchingEngine or matching client
        history_client,  # routed history client for cross-workflow calls
        visibility=None,  # VisibilityManager
        worker_count: int = 4,
        batch_size: int = 64,
        metrics=None,
        exhausted_retry_delay_s=None,
    ) -> None:
        self.shard = shard
        self.engine = engine
        self.matching = matching
        self.history_client = history_client
        self.visibility = (
            visibility
            if visibility is not None
            else shard.persistence.visibility
        )
        self._tlog = get_logger(
            "cadence_tpu_torch.queue.transfer", shard=shard.shard_id
        )
        self._allocator = TaskAllocator(
            engine.domains, getattr(engine, "cluster_metadata", None)
        )
        ack = QueueAckManager(
            shard.get_transfer_ack_level(),
            update_shard_ack=shard.update_transfer_ack_level,
        )
        super().__init__(
            name=f"transfer-{shard.shard_id}",
            ack=ack,
            read_batch=lambda level, n: shard.persistence.execution.get_transfer_tasks(
                shard.shard_id, level, 2**62, n
            ),
            process_task=self._process,
            complete_task=lambda t: (
                shard.persistence.execution.complete_transfer_task(
                    shard.shard_id, t.task_id
                )
            ),
            task_key=lambda t: t.task_id,
            worker_count=worker_count,
            batch_size=batch_size,
            metrics=metrics,
            exhausted_retry_delay_s=exhausted_retry_delay_s,
        )

    # -- dispatch ------------------------------------------------------

    def _process(self, task: TransferTask) -> None:
        if self._allocator.owning_cluster(task.domain_id) is not None:
            # the domain is active in another cluster: hold until
            # failover makes us active (the standby plane that would own
            # such a task is not ported)
            raise DeferTask(task.domain_id)
        handler = {
            TransferTaskType.DecisionTask: self._process_decision,
            TransferTaskType.ActivityTask: self._process_activity,
            TransferTaskType.CloseExecution: self._process_close,
            TransferTaskType.CancelExecution: self._process_cancel,
            TransferTaskType.SignalExecution: self._process_signal,
            TransferTaskType.StartChildExecution: self._process_start_child,
            TransferTaskType.RecordWorkflowStarted: self._process_record_started,
            TransferTaskType.UpsertWorkflowSearchAttributes: self._process_upsert,
            TransferTaskType.ResetWorkflow: self._process_reset,
        }.get(task.task_type)
        if handler is None:
            self._tlog.info(f"unknown transfer task type {task.task_type}")
            return
        handler(task)

    def _read_state(self, task: TransferTask, reader):
        """Snapshot fields from the workflow's mutable state; None if the
        workflow is gone (stale task)."""
        try:
            return self.engine.with_workflow(
                task.domain_id, task.workflow_id, task.run_id,
                lambda ctx, ms: reader(ms),
            )
        except EntityNotExistsServiceError:
            return None

    # -- per-type handlers ---------------------------------------------

    def _process_decision(self, task: TransferTask) -> None:
        # verify still pending, resolve sticky task list + timeout
        # (transferQueueActiveProcessor.go processDecisionTask)
        def read(ms):
            ei = ms.execution_info
            if (
                not ms.has_pending_decision()
                or ei.decision_schedule_id != task.schedule_id
                or ei.decision_started_id != EMPTY_EVENT_ID
            ):
                return None
            if ms.is_sticky_task_list_enabled():
                return (ei.sticky_task_list, ei.sticky_schedule_to_start_timeout)
            return (task.task_list or ei.task_list, ei.workflow_timeout)

        target = self._read_state(task, read)
        if target is None:
            return
        task_list, timeout = target
        self.matching.add_decision_task(
            task.domain_id, task.workflow_id, task.run_id,
            task_list, task.schedule_id,
            schedule_to_start_timeout_seconds=timeout,
        )

    def _process_activity(self, task: TransferTask) -> None:
        def read(ms):
            ai = ms.get_activity_info(task.schedule_id)
            if ai is None or ai.started_id != EMPTY_EVENT_ID:
                return None
            return (ai.task_list or task.task_list, ai.schedule_to_start_timeout)

        target = self._read_state(task, read)
        if target is None:
            return
        task_list, timeout = target
        self.matching.add_activity_task(
            task.domain_id, task.workflow_id, task.run_id,
            task_list, task.schedule_id,
            schedule_to_start_timeout_seconds=timeout,
        )

    _CLOSE_ATTR_KEYS = {
        EventType.ChildWorkflowExecutionCompleted: ("result",),
        EventType.ChildWorkflowExecutionFailed: ("reason", "details"),
        EventType.ChildWorkflowExecutionCanceled: ("details",),
        EventType.ChildWorkflowExecutionTimedOut: ("timeout_type",),
        EventType.ChildWorkflowExecutionTerminated: (),
    }

    def _child_close_attrs(self, close_event: EventType, attrs: dict) -> dict:
        keys = self._CLOSE_ATTR_KEYS.get(close_event, ())
        return {k: attrs[k] for k in keys if k in attrs}

    def _process_close(self, task: TransferTask) -> None:
        # (transferQueueActiveProcessor.go processCloseExecution)
        def read(ctx, ms):
            ei = ms.execution_info
            # the close event lives in the final batch — read only that
            first = max(1, ei.completion_event_batch_id)
            history, _ = ctx.read_history(ms, first_event_id=first)
            close_attrs = dict(history[-1].attributes) if history else {}
            return {
                "close_attrs": close_attrs,
                "close_status": int(ei.close_status),
                "workflow_type": ei.workflow_type_name,
                "start_time": ei.start_timestamp,
                "close_time": ei.last_updated_timestamp or self.shard.now(),
                "history_length": ms.next_event_id - 1,
                "parent_domain_id": ei.parent_domain_id,
                "parent_workflow_id": ei.parent_workflow_id,
                "parent_run_id": ei.parent_run_id,
                "parent_initiated_id": ei.initiated_id,
                "memo": dict(ei.memo),
                "search_attributes": dict(ei.search_attributes),
                "branch_token": ei.branch_token,
                "children": [
                    {
                        "policy": ci.parent_close_policy,
                        "domain_id": ms.domain_id,
                        "domain_name": ci.domain_name,
                        "workflow_id": ci.started_workflow_id,
                        "run_id": ci.started_run_id,
                    }
                    for ci in ms.pending_children.values()
                    if ci.started_id != EMPTY_EVENT_ID
                ],
            }

        try:
            snap = self.engine.with_workflow(
                task.domain_id, task.workflow_id, task.run_id, read
            )
        except EntityNotExistsServiceError:
            return
        if self.visibility is not None:
            self.visibility.record_workflow_execution_closed(
                VisibilityRecord(
                    domain_id=task.domain_id,
                    workflow_id=task.workflow_id,
                    run_id=task.run_id,
                    workflow_type=snap["workflow_type"],
                    start_time=snap["start_time"],
                    close_time=snap["close_time"],
                    close_status=snap["close_status"],
                    history_length=snap["history_length"],
                    memo=snap["memo"],
                    search_attributes=snap["search_attributes"],
                )
            )
        # notify parent (RecordChildExecutionCompleted); ContinuedAsNew
        # does not notify — the final run will
        close_event = _CLOSE_EVENT.get(snap["close_status"])
        if snap["parent_workflow_id"] and close_event is not None:
            try:
                self.history_client.record_child_execution_completed(
                    snap["parent_domain_id"], snap["parent_workflow_id"],
                    snap["parent_run_id"], snap["parent_initiated_id"],
                    close_event,
                    child_run_id=task.run_id,
                    **self._child_close_attrs(close_event, snap["close_attrs"]),
                )
            except EntityNotExistsServiceError:
                pass  # parent already gone
        # parent close policy over started children
        # (reference: processCloseExecution → parentclosepolicy)
        for child in snap["children"]:
            self._apply_parent_close_policy(child)
        # archival fan-out (reference: processCloseExecution →
        # archivalClient.Archive when the domain has archival enabled)
        client = getattr(self, "archival_client", None)
        if client is not None:
            try:
                client.maybe_archive(task, snap)
            except Exception:
                self._tlog.exception("archival trigger failed")

    def _apply_parent_close_policy(self, child: dict) -> None:
        policy = child["policy"]
        if policy == ParentClosePolicy.Abandon:
            return
        try:
            domain_name = self.engine.domains.resolve(
                child["domain_name"] or child["domain_id"]
            ).info.name
            if policy == ParentClosePolicy.Terminate:
                self.history_client.terminate_workflow_execution(
                    domain_name, child["workflow_id"], child["run_id"],
                    reason="by parent close policy",
                )
            elif policy == ParentClosePolicy.RequestCancel:
                self.history_client.request_cancel_workflow_execution(
                    domain_name, child["workflow_id"], child["run_id"],
                )
        except EntityNotExistsServiceError:
            pass  # child already closed

    def _process_cancel(self, task: TransferTask) -> None:
        # (processCancelExecution: RPC target, then record result)
        failed_cause: Optional[int] = None
        try:
            target_domain_name = self.engine.domains.get_by_id(
                task.target_domain_id
            ).info.name
            self.history_client.request_cancel_workflow_execution(
                target_domain_name, task.target_workflow_id,
                task.target_run_id,
            )
        except EntityNotExistsServiceError:
            failed_cause = int(
                CancelExternalWorkflowFailedCause.UnknownExternalWorkflowExecution
            )
        self.engine.record_external_cancel_result(
            task.domain_id, task.workflow_id, task.run_id,
            task.initiated_id, task.target_domain_id,
            task.target_workflow_id, task.target_run_id,
            failed_cause=failed_cause,
        )

    def _process_signal(self, task: TransferTask) -> None:
        def read(ms):
            si = ms.get_signal_info(task.initiated_id)
            if si is None:
                return None
            return (si.signal_name, si.input, si.control, si.signal_request_id)

        sig = self._read_state(task, read)
        if sig is None:
            return
        signal_name, input_, control, request_id = sig
        failed_cause: Optional[int] = None
        try:
            target_domain_name = self.engine.domains.get_by_id(
                task.target_domain_id
            ).info.name
            self.history_client.signal_workflow_execution(
                SignalRequest(
                    domain=target_domain_name,
                    workflow_id=task.target_workflow_id,
                    run_id=task.target_run_id, signal_name=signal_name,
                    input=input_, request_id=request_id,
                )
            )
        except EntityNotExistsServiceError:
            failed_cause = int(
                SignalExternalWorkflowFailedCause.UnknownExternalWorkflowExecution
            )
        self.engine.record_external_signal_result(
            task.domain_id, task.workflow_id, task.run_id,
            task.initiated_id, task.target_domain_id,
            task.target_workflow_id, task.target_run_id,
            control=control, failed_cause=failed_cause,
        )

    def _process_start_child(self, task: TransferTask) -> None:
        # (processStartChildExecution: read initiated attrs from the
        # events cache — history branch on miss — then start the child
        # with parent linkage, record started/failed in the parent)
        def read(ctx, ms):
            ci = ms.get_child_execution_info(task.initiated_id)
            if ci is None:
                return None
            if ci.started_id != EMPTY_EVENT_ID:
                return {"already_started": True, "ci": ci}
            initiated = ctx.get_event(
                ms, task.initiated_id,
                first_event_id=max(1, ci.initiated_event_batch_id),
            )
            return {
                "already_started": False,
                "ci": ci,
                "initiated_attrs": dict(initiated.attributes)
                if initiated is not None
                else None,
            }

        try:
            snap = self.engine.with_workflow(
                task.domain_id, task.workflow_id, task.run_id, read
            )
        except EntityNotExistsServiceError:
            return
        if snap is None or snap["already_started"]:
            return
        attrs = snap["initiated_attrs"]
        if attrs is None:
            return
        ci = snap["ci"]
        child_domain = self.engine.domains.resolve(
            attrs.get("domain") or ci.domain_name or task.domain_id
        )
        child_domain_name = child_domain.info.name
        child_domain_id = child_domain.info.id
        parent_domain_name = self.engine.domains.get_by_id(
            task.domain_id
        ).info.name
        request = StartWorkflowRequest(
            domain=child_domain_name,
            workflow_id=attrs.get("workflow_id", ci.started_workflow_id),
            workflow_type=attrs.get("workflow_type", ci.workflow_type_name),
            task_list=attrs.get("task_list", ""),
            execution_start_to_close_timeout_seconds=attrs.get(
                "execution_start_to_close_timeout_seconds", 60
            ),
            task_start_to_close_timeout_seconds=attrs.get(
                "task_start_to_close_timeout_seconds", 10
            ),
            input=attrs.get("input", b""),
            request_id=ci.create_request_id,
            workflow_id_reuse_policy=attrs.get(
                "workflow_id_reuse_policy", 0
            ),
            retry_policy=attrs.get("retry_policy"),
            cron_schedule=attrs.get("cron_schedule", ""),
            parent_domain=parent_domain_name,
            parent_workflow_id=task.workflow_id,
            parent_run_id=task.run_id,
            parent_initiated_id=task.initiated_id,
        )
        try:
            child_run_id = self.history_client.start_workflow_execution(
                request, domain_id=child_domain_id
            )
        except WorkflowExecutionAlreadyStartedServiceError:
            self.engine.record_start_child_execution_failed(
                task.domain_id, task.workflow_id, task.run_id,
                task.initiated_id, child_domain_name,
                request.workflow_id, request.workflow_type,
                cause=int(ChildWorkflowFailedCause.WorkflowAlreadyRunning),
            )
            return
        self.engine.record_child_execution_started(
            task.domain_id, task.workflow_id, task.run_id,
            task.initiated_id, child_domain_name,
            request.workflow_id, child_run_id, request.workflow_type,
        )

    def _open_visibility_record(self, task: TransferTask):
        return self._read_state(
            task, lambda ms: open_visibility_record(task, ms)
        )

    def _process_record_started(self, task: TransferTask) -> None:
        rec = self._open_visibility_record(task)
        if rec is not None and self.visibility is not None:
            self.visibility.record_workflow_execution_started(rec)

    def _process_upsert(self, task: TransferTask) -> None:
        rec = self._open_visibility_record(task)
        if rec is not None and self.visibility is not None:
            self.visibility.upsert_workflow_execution(rec)

    def _process_reset(self, task: TransferTask) -> None:
        # reset-workflow fan-out is driven by the resetor; the transfer
        # task only records visibility of the reset point in the reference
        self._tlog.info(
            f"reset transfer task for {task.workflow_id} (handled by resetor)"
        )
