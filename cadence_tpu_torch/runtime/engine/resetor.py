"""User-initiated workflow reset.

Reference: service/history/workflowResetor.go:692,941 — fork the history
branch at a decision boundary, replay the prefix into a fresh run via
the shared StateBuilder (the same replay the TPU kernel accelerates),
fail the in-flight decision with cause ResetWorkflow, carry signals
recorded after the reset point into the new run, terminate the old run,
and persist both atomically-enough (old update + new create).

A copy of the reference package's ``runtime/engine/resetor.py``. The
port holds the shard's ``task_write_lock`` from the task-id assignment
through the store write.
"""

from __future__ import annotations

import uuid
from typing import List, Optional, Tuple

from ...core.active_transaction import ActiveTransaction
from ...core.enums import (
    DecisionTaskFailedCause,
    EventType,
)
from ...core.events import HistoryEvent
from ...core.ids import EMPTY_EVENT_ID
from ...core.mutable_state import MutableState
from ...core.state_builder import StateBuilder
from ...core.version_history import VersionHistories

from ..api import BadRequestError, InternalServiceError
from ..persistence.records import (
    BranchToken,
    CreateWorkflowMode,
    WorkflowSnapshot,
)

_DECISION_FINISH_TYPES = frozenset(
    {
        EventType.DecisionTaskCompleted,
        EventType.DecisionTaskFailed,
        EventType.DecisionTaskTimedOut,
    }
)


class WorkflowResetor:
    def __init__(self, engine) -> None:
        self.engine = engine
        self.shard = engine.shard

    # -- public --------------------------------------------------------

    def reset_workflow_execution(
        self,
        domain_id: str,
        workflow_id: str,
        run_id: str,
        reason: str,
        decision_finish_event_id: int,
        request_id: str = "",
        identity: str = "",
    ) -> str:
        """Returns the new run id."""
        engine = self.engine
        ctx = engine.cache.get_or_create(domain_id, workflow_id, run_id)
        with ctx.lock:
            ms = ctx.load()
            base_events = self._read_all_events(ctx, ms)
            self._validate(ms, base_events, decision_finish_event_id)

            new_run_id = str(uuid.uuid4())
            new_ms, sb = self._replay_prefix(
                domain_id, workflow_id, new_run_id,
                base_events, decision_finish_event_id,
            )

            # fail the in-flight decision + carry post-reset signals +
            # schedule a fresh decision
            txn = ActiveTransaction(
                new_ms, domain_id, workflow_id, new_run_id,
                new_ms.current_version,
                request_id=request_id or str(uuid.uuid4()),
            )
            now = self.shard.now()
            ei = new_ms.execution_info
            if ei.decision_started_id != EMPTY_EVENT_ID:
                txn.add_decision_task_failed(
                    ei.decision_schedule_id, ei.decision_started_id, now,
                    cause=int(DecisionTaskFailedCause.ResetWorkflow),
                    identity=identity,
                    details=reason.encode(),
                )
            # post-cut signals come from persisted history AND from the
            # old run's buffered events (signals held behind an in-flight
            # decision are not yet in history but must survive the reset)
            carried = self._signals_after(
                base_events, decision_finish_event_id
            ) + [
                e
                for e in ms.buffered_events
                if e.event_type == EventType.WorkflowExecutionSignaled
            ]
            for sig in carried:
                a = sig.attributes
                txn.add_workflow_execution_signaled(
                    a.get("signal_name", ""), a.get("input", b""),
                    a.get("identity", ""), now,
                )
            if not new_ms.has_pending_decision():
                txn.add_decision_task_scheduled(now)
            result = txn.close()

            # terminate the old run if it is still running
            self._close_old_run(ctx, ms, reason, identity)

            # persist the new run on a forked branch
            try:
                self._persist_new_run(
                    ctx, ms, new_ms, result, decision_finish_event_id
                )
            except BaseException as e:
                # the old run is already durably terminated; drop the
                # cached state and surface a precise error so the
                # operator retries the reset (idempotent: the old run
                # terminates at most once, the new run id is fresh)
                ctx.clear()
                raise InternalServiceError(
                    f"reset of {workflow_id}/{run_id} terminated the "
                    f"old run but failed to create the new run: {e}; "
                    "retry the reset"
                ) from e
        engine._notify(result)
        return new_run_id

    # -- internals -----------------------------------------------------

    def _read_all_events(self, ctx, ms: MutableState) -> List[HistoryEvent]:
        events, _ = ctx.read_history(ms)
        return events

    def _validate(
        self, ms: MutableState, events: List[HistoryEvent], finish_id: int
    ) -> None:
        if finish_id <= 1 or finish_id > ms.next_event_id:
            raise BadRequestError(
                f"decision_finish_event_id {finish_id} out of range "
                f"(1, {ms.next_event_id}]"
            )
        # the cut must sit at a decision boundary: the last event kept is
        # DecisionTaskStarted, i.e. the event AT finish_id (if recorded)
        # is a decision finish
        by_id = {e.event_id: e for e in events}
        prev = by_id.get(finish_id - 1)
        if prev is None or prev.event_type != EventType.DecisionTaskStarted:
            at = by_id.get(finish_id)
            if at is None or at.event_type not in _DECISION_FINISH_TYPES:
                raise BadRequestError(
                    "reset point must be a decision finish event "
                    "(DecisionTaskCompleted/Failed/TimedOut)"
                )

    def _replay_prefix(
        self,
        domain_id: str,
        workflow_id: str,
        new_run_id: str,
        events: List[HistoryEvent],
        finish_id: int,
    ) -> Tuple[MutableState, StateBuilder]:
        prefix = [e for e in events if e.event_id < finish_id]
        new_ms = MutableState(domain_id=domain_id)
        if self.engine.domains.get_by_id(domain_id).is_global:
            new_ms.version_histories = VersionHistories.new_empty()
        sb = StateBuilder(
            new_ms,
            domain_resolver=lambda name: (
                self.engine.domains.resolve(name).info.id if name else ""
            ),
        )
        sb.apply_events(
            domain_id, "reset", workflow_id, new_run_id, prefix
        )
        # replay ran in passive mode; the new run continues active
        new_ms.execution_info.run_id = new_run_id
        return new_ms, sb

    def _signals_after(
        self, events: List[HistoryEvent], finish_id: int
    ) -> List[HistoryEvent]:
        return [
            e
            for e in events
            if e.event_id >= finish_id
            and e.event_type == EventType.WorkflowExecutionSignaled
        ]

    def _close_old_run(
        self, ctx, ms: MutableState, reason: str, identity: str
    ) -> None:
        if not ms.is_workflow_execution_running():
            return
        txn = self.engine._txn(ctx, ms, ms.current_version)
        txn.add_workflow_execution_terminated(
            self.shard.now(), reason=f"reset: {reason}", identity=identity
        )
        result = txn.close()
        ctx.update_workflow(ms, result)
        self.engine._notify(result)

    def _persist_new_run(
        self,
        ctx,
        old_ms: MutableState,
        new_ms: MutableState,
        result,
        finish_id: int,
    ) -> None:
        history = self.shard.persistence.history
        base_branch = BranchToken.from_json(
            old_ms.execution_info.branch_token.decode()
        )
        forked = history.fork_history_branch(base_branch, finish_id)
        new_ms.execution_info.branch_token = forked.to_json().encode()
        if new_ms.version_histories is not None:
            new_ms.version_histories.get_current_version_history(
            ).branch_token = new_ms.execution_info.branch_token
        if result.events:
            history.append_history_nodes(
                forked, result.events,
                transaction_id=self.shard.next_task_id(),
            )
        from ...core.task_refresher import refresh_tasks

        # the new run inherits the forked prefix: carry the byte
        # accounting so the 200MB history-size limit doesn't restart
        # from zero after every reset
        new_ms.execution_info.history_size = (
            old_ms.execution_info.history_size
        )

        transfer, timer = refresh_tasks(new_ms)
        ei = new_ms.execution_info
        for t in transfer + timer:
            t.domain_id = t.domain_id or ei.domain_id
            t.workflow_id = t.workflow_id or ei.workflow_id
            t.run_id = t.run_id or ei.run_id
        with self.shard.task_write_lock:
            self.shard.assign_task_ids(transfer, timer)
            snapshot = WorkflowSnapshot(
                domain_id=ei.domain_id,
                workflow_id=ei.workflow_id,
                run_id=ei.run_id,
                snapshot=new_ms.snapshot(),
                next_event_id=new_ms.next_event_id,
                last_write_version=new_ms.current_version,
                transfer_tasks=transfer,
                timer_tasks=timer,
            )
            self.shard.persistence.execution.create_workflow_execution(
                self.shard.shard_id,
                self.shard.range_id,
                CreateWorkflowMode.WORKFLOW_ID_REUSE,
                snapshot,
                prev_run_id=old_ms.execution_info.run_id,
            )
