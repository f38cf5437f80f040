"""Workflow execution context: load / persist orchestration.

Reference: service/history/workflowExecutionContext.go — the component
that knows how a closed ActiveTransaction becomes durable: append the
event batch to the history branch, stamp queue-task IDs from the shard
sequencer, then write the mutable-state snapshot conditioned on the
load-time next_event_id (and the shard's range_id), creating the
continue-as-new run atomically when present.

A copy of the reference package's ``runtime/engine/context.py``. The
port holds the shard's ``task_write_lock`` from a transaction's task-id
assignment through its store write.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from ...core.active_transaction import TransactionResult
from ...core.events import HistoryEvent
from ...core.mutable_state import MutableState
from ...core.tasks import ReplicationTask
from ...utils.locks import make_rlock

from ..persistence.records import (
    BranchToken,
    CreateWorkflowMode,
    WorkflowSnapshot,
)
from ..shard import ShardContext


class WorkflowExecutionContext:
    def __init__(
        self,
        shard: ShardContext,
        domain_id: str,
        workflow_id: str,
        run_id: str,
        on_persist=None,
        events_cache=None,
    ) -> None:
        self.shard = shard
        self.domain_id = domain_id
        self.workflow_id = workflow_id
        self.run_id = run_id
        self.lock = make_rlock("WorkflowExecutionContext.lock")
        self._ms: Optional[MutableState] = None
        self._condition = 0
        # invoked after every durable write (historyEventNotifier feed)
        self._on_persist = on_persist or (lambda ms: None)
        # shard-level event LRU (engine/events_cache.py); None in bare
        # test harnesses — get_event then always pages history
        self.events_cache = events_cache

    def _drain_cached_events(self, ms: MutableState, run_id: str = "") -> None:
        """Move transition-written events (activity scheduled, child
        initiated, ...) into the shard events cache, keeping the
        mutable state bounded (ref eventsCache.go putEvent)."""
        if self.events_cache is not None:
            for e in ms.cached_events:
                self.events_cache.put(
                    self.domain_id, self.workflow_id,
                    run_id or self.run_id, e,
                )
        ms.cached_events.clear()

    def get_event(
        self, ms: MutableState, event_id: int, first_event_id: int = 1
    ):
        """Event lookup: staged → shard cache → history branch
        (ref eventsCache.go getEvent's history fallback)."""
        for e in ms.cached_events:
            if e.event_id == event_id:
                return e
        if self.events_cache is not None:
            hit = self.events_cache.get(
                self.domain_id, self.workflow_id, self.run_id, event_id
            )
            if hit is not None:
                return hit
        history, _ = self.read_history(ms, first_event_id=first_event_id)
        for e in history:
            if e.event_id == event_id:
                # cache only the requested event — inserting the whole
                # page would let one deep-history lookup evict the
                # shard cache's hot entries
                if self.events_cache is not None:
                    self.events_cache.put(
                        self.domain_id, self.workflow_id, self.run_id, e
                    )
                return e
        return None

    # -- load ---------------------------------------------------------

    def load(self) -> MutableState:
        if self._ms is None:
            resp = self.shard.persistence.execution.get_workflow_execution(
                self.shard.shard_id, self.domain_id, self.workflow_id,
                self.run_id,
            )
            self._ms = MutableState.from_snapshot(resp.snapshot)
            self._condition = resp.next_event_id
        return self._ms

    def clear(self) -> None:
        """Drop cached state (after a condition failure — reload next)."""
        self._ms = None

    @property
    def condition(self) -> int:
        return self._condition

    # -- history ------------------------------------------------------

    def branch_token(self, ms: MutableState) -> BranchToken:
        raw = ms.execution_info.branch_token
        return BranchToken.from_json(raw.decode())

    def _append_events(
        self, branch: BranchToken, events: List[HistoryEvent]
    ) -> int:
        if not events:
            return 0
        return self.shard.persistence.history.append_history_nodes(
            branch, events, transaction_id=self.shard.next_task_id()
        )

    # -- persist ------------------------------------------------------

    def _stamp_identity(self, run_id: str, *task_lists) -> None:
        """Stamp workflow identity onto queue tasks (the reference's task
        rows carry domainID/workflowID/runID; the StateBuilder emits them
        identity-free so replay stays pure)."""
        for tasks in task_lists:
            for t in tasks:
                if not t.domain_id:
                    t.domain_id = self.domain_id
                if not t.workflow_id:
                    t.workflow_id = self.workflow_id
                if not t.run_id:
                    t.run_id = run_id

    def _replication_tasks(
        self, ms: MutableState, events: List[HistoryEvent],
        new_run_branch: bytes = b"",
    ) -> List[ReplicationTask]:
        """Active-side replication task for one persisted event batch.

        Reference: mutableStateBuilder closeTransactionHandleWorkflow-
        ReplicationTask — global domains (version histories present) emit
        one HistoryReplicationTask per transaction batch so the
        replicator queue can ship it to remote clusters."""
        if ms.version_histories is None or not events:
            return []
        return [
            ReplicationTask(
                first_event_id=events[0].event_id,
                next_event_id=events[-1].event_id + 1,
                version=events[0].version,
                branch_token=ms.execution_info.branch_token,
                new_run_branch_token=new_run_branch,
            )
        ]

    def _snapshot_of(
        self, ms: MutableState, result_tasks: TransactionResult,
        new_run: bool = False,
        replication_tasks: Optional[List[ReplicationTask]] = None,
    ) -> WorkflowSnapshot:
        ei = ms.execution_info
        return WorkflowSnapshot(
            domain_id=self.domain_id,
            workflow_id=self.workflow_id,
            run_id=ei.run_id,
            snapshot=ms.snapshot(),
            next_event_id=ms.next_event_id,
            last_write_version=ms.current_version,
            transfer_tasks=(
                result_tasks.new_run_transfer_tasks
                if new_run
                else result_tasks.transfer_tasks
            ),
            timer_tasks=(
                result_tasks.new_run_timer_tasks
                if new_run
                else result_tasks.timer_tasks
            ),
            replication_tasks=replication_tasks or [],
        )

    def create_workflow(
        self,
        ms: MutableState,
        result: TransactionResult,
        mode: int = CreateWorkflowMode.BRAND_NEW,
        prev_run_id: str = "",
    ) -> None:
        """First persistence of a new run: new branch, events, record."""
        history = self.shard.persistence.history
        branch = history.new_history_branch(tree_id=self.run_id)
        ms.execution_info.branch_token = branch.to_json().encode()
        if ms.version_histories is not None:
            ms.version_histories.get_current_version_history().branch_token = (
                ms.execution_info.branch_token
            )
        size = self._append_events(branch, result.events)
        ms.execution_info.history_size = size
        repl = self._replication_tasks(ms, result.events)
        with self.shard.task_write_lock:
            self.shard.assign_task_ids(
                result.transfer_tasks, result.timer_tasks, repl
            )
            self._stamp_identity(
                self.run_id, result.transfer_tasks, result.timer_tasks, repl
            )
            self.shard.persistence.execution.create_workflow_execution(
                self.shard.shard_id,
                self.shard.range_id,
                mode,
                self._snapshot_of(ms, result, replication_tasks=repl),
                prev_run_id=prev_run_id,
            )
        self._ms = ms
        self._condition = ms.next_event_id
        self._drain_cached_events(ms)
        self._on_persist(ms)

    def update_workflow(
        self, ms: MutableState, result: TransactionResult
    ) -> None:
        """Persist a mutation of a loaded workflow (+ CAN run if staged)."""
        size = 0
        if result.events:
            size = self._append_events(self.branch_token(ms), result.events)
        ms.execution_info.history_size += size

        new_snapshot = None
        new_ms = None
        new_run_id = ""
        new_run_branch = b""
        if result.new_run_ms is not None:
            new_ms = result.new_run_ms
            new_run_id = result.events[-1].attributes.get(
                "new_execution_run_id", ""
            )
            new_ms.execution_info.run_id = new_run_id
            branch = self.shard.persistence.history.new_history_branch(
                tree_id=new_run_id
            )
            new_ms.execution_info.branch_token = branch.to_json().encode()
            if new_ms.version_histories is not None:
                new_ms.version_histories.get_current_version_history(
                ).branch_token = new_ms.execution_info.branch_token
            new_run_branch = new_ms.execution_info.branch_token
            new_size = self._append_events(branch, result.new_run_events)
            new_ms.execution_info.history_size = new_size

        repl = self._replication_tasks(ms, result.events, new_run_branch)
        with self.shard.task_write_lock:
            if new_ms is not None:
                self.shard.assign_task_ids(
                    result.new_run_transfer_tasks, result.new_run_timer_tasks
                )
                self._stamp_identity(
                    new_run_id,
                    result.new_run_transfer_tasks,
                    result.new_run_timer_tasks,
                )
                new_snapshot = self._snapshot_of(
                    new_ms, result, new_run=True
                )
            self.shard.assign_task_ids(
                result.transfer_tasks, result.timer_tasks, repl
            )
            self._stamp_identity(
                self.run_id, result.transfer_tasks, result.timer_tasks, repl
            )
            self.shard.persistence.execution.update_workflow_execution(
                self.shard.shard_id,
                self.shard.range_id,
                self._condition,
                self._snapshot_of(ms, result, replication_tasks=repl),
                new_snapshot=new_snapshot,
            )
        self._condition = ms.next_event_id
        self._drain_cached_events(ms)
        if result.new_run_ms is not None:
            self._drain_cached_events(result.new_run_ms, run_id=new_run_id)
        self._on_persist(ms)

    # -- reads --------------------------------------------------------

    def read_history(
        self,
        ms: MutableState,
        first_event_id: int = 1,
        next_event_id: int = 0,
        page_size: int = 0,
        next_token: int = 0,
    ) -> Tuple[List[HistoryEvent], int]:
        branch = self.branch_token(ms)
        batches, token = self.shard.persistence.history.read_history_branch(
            branch,
            first_event_id,
            next_event_id or ms.next_event_id,
            page_size=page_size,
            next_token=next_token,
        )
        return [e for batch in batches for e in batch], token
