"""The five-manager persistence contract.

Abstract base classes mirroring the reference's manager interfaces
(Cadence common/persistence/dataInterfaces.go:1470-1596 and
visibilityInterfaces.go:167). Every backend (memory, sqlite) implements
all of them; the conformance suite in tests/test_persistence.py runs
identically against each — the reference's persistence-tests pattern.

Concurrency contract (identical to the reference):
  * every execution write carries the shard's ``range_id``; a stored
    range_id greater than the caller's fences the write with
    ShardOwnershipLostError (Cassandra LWT ``IF range_id = ?``,
    reference cassandraPersistence.go:397-406);
  * update_workflow_execution additionally carries ``condition`` — the
    next_event_id read at load; mismatch raises ConditionFailedError and
    the caller re-loads and retries (Update_History_Loop);
  * task-list writes carry the lease range_id the same way.

A copy of the reference package's ``runtime/persistence/interfaces.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ...core.events import HistoryEvent
from ...core.tasks import ReplicationTask, TimerTask, TransferTask

from .records import (
    BranchToken,
    CurrentExecution,
    DomainRecord,
    GetWorkflowResponse,
    ShardInfo,
    TaskInfo,
    TaskListInfo,
    VisibilityRecord,
    WorkflowSnapshot,
)


class ShardManager:
    def create_shard(self, info: ShardInfo) -> None:
        raise NotImplementedError

    def get_shard(self, shard_id: int) -> ShardInfo:
        raise NotImplementedError

    def update_shard(self, info: ShardInfo, previous_range_id: int) -> None:
        """Conditioned on the stored range_id == previous_range_id."""
        raise NotImplementedError

    # -- elastic resharding (runtime/resharding.py) -------------------

    def get_reshard_state(self) -> Optional[Tuple[int, str]]:
        """The singleton routing-epoch row: ``(epoch, blob)`` where the
        blob carries the committed ShardMap + the in-flight/last
        ReshardPlan (the reconfiguration write-ahead record), or None
        when no reshard was ever attempted."""
        raise NotImplementedError

    def set_reshard_state(
        self, epoch: int, blob: str, previous_epoch: int
    ) -> None:
        """LWT on the stored epoch (an absent row reads as epoch 0):
        raises ConditionFailedError when ``previous_epoch`` doesn't
        match — two coordinators can never both commit an epoch."""
        raise NotImplementedError

    # -- adaptive geo-replication (runtime/replication/) ---------------

    def get_replication_progress(
        self, shard_id: int, cluster: str
    ) -> Optional[Tuple[int, str]]:
        """The consumer-side replication progress row for one
        (shard, remote cluster) link: ``(version, blob)`` where the
        blob carries the durably applied cursor + transport mode
        (processor._progress_blob), or None when the link has never
        persisted progress."""
        raise NotImplementedError

    def set_replication_progress(
        self, shard_id: int, cluster: str, blob: str,
        previous_version: int,
    ) -> None:
        """LWT on the stored version (an absent row reads as version
        0); the stored version becomes ``previous_version + 1``. Raises
        ConditionFailedError on mismatch — same torn-write-retry
        discipline as ``set_reshard_state``: a retry that re-reads the
        blob it meant to write treats the torn write as landed."""
        raise NotImplementedError


class ExecutionManager:
    """Per-shard workflow-execution store + transfer/timer/replication
    queues (the queues live here because they commit atomically with the
    execution write, as in the reference's batched LWT)."""

    # -- executions ---------------------------------------------------

    def create_workflow_execution(
        self,
        shard_id: int,
        range_id: int,
        mode: int,
        snapshot: WorkflowSnapshot,
        prev_run_id: str = "",
        prev_last_write_version: int = 0,
    ) -> None:
        raise NotImplementedError

    def get_workflow_execution(
        self, shard_id: int, domain_id: str, workflow_id: str, run_id: str
    ) -> GetWorkflowResponse:
        raise NotImplementedError

    def update_workflow_execution(
        self,
        shard_id: int,
        range_id: int,
        condition: int,
        mutation: WorkflowSnapshot,
        new_snapshot: Optional[WorkflowSnapshot] = None,
        new_mode: int = 2,  # CreateWorkflowMode.CONTINUE_AS_NEW
    ) -> None:
        """Update current run; optionally create the continue-as-new run
        atomically."""
        raise NotImplementedError

    def conflict_resolve_workflow_execution(
        self,
        shard_id: int,
        range_id: int,
        condition: int,
        reset_snapshot: WorkflowSnapshot,
    ) -> None:
        """Replace mutable state wholesale (reset / NDC conflict resolve)."""
        raise NotImplementedError

    def delete_workflow_execution(
        self, shard_id: int, domain_id: str, workflow_id: str, run_id: str
    ) -> None:
        raise NotImplementedError

    def delete_current_workflow_execution(
        self, shard_id: int, domain_id: str, workflow_id: str, run_id: str
    ) -> None:
        raise NotImplementedError

    def get_current_execution(
        self, shard_id: int, domain_id: str, workflow_id: str
    ) -> CurrentExecution:
        raise NotImplementedError

    def list_concrete_executions(
        self, shard_id: int
    ) -> List[Tuple[str, str, str]]:
        """(domain_id, workflow_id, run_id) triples — scavenger support."""
        raise NotImplementedError

    # -- elastic resharding (runtime/resharding.py) -------------------

    def reshard_extract(
        self,
        shard_id: int,
        workflow_ids: List[str],
        transfer_watermark: int,
        timer_watermark: Tuple[int, int],
        delete: bool = False,
    ) -> Dict[str, list]:
        """Collect everything of ``workflow_ids`` that must move with a
        shard handoff: execution rows, current-execution rows, and the
        pending queue tasks past the drained ack watermarks (tasks
        at/below a watermark are durably complete and stay behind).
        Replication tasks for the moved workflows move wholesale (their
        per-cluster read cursors are shard-local, so moved tasks are
        re-minted above the target's cursor).

        ``delete=False`` is a pure read — the coordinator's
        copy-then-purge move keeps the source rows intact until the
        target copy durably landed (crash-safe in every window);
        ``delete=True`` removes atomically (rollback cleanup).

        Returns ``{"executions", "currents", "transfer", "timers",
        "replication"}`` — the exact payload ``reshard_install``
        accepts, on this or any other backend of the same schema."""
        raise NotImplementedError

    def reshard_install(
        self,
        shard_id: int,
        range_id: int,
        extracted: Dict[str, list],
        task_id_fn,
    ) -> None:
        """Atomically install an extracted payload under ``shard_id``,
        re-minting every queue task id from ``task_id_fn`` (the target
        shard's block sequencer — moved tasks can never regress or
        collide with the target's ids). Conditioned on the target's
        stored range_id == ``range_id`` (all-or-nothing: a fenced or
        partially-failed install leaves the target untouched)."""
        raise NotImplementedError

    def reshard_purge(
        self, shard_id: int, extracted: Dict[str, list]
    ) -> None:
        """Delete exactly the rows named in an extracted payload from
        ``shard_id`` (by ORIGINAL task ids) — the final step of a
        copy-then-purge move. Idempotent."""
        raise NotImplementedError

    # -- transfer queue -----------------------------------------------

    def get_transfer_tasks(
        self, shard_id: int, read_level: int, max_read_level: int, batch_size: int
    ) -> List[TransferTask]:
        raise NotImplementedError

    def complete_transfer_task(self, shard_id: int, task_id: int) -> None:
        raise NotImplementedError

    def range_complete_transfer_tasks(
        self, shard_id: int, exclusive_begin: int, inclusive_end: int
    ) -> None:
        raise NotImplementedError

    # -- timer queue --------------------------------------------------

    def get_timer_tasks(
        self, shard_id: int, min_ts: int, max_ts: int, batch_size: int,
        after_key: Optional[Tuple[int, int]] = None,
    ) -> List[TimerTask]:
        """Tasks with min_ts <= visibility_timestamp < max_ts, ordered
        by (visibility_timestamp, task_id). ``after_key`` is an
        EXCLUSIVE (ts, task_id) resume cursor: pumps page past held
        (deferred) tasks with it, so a span of waiting standby tasks
        cannot starve everything behind them."""
        raise NotImplementedError

    def complete_timer_task(
        self, shard_id: int, visibility_ts: int, task_id: int
    ) -> None:
        raise NotImplementedError

    def range_complete_timer_tasks(
        self, shard_id: int, inclusive_begin_ts: int, exclusive_end_ts: int
    ) -> None:
        raise NotImplementedError

    # -- replication queue --------------------------------------------

    def get_replication_tasks(
        self, shard_id: int, read_level: int, batch_size: int
    ) -> List[ReplicationTask]:
        raise NotImplementedError

    def complete_replication_task(self, shard_id: int, task_id: int) -> None:
        raise NotImplementedError


class HistoryManager:
    """History-as-tree: append-only branches of event-batch nodes
    (reference: historyV2Store.go; node_id == first event id of batch)."""

    def new_history_branch(self, tree_id: str) -> BranchToken:
        raise NotImplementedError

    def append_history_nodes(
        self,
        branch: BranchToken,
        events: List[HistoryEvent],
        transaction_id: int,
    ) -> int:
        """Returns stored size in bytes. Highest transaction_id wins on
        node-id collision (reference's fork/conflict discipline)."""
        raise NotImplementedError

    def read_history_branch(
        self,
        branch: BranchToken,
        min_event_id: int,
        max_event_id: int,
        page_size: int = 0,
        next_token: int = 0,
    ) -> Tuple[List[List[HistoryEvent]], int]:
        """Batches with min_event_id <= first event id < max_event_id.
        Returns (batches, next_token); next_token 0 == done."""
        raise NotImplementedError

    def fork_history_branch(
        self, branch: BranchToken, fork_node_id: int
    ) -> BranchToken:
        """New branch whose ancestor chain covers [..., fork_node_id)."""
        raise NotImplementedError

    def delete_history_branch(self, branch: BranchToken) -> None:
        raise NotImplementedError

    def get_history_tree(self, tree_id: str) -> List[BranchToken]:
        raise NotImplementedError


class TaskManager:
    """Matching task storage (reference: TaskManager,
    dataInterfaces.go:1520-1540 + taskListManager lease semantics)."""

    def lease_task_list(
        self, domain_id: str, name: str, task_type: int
    ) -> TaskListInfo:
        """Creates if absent; bumps range_id (a new lease)."""
        raise NotImplementedError

    def update_task_list(self, info: TaskListInfo) -> None:
        """Conditioned on stored range_id == info.range_id."""
        raise NotImplementedError

    def create_tasks(
        self, info: TaskListInfo, tasks: List[TaskInfo]
    ) -> None:
        raise NotImplementedError

    def get_tasks(
        self,
        domain_id: str,
        name: str,
        task_type: int,
        read_level: int,
        max_read_level: int,
        batch_size: int,
    ) -> List[TaskInfo]:
        raise NotImplementedError

    def complete_task(
        self, domain_id: str, name: str, task_type: int, task_id: int
    ) -> None:
        raise NotImplementedError

    def complete_tasks_less_than(
        self, domain_id: str, name: str, task_type: int, task_id: int
    ) -> int:
        raise NotImplementedError

    def list_task_lists(self) -> List[TaskListInfo]:
        raise NotImplementedError

    def delete_task_list(
        self, domain_id: str, name: str, task_type: int, range_id: int
    ) -> None:
        raise NotImplementedError


class MetadataManager:
    """Domain CRUD (reference: MetadataManager + domain notification
    versions driving cache refresh)."""

    def create_domain(self, record: DomainRecord) -> str:
        raise NotImplementedError

    def get_domain(
        self, id: str = "", name: str = ""
    ) -> DomainRecord:
        raise NotImplementedError

    def update_domain(self, record: DomainRecord) -> None:
        raise NotImplementedError

    def delete_domain(self, id: str = "", name: str = "") -> None:
        raise NotImplementedError

    def list_domains(self) -> List[DomainRecord]:
        raise NotImplementedError

    def get_metadata_version(self) -> int:
        raise NotImplementedError


class VisibilityManager:
    def record_workflow_execution_started(self, rec: VisibilityRecord) -> None:
        raise NotImplementedError

    def record_workflow_execution_closed(self, rec: VisibilityRecord) -> None:
        raise NotImplementedError

    def upsert_workflow_execution(self, rec: VisibilityRecord) -> None:
        raise NotImplementedError

    def list_open_workflow_executions(
        self,
        domain_id: str,
        earliest_start: int = 0,
        latest_start: int = 2**63 - 1,
        workflow_type: str = "",
        workflow_id: str = "",
        page_size: int = 100,
        next_token: int = 0,
    ) -> Tuple[List[VisibilityRecord], int]:
        raise NotImplementedError

    def list_closed_workflow_executions(
        self,
        domain_id: str,
        earliest_start: int = 0,
        latest_start: int = 2**63 - 1,
        workflow_type: str = "",
        workflow_id: str = "",
        close_status: int = -1,
        page_size: int = 100,
        next_token: int = 0,
    ) -> Tuple[List[VisibilityRecord], int]:
        raise NotImplementedError

    def get_closed_workflow_execution(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> VisibilityRecord:
        raise NotImplementedError

    def count_workflow_executions(
        self, domain_id: str, open_only: bool = False
    ) -> int:
        raise NotImplementedError

    def delete_workflow_execution(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> None:
        raise NotImplementedError


class PersistenceBundle:
    """All managers for one datastore — what a backend factory returns.

    ``checkpoint`` (a checkpoint.store.CheckpointStore) is
    optional: it rides in the bundle so the decorator factory
    (``wrap_bundle``) stacks metrics/fault-injection over checkpoint
    I/O exactly like the five core managers, but nothing in the
    runtime requires it — a None store simply disables checkpointed
    incremental replay."""

    def __init__(
        self,
        shard: ShardManager,
        execution: ExecutionManager,
        history: HistoryManager,
        task: TaskManager,
        metadata: MetadataManager,
        visibility: VisibilityManager,
        checkpoint=None,
    ) -> None:
        self.shard = shard
        self.execution = execution
        self.history = history
        self.task = task
        self.metadata = metadata
        self.visibility = visibility
        self.checkpoint = checkpoint

    def close(self) -> None:
        pass
