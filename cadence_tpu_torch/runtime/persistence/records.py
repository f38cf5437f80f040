"""Storage record types shared by every persistence backend.

The manager-facing model (reference: common/persistence/dataInterfaces.go).
One deliberate simplification vs the reference: workflow executions are
persisted as the full MutableState snapshot dict (core MutableState
.snapshot()/.from_snapshot()) conditioned on next_event_id, instead of the
reference's snapshot+per-map-mutation split — same optimistic-concurrency
contract, far less surface. Histories remain the source of truth; the
snapshot is the replay-avoidance cache, exactly as in the reference.

A copy of the reference package's ``runtime/persistence/records.py``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from ...core.tasks import ReplicationTask, TimerTask, TransferTask

# -- shard ----------------------------------------------------------------


@dataclasses.dataclass
class ShardInfo:
    shard_id: int
    owner: str = ""
    range_id: int = 0
    transfer_ack_level: int = 0
    timer_ack_level: int = 0            # ns timestamp
    replication_ack_level: int = 0
    # per remote cluster ack levels (NDC)
    cluster_transfer_ack_level: Dict[str, int] = dataclasses.field(default_factory=dict)
    cluster_timer_ack_level: Dict[str, int] = dataclasses.field(default_factory=dict)
    domain_notification_version: int = 0
    stolen_since_renew: int = 0
    update_time: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "ShardInfo":
        return cls(**json.loads(s))


# -- executions -----------------------------------------------------------


class CreateWorkflowMode:
    BRAND_NEW = 0
    WORKFLOW_ID_REUSE = 1
    CONTINUE_AS_NEW = 2
    ZOMBIE = 3  # replication-created, not the current run
    # replication-created with a NEWER version than a still-running
    # current run: the stale run is zombified and the incoming run takes
    # the current record (ref nDCTransactionPolicySuppressCurrentAndCreateAsCurrent,
    # nDCTransactionMgrForNewWorkflow.go)
    SUPPRESS_CURRENT = 4


@dataclasses.dataclass
class WorkflowSnapshot:
    """A durable workflow execution: MutableState snapshot + queue tasks
    to enqueue atomically with it."""

    domain_id: str
    workflow_id: str
    run_id: str
    snapshot: Dict[str, Any]            # MutableState.snapshot()
    next_event_id: int                  # the write's condition value
    last_write_version: int = 0
    transfer_tasks: List[TransferTask] = dataclasses.field(default_factory=list)
    timer_tasks: List[TimerTask] = dataclasses.field(default_factory=list)
    replication_tasks: List[ReplicationTask] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CurrentExecution:
    run_id: str
    create_request_id: str
    state: int
    close_status: int
    last_write_version: int


@dataclasses.dataclass
class GetWorkflowResponse:
    snapshot: Dict[str, Any]
    next_event_id: int                  # condition for the next update


# -- history tree ---------------------------------------------------------


@dataclasses.dataclass
class BranchAncestor:
    branch_id: str
    begin_node_id: int                  # inclusive
    end_node_id: int                    # exclusive


@dataclasses.dataclass
class BranchToken:
    """Identifies a branch in a workflow's history tree
    (reference: historyV2Store.go branch token + ancestors)."""

    tree_id: str
    branch_id: str
    ancestors: List[BranchAncestor] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {
                "tree_id": self.tree_id,
                "branch_id": self.branch_id,
                "ancestors": [dataclasses.asdict(a) for a in self.ancestors],
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "BranchToken":
        d = json.loads(s)
        return cls(
            tree_id=d["tree_id"],
            branch_id=d["branch_id"],
            ancestors=[BranchAncestor(**a) for a in d.get("ancestors", [])],
        )


# -- matching tasks -------------------------------------------------------


class TaskType:
    DECISION = 0
    ACTIVITY = 1


@dataclasses.dataclass
class TaskListInfo:
    domain_id: str
    name: str
    task_type: int
    range_id: int = 0
    ack_level: int = 0
    kind: int = 0                       # 0 normal, 1 sticky
    last_updated: int = 0


@dataclasses.dataclass
class TaskInfo:
    domain_id: str
    workflow_id: str
    run_id: str
    task_id: int                        # assigned from the task list's block
    schedule_id: int
    schedule_to_start_timeout_seconds: int = 0
    created_time: int = 0
    expiry_time: int = 0


# -- domains --------------------------------------------------------------


@dataclasses.dataclass
class DomainInfo:
    id: str
    name: str
    status: int = 0                     # 0 registered, 1 deprecated
    description: str = ""
    owner_email: str = ""
    data: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DomainConfig:
    retention_days: int = 7
    emit_metric: bool = True
    archival_bucket: str = ""
    archival_status: int = 0
    history_archival_status: int = 0
    history_archival_uri: str = ""
    visibility_archival_status: int = 0
    visibility_archival_uri: str = ""
    bad_binaries: Dict[str, Dict[str, str]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DomainReplicationConfig:
    active_cluster_name: str = "active"
    clusters: List[str] = dataclasses.field(default_factory=lambda: ["active"])


@dataclasses.dataclass
class DomainRecord:
    info: DomainInfo
    config: DomainConfig
    replication_config: DomainReplicationConfig
    is_global: bool = False
    config_version: int = 0
    failover_version: int = 0
    failover_notification_version: int = 0
    notification_version: int = 0


# -- visibility -----------------------------------------------------------


@dataclasses.dataclass
class VisibilityRecord:
    domain_id: str
    workflow_id: str
    run_id: str
    workflow_type: str
    start_time: int = 0                 # ns
    execution_time: int = 0             # ns (start + backoff)
    close_time: int = 0                 # ns, 0 while open
    close_status: int = -1              # -1 while open
    history_length: int = 0
    memo: Dict[str, Any] = dataclasses.field(default_factory=dict)
    search_attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)


# -- stored-snapshot helpers ----------------------------------------------


def current_version_history(snapshot: Dict[str, Any]):
    """Extract the CURRENT version history from a stored mutable-state
    snapshot dict: ``(branch_token_str, [(event_id, version), ...])``,
    with the execution_info branch token as the fallback when the
    history carries none. One place owns the fiddly current_index /
    bytes-vs-str / fallback dance (the raw-history read path, the
    replication snapshot server) — returns ("", []) when the snapshot
    has no version histories."""
    snap = snapshot or {}
    vh = snap.get("version_histories") or {}
    histories = vh.get("histories", [])
    if not histories:
        return "", []
    current = histories[vh.get("current_index", 0)]
    token = current.get("branch_token") or snap.get(
        "execution_info", {}
    ).get("branch_token", "")
    if isinstance(token, bytes):
        token = token.decode()
    items = [(int(e), int(v)) for e, v in current.get("items", [])]
    return token, items
