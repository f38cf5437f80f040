"""In-memory persistence backend.

The default store for tests and the onebox cluster (the reference's
equivalent role is its TestBase-managed store). Implements the full
five-manager contract including LWT-style conditional writes — the
concurrency semantics are real even though the medium is a dict.

A copy of the reference package's ``runtime/persistence/memory.py``. Its
history manager keeps the port's branch copy on first sight (the
reference copies the branch on every append). Its execution manager keeps
each shard's transfer, timer and replication tasks in a ``_TaskTable``, a
dict with its keys kept sorted, so a queue read costs the page it returns
and not a sort of the shard's whole table (the reference sorts on every
read, quadratic in a backlog that its standby queues hold). Tasks, whose
fields are all immutable, are copied shallow, and mutable-state snapshots
by a pickle round trip (the reference deep-copies both).
"""

from __future__ import annotations

import bisect
import copy
import pickle
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ...core.events import HistoryEvent, decode_batch, encode_batch
from ...core.tasks import ReplicationTask, TimerTask, TransferTask
from ...utils.locks import make_guarded, make_rlock

from . import interfaces as I
from .errors import (
    ConditionFailedError,
    DomainAlreadyExistsError,
    EntityNotExistsError,
    ShardAlreadyExistsError,
    ShardOwnershipLostError,
    TaskListLeaseLostError,
    WorkflowAlreadyStartedError,
)
from .records import (
    BranchAncestor,
    BranchToken,
    CreateWorkflowMode,
    CurrentExecution,
    DomainRecord,
    GetWorkflowResponse,
    ShardInfo,
    TaskInfo,
    TaskListInfo,
    VisibilityRecord,
    WorkflowSnapshot,
)

_COMPLETED = 2  # WorkflowState.Completed
_ZOMBIE = 3  # WorkflowState.Zombie


class MemoryShardManager(I.ShardManager):
    def __init__(self) -> None:
        self._lock = make_rlock("MemoryShardManager._lock")
        self._shards: Dict[int, ShardInfo] = make_guarded(
            {}, "MemoryShardManager._shards", self._lock
        )
        # singleton routing-epoch row: (epoch, blob) or None
        self._reshard_state: Optional[Tuple[int, str]] = None
        # (shard_id, cluster) -> (version, blob): the consumer-side
        # replication cursor/mode rows (adaptive geo-replication)
        self._replication_progress: Dict[Tuple[int, str], Tuple[int, str]] = {}

    def create_shard(self, info: ShardInfo) -> None:
        with self._lock:
            if info.shard_id in self._shards:
                raise ShardAlreadyExistsError(str(info.shard_id))
            self._shards[info.shard_id] = copy.deepcopy(info)

    def get_shard(self, shard_id: int) -> ShardInfo:
        with self._lock:
            info = self._shards.get(shard_id)
            if info is None:
                raise EntityNotExistsError(f"shard {shard_id}")
            return copy.deepcopy(info)

    def range_id(self, shard_id: int) -> int:
        """The stored shard's range id (the fence of every execution
        write), without copying its info."""
        with self._lock:
            info = self._shards.get(shard_id)
            if info is None:
                raise EntityNotExistsError(f"shard {shard_id}")
            return info.range_id

    def update_shard(self, info: ShardInfo, previous_range_id: int) -> None:
        with self._lock:
            stored = self._shards.get(info.shard_id)
            if stored is None:
                raise EntityNotExistsError(f"shard {info.shard_id}")
            if stored.range_id != previous_range_id:
                raise ShardOwnershipLostError(info.shard_id)
            self._shards[info.shard_id] = copy.deepcopy(info)

    # -- elastic resharding -------------------------------------------

    def get_reshard_state(self) -> Optional[Tuple[int, str]]:
        with self._lock:
            return self._reshard_state

    def set_reshard_state(
        self, epoch: int, blob: str, previous_epoch: int
    ) -> None:
        with self._lock:
            stored = self._reshard_state[0] if self._reshard_state else 0
            if stored != previous_epoch:
                raise ConditionFailedError(
                    f"reshard epoch {stored} != expected {previous_epoch}"
                )
            self._reshard_state = (epoch, blob)

    # -- adaptive geo-replication --------------------------------------

    def get_replication_progress(
        self, shard_id: int, cluster: str
    ) -> Optional[Tuple[int, str]]:
        with self._lock:
            return self._replication_progress.get((shard_id, cluster))

    def set_replication_progress(
        self, shard_id: int, cluster: str, blob: str,
        previous_version: int,
    ) -> None:
        with self._lock:
            key = (shard_id, cluster)
            row = self._replication_progress.get(key)
            stored = row[0] if row else 0
            if stored != previous_version:
                raise ConditionFailedError(
                    f"replication progress version {stored} != "
                    f"expected {previous_version}"
                )
            self._replication_progress[key] = (previous_version + 1, blob)


def _copy_snapshot(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """A deep copy of a mutable-state snapshot (plain data: dicts,
    lists, strings, numbers, bytes) by a pickle round trip, a third of
    ``copy.deepcopy``'s time."""
    return pickle.loads(pickle.dumps(snapshot, pickle.HIGHEST_PROTOCOL))


class _TaskTable(dict):
    """One shard's task table: a dict whose keys are also held sorted, in
    runs of at most ``2 * _RUN`` keys (so an insert moves one run, not the
    table), so a range read bisects to its first key instead of sorting
    the table."""

    _RUN = 512

    def __init__(self) -> None:
        super().__init__()
        self._runs: list = []   # sorted runs of keys, in order
        self._maxes: list = []  # the last key of each run

    def __setitem__(self, key, value) -> None:
        if key not in self:
            self._insort(key)
        super().__setitem__(key, value)

    def __delitem__(self, key) -> None:
        super().__delitem__(key)
        self._discard(key)

    def pop(self, key, *default):
        if key in self:
            value = super().pop(key)
            self._discard(key)
            return value
        return super().pop(key, *default)

    def _insort(self, key) -> None:
        if not self._runs:
            self._runs.append([key])
            self._maxes.append(key)
            return
        i = min(bisect.bisect_left(self._maxes, key), len(self._runs) - 1)
        run = self._runs[i]
        bisect.insort(run, key)
        self._maxes[i] = run[-1]
        if len(run) > 2 * self._RUN:
            self._runs[i:i + 1] = [run[:self._RUN], run[self._RUN:]]
            self._maxes[i:i + 1] = [run[self._RUN - 1], run[-1]]

    def _discard(self, key) -> None:
        i = bisect.bisect_left(self._maxes, key)
        run = self._runs[i]
        del run[bisect.bisect_left(run, key)]
        if run:
            self._maxes[i] = run[-1]
        else:
            del self._runs[i], self._maxes[i]

    def page(self, key, size: int, limit, inclusive: bool = False) -> list:
        """Up to ``size`` values in key order from the first key above
        ``key`` (from it, with ``inclusive``), while ``limit(key)``
        holds."""
        find = bisect.bisect_left if inclusive else bisect.bisect_right
        i = find(self._maxes, key)
        out: list = []
        if i == len(self._runs):
            return out
        j = find(self._runs[i], key)
        while i < len(self._runs) and len(out) < size:
            for k in self._runs[i][j:j + size - len(out)]:
                if not limit(k):
                    return out
                out.append(self[k])
            i, j = i + 1, 0
        return out


class _TaskTables(dict):
    """shard -> ``_TaskTable``, made on first sight of a shard."""

    def setdefault(self, shard_id, default=None):
        if shard_id not in self:
            self[shard_id] = _TaskTable()
        return self[shard_id]

    def get(self, shard_id, default=None):
        return self.setdefault(shard_id)


class MemoryExecutionManager(I.ExecutionManager):
    def __init__(self, shard_manager: MemoryShardManager) -> None:
        self._shard_manager = shard_manager
        self._lock = make_rlock("MemoryExecutionManager._lock")
        # (shard, domain, wf, run) -> (snapshot dict, next_event_id, last_write_version)
        self._executions: Dict[Tuple, Tuple[Dict[str, Any], int, int]] = {}
        # (shard, domain, wf) -> CurrentExecution
        self._current: Dict[Tuple, CurrentExecution] = {}
        # shard -> {task_id -> TransferTask}
        self._transfer: Dict[int, Dict[int, TransferTask]] = _TaskTables()
        # shard -> {(vis_ts, task_id) -> TimerTask}
        self._timers: Dict[int, Dict[Tuple[int, int], TimerTask]] = (
            _TaskTables())
        self._replication: Dict[int, Dict[int, ReplicationTask]] = (
            _TaskTables())

    # -- fencing ------------------------------------------------------

    def _check_range(self, shard_id: int, range_id: int) -> None:
        if self._shard_manager.range_id(shard_id) > range_id:
            raise ShardOwnershipLostError(shard_id)

    # -- helpers ------------------------------------------------------

    def _put_tasks(self, shard_id: int, snap: WorkflowSnapshot) -> None:
        tq = self._transfer.setdefault(shard_id, {})
        for t in snap.transfer_tasks:
            tq[t.task_id] = copy.copy(t)
        mq = self._timers.setdefault(shard_id, {})
        for t in snap.timer_tasks:
            mq[(t.visibility_timestamp, t.task_id)] = copy.copy(t)
        rq = self._replication.setdefault(shard_id, {})
        for t in snap.replication_tasks:
            rq[t.task_id] = copy.copy(t)

    def _store(self, shard_id: int, snap: WorkflowSnapshot) -> None:
        key = (shard_id, snap.domain_id, snap.workflow_id, snap.run_id)
        self._executions[key] = (
            _copy_snapshot(snap.snapshot),
            snap.next_event_id,
            snap.last_write_version,
        )
        self._put_tasks(shard_id, snap)

    def _exec_state(self, snapshot: Dict[str, Any]) -> Tuple[int, int]:
        ex = snapshot.get("execution_info") or snapshot.get("exec") or snapshot
        return int(ex.get("state", 0)), int(ex.get("close_status", 0))

    @staticmethod
    def _request_id(snapshot: Dict[str, Any]) -> str:
        ex = snapshot.get("execution_info") or {}
        return ex.get("create_request_id") or snapshot.get("request_id", "")

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
        with self._lock:
            self._check_range(shard_id, range_id)
            cur_key = (shard_id, snapshot.domain_id, snapshot.workflow_id)
            cur = self._current.get(cur_key)
            if mode == CreateWorkflowMode.BRAND_NEW:
                if cur is not None:
                    raise WorkflowAlreadyStartedError(
                        f"workflow {snapshot.workflow_id} already started",
                        cur.create_request_id,
                        cur.run_id,
                        cur.state,
                        cur.close_status,
                        cur.last_write_version,
                    )
            elif mode == CreateWorkflowMode.WORKFLOW_ID_REUSE:
                if cur is None:
                    raise ConditionFailedError("no current execution to reuse")
                if cur.state != _COMPLETED:
                    raise WorkflowAlreadyStartedError(
                        f"workflow {snapshot.workflow_id} still running",
                        cur.create_request_id, cur.run_id, cur.state,
                        cur.close_status, cur.last_write_version,
                    )
                if cur.run_id != prev_run_id:
                    raise ConditionFailedError(
                        f"current run {cur.run_id} != expected {prev_run_id}"
                    )
            elif mode == CreateWorkflowMode.CONTINUE_AS_NEW:
                if cur is None or cur.run_id != prev_run_id:
                    raise ConditionFailedError("continue-as-new current mismatch")
            elif mode == CreateWorkflowMode.ZOMBIE:
                pass
            elif mode == CreateWorkflowMode.SUPPRESS_CURRENT:
                if cur is None or cur.run_id != prev_run_id:
                    raise ConditionFailedError(
                        "suppress-current run mismatch: "
                        f"{cur.run_id if cur else None} != {prev_run_id}"
                    )
                # zombify the stale run's stored record so nothing that
                # reloads it treats it as a live current run
                old_key = (
                    shard_id, snapshot.domain_id, snapshot.workflow_id,
                    cur.run_id,
                )
                old = self._executions.get(old_key)
                if old is not None:
                    snap, next_eid, lwv = old
                    ex = snap.get("execution_info")
                    if isinstance(ex, dict):
                        ex["state"] = _ZOMBIE
                    self._executions[old_key] = (snap, next_eid, lwv)
            else:
                raise ValueError(f"unknown create mode {mode}")

            state, close_status = self._exec_state(snapshot.snapshot)
            if mode != CreateWorkflowMode.ZOMBIE:
                self._current[cur_key] = CurrentExecution(
                    run_id=snapshot.run_id,
                    create_request_id=self._request_id(snapshot.snapshot),
                    state=state,
                    close_status=close_status,
                    last_write_version=snapshot.last_write_version,
                )
            self._store(shard_id, snapshot)

    def get_workflow_execution(
        self, shard_id: int, domain_id: str, workflow_id: str, run_id: str
    ) -> GetWorkflowResponse:
        with self._lock:
            key = (shard_id, domain_id, workflow_id, run_id)
            stored = self._executions.get(key)
            if stored is None:
                raise EntityNotExistsError(f"execution {workflow_id}/{run_id}")
            snap, next_event_id, _ = stored
            return GetWorkflowResponse(
                snapshot=_copy_snapshot(snap), next_event_id=next_event_id
            )

    def update_workflow_execution(
        self,
        shard_id: int,
        range_id: int,
        condition: int,
        mutation: WorkflowSnapshot,
        new_snapshot: Optional[WorkflowSnapshot] = None,
        new_mode: int = CreateWorkflowMode.CONTINUE_AS_NEW,
    ) -> None:
        with self._lock:
            self._check_range(shard_id, range_id)
            key = (
                shard_id, mutation.domain_id, mutation.workflow_id,
                mutation.run_id,
            )
            stored = self._executions.get(key)
            if stored is None:
                raise EntityNotExistsError(
                    f"execution {mutation.workflow_id}/{mutation.run_id}"
                )
            if stored[1] != condition:
                raise ConditionFailedError(
                    f"next_event_id {stored[1]} != condition {condition}"
                )
            self._store(shard_id, mutation)
            cur_key = (shard_id, mutation.domain_id, mutation.workflow_id)
            cur = self._current.get(cur_key)
            state, close_status = self._exec_state(mutation.snapshot)
            if cur is not None and cur.run_id == mutation.run_id:
                cur.state = state
                cur.close_status = close_status
                cur.last_write_version = mutation.last_write_version
            if new_snapshot is not None:
                self.create_workflow_execution(
                    shard_id, range_id, new_mode, new_snapshot,
                    prev_run_id=mutation.run_id,
                )

    def conflict_resolve_workflow_execution(
        self,
        shard_id: int,
        range_id: int,
        condition: int,
        reset_snapshot: WorkflowSnapshot,
    ) -> None:
        with self._lock:
            self._check_range(shard_id, range_id)
            key = (
                shard_id, reset_snapshot.domain_id,
                reset_snapshot.workflow_id, reset_snapshot.run_id,
            )
            stored = self._executions.get(key)
            if stored is not None and stored[1] != condition:
                raise ConditionFailedError(
                    f"next_event_id {stored[1]} != condition {condition}"
                )
            self._store(shard_id, reset_snapshot)
            cur_key = (
                shard_id, reset_snapshot.domain_id, reset_snapshot.workflow_id
            )
            cur = self._current.get(cur_key)
            state, close_status = self._exec_state(reset_snapshot.snapshot)
            if cur is not None and cur.run_id == reset_snapshot.run_id:
                cur.state = state
                cur.close_status = close_status

    def delete_workflow_execution(
        self, shard_id: int, domain_id: str, workflow_id: str, run_id: str
    ) -> None:
        with self._lock:
            self._executions.pop((shard_id, domain_id, workflow_id, run_id), None)

    def delete_current_workflow_execution(
        self, shard_id: int, domain_id: str, workflow_id: str, run_id: str
    ) -> None:
        with self._lock:
            cur_key = (shard_id, domain_id, workflow_id)
            cur = self._current.get(cur_key)
            if cur is not None and cur.run_id == run_id:
                del self._current[cur_key]

    def get_current_execution(
        self, shard_id: int, domain_id: str, workflow_id: str
    ) -> CurrentExecution:
        with self._lock:
            cur = self._current.get((shard_id, domain_id, workflow_id))
            if cur is None:
                raise EntityNotExistsError(f"no current execution {workflow_id}")
            return copy.deepcopy(cur)

    def list_concrete_executions(
        self, shard_id: int
    ) -> List[Tuple[str, str, str]]:
        with self._lock:
            return [
                (d, w, r)
                for (s, d, w, r) in self._executions
                if s == shard_id
            ]

    # -- elastic resharding -------------------------------------------

    def reshard_extract(
        self, shard_id, workflow_ids, transfer_watermark, timer_watermark,
        delete=False,
    ):
        wids = set(workflow_ids)
        out = {"executions": [], "currents": [], "transfer": [],
               "timers": [], "replication": []}
        with self._lock:
            for key in [k for k in self._executions
                        if k[0] == shard_id and k[2] in wids]:
                snap, next_eid, lwv = (
                    self._executions.pop(key) if delete
                    else self._executions[key]
                )
                out["executions"].append({
                    "domain_id": key[1], "workflow_id": key[2],
                    "run_id": key[3], "next_event_id": next_eid,
                    "last_write_version": lwv,
                    "snapshot": copy.deepcopy(snap),
                })
            for key in [k for k in self._current
                        if k[0] == shard_id and k[2] in wids]:
                cur = (
                    self._current.pop(key) if delete else self._current[key]
                )
                out["currents"].append({
                    "domain_id": key[1], "workflow_id": key[2],
                    "run_id": cur.run_id,
                    "create_request_id": cur.create_request_id,
                    "state": cur.state, "close_status": cur.close_status,
                    "last_write_version": cur.last_write_version,
                })
            tq = self._transfer.get(shard_id, {})
            for tid in [tid for tid, t in tq.items()
                        if t.workflow_id in wids
                        and tid > transfer_watermark]:
                out["transfer"].append(
                    tq.pop(tid) if delete else copy.deepcopy(tq[tid])
                )
            mq = self._timers.get(shard_id, {})
            for key in [k for k, t in mq.items()
                        if t.workflow_id in wids
                        and k > tuple(timer_watermark)]:
                out["timers"].append(
                    mq.pop(key) if delete else copy.deepcopy(mq[key])
                )
            rq = self._replication.get(shard_id, {})
            for tid in [tid for tid, t in rq.items()
                        if t.workflow_id in wids]:
                out["replication"].append(
                    rq.pop(tid) if delete else copy.deepcopy(rq[tid])
                )
        for name in out:
            key_fn = {
                "executions": lambda e: (e["workflow_id"], e["run_id"]),
                "currents": lambda e: e["workflow_id"],
                "timers": lambda t: (t.visibility_timestamp, t.task_id),
            }.get(name, lambda t: t.task_id)
            out[name].sort(key=key_fn)
        return out

    def reshard_purge(self, shard_id, extracted):
        with self._lock:
            for e in extracted["executions"]:
                self._executions.pop(
                    (shard_id, e["domain_id"], e["workflow_id"],
                     e["run_id"]), None,
                )
            for c in extracted["currents"]:
                self._current.pop(
                    (shard_id, c["domain_id"], c["workflow_id"]), None
                )
            tq = self._transfer.get(shard_id, {})
            for t in extracted["transfer"]:
                tq.pop(t.task_id, None)
            mq = self._timers.get(shard_id, {})
            for t in extracted["timers"]:
                mq.pop((t.visibility_timestamp, t.task_id), None)
            rq = self._replication.get(shard_id, {})
            for t in extracted["replication"]:
                rq.pop(t.task_id, None)

    def reshard_install(self, shard_id, range_id, extracted, task_id_fn):
        with self._lock:
            stored = self._shard_manager.get_shard(shard_id)
            if stored.range_id != range_id:
                raise ShardOwnershipLostError(shard_id)
            for e in extracted["executions"]:
                key = (shard_id, e["domain_id"], e["workflow_id"],
                       e["run_id"])
                self._executions[key] = (
                    copy.deepcopy(e["snapshot"]),
                    e["next_event_id"], e["last_write_version"],
                )
            for c in extracted["currents"]:
                self._current[(shard_id, c["domain_id"], c["workflow_id"])] \
                    = CurrentExecution(
                        run_id=c["run_id"],
                        create_request_id=c["create_request_id"],
                        state=c["state"], close_status=c["close_status"],
                        last_write_version=c["last_write_version"],
                    )
            tq = self._transfer.setdefault(shard_id, {})
            for t in extracted["transfer"]:
                t = copy.deepcopy(t)
                t.task_id = task_id_fn()
                tq[t.task_id] = t
            mq = self._timers.setdefault(shard_id, {})
            for t in extracted["timers"]:
                t = copy.deepcopy(t)
                t.task_id = task_id_fn()
                mq[(t.visibility_timestamp, t.task_id)] = t
            rq = self._replication.setdefault(shard_id, {})
            for t in extracted["replication"]:
                t = copy.deepcopy(t)
                t.task_id = task_id_fn()
                rq[t.task_id] = t

    # -- transfer queue -----------------------------------------------

    def get_transfer_tasks(
        self, shard_id: int, read_level: int, max_read_level: int, batch_size: int
    ) -> List[TransferTask]:
        with self._lock:
            q = self._transfer.get(shard_id)
            tasks = q.page(read_level, batch_size,
                           lambda tid: tid <= max_read_level)
            return [copy.copy(t) for t in tasks]

    def complete_transfer_task(self, shard_id: int, task_id: int) -> None:
        with self._lock:
            self._transfer.get(shard_id, {}).pop(task_id, None)

    def range_complete_transfer_tasks(
        self, shard_id: int, exclusive_begin: int, inclusive_end: int
    ) -> None:
        with self._lock:
            q = self._transfer.get(shard_id, {})
            for tid in [t for t in q if exclusive_begin < t <= inclusive_end]:
                del q[tid]

    # -- timer queue --------------------------------------------------

    def get_timer_tasks(
        self, shard_id: int, min_ts: int, max_ts: int, batch_size: int,
        after_key=None,
    ) -> List[TimerTask]:
        with self._lock:
            q = self._timers.get(shard_id)
            if after_key is not None and tuple(after_key) >= (min_ts,):
                tasks = q.page(tuple(after_key), batch_size,
                               lambda k: k[0] < max_ts)
            else:
                tasks = q.page((min_ts,), batch_size,
                               lambda k: k[0] < max_ts, inclusive=True)
            return [copy.copy(t) for t in tasks]

    def complete_timer_task(
        self, shard_id: int, visibility_ts: int, task_id: int
    ) -> None:
        with self._lock:
            self._timers.get(shard_id, {}).pop((visibility_ts, task_id), None)

    def range_complete_timer_tasks(
        self, shard_id: int, inclusive_begin_ts: int, exclusive_end_ts: int
    ) -> None:
        with self._lock:
            q = self._timers.get(shard_id, {})
            for key in [
                k for k in q if inclusive_begin_ts <= k[0] < exclusive_end_ts
            ]:
                del q[key]

    # -- replication queue --------------------------------------------

    def get_replication_tasks(
        self, shard_id: int, read_level: int, batch_size: int
    ) -> List[ReplicationTask]:
        with self._lock:
            q = self._replication.get(shard_id)
            tasks = q.page(read_level, batch_size, lambda _: True)
            return [copy.copy(t) for t in tasks]

    def complete_replication_task(self, shard_id: int, task_id: int) -> None:
        with self._lock:
            self._replication.get(shard_id, {}).pop(task_id, None)


class MemoryHistoryManager(I.HistoryManager):
    """The history store in a dict, under one re-entrant lock."""

    def __init__(self) -> None:
        self._lock = make_rlock("MemoryHistoryManager._lock")
        # (tree_id, branch_id) -> {node_id -> (transaction_id, blob)}
        self._nodes: Dict[Tuple[str, str], Dict[int, Tuple[int, bytes]]] = {}
        # tree_id -> {branch_id -> BranchToken}
        self._branches: Dict[str, Dict[str, BranchToken]] = {}

    def new_history_branch(self, tree_id: str) -> BranchToken:
        with self._lock:
            token = BranchToken(tree_id=tree_id, branch_id=str(uuid.uuid4()))
            self._branches.setdefault(tree_id, {})[token.branch_id] = token
            self._nodes.setdefault((tree_id, token.branch_id), {})
            return copy.deepcopy(token)

    def append_history_nodes(
        self,
        branch: BranchToken,
        events: List[HistoryEvent],
        transaction_id: int,
    ) -> int:
        if not events:
            raise ValueError("empty event batch")
        node_id = events[0].event_id
        blob = encode_batch(events)
        with self._lock:
            nodes = self._nodes.setdefault(
                (branch.tree_id, branch.branch_id), {}
            )
            tree = self._branches.setdefault(branch.tree_id, {})
            if branch.branch_id not in tree:
                # copied once, when the branch is first seen (a copy per
                # append was half of an append's cost)
                tree[branch.branch_id] = copy.deepcopy(branch)
            existing = nodes.get(node_id)
            if existing is None or existing[0] < transaction_id:
                nodes[node_id] = (transaction_id, blob)
            return len(blob)

    def _branch_node_ranges(
        self, branch: BranchToken
    ) -> List[Tuple[str, int, int]]:
        """(branch_id, begin, end) segments composing this branch's view."""
        segments = [
            (a.branch_id, a.begin_node_id, a.end_node_id)
            for a in branch.ancestors
        ]
        segments.append((branch.branch_id, 1 if not branch.ancestors else
                         branch.ancestors[-1].end_node_id, 2**62))
        return segments

    def read_history_branch(
        self,
        branch: BranchToken,
        min_event_id: int,
        max_event_id: int,
        page_size: int = 0,
        next_token: int = 0,
    ) -> Tuple[List[List[HistoryEvent]], int]:
        with self._lock:
            collected: List[Tuple[int, bytes]] = []
            for branch_id, begin, end in self._branch_node_ranges(branch):
                nodes = self._nodes.get((branch.tree_id, branch_id), {})
                for node_id, (_, blob) in nodes.items():
                    if begin <= node_id < end and (
                        min_event_id <= node_id < max_event_id
                    ) and node_id >= next_token:
                        collected.append((node_id, blob))
            collected.sort(key=lambda x: x[0])
            if page_size and len(collected) > page_size:
                page = collected[:page_size]
                token = collected[page_size][0]
            else:
                page, token = collected, 0
            return [decode_batch(blob) for _, blob in page], token

    def fork_history_branch(
        self, branch: BranchToken, fork_node_id: int
    ) -> BranchToken:
        with self._lock:
            ancestors: List[BranchAncestor] = []
            for a in branch.ancestors:
                if a.end_node_id <= fork_node_id:
                    ancestors.append(copy.deepcopy(a))
                else:
                    ancestors.append(
                        BranchAncestor(
                            a.branch_id, a.begin_node_id, fork_node_id
                        )
                    )
                    break
            else:
                begin = (
                    branch.ancestors[-1].end_node_id if branch.ancestors else 1
                )
                ancestors.append(
                    BranchAncestor(branch.branch_id, begin, fork_node_id)
                )
            token = BranchToken(
                tree_id=branch.tree_id,
                branch_id=str(uuid.uuid4()),
                ancestors=ancestors,
            )
            self._branches.setdefault(branch.tree_id, {})[
                token.branch_id
            ] = token
            self._nodes.setdefault((branch.tree_id, token.branch_id), {})
            return copy.deepcopy(token)

    def delete_history_branch(self, branch: BranchToken) -> None:
        with self._lock:
            tree = self._branches.get(branch.tree_id) or {}
            tree.pop(branch.branch_id, None)
            if branch.tree_id in self._branches and not tree:
                del self._branches[branch.tree_id]
            # Sweep every node range in the tree no surviving branch
            # owns or references as an ancestor segment (shared fork
            # prefix — reference historyV2 deleteBranch keeps shared
            # ranges). Whole-tree sweep also reclaims ranges a
            # previously-deleted ancestor left behind, orphaned exactly
            # when its last descendant goes.
            live: dict = {}  # branch_id -> protected end (0 = whole)
            for bid, token in tree.items():
                live[bid] = 0
                for anc in token.ancestors:
                    if live.get(anc.branch_id, 1) != 0:
                        live[anc.branch_id] = max(
                            live.get(anc.branch_id, 0), anc.end_node_id
                        )
            # candidate ranges only (not a store-wide key scan): the
            # deleted branch, its full ancestor chain, and every live
            # branch id cover all ranges this delete can orphan —
            # an orphan outside this set would have been swept when ITS
            # last descendant was deleted (induction)
            candidates = {branch.branch_id}
            candidates.update(a.branch_id for a in branch.ancestors)
            candidates.update(live)
            for bid in candidates:
                key = (branch.tree_id, bid)
                if key not in self._nodes:
                    continue
                end = live.get(bid)
                if end == 0:
                    continue  # a live branch owns the whole range
                if end is None:
                    self._nodes.pop(key, None)
                else:
                    nodes = self._nodes[key]
                    for nid in [n for n in nodes if n >= end]:
                        del nodes[nid]

    def list_history_trees(self):
        """All (tree_id, branches) pairs — the history scavenger's scan
        surface (reference: GetAllHistoryTreeBranches)."""
        with self._lock:
            return [
                (tree_id, [copy.deepcopy(t) for t in branches.values()])
                for tree_id, branches in self._branches.items()
            ]

    def get_history_tree(self, tree_id: str) -> List[BranchToken]:
        with self._lock:
            return [
                copy.deepcopy(t)
                for t in self._branches.get(tree_id, {}).values()
            ]


class MemoryTaskManager(I.TaskManager):
    def __init__(self) -> None:
        self._lock = make_rlock("MemoryTaskManager._lock")
        self._lists: Dict[Tuple[str, str, int], TaskListInfo] = {}
        self._tasks: Dict[Tuple[str, str, int], Dict[int, TaskInfo]] = {}

    def lease_task_list(
        self, domain_id: str, name: str, task_type: int
    ) -> TaskListInfo:
        with self._lock:
            key = (domain_id, name, task_type)
            info = self._lists.get(key)
            if info is None:
                info = TaskListInfo(
                    domain_id=domain_id, name=name, task_type=task_type
                )
            info = copy.deepcopy(info)
            info.range_id += 1
            info.last_updated = time.time_ns()
            self._lists[key] = copy.deepcopy(info)
            return info

    def update_task_list(self, info: TaskListInfo) -> None:
        with self._lock:
            key = (info.domain_id, info.name, info.task_type)
            stored = self._lists.get(key)
            if stored is None or stored.range_id != info.range_id:
                raise TaskListLeaseLostError(info.name)
            info.last_updated = time.time_ns()
            self._lists[key] = copy.deepcopy(info)

    def create_tasks(
        self, info: TaskListInfo, tasks: List[TaskInfo]
    ) -> None:
        with self._lock:
            key = (info.domain_id, info.name, info.task_type)
            stored = self._lists.get(key)
            if stored is None or stored.range_id != info.range_id:
                raise TaskListLeaseLostError(info.name)
            bucket = self._tasks.setdefault(key, {})
            for t in tasks:
                bucket[t.task_id] = copy.deepcopy(t)

    def get_tasks(
        self,
        domain_id: str,
        name: str,
        task_type: int,
        read_level: int,
        max_read_level: int,
        batch_size: int,
    ) -> List[TaskInfo]:
        with self._lock:
            bucket = self._tasks.get((domain_id, name, task_type), {})
            tasks = sorted(
                (
                    t
                    for tid, t in bucket.items()
                    if read_level < tid <= max_read_level
                ),
                key=lambda t: t.task_id,
            )
            return copy.deepcopy(tasks[:batch_size])

    def complete_task(
        self, domain_id: str, name: str, task_type: int, task_id: int
    ) -> None:
        with self._lock:
            self._tasks.get((domain_id, name, task_type), {}).pop(task_id, None)

    def complete_tasks_less_than(
        self, domain_id: str, name: str, task_type: int, task_id: int
    ) -> int:
        with self._lock:
            bucket = self._tasks.get((domain_id, name, task_type), {})
            victims = [tid for tid in bucket if tid < task_id]
            for tid in victims:
                del bucket[tid]
            return len(victims)

    def list_task_lists(self) -> List[TaskListInfo]:
        with self._lock:
            return [copy.deepcopy(i) for i in self._lists.values()]

    def delete_task_list(
        self, domain_id: str, name: str, task_type: int, range_id: int
    ) -> None:
        with self._lock:
            key = (domain_id, name, task_type)
            stored = self._lists.get(key)
            if stored is None:
                return
            if stored.range_id != range_id:
                raise TaskListLeaseLostError(name)
            del self._lists[key]
            self._tasks.pop(key, None)


class MemoryMetadataManager(I.MetadataManager):
    def __init__(self) -> None:
        self._lock = make_rlock("MemoryMetadataManager._lock")
        self._by_id: Dict[str, DomainRecord] = {}
        self._name_to_id: Dict[str, str] = {}
        self._notification_version = 0

    def create_domain(self, record: DomainRecord) -> str:
        with self._lock:
            if record.info.name in self._name_to_id:
                raise DomainAlreadyExistsError(record.info.name)
            record = copy.deepcopy(record)
            if not record.info.id:
                record.info.id = str(uuid.uuid4())
            record.notification_version = self._notification_version
            self._notification_version += 1
            self._by_id[record.info.id] = record
            self._name_to_id[record.info.name] = record.info.id
            return record.info.id

    def _resolve(self, id: str, name: str) -> DomainRecord:
        if id:
            rec = self._by_id.get(id)
        elif name:
            rec = self._by_id.get(self._name_to_id.get(name, ""))
        else:
            raise ValueError("id or name required")
        if rec is None:
            raise EntityNotExistsError(f"domain {id or name}")
        return rec

    def get_domain(self, id: str = "", name: str = "") -> DomainRecord:
        with self._lock:
            return copy.deepcopy(self._resolve(id, name))

    def update_domain(self, record: DomainRecord) -> None:
        with self._lock:
            stored = self._by_id.get(record.info.id)
            if stored is None:
                raise EntityNotExistsError(f"domain {record.info.id}")
            record = copy.deepcopy(record)
            record.notification_version = self._notification_version
            self._notification_version += 1
            if stored.info.name != record.info.name:
                del self._name_to_id[stored.info.name]
                self._name_to_id[record.info.name] = record.info.id
            self._by_id[record.info.id] = record

    def delete_domain(self, id: str = "", name: str = "") -> None:
        with self._lock:
            try:
                rec = self._resolve(id, name)
            except EntityNotExistsError:
                return
            del self._by_id[rec.info.id]
            del self._name_to_id[rec.info.name]

    def list_domains(self) -> List[DomainRecord]:
        with self._lock:
            return [copy.deepcopy(r) for r in self._by_id.values()]

    def get_metadata_version(self) -> int:
        with self._lock:
            return self._notification_version


class MemoryVisibilityManager(I.VisibilityManager):
    def __init__(self) -> None:
        self._lock = make_rlock("MemoryVisibilityManager._lock")
        # domain -> {(wf, run) -> record}
        self._open: Dict[str, Dict[Tuple[str, str], VisibilityRecord]] = {}
        self._closed: Dict[str, Dict[Tuple[str, str], VisibilityRecord]] = {}

    def record_workflow_execution_started(self, rec: VisibilityRecord) -> None:
        with self._lock:
            self._open.setdefault(rec.domain_id, {})[
                (rec.workflow_id, rec.run_id)
            ] = copy.deepcopy(rec)

    def record_workflow_execution_closed(self, rec: VisibilityRecord) -> None:
        with self._lock:
            self._open.get(rec.domain_id, {}).pop(
                (rec.workflow_id, rec.run_id), None
            )
            self._closed.setdefault(rec.domain_id, {})[
                (rec.workflow_id, rec.run_id)
            ] = copy.deepcopy(rec)

    def upsert_workflow_execution(self, rec: VisibilityRecord) -> None:
        with self._lock:
            bucket = self._open.setdefault(rec.domain_id, {})
            key = (rec.workflow_id, rec.run_id)
            if key in bucket:
                bucket[key] = copy.deepcopy(rec)
            else:
                self._closed.setdefault(rec.domain_id, {})[key] = copy.deepcopy(rec)

    def _list(
        self,
        store: Dict[str, Dict[Tuple[str, str], VisibilityRecord]],
        domain_id: str,
        earliest_start: int,
        latest_start: int,
        workflow_type: str,
        workflow_id: str,
        close_status: int,
        page_size: int,
        next_token: int,
    ) -> Tuple[List[VisibilityRecord], int]:
        records = [
            r
            for r in store.get(domain_id, {}).values()
            if earliest_start <= r.start_time <= latest_start
            and (not workflow_type or r.workflow_type == workflow_type)
            and (not workflow_id or r.workflow_id == workflow_id)
            and (close_status < 0 or r.close_status == close_status)
        ]
        records.sort(key=lambda r: (-r.start_time, r.workflow_id, r.run_id))
        page = records[next_token : next_token + page_size]
        token = next_token + page_size if next_token + page_size < len(records) else 0
        return copy.deepcopy(page), token

    def list_open_workflow_executions(
        self, domain_id, earliest_start=0, latest_start=2**63 - 1,
        workflow_type="", workflow_id="", page_size=100, next_token=0,
    ):
        with self._lock:
            return self._list(
                self._open, domain_id, earliest_start, latest_start,
                workflow_type, workflow_id, -1, page_size, next_token,
            )

    def list_closed_workflow_executions(
        self, domain_id, earliest_start=0, latest_start=2**63 - 1,
        workflow_type="", workflow_id="", close_status=-1,
        page_size=100, next_token=0,
    ):
        with self._lock:
            return self._list(
                self._closed, domain_id, earliest_start, latest_start,
                workflow_type, workflow_id, close_status, page_size, next_token,
            )

    def get_closed_workflow_execution(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> VisibilityRecord:
        with self._lock:
            if run_id:
                rec = self._closed.get(domain_id, {}).get((workflow_id, run_id))
            else:
                matches = [
                    r
                    for (w, _), r in self._closed.get(domain_id, {}).items()
                    if w == workflow_id
                ]
                rec = max(matches, key=lambda r: r.close_time) if matches else None
            if rec is None:
                raise EntityNotExistsError(f"closed {workflow_id}/{run_id}")
            return copy.deepcopy(rec)

    def count_workflow_executions(
        self, domain_id: str, open_only: bool = False
    ) -> int:
        with self._lock:
            n = len(self._open.get(domain_id, {}))
            if not open_only:
                n += len(self._closed.get(domain_id, {}))
            return n

    def delete_workflow_execution(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> None:
        with self._lock:
            self._open.get(domain_id, {}).pop((workflow_id, run_id), None)
            self._closed.get(domain_id, {}).pop((workflow_id, run_id), None)


def create_memory_bundle() -> I.PersistenceBundle:
    from ...checkpoint.store import MemoryCheckpointStore

    shard = MemoryShardManager()
    return I.PersistenceBundle(
        shard=shard,
        execution=MemoryExecutionManager(shard),
        history=MemoryHistoryManager(),
        task=MemoryTaskManager(),
        metadata=MemoryMetadataManager(),
        visibility=MemoryVisibilityManager(),
        checkpoint=MemoryCheckpointStore(),
    )
