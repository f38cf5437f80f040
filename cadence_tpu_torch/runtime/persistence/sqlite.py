"""SQLite persistence backend — the durable single-node store.

Plays the role the reference's SQL plugin plays
(Cadence common/persistence/sql/): the same five-manager
contract as the memory backend, with every conditional write executed
inside a transaction so the LWT semantics hold across processes.
MutableState snapshots, events, and tasks are JSON blobs; condition
columns (range_id, next_event_id) are real columns checked in SQL.

A copy of the reference package's ``runtime/persistence/sqlite.py``, with
its guarantees unchanged: WAL journal, a 5 s busy timeout, every
transaction ``BEGIN IMMEDIATE`` under the one connection's lock, the same
conditions (range-id fencing, ``next_event_id``, task-list leases) and the
same boot gate (``auto_setup`` or ``check_compat``). It writes the rows
the reference writes, so a file written by either package opens in the
other.
"""

from __future__ import annotations

import json
import sqlite3
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from ...core.events import HistoryEvent, decode_batch, encode_batch
from ...core.tasks import ReplicationTask, TimerTask, TransferTask
from ...utils.locks import make_rlock

from . import interfaces as I
from . import serde
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
    DomainConfig,
    DomainInfo,
    DomainRecord,
    DomainReplicationConfig,
    GetWorkflowResponse,
    ShardInfo,
    TaskInfo,
    TaskListInfo,
    VisibilityRecord,
    WorkflowSnapshot,
)

# schema DDL lives in schema.py (versioned migrations)


class _Db:
    """One shared connection guarded by a lock; transactions via context."""

    def __init__(self, path: str, auto_setup: bool = True) -> None:
        from .schema import check_compat, update_schema

        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        # writers from other PROCESSES (two-process service plane) wait
        # instead of failing immediately with SQLITE_BUSY
        self.conn.execute("PRAGMA busy_timeout=5000")
        if auto_setup:
            # embedded/onebox convenience: bring the schema to current
            update_schema(self.conn)
        else:
            # production boot: the operator runs `schema update`
            # explicitly (ref cmd/server/cadence.go:66 compat gate)
            check_compat(self.conn)
        # manual transaction control: txn() issues BEGIN IMMEDIATE
        # itself; the driver must not inject its own deferred BEGINs
        self.conn.isolation_level = None
        self.lock = make_rlock("_Db.lock")

    @contextmanager
    def txn(self):
        with self.lock:
            try:
                # BEGIN IMMEDIATE: python-sqlite3's legacy mode starts
                # the transaction only at the first DML, so a
                # check-then-write (the LWT pattern: current-execution
                # probe, next_event_id condition, lease bump) would run
                # its SELECT in autocommit and race a second PROCESS.
                # Taking the reserved lock up front makes the whole
                # block atomic across processes
                self.conn.execute("BEGIN IMMEDIATE")
                yield self.conn
                self.conn.commit()
            except BaseException:
                self.conn.rollback()
                raise


def _vis_to_json(r: VisibilityRecord) -> str:
    import dataclasses

    return json.dumps(dataclasses.asdict(r))


def _vis_from_json(s: str) -> VisibilityRecord:
    return VisibilityRecord(**json.loads(s))


class SqliteShardManager(I.ShardManager):
    def __init__(self, db: _Db) -> None:
        self.db = db

    def create_shard(self, info: ShardInfo) -> None:
        with self.db.txn() as c:
            row = c.execute(
                "SELECT 1 FROM shards WHERE shard_id=?", (info.shard_id,)
            ).fetchone()
            if row:
                raise ShardAlreadyExistsError(str(info.shard_id))
            c.execute(
                "INSERT INTO shards VALUES (?,?,?)",
                (info.shard_id, info.range_id, info.to_json()),
            )

    def get_shard(self, shard_id: int) -> ShardInfo:
        with self.db.txn() as c:
            row = c.execute(
                "SELECT blob FROM shards WHERE shard_id=?", (shard_id,)
            ).fetchone()
        if not row:
            raise EntityNotExistsError(f"shard {shard_id}")
        return ShardInfo.from_json(row[0])

    def update_shard(self, info: ShardInfo, previous_range_id: int) -> None:
        with self.db.txn() as c:
            cur = c.execute(
                "UPDATE shards SET range_id=?, blob=? "
                "WHERE shard_id=? AND range_id=?",
                (info.range_id, info.to_json(), info.shard_id, previous_range_id),
            )
            if cur.rowcount == 0:
                row = c.execute(
                    "SELECT 1 FROM shards WHERE shard_id=?", (info.shard_id,)
                ).fetchone()
                if not row:
                    raise EntityNotExistsError(f"shard {info.shard_id}")
                raise ShardOwnershipLostError(info.shard_id)

    # -- elastic resharding -------------------------------------------

    def get_reshard_state(self):
        with self.db.txn() as c:
            row = c.execute(
                "SELECT epoch, blob FROM reshard_state WHERE id=0"
            ).fetchone()
        return (int(row[0]), row[1]) if row else None

    def set_reshard_state(self, epoch, blob, previous_epoch):
        with self.db.txn() as c:
            row = c.execute(
                "SELECT epoch FROM reshard_state WHERE id=0"
            ).fetchone()
            stored = int(row[0]) if row else 0
            if stored != previous_epoch:
                raise ConditionFailedError(
                    f"reshard epoch {stored} != expected {previous_epoch}"
                )
            c.execute(
                "INSERT OR REPLACE INTO reshard_state VALUES (0,?,?)",
                (epoch, blob),
            )

    # -- adaptive geo-replication --------------------------------------

    def get_replication_progress(self, shard_id, cluster):
        with self.db.txn() as c:
            row = c.execute(
                "SELECT version, blob FROM replication_progress "
                "WHERE shard_id=? AND cluster=?",
                (shard_id, cluster),
            ).fetchone()
        return (int(row[0]), row[1]) if row else None

    def set_replication_progress(
        self, shard_id, cluster, blob, previous_version
    ):
        with self.db.txn() as c:
            row = c.execute(
                "SELECT version FROM replication_progress "
                "WHERE shard_id=? AND cluster=?",
                (shard_id, cluster),
            ).fetchone()
            stored = int(row[0]) if row else 0
            if stored != previous_version:
                raise ConditionFailedError(
                    f"replication progress version {stored} != "
                    f"expected {previous_version}"
                )
            c.execute(
                "INSERT OR REPLACE INTO replication_progress "
                "VALUES (?,?,?,?)",
                (shard_id, cluster, previous_version + 1, blob),
            )


class SqliteExecutionManager(I.ExecutionManager):
    def __init__(self, db: _Db) -> None:
        self.db = db

    def _check_range(self, c, shard_id: int, range_id: int) -> None:
        row = c.execute(
            "SELECT range_id FROM shards WHERE shard_id=?", (shard_id,)
        ).fetchone()
        if row is None:
            # a missing shard row must FENCE, not bypass fencing (the
            # memory backend raises here too — conformance)
            raise EntityNotExistsError(f"shard {shard_id}")
        if row[0] > range_id:
            raise ShardOwnershipLostError(shard_id)

    def _put_tasks(self, c, shard_id: int, snap: WorkflowSnapshot) -> None:
        for t in snap.transfer_tasks:
            c.execute(
                "INSERT OR REPLACE INTO transfer_tasks VALUES (?,?,?)",
                (shard_id, t.task_id, serde.transfer_to_json(t)),
            )
        for t in snap.timer_tasks:
            c.execute(
                "INSERT OR REPLACE INTO timer_tasks VALUES (?,?,?,?)",
                (
                    shard_id, t.visibility_timestamp, t.task_id,
                    serde.timer_to_json(t),
                ),
            )
        for t in snap.replication_tasks:
            c.execute(
                "INSERT OR REPLACE INTO replication_tasks VALUES (?,?,?)",
                (shard_id, t.task_id, serde.replication_to_json(t)),
            )

    def _store(self, c, shard_id: int, snap: WorkflowSnapshot) -> None:
        c.execute(
            "INSERT OR REPLACE INTO executions VALUES (?,?,?,?,?,?,?)",
            (
                shard_id, snap.domain_id, snap.workflow_id, snap.run_id,
                snap.next_event_id, snap.last_write_version,
                serde.snapshot_to_json(snap.snapshot),
            ),
        )
        self._put_tasks(c, shard_id, snap)

    @staticmethod
    def _exec_state(snapshot: Dict[str, Any]) -> Tuple[int, int]:
        ex = snapshot.get("execution_info") or snapshot.get("exec") or snapshot
        return int(ex.get("state", 0)), int(ex.get("close_status", 0))

    @staticmethod
    def _request_id(snapshot: Dict[str, Any]) -> str:
        ex = snapshot.get("execution_info") or {}
        return ex.get("create_request_id") or snapshot.get("request_id", "")

    def _create_locked(
        self, c, shard_id, range_id, mode, snapshot, prev_run_id,
        prev_last_write_version,
    ) -> None:
        self._check_range(c, shard_id, range_id)
        cur_row = c.execute(
            "SELECT run_id, create_request_id, state, close_status, "
            "last_write_version FROM current_executions "
            "WHERE shard_id=? AND domain_id=? AND workflow_id=?",
            (shard_id, snapshot.domain_id, snapshot.workflow_id),
        ).fetchone()
        if mode == CreateWorkflowMode.BRAND_NEW:
            if cur_row:
                raise WorkflowAlreadyStartedError(
                    f"workflow {snapshot.workflow_id} already started",
                    cur_row[1], cur_row[0], cur_row[2], cur_row[3], cur_row[4],
                )
        elif mode == CreateWorkflowMode.WORKFLOW_ID_REUSE:
            if not cur_row:
                raise ConditionFailedError("no current execution to reuse")
            if cur_row[2] != 2:  # WorkflowState.Completed
                raise WorkflowAlreadyStartedError(
                    f"workflow {snapshot.workflow_id} still running",
                    cur_row[1], cur_row[0], cur_row[2], cur_row[3], cur_row[4],
                )
            if cur_row[0] != prev_run_id:
                raise ConditionFailedError(
                    f"current run {cur_row[0]} != expected {prev_run_id}"
                )
        elif mode == CreateWorkflowMode.CONTINUE_AS_NEW:
            if not cur_row or cur_row[0] != prev_run_id:
                raise ConditionFailedError("continue-as-new current mismatch")
        elif mode == CreateWorkflowMode.ZOMBIE:
            pass
        elif mode == CreateWorkflowMode.SUPPRESS_CURRENT:
            if not cur_row or cur_row[0] != prev_run_id:
                raise ConditionFailedError(
                    "suppress-current run mismatch: "
                    f"{cur_row[0] if cur_row else None} != {prev_run_id}"
                )
            # zombify the stale run's stored record (WorkflowState.Zombie=3)
            old = c.execute(
                "SELECT snapshot FROM executions WHERE shard_id=? AND "
                "domain_id=? AND workflow_id=? AND run_id=?",
                (shard_id, snapshot.domain_id, snapshot.workflow_id,
                 cur_row[0]),
            ).fetchone()
            if old:
                snap = serde.snapshot_from_json(old[0])
                ex = snap.get("execution_info")
                if isinstance(ex, dict):
                    ex["state"] = 3
                c.execute(
                    "UPDATE executions SET snapshot=? WHERE shard_id=? AND "
                    "domain_id=? AND workflow_id=? AND run_id=?",
                    (serde.snapshot_to_json(snap), shard_id,
                     snapshot.domain_id, snapshot.workflow_id, cur_row[0]),
                )
        else:
            raise ValueError(f"unknown create mode {mode}")
        state, close_status = self._exec_state(snapshot.snapshot)
        if mode != CreateWorkflowMode.ZOMBIE:
            c.execute(
                "INSERT OR REPLACE INTO current_executions VALUES "
                "(?,?,?,?,?,?,?,?)",
                (
                    shard_id, snapshot.domain_id, snapshot.workflow_id,
                    snapshot.run_id,
                    self._request_id(snapshot.snapshot),
                    state, close_status, snapshot.last_write_version,
                ),
            )
        self._store(c, shard_id, snapshot)

    def create_workflow_execution(
        self, shard_id, range_id, mode, snapshot,
        prev_run_id="", prev_last_write_version=0,
    ) -> None:
        with self.db.txn() as c:
            self._create_locked(
                c, shard_id, range_id, mode, snapshot, prev_run_id,
                prev_last_write_version,
            )

    def get_workflow_execution(
        self, shard_id, domain_id, workflow_id, run_id
    ) -> GetWorkflowResponse:
        with self.db.txn() as c:
            row = c.execute(
                "SELECT snapshot, next_event_id FROM executions WHERE "
                "shard_id=? AND domain_id=? AND workflow_id=? AND run_id=?",
                (shard_id, domain_id, workflow_id, run_id),
            ).fetchone()
        if not row:
            raise EntityNotExistsError(f"execution {workflow_id}/{run_id}")
        return GetWorkflowResponse(
            snapshot=serde.snapshot_from_json(row[0]), next_event_id=row[1]
        )

    def update_workflow_execution(
        self, shard_id, range_id, condition, mutation,
        new_snapshot=None, new_mode=CreateWorkflowMode.CONTINUE_AS_NEW,
    ) -> None:
        with self.db.txn() as c:
            self._check_range(c, shard_id, range_id)
            row = c.execute(
                "SELECT next_event_id FROM executions WHERE "
                "shard_id=? AND domain_id=? AND workflow_id=? AND run_id=?",
                (
                    shard_id, mutation.domain_id, mutation.workflow_id,
                    mutation.run_id,
                ),
            ).fetchone()
            if not row:
                raise EntityNotExistsError(
                    f"execution {mutation.workflow_id}/{mutation.run_id}"
                )
            if row[0] != condition:
                raise ConditionFailedError(
                    f"next_event_id {row[0]} != condition {condition}"
                )
            self._store(c, shard_id, mutation)
            state, close_status = self._exec_state(mutation.snapshot)
            c.execute(
                "UPDATE current_executions SET state=?, close_status=?, "
                "last_write_version=? WHERE shard_id=? AND domain_id=? AND "
                "workflow_id=? AND run_id=?",
                (
                    state, close_status, mutation.last_write_version,
                    shard_id, mutation.domain_id, mutation.workflow_id,
                    mutation.run_id,
                ),
            )
            if new_snapshot is not None:
                self._create_locked(
                    c, shard_id, range_id, new_mode, new_snapshot,
                    mutation.run_id, 0,
                )

    def conflict_resolve_workflow_execution(
        self, shard_id, range_id, condition, reset_snapshot
    ) -> None:
        with self.db.txn() as c:
            self._check_range(c, shard_id, range_id)
            row = c.execute(
                "SELECT next_event_id FROM executions WHERE "
                "shard_id=? AND domain_id=? AND workflow_id=? AND run_id=?",
                (
                    shard_id, reset_snapshot.domain_id,
                    reset_snapshot.workflow_id, reset_snapshot.run_id,
                ),
            ).fetchone()
            if row and row[0] != condition:
                raise ConditionFailedError(
                    f"next_event_id {row[0]} != condition {condition}"
                )
            self._store(c, shard_id, reset_snapshot)
            state, close_status = self._exec_state(reset_snapshot.snapshot)
            c.execute(
                "UPDATE current_executions SET state=?, close_status=? "
                "WHERE shard_id=? AND domain_id=? AND workflow_id=? AND run_id=?",
                (
                    state, close_status, shard_id, reset_snapshot.domain_id,
                    reset_snapshot.workflow_id, reset_snapshot.run_id,
                ),
            )

    def delete_workflow_execution(
        self, shard_id, domain_id, workflow_id, run_id
    ) -> None:
        with self.db.txn() as c:
            c.execute(
                "DELETE FROM executions WHERE shard_id=? AND domain_id=? "
                "AND workflow_id=? AND run_id=?",
                (shard_id, domain_id, workflow_id, run_id),
            )

    def delete_current_workflow_execution(
        self, shard_id, domain_id, workflow_id, run_id
    ) -> None:
        with self.db.txn() as c:
            c.execute(
                "DELETE FROM current_executions WHERE shard_id=? AND "
                "domain_id=? AND workflow_id=? AND run_id=?",
                (shard_id, domain_id, workflow_id, run_id),
            )

    def get_current_execution(
        self, shard_id, domain_id, workflow_id
    ) -> CurrentExecution:
        with self.db.txn() as c:
            row = c.execute(
                "SELECT run_id, create_request_id, state, close_status, "
                "last_write_version FROM current_executions WHERE "
                "shard_id=? AND domain_id=? AND workflow_id=?",
                (shard_id, domain_id, workflow_id),
            ).fetchone()
        if not row:
            raise EntityNotExistsError(f"no current execution {workflow_id}")
        return CurrentExecution(*row)

    def list_concrete_executions(self, shard_id):
        with self.db.txn() as c:
            rows = c.execute(
                "SELECT domain_id, workflow_id, run_id FROM executions "
                "WHERE shard_id=?",
                (shard_id,),
            ).fetchall()
        return [tuple(r) for r in rows]

    # -- elastic resharding -------------------------------------------

    def reshard_extract(
        self, shard_id, workflow_ids, transfer_watermark, timer_watermark,
        delete=False,
    ):
        out = {"executions": [], "currents": [], "transfer": [],
               "timers": [], "replication": []}
        wids = sorted(set(workflow_ids))
        if not wids:
            return out
        marks = ",".join("?" * len(wids))
        with self.db.txn() as c:
            for row in c.execute(
                "SELECT domain_id, workflow_id, run_id, next_event_id, "
                f"last_write_version, snapshot FROM executions "
                f"WHERE shard_id=? AND workflow_id IN ({marks}) "
                "ORDER BY workflow_id, run_id",
                [shard_id] + wids,
            ).fetchall():
                out["executions"].append({
                    "domain_id": row[0], "workflow_id": row[1],
                    "run_id": row[2], "next_event_id": row[3],
                    "last_write_version": row[4],
                    "snapshot": serde.snapshot_from_json(row[5]),
                })
            for row in c.execute(
                "SELECT domain_id, workflow_id, run_id, create_request_id,"
                f" state, close_status, last_write_version "
                f"FROM current_executions "
                f"WHERE shard_id=? AND workflow_id IN ({marks}) "
                "ORDER BY workflow_id",
                [shard_id] + wids,
            ).fetchall():
                out["currents"].append({
                    "domain_id": row[0], "workflow_id": row[1],
                    "run_id": row[2], "create_request_id": row[3],
                    "state": row[4], "close_status": row[5],
                    "last_write_version": row[6],
                })
            tasks = [
                serde.transfer_from_json(r[0]) for r in c.execute(
                    "SELECT blob FROM transfer_tasks WHERE shard_id=? "
                    "AND task_id>? ORDER BY task_id",
                    (shard_id, transfer_watermark),
                ).fetchall()
            ]
            out["transfer"] = [t for t in tasks if t.workflow_id in wids]
            tasks = [
                serde.timer_from_json(r[0]) for r in c.execute(
                    "SELECT blob FROM timer_tasks WHERE shard_id=? "
                    "AND (visibility_ts>? OR (visibility_ts=? AND "
                    "task_id>?)) ORDER BY visibility_ts, task_id",
                    (shard_id, timer_watermark[0], timer_watermark[0],
                     timer_watermark[1]),
                ).fetchall()
            ]
            out["timers"] = [t for t in tasks if t.workflow_id in wids]
            tasks = [
                serde.replication_from_json(r[0]) for r in c.execute(
                    "SELECT blob FROM replication_tasks WHERE shard_id=? "
                    "ORDER BY task_id", (shard_id,),
                ).fetchall()
            ]
            out["replication"] = [
                t for t in tasks if t.workflow_id in wids
            ]
            if delete:
                self._purge_locked(c, shard_id, out)
        return out

    @staticmethod
    def _purge_locked(c, shard_id, extracted) -> None:
        for e in extracted["executions"]:
            c.execute(
                "DELETE FROM executions WHERE shard_id=? AND domain_id=? "
                "AND workflow_id=? AND run_id=?",
                (shard_id, e["domain_id"], e["workflow_id"], e["run_id"]),
            )
        for cur in extracted["currents"]:
            c.execute(
                "DELETE FROM current_executions WHERE shard_id=? AND "
                "domain_id=? AND workflow_id=?",
                (shard_id, cur["domain_id"], cur["workflow_id"]),
            )
        for t in extracted["transfer"]:
            c.execute(
                "DELETE FROM transfer_tasks WHERE shard_id=? AND "
                "task_id=?", (shard_id, t.task_id),
            )
        for t in extracted["timers"]:
            c.execute(
                "DELETE FROM timer_tasks WHERE shard_id=? AND "
                "visibility_ts=? AND task_id=?",
                (shard_id, t.visibility_timestamp, t.task_id),
            )
        for t in extracted["replication"]:
            c.execute(
                "DELETE FROM replication_tasks WHERE shard_id=? AND "
                "task_id=?", (shard_id, t.task_id),
            )

    def reshard_purge(self, shard_id, extracted):
        with self.db.txn() as c:
            self._purge_locked(c, shard_id, extracted)

    def reshard_install(self, shard_id, range_id, extracted, task_id_fn):
        import copy as _copy

        with self.db.txn() as c:
            row = c.execute(
                "SELECT range_id FROM shards WHERE shard_id=?", (shard_id,)
            ).fetchone()
            if row is None:
                raise EntityNotExistsError(f"shard {shard_id}")
            if row[0] != range_id:
                raise ShardOwnershipLostError(shard_id)
            for e in extracted["executions"]:
                c.execute(
                    "INSERT OR REPLACE INTO executions VALUES "
                    "(?,?,?,?,?,?,?)",
                    (shard_id, e["domain_id"], e["workflow_id"],
                     e["run_id"], e["next_event_id"],
                     e["last_write_version"],
                     serde.snapshot_to_json(e["snapshot"])),
                )
            for cur in extracted["currents"]:
                c.execute(
                    "INSERT OR REPLACE INTO current_executions VALUES "
                    "(?,?,?,?,?,?,?,?)",
                    (shard_id, cur["domain_id"], cur["workflow_id"],
                     cur["run_id"], cur["create_request_id"],
                     cur["state"], cur["close_status"],
                     cur["last_write_version"]),
                )
            for t in extracted["transfer"]:
                t = _copy.deepcopy(t)
                t.task_id = task_id_fn()
                c.execute(
                    "INSERT OR REPLACE INTO transfer_tasks VALUES (?,?,?)",
                    (shard_id, t.task_id, serde.transfer_to_json(t)),
                )
            for t in extracted["timers"]:
                t = _copy.deepcopy(t)
                t.task_id = task_id_fn()
                c.execute(
                    "INSERT OR REPLACE INTO timer_tasks VALUES (?,?,?,?)",
                    (shard_id, t.visibility_timestamp, t.task_id,
                     serde.timer_to_json(t)),
                )
            for t in extracted["replication"]:
                t = _copy.deepcopy(t)
                t.task_id = task_id_fn()
                c.execute(
                    "INSERT OR REPLACE INTO replication_tasks VALUES "
                    "(?,?,?)",
                    (shard_id, t.task_id, serde.replication_to_json(t)),
                )

    # -- queues -------------------------------------------------------

    def get_transfer_tasks(self, shard_id, read_level, max_read_level, batch_size):
        with self.db.txn() as c:
            rows = c.execute(
                "SELECT blob FROM transfer_tasks WHERE shard_id=? AND "
                "task_id>? AND task_id<=? ORDER BY task_id LIMIT ?",
                (shard_id, read_level, max_read_level, batch_size),
            ).fetchall()
        return [serde.transfer_from_json(r[0]) for r in rows]

    def complete_transfer_task(self, shard_id, task_id):
        with self.db.txn() as c:
            c.execute(
                "DELETE FROM transfer_tasks WHERE shard_id=? AND task_id=?",
                (shard_id, task_id),
            )

    def range_complete_transfer_tasks(self, shard_id, exclusive_begin, inclusive_end):
        with self.db.txn() as c:
            c.execute(
                "DELETE FROM transfer_tasks WHERE shard_id=? AND task_id>? "
                "AND task_id<=?",
                (shard_id, exclusive_begin, inclusive_end),
            )

    def get_timer_tasks(self, shard_id, min_ts, max_ts, batch_size,
                        after_key=None):
        sql = (
            "SELECT blob FROM timer_tasks WHERE shard_id=? AND "
            "visibility_ts>=? AND visibility_ts<? "
        )
        params = [shard_id, min_ts, max_ts]
        if after_key is not None:
            sql += (
                "AND (visibility_ts>? OR (visibility_ts=? AND task_id>?)) "
            )
            params += [after_key[0], after_key[0], after_key[1]]
        sql += "ORDER BY visibility_ts, task_id LIMIT ?"
        params.append(batch_size)
        with self.db.txn() as c:
            rows = c.execute(sql, params).fetchall()
        return [serde.timer_from_json(r[0]) for r in rows]

    def complete_timer_task(self, shard_id, visibility_ts, task_id):
        with self.db.txn() as c:
            c.execute(
                "DELETE FROM timer_tasks WHERE shard_id=? AND "
                "visibility_ts=? AND task_id=?",
                (shard_id, visibility_ts, task_id),
            )

    def range_complete_timer_tasks(self, shard_id, inclusive_begin_ts, exclusive_end_ts):
        with self.db.txn() as c:
            c.execute(
                "DELETE FROM timer_tasks WHERE shard_id=? AND "
                "visibility_ts>=? AND visibility_ts<?",
                (shard_id, inclusive_begin_ts, exclusive_end_ts),
            )

    def get_replication_tasks(self, shard_id, read_level, batch_size):
        with self.db.txn() as c:
            rows = c.execute(
                "SELECT blob FROM replication_tasks WHERE shard_id=? AND "
                "task_id>? ORDER BY task_id LIMIT ?",
                (shard_id, read_level, batch_size),
            ).fetchall()
        return [serde.replication_from_json(r[0]) for r in rows]

    def complete_replication_task(self, shard_id, task_id):
        with self.db.txn() as c:
            c.execute(
                "DELETE FROM replication_tasks WHERE shard_id=? AND task_id=?",
                (shard_id, task_id),
            )


class SqliteHistoryManager(I.HistoryManager):
    def __init__(self, db: _Db) -> None:
        self.db = db

    def new_history_branch(self, tree_id: str) -> BranchToken:
        token = BranchToken(tree_id=tree_id, branch_id=str(uuid.uuid4()))
        with self.db.txn() as c:
            c.execute(
                "INSERT INTO history_branches VALUES (?,?,?)",
                (tree_id, token.branch_id, token.to_json()),
            )
        return token

    def append_history_nodes(self, branch, events, transaction_id) -> int:
        if not events:
            raise ValueError("empty event batch")
        node_id = events[0].event_id
        blob = encode_batch(events)
        with self.db.txn() as c:
            c.execute(
                "INSERT OR IGNORE INTO history_branches VALUES (?,?,?)",
                (branch.tree_id, branch.branch_id, branch.to_json()),
            )
            row = c.execute(
                "SELECT txn_id FROM history_nodes WHERE tree_id=? AND "
                "branch_id=? AND node_id=?",
                (branch.tree_id, branch.branch_id, node_id),
            ).fetchone()
            if row is None or row[0] < transaction_id:
                c.execute(
                    "INSERT OR REPLACE INTO history_nodes VALUES (?,?,?,?,?)",
                    (
                        branch.tree_id, branch.branch_id, node_id,
                        transaction_id, blob,
                    ),
                )
        return len(blob)

    def _segments(self, branch: BranchToken):
        segs = [
            (a.branch_id, a.begin_node_id, a.end_node_id)
            for a in branch.ancestors
        ]
        begin = branch.ancestors[-1].end_node_id if branch.ancestors else 1
        segs.append((branch.branch_id, begin, 2**62))
        return segs

    def read_history_branch(
        self, branch, min_event_id, max_event_id, page_size=0, next_token=0
    ):
        collected: List[Tuple[int, bytes]] = []
        with self.db.txn() as c:
            for branch_id, begin, end in self._segments(branch):
                rows = c.execute(
                    "SELECT node_id, blob FROM history_nodes WHERE tree_id=? "
                    "AND branch_id=? AND node_id>=? AND node_id<? "
                    "AND node_id>=? AND node_id<? AND node_id>=?",
                    (
                        branch.tree_id, branch_id, begin, end,
                        min_event_id, max_event_id, next_token,
                    ),
                ).fetchall()
                collected.extend((r[0], r[1]) for r in rows)
        collected.sort(key=lambda x: x[0])
        if page_size and len(collected) > page_size:
            page = collected[:page_size]
            token = collected[page_size][0]
        else:
            page, token = collected, 0
        return [decode_batch(blob) for _, blob in page], token

    def fork_history_branch(self, branch, fork_node_id) -> BranchToken:
        ancestors: List[BranchAncestor] = []
        for a in branch.ancestors:
            if a.end_node_id <= fork_node_id:
                ancestors.append(a)
            else:
                ancestors.append(
                    BranchAncestor(a.branch_id, a.begin_node_id, fork_node_id)
                )
                break
        else:
            begin = branch.ancestors[-1].end_node_id if branch.ancestors else 1
            ancestors.append(
                BranchAncestor(branch.branch_id, begin, fork_node_id)
            )
        token = BranchToken(
            tree_id=branch.tree_id, branch_id=str(uuid.uuid4()),
            ancestors=ancestors,
        )
        with self.db.txn() as c:
            c.execute(
                "INSERT INTO history_branches VALUES (?,?,?)",
                (branch.tree_id, token.branch_id, token.to_json()),
            )
        return token

    def delete_history_branch(self, branch) -> None:
        with self.db.txn() as c:
            c.execute(
                "DELETE FROM history_branches WHERE tree_id=? AND branch_id=?",
                (branch.tree_id, branch.branch_id),
            )
            # Sweep every node range in the tree that no surviving
            # branch owns or references as an ancestor segment (shared
            # fork prefix — reference historyV2 deleteBranch keeps
            # shared ranges). Sweeping the whole tree rather than just
            # the target also reclaims ranges a *previously deleted*
            # ancestor left behind, which become orphaned exactly when
            # their last descendant goes.
            live: dict = {}  # branch_id -> protected end (0 = whole)
            for (token,) in c.execute(
                "SELECT token FROM history_branches WHERE tree_id=?",
                (branch.tree_id,),
            ).fetchall():
                bt = BranchToken.from_json(token)
                live[bt.branch_id] = 0
                for anc in bt.ancestors:
                    if live.get(anc.branch_id, 1) != 0:
                        live[anc.branch_id] = max(
                            live.get(anc.branch_id, 0), anc.end_node_id
                        )
            node_bids = [r[0] for r in c.execute(
                "SELECT DISTINCT branch_id FROM history_nodes "
                "WHERE tree_id=?",
                (branch.tree_id,),
            ).fetchall()]
            for bid in node_bids:
                end = live.get(bid)
                if end == 0:
                    continue  # a live branch owns the whole range
                if end is None:
                    c.execute(
                        "DELETE FROM history_nodes WHERE tree_id=? AND "
                        "branch_id=?",
                        (branch.tree_id, bid),
                    )
                else:
                    c.execute(
                        "DELETE FROM history_nodes WHERE tree_id=? AND "
                        "branch_id=? AND node_id>=?",
                        (branch.tree_id, bid, end),
                    )

    def list_history_trees(self):
        """All (tree_id, branch tokens) pairs — the history scavenger's
        scan surface (reference GetAllHistoryTreeBranches); without it
        the scavenger silently skips the durable backend."""
        with self.db.txn() as c:
            rows = c.execute(
                "SELECT tree_id, token FROM history_branches "
                "ORDER BY tree_id"
            ).fetchall()
        out = {}
        for tree_id, blob in rows:
            out.setdefault(tree_id, []).append(BranchToken.from_json(blob))
        return list(out.items())

    def get_history_tree(self, tree_id: str) -> List[BranchToken]:
        with self.db.txn() as c:
            rows = c.execute(
                "SELECT token FROM history_branches WHERE tree_id=?",
                (tree_id,),
            ).fetchall()
        return [BranchToken.from_json(r[0]) for r in rows]


class SqliteTaskManager(I.TaskManager):
    def __init__(self, db: _Db) -> None:
        self.db = db

    def lease_task_list(self, domain_id, name, task_type) -> TaskListInfo:
        with self.db.txn() as c:
            row = c.execute(
                "SELECT range_id, ack_level, kind, last_updated FROM "
                "task_lists WHERE domain_id=? AND name=? AND task_type=?",
                (domain_id, name, task_type),
            ).fetchone()
            now_ns = time.time_ns()
            if row:
                info = TaskListInfo(
                    domain_id, name, task_type, row[0] + 1, row[1], row[2],
                    now_ns,
                )
                c.execute(
                    "UPDATE task_lists SET range_id=?, last_updated=? "
                    "WHERE domain_id=? AND name=? AND task_type=?",
                    (info.range_id, now_ns, domain_id, name, task_type),
                )
            else:
                info = TaskListInfo(
                    domain_id, name, task_type, range_id=1,
                    last_updated=now_ns,
                )
                c.execute(
                    "INSERT INTO task_lists VALUES (?,?,?,?,?,?,?)",
                    (domain_id, name, task_type, 1, 0, 0, now_ns),
                )
        return info

    def update_task_list(self, info: TaskListInfo) -> None:
        with self.db.txn() as c:
            cur = c.execute(
                "UPDATE task_lists SET ack_level=?, kind=?, last_updated=? "
                "WHERE domain_id=? AND name=? AND task_type=? AND range_id=?",
                (
                    info.ack_level, info.kind, time.time_ns(),
                    info.domain_id, info.name, info.task_type, info.range_id,
                ),
            )
            if cur.rowcount == 0:
                raise TaskListLeaseLostError(info.name)

    def create_tasks(self, info: TaskListInfo, tasks: List[TaskInfo]) -> None:
        import dataclasses

        with self.db.txn() as c:
            row = c.execute(
                "SELECT range_id FROM task_lists WHERE domain_id=? AND "
                "name=? AND task_type=?",
                (info.domain_id, info.name, info.task_type),
            ).fetchone()
            if not row or row[0] != info.range_id:
                raise TaskListLeaseLostError(info.name)
            for t in tasks:
                c.execute(
                    "INSERT OR REPLACE INTO tasks VALUES (?,?,?,?,?)",
                    (
                        info.domain_id, info.name, info.task_type, t.task_id,
                        json.dumps(dataclasses.asdict(t)),
                    ),
                )

    def get_tasks(
        self, domain_id, name, task_type, read_level, max_read_level, batch_size
    ):
        with self.db.txn() as c:
            rows = c.execute(
                "SELECT blob FROM tasks WHERE domain_id=? AND name=? AND "
                "task_type=? AND task_id>? AND task_id<=? "
                "ORDER BY task_id LIMIT ?",
                (
                    domain_id, name, task_type, read_level, max_read_level,
                    batch_size,
                ),
            ).fetchall()
        return [TaskInfo(**json.loads(r[0])) for r in rows]

    def complete_task(self, domain_id, name, task_type, task_id):
        with self.db.txn() as c:
            c.execute(
                "DELETE FROM tasks WHERE domain_id=? AND name=? AND "
                "task_type=? AND task_id=?",
                (domain_id, name, task_type, task_id),
            )

    def complete_tasks_less_than(self, domain_id, name, task_type, task_id):
        with self.db.txn() as c:
            cur = c.execute(
                "DELETE FROM tasks WHERE domain_id=? AND name=? AND "
                "task_type=? AND task_id<?",
                (domain_id, name, task_type, task_id),
            )
            return cur.rowcount

    def list_task_lists(self):
        with self.db.txn() as c:
            rows = c.execute(
                "SELECT domain_id, name, task_type, range_id, ack_level, "
                "kind, last_updated FROM task_lists"
            ).fetchall()
        return [TaskListInfo(*r) for r in rows]

    def delete_task_list(self, domain_id, name, task_type, range_id):
        with self.db.txn() as c:
            row = c.execute(
                "SELECT range_id FROM task_lists WHERE domain_id=? AND "
                "name=? AND task_type=?",
                (domain_id, name, task_type),
            ).fetchone()
            if not row:
                return
            if row[0] != range_id:
                raise TaskListLeaseLostError(name)
            c.execute(
                "DELETE FROM task_lists WHERE domain_id=? AND name=? AND "
                "task_type=?",
                (domain_id, name, task_type),
            )
            c.execute(
                "DELETE FROM tasks WHERE domain_id=? AND name=? AND task_type=?",
                (domain_id, name, task_type),
            )


class SqliteMetadataManager(I.MetadataManager):
    def __init__(self, db: _Db) -> None:
        self.db = db
        with self.db.txn() as c:
            c.execute(
                "INSERT OR IGNORE INTO meta VALUES ('domain_notification', 0)"
            )

    @staticmethod
    def _to_json(rec: DomainRecord) -> str:
        import dataclasses

        return json.dumps(dataclasses.asdict(rec))

    @staticmethod
    def _from_json(s: str) -> DomainRecord:
        d = json.loads(s)
        return DomainRecord(
            info=DomainInfo(**d["info"]),
            config=DomainConfig(**d["config"]),
            replication_config=DomainReplicationConfig(**d["replication_config"]),
            is_global=d["is_global"],
            config_version=d["config_version"],
            failover_version=d["failover_version"],
            failover_notification_version=d["failover_notification_version"],
            notification_version=d["notification_version"],
        )

    def _bump_version(self, c) -> int:
        c.execute("UPDATE meta SET v=v+1 WHERE k='domain_notification'")
        return c.execute(
            "SELECT v FROM meta WHERE k='domain_notification'"
        ).fetchone()[0] - 1

    def create_domain(self, record: DomainRecord) -> str:
        import copy

        record = copy.deepcopy(record)
        if not record.info.id:
            record.info.id = str(uuid.uuid4())
        with self.db.txn() as c:
            row = c.execute(
                "SELECT 1 FROM domains WHERE name=?", (record.info.name,)
            ).fetchone()
            if row:
                raise DomainAlreadyExistsError(record.info.name)
            record.notification_version = self._bump_version(c)
            c.execute(
                "INSERT INTO domains VALUES (?,?,?,?)",
                (
                    record.info.id, record.info.name, self._to_json(record),
                    record.notification_version,
                ),
            )
        return record.info.id

    def get_domain(self, id: str = "", name: str = "") -> DomainRecord:
        with self.db.txn() as c:
            if id:
                row = c.execute(
                    "SELECT blob FROM domains WHERE id=?", (id,)
                ).fetchone()
            elif name:
                row = c.execute(
                    "SELECT blob FROM domains WHERE name=?", (name,)
                ).fetchone()
            else:
                raise ValueError("id or name required")
        if not row:
            raise EntityNotExistsError(f"domain {id or name}")
        return self._from_json(row[0])

    def update_domain(self, record: DomainRecord) -> None:
        import copy

        record = copy.deepcopy(record)
        with self.db.txn() as c:
            row = c.execute(
                "SELECT 1 FROM domains WHERE id=?", (record.info.id,)
            ).fetchone()
            if not row:
                raise EntityNotExistsError(f"domain {record.info.id}")
            record.notification_version = self._bump_version(c)
            c.execute(
                "UPDATE domains SET name=?, blob=?, notification_version=? "
                "WHERE id=?",
                (
                    record.info.name, self._to_json(record),
                    record.notification_version, record.info.id,
                ),
            )

    def delete_domain(self, id: str = "", name: str = "") -> None:
        with self.db.txn() as c:
            if id:
                c.execute("DELETE FROM domains WHERE id=?", (id,))
            elif name:
                c.execute("DELETE FROM domains WHERE name=?", (name,))

    def list_domains(self) -> List[DomainRecord]:
        with self.db.txn() as c:
            rows = c.execute("SELECT blob FROM domains").fetchall()
        return [self._from_json(r[0]) for r in rows]

    def get_metadata_version(self) -> int:
        with self.db.txn() as c:
            return c.execute(
                "SELECT v FROM meta WHERE k='domain_notification'"
            ).fetchone()[0]


class SqliteVisibilityManager(I.VisibilityManager):
    def __init__(self, db: _Db) -> None:
        self.db = db

    def record_workflow_execution_started(self, rec: VisibilityRecord) -> None:
        with self.db.txn() as c:
            c.execute(
                "INSERT OR REPLACE INTO visibility VALUES (?,?,?,?,?,?,?,?,?)",
                (
                    rec.domain_id, rec.workflow_id, rec.run_id, 1,
                    rec.start_time, 0, -1, rec.workflow_type,
                    _vis_to_json(rec),
                ),
            )

    def record_workflow_execution_closed(self, rec: VisibilityRecord) -> None:
        with self.db.txn() as c:
            c.execute(
                "INSERT OR REPLACE INTO visibility VALUES (?,?,?,?,?,?,?,?,?)",
                (
                    rec.domain_id, rec.workflow_id, rec.run_id, 0,
                    rec.start_time, rec.close_time, rec.close_status,
                    rec.workflow_type, _vis_to_json(rec),
                ),
            )

    def upsert_workflow_execution(self, rec: VisibilityRecord) -> None:
        with self.db.txn() as c:
            row = c.execute(
                "SELECT is_open FROM visibility WHERE domain_id=? AND "
                "workflow_id=? AND run_id=?",
                (rec.domain_id, rec.workflow_id, rec.run_id),
            ).fetchone()
            is_open = row[0] if row else 0
            c.execute(
                "INSERT OR REPLACE INTO visibility VALUES (?,?,?,?,?,?,?,?,?)",
                (
                    rec.domain_id, rec.workflow_id, rec.run_id, is_open,
                    rec.start_time, rec.close_time, rec.close_status,
                    rec.workflow_type, _vis_to_json(rec),
                ),
            )

    def _list(
        self, is_open, domain_id, earliest_start, latest_start,
        workflow_type, workflow_id, close_status, page_size, next_token,
    ):
        q = (
            "SELECT blob FROM visibility WHERE domain_id=? AND is_open=? "
            "AND start_time>=? AND start_time<=?"
        )
        args: List[Any] = [domain_id, is_open, earliest_start, latest_start]
        if workflow_type:
            q += " AND workflow_type=?"
            args.append(workflow_type)
        if workflow_id:
            q += " AND workflow_id=?"
            args.append(workflow_id)
        if close_status >= 0:
            q += " AND close_status=?"
            args.append(close_status)
        q += " ORDER BY start_time DESC, workflow_id, run_id LIMIT ? OFFSET ?"
        args.extend([page_size + 1, next_token])
        with self.db.txn() as c:
            rows = c.execute(q, args).fetchall()
        records = [_vis_from_json(r[0]) for r in rows[:page_size]]
        token = next_token + page_size if len(rows) > page_size else 0
        return records, token

    def list_open_workflow_executions(
        self, domain_id, earliest_start=0, latest_start=2**63 - 1,
        workflow_type="", workflow_id="", page_size=100, next_token=0,
    ):
        return self._list(
            1, domain_id, earliest_start, latest_start, workflow_type,
            workflow_id, -1, page_size, next_token,
        )

    def list_closed_workflow_executions(
        self, domain_id, earliest_start=0, latest_start=2**63 - 1,
        workflow_type="", workflow_id="", close_status=-1,
        page_size=100, next_token=0,
    ):
        return self._list(
            0, domain_id, earliest_start, latest_start, workflow_type,
            workflow_id, close_status, page_size, next_token,
        )

    def get_closed_workflow_execution(self, domain_id, workflow_id, run_id):
        with self.db.txn() as c:
            if run_id:
                row = c.execute(
                    "SELECT blob FROM visibility WHERE domain_id=? AND "
                    "workflow_id=? AND run_id=? AND is_open=0",
                    (domain_id, workflow_id, run_id),
                ).fetchone()
            else:
                row = c.execute(
                    "SELECT blob FROM visibility WHERE domain_id=? AND "
                    "workflow_id=? AND is_open=0 ORDER BY close_time DESC "
                    "LIMIT 1",
                    (domain_id, workflow_id),
                ).fetchone()
        if not row:
            raise EntityNotExistsError(f"closed {workflow_id}/{run_id}")
        return _vis_from_json(row[0])

    def count_workflow_executions(self, domain_id, open_only=False):
        q = "SELECT COUNT(*) FROM visibility WHERE domain_id=?"
        if open_only:
            q += " AND is_open=1"
        with self.db.txn() as c:
            return c.execute(q, (domain_id,)).fetchone()[0]

    def delete_workflow_execution(self, domain_id, workflow_id, run_id):
        with self.db.txn() as c:
            c.execute(
                "DELETE FROM visibility WHERE domain_id=? AND workflow_id=? "
                "AND run_id=?",
                (domain_id, workflow_id, run_id),
            )


class SqliteBundle(I.PersistenceBundle):
    def __init__(self, path: str = ":memory:", auto_setup: bool = True) -> None:
        from ...checkpoint.store import SqliteCheckpointStore

        self._db = _Db(path, auto_setup=auto_setup)
        super().__init__(
            shard=SqliteShardManager(self._db),
            execution=SqliteExecutionManager(self._db),
            history=SqliteHistoryManager(self._db),
            task=SqliteTaskManager(self._db),
            metadata=SqliteMetadataManager(self._db),
            visibility=SqliteVisibilityManager(self._db),
            checkpoint=SqliteCheckpointStore(self._db),
        )

    def close(self) -> None:
        self._db.conn.close()


def create_sqlite_bundle(
    path: str = ":memory:", auto_setup: bool = True
) -> I.PersistenceBundle:
    return SqliteBundle(path, auto_setup=auto_setup)
