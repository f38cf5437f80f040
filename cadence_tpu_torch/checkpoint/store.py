"""Checkpoint store: the contract and its memory and sqlite backends.

A copy of the reference package's ``CheckpointStore`` and
``MemoryCheckpointStore``: records keyed by ``(branch_key, event_id)``
with a tree-scoped index, stored as the serde JSON blob so corruption and
torn writes behave as in a durable store. Reads are defensive: a record
that fails to decode is skipped, not raised, so a corrupted checkpoint
degrades that one resume to a full replay. ``SqliteCheckpointStore`` is
the durable backend over the sqlite bundle's connection (the
``replay_checkpoints`` table), as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..utils.locks import make_guarded, make_lock
from .record import ReplayCheckpoint


class CheckpointStore:
    """Durable replay-checkpoint storage."""

    def put_checkpoint(self, ckpt: ReplayCheckpoint) -> None:
        """Upsert by (branch_key, event_id)."""
        raise NotImplementedError

    def list_checkpoints(self, branch_key: str) -> List[ReplayCheckpoint]:
        """All checkpoints of one branch, newest (highest event_id)
        first."""
        raise NotImplementedError

    def list_tree_checkpoints(self, tree_id: str) -> List[ReplayCheckpoint]:
        """All checkpoints across a run's history tree, newest first —
        the cross-branch (fork-point resume) lookup surface."""
        raise NotImplementedError

    def delete_checkpoint(self, branch_key: str, event_id: int) -> None:
        raise NotImplementedError

    def prune_tree(self, tree_id: str, keep_last: int) -> int:
        """Drop all but the newest ``keep_last`` records of a tree;
        returns how many were deleted (the keep-last-K-per-run GC)."""
        raise NotImplementedError

    def newest_event_id(self, branch_key: str) -> int:
        """Highest stored event_id for a branch, or 0 — the write
        policy's hot-path probe (no blob decode). Default derives from
        ``list_checkpoints`` for stores without a cheaper index."""
        newest = next(iter(self.list_checkpoints(branch_key)), None)
        return newest.event_id if newest is not None else 0

    def count_checkpoints(self) -> int:
        raise NotImplementedError


def _decode_many(blobs) -> List[ReplayCheckpoint]:
    out: List[ReplayCheckpoint] = []
    for blob in blobs:
        try:
            out.append(ReplayCheckpoint.from_json(blob))
        except Exception:
            continue  # corrupted record: that resume degrades to a miss
    return out


class MemoryCheckpointStore(CheckpointStore):
    def __init__(self) -> None:
        self._lock = make_lock("MemoryCheckpointStore._lock")
        # (branch_key, event_id) -> json blob
        self._rows: Dict[Tuple[str, int], str] = make_guarded(
            {}, "MemoryCheckpointStore._rows", self._lock
        )
        # (branch_key, event_id) -> tree_id (index for tree scans/GC)
        self._tree: Dict[Tuple[str, int], str] = make_guarded(
            {}, "MemoryCheckpointStore._tree", self._lock
        )

    def put_checkpoint(self, ckpt: ReplayCheckpoint) -> None:
        blob = ckpt.to_json()
        with self._lock:
            key = (ckpt.branch_key, ckpt.event_id)
            self._rows[key] = blob
            self._tree[key] = ckpt.tree_id

    def list_checkpoints(self, branch_key: str) -> List[ReplayCheckpoint]:
        with self._lock:
            blobs = [
                self._rows[k]
                for k in sorted(
                    (k for k in self._rows if k[0] == branch_key),
                    key=lambda k: -k[1],
                )
            ]
        return _decode_many(blobs)

    def list_tree_checkpoints(self, tree_id: str) -> List[ReplayCheckpoint]:
        with self._lock:
            keys = sorted(
                (k for k, t in self._tree.items() if t == tree_id),
                key=lambda k: -k[1],
            )
            blobs = [self._rows[k] for k in keys]
        return _decode_many(blobs)

    def delete_checkpoint(self, branch_key: str, event_id: int) -> None:
        with self._lock:
            self._rows.pop((branch_key, event_id), None)
            self._tree.pop((branch_key, event_id), None)

    def prune_tree(self, tree_id: str, keep_last: int) -> int:
        with self._lock:
            keys = sorted(
                (k for k, t in self._tree.items() if t == tree_id),
                key=lambda k: -k[1],
            )
            drop = keys[max(keep_last, 0):]
            for k in drop:
                self._rows.pop(k, None)
                self._tree.pop(k, None)
            return len(drop)

    def newest_event_id(self, branch_key: str) -> int:
        with self._lock:
            return max(
                (k[1] for k in self._rows if k[0] == branch_key),
                default=0,
            )

    def count_checkpoints(self) -> int:
        with self._lock:
            return len(self._rows)

    # testing hook: corrupt a stored record in place
    def _corrupt(self, branch_key: str, event_id: int) -> None:
        with self._lock:
            key = (branch_key, event_id)
            if key in self._rows:
                self._rows[key] = "{corrupted" + self._rows[key][:32]


class SqliteCheckpointStore(CheckpointStore):
    """Sqlite backend over the bundle's shared connection (the
    ``replay_checkpoints`` table, schema v3). ``db`` is the sqlite
    bundle's ``_Db`` — duck-typed on its ``txn()`` context manager so
    this module never imports the backend package."""

    def __init__(self, db) -> None:
        self.db = db

    def put_checkpoint(self, ckpt: ReplayCheckpoint) -> None:
        blob = ckpt.to_json()
        with self.db.txn() as c:
            c.execute(
                "INSERT OR REPLACE INTO replay_checkpoints "
                "(branch_key, event_id, tree_id, fingerprint, created_at,"
                " blob) VALUES (?,?,?,?,?,?)",
                (ckpt.branch_key, ckpt.event_id, ckpt.tree_id,
                 ckpt.fingerprint, int(ckpt.created_at), blob),
            )

    def list_checkpoints(self, branch_key: str) -> List[ReplayCheckpoint]:
        with self.db.txn() as c:
            rows = c.execute(
                "SELECT blob FROM replay_checkpoints WHERE branch_key=? "
                "ORDER BY event_id DESC",
                (branch_key,),
            ).fetchall()
        return _decode_many(r[0] for r in rows)

    def list_tree_checkpoints(self, tree_id: str) -> List[ReplayCheckpoint]:
        with self.db.txn() as c:
            rows = c.execute(
                "SELECT blob FROM replay_checkpoints WHERE tree_id=? "
                "ORDER BY event_id DESC",
                (tree_id,),
            ).fetchall()
        return _decode_many(r[0] for r in rows)

    def delete_checkpoint(self, branch_key: str, event_id: int) -> None:
        with self.db.txn() as c:
            c.execute(
                "DELETE FROM replay_checkpoints WHERE branch_key=? "
                "AND event_id=?",
                (branch_key, event_id),
            )

    def prune_tree(self, tree_id: str, keep_last: int) -> int:
        with self.db.txn() as c:
            keys = c.execute(
                "SELECT branch_key, event_id FROM replay_checkpoints "
                "WHERE tree_id=? ORDER BY event_id DESC",
                (tree_id,),
            ).fetchall()
            drop = keys[max(keep_last, 0):]
            for bk, eid in drop:
                c.execute(
                    "DELETE FROM replay_checkpoints WHERE branch_key=? "
                    "AND event_id=?",
                    (bk, eid),
                )
            return len(drop)

    def newest_event_id(self, branch_key: str) -> int:
        with self.db.txn() as c:
            row = c.execute(
                "SELECT MAX(event_id) FROM replay_checkpoints "
                "WHERE branch_key=?",
                (branch_key,),
            ).fetchone()
        return int(row[0] or 0)

    def count_checkpoints(self) -> int:
        with self.db.txn() as c:
            return c.execute(
                "SELECT COUNT(*) FROM replay_checkpoints"
            ).fetchone()[0]
