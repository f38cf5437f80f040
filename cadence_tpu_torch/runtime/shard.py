"""Shard context: per-shard sequencing, ack levels, range fencing.

Reference: service/history/shardContext.go — every history-shard write
carries the shard's range_id; task IDs are allocated monotonically from
range-scoped blocks so a stolen shard can never mint colliding or
regressing IDs (taskID = range_id << 24 | seq, renewing the lease when a
block exhausts, mirroring the reference's transferSequenceNumber block
scheme).

A copy of the reference package's ``runtime/shard.py``.
``task_write_lock`` is the port's: see its docstring.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..utils.clock import RealTimeSource, TimeSource
from ..utils.locks import make_guarded, make_rlock

from .persistence.errors import (
    EntityNotExistsError,
    ShardOwnershipLostError,
)
from .persistence.interfaces import PersistenceBundle
from .persistence.records import ShardInfo

BLOCK_BITS = 24
BLOCK_SIZE = 1 << BLOCK_BITS


class ShardContext:
    def __init__(
        self,
        shard_id: int,
        persistence: PersistenceBundle,
        owner: str = "",
        time_source: Optional[TimeSource] = None,
    ) -> None:
        self.shard_id = shard_id
        self.persistence = persistence
        self.owner = owner
        self.time_source = time_source or RealTimeSource()
        self._lock = make_rlock("ShardContext._lock")
        self._remote_cluster_time: dict = make_guarded(
            {}, "ShardContext._remote_cluster_time", self._lock
        )
        self._remote_time_listeners: list = make_guarded(
            [], "ShardContext._remote_time_listeners", self._lock
        )
        self._fenced = False
        self._info = self._acquire()
        self._next_task_seq = 0

    # -- lease --------------------------------------------------------

    def _acquire(self) -> ShardInfo:
        try:
            info = self.persistence.shard.get_shard(self.shard_id)
        except EntityNotExistsError:
            info = ShardInfo(shard_id=self.shard_id, range_id=0)
            self.persistence.shard.create_shard(info)
        info.owner = self.owner
        self._bump_range_with_retry(info)
        return info

    def _bump_range_with_retry(self, info: ShardInfo) -> None:
        """Bump ``info.range_id`` durably, surviving the torn-write
        reality: a bump whose ack was lost LANDED — re-reading the row
        and seeing our bump (same range, our owner) IS success, and a
        transient error simply retries. A bump by someone ELSE means
        the shard moved mid-acquire: re-bump from their lease so our
        writes still fence theirs (last-acquirer-wins, exactly the
        reference's steal semantics)."""
        last_exc = None
        for _ in range(4):
            prev = info.range_id
            info.range_id = prev + 1
            try:
                self.persistence.shard.update_shard(
                    info, previous_range_id=prev
                )
                return
            except Exception as e:
                last_exc = e
                try:
                    stored = self.persistence.shard.get_shard(self.shard_id)
                except Exception:
                    info.range_id = prev
                    continue
                if (
                    stored.range_id == info.range_id
                    and stored.owner == info.owner
                ):
                    return  # our torn write landed
                # someone else's lease (or a stale read): adopt and retry
                info.__dict__.update(stored.__dict__)
                info.owner = self.owner
        raise last_exc

    @property
    def range_id(self) -> int:
        """The current lease for stamping writes. Raises once the shard
        is fenced for a reshard handoff: the context bumped its OWN
        lease, so only an explicit refusal stops it from minting valid
        writes against a shard that is being moved (clients retry
        through the ring and land on the new owner after the flip)."""
        with self._lock:
            if self._fenced:
                raise ShardOwnershipLostError(
                    self.shard_id, f"shard {self.shard_id} fenced for reshard"
                )
            return self._info.range_id

    @property
    def fenced(self) -> bool:
        with self._lock:
            return self._fenced

    def fence(self) -> None:
        """Reshard handoff step (2): bump the lease (anything still
        holding the old range_id fences at the store — a stolen shard
        can never mint regressing task IDs) and refuse all further
        writes/task-ID mints from THIS context. Idempotent, and it
        survives torn lease writes (chaos on persistence.shard)."""
        with self._lock:
            if self._fenced:
                return
            self._bump_range_with_retry(self._info)
            self._next_task_seq = 0
            self._fenced = True

    def renew_range(self) -> None:
        """Bump the lease (new task-ID block; fences older owners)."""
        with self._lock:
            prev = self._info.range_id
            self._info.range_id += 1
            self.persistence.shard.update_shard(
                self._info, previous_range_id=prev
            )
            self._next_task_seq = 0

    # -- task id sequencing -------------------------------------------

    def next_task_id(self) -> int:
        with self._lock:
            if self._fenced:
                raise ShardOwnershipLostError(
                    self.shard_id, f"shard {self.shard_id} fenced for reshard"
                )
            if self._next_task_seq >= BLOCK_SIZE:
                self.renew_range()
            tid = (self._info.range_id << BLOCK_BITS) | self._next_task_seq
            self._next_task_seq += 1
            return tid

    def assign_task_ids(self, *task_lists) -> None:
        """Stamp task_id on every task in the given lists."""
        for tasks in task_lists:
            for t in tasks:
                t.task_id = self.next_task_id()

    @property
    def task_write_lock(self):
        """Held from a transaction's ``assign_task_ids`` through the store
        write that makes its tasks visible, so a shard's tasks become
        readable in task-id order. The queue pumps read past the highest
        id they see; a transaction that took lower ids but wrote later
        would leave its tasks below the read level, never processed.
        (Cadence holds the shard lock across the id allocation and the
        write, shardContext.UpdateWorkflowExecution; the reference
        package's copy releases it between the two.)"""
        return self._lock

    # -- ack levels ---------------------------------------------------

    def _update(self) -> None:
        """Persist ack-level/cursor state under the CURRENT lease.
        Same-range writes are idempotent (the condition still matches
        after a torn write lands), so transient store errors get a
        bounded retry; a genuine fence (newer range) surfaces."""
        last_exc = None
        for _ in range(3):
            try:
                self.persistence.shard.update_shard(
                    self._info, previous_range_id=self._info.range_id
                )
                return
            except ShardOwnershipLostError:
                raise
            except Exception as e:
                last_exc = e
        raise last_exc

    def get_transfer_ack_level(self) -> int:
        with self._lock:
            return self._info.transfer_ack_level

    def update_transfer_ack_level(self, level: int) -> None:
        with self._lock:
            self._info.transfer_ack_level = level
            self._update()

    def get_timer_ack_level(self) -> int:
        with self._lock:
            return self._info.timer_ack_level

    def update_timer_ack_level(self, level: int) -> None:
        with self._lock:
            self._info.timer_ack_level = level
            self._update()

    def ensure_cluster_ack_levels(self, cluster: str) -> None:
        """Checkpoint the standby cursors at standby-plane construction.
        Without a persisted per-cluster level the getters would fall
        back to the LIVE active ack level — which moves past standby-
        owned tasks, letting queue GC delete rows the standby never
        verified and making a failover rewind a no-op."""
        with self._lock:
            changed = False
            if cluster not in self._info.cluster_transfer_ack_level:
                self._info.cluster_transfer_ack_level[cluster] = (
                    self._info.transfer_ack_level
                )
                changed = True
            if cluster not in self._info.cluster_timer_ack_level:
                self._info.cluster_timer_ack_level[cluster] = (
                    self._info.timer_ack_level
                )
                changed = True
            if changed:
                self._update()

    def get_cluster_transfer_ack_level(self, cluster: str) -> int:
        """Per-remote-cluster standby cursor; falls back to the shard's
        own transfer ack level (ref shardContext.go clusterTransferAckLevel)."""
        with self._lock:
            return self._info.cluster_transfer_ack_level.get(
                cluster, self._info.transfer_ack_level
            )

    def update_cluster_transfer_ack_level(self, cluster: str, level: int) -> None:
        with self._lock:
            self._info.cluster_transfer_ack_level[cluster] = level
            self._update()

    def get_cluster_timer_ack_level(self, cluster: str) -> int:
        with self._lock:
            return self._info.cluster_timer_ack_level.get(
                cluster, self._info.timer_ack_level
            )

    def update_cluster_timer_ack_level(self, cluster: str, level: int) -> None:
        with self._lock:
            self._info.cluster_timer_ack_level[cluster] = level
            self._update()

    # -- remote cluster clocks (ref shardContext.go SetCurrentTime) ----

    def set_remote_cluster_current_time(self, cluster: str, now_ns: int) -> None:
        """Advance the view of a remote cluster's clock (fed by its
        replication stream); standby timer processing fires against this
        clock, never the local one."""
        with self._lock:
            cur = self._remote_cluster_time.get(cluster, 0)
            if now_ns > cur:
                self._remote_cluster_time[cluster] = now_ns
            # snapshot under the lock; fire outside it (listener code
            # must not run under the shard lock)
            listeners = list(self._remote_time_listeners)
        for listener in listeners:
            listener(cluster, now_ns)

    def get_remote_cluster_current_time(self, cluster: str) -> int:
        with self._lock:
            return self._remote_cluster_time.get(cluster, 0)

    def add_remote_time_listener(self, fn) -> None:
        # under the lock: registration races with the replication
        # pump's snapshot in set_remote_cluster_current_time (the
        # sanitizer's GUARDED-FIELD-RACE caught the bare append)
        with self._lock:
            self._remote_time_listeners.append(fn)

    def remove_remote_time_listener(self, fn) -> None:
        """Detach a listener (standby processor stop): a dead processor
        must not stay reachable from the shard's listener list."""
        with self._lock:
            try:
                self._remote_time_listeners.remove(fn)
            except ValueError:
                pass

    def get_replication_ack_level(self) -> int:
        with self._lock:
            return self._info.replication_ack_level

    def update_replication_ack_level(self, level: int) -> None:
        with self._lock:
            self._info.replication_ack_level = level
            self._update()

    # -- time ---------------------------------------------------------

    def now(self) -> int:
        return self.time_source.now()
