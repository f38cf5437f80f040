"""Ordered ack levels over out-of-order task completion.

Reference: Cadence service/history/queueAckMgr.go — tasks are
read in order, complete in any order; the ack level advances over the
longest finished prefix and is checkpointed into shardInfo.

Entry states: RUNNING (handed to a worker), DONE (swept by
update_ack_level), DEFERRED (held: the handler raised DeferTask and the
task must be re-read later), RETRY (the defer delay elapsed; the next
pump read may re-take it). A DEFERRED/RETRY entry keeps blocking the
ack sweep — the cursor must never pass a task that was read but not
processed, or queue GC would delete it unexecuted.

A copy of the reference package's ``runtime/queues/ack.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ...utils.locks import make_guarded, make_lock

_RUNNING = 0
_DONE = 1
_DEFERRED = 2
_RETRY = 3


class QueueAckManager:
    def __init__(
        self,
        ack_level,
        update_shard_ack: Optional[Callable[[object], None]] = None,
    ) -> None:
        self._lock = make_lock("QueueAckManager._lock")
        self.ack_level = ack_level  # int task_id or (ts, task_id) for timers
        self.read_level = ack_level
        self._outstanding: Dict[object, int] = make_guarded(
            {}, "QueueAckManager._outstanding", self._lock
        )  # key → state
        self._update_shard_ack = update_shard_ack
        # last level KNOWN to have persisted: a transient checkpoint
        # failure leaves this behind ack_level, and the next sweep
        # retries the checkpoint even if the level didn't move again
        # (otherwise a failed final sweep would lag forever and a
        # restart re-processes the whole span)
        self._persisted_level = ack_level
        # cached min RETRY key (None = no retries): _bump_read_locked
        # consults it on every add(), so it must not rescan the dict
        self._retry_min = None
        # pumps that keep their own read cursor (the timer pumps'
        # _resume_key) register here; called whenever the read level is
        # FORCED backwards (rewind / a defer retry firing) so the
        # cursor can't skip the span the ack wants re-read
        self.on_read_rewind: Optional[Callable[[], None]] = None
        # bumped on every rewind: offers stamped with an older
        # generation belong to a batch read BEFORE the rewind and must
        # not land — their add()/set_read_level would re-bump the read
        # cursor past the rewound span, and the ack sweep would then
        # jump the hole without the span ever re-processing (the
        # failover drill caught exactly this: a handover rewind racing
        # an in-flight read batch lost the handed-over decision task)
        self._generation = 0

    def generation(self) -> int:
        """Stamp for a read batch: capture BEFORE reading, pass to
        add()/set_read_level() — a rewind between read and offer then
        rejects the stale batch instead of skipping the rewound span."""
        with self._lock:
            return self._generation

    def add(self, key, generation: Optional[int] = None) -> bool:
        """Register a read task; False if already outstanding (dup read)
        or already acked (a completed frontier row re-read because queue
        GC deletes exclusively below the ack level). A RETRY entry (its
        defer delay elapsed) is re-taken. ``generation`` (from
        ``generation()`` at read time) rejects offers from a batch read
        before a rewind."""
        with self._lock:
            if generation is not None and generation != self._generation:
                return False
            if key <= self.ack_level:
                return False
            state = self._outstanding.get(key)
            if state is None:
                self._outstanding[key] = _RUNNING
                self._bump_read_locked(key)
                return True
            if state == _RETRY:
                self._outstanding[key] = _RUNNING
                if key == self._retry_min:
                    self._recompute_retry_min_locked()
                return True
            return False

    def add_batch(self, keys, generation: Optional[int] = None):
        """Batched ``add()``: one lock acquisition for a whole read
        batch (the parallel executor's collect path — a 64-task wave
        would otherwise take this lock 64 times per cycle). Per-key
        semantics are identical to ``add()``; returns the taken flags
        in key order. A stale ``generation`` rejects the batch whole."""
        out = []
        with self._lock:
            if generation is not None and generation != self._generation:
                return [False] * len(keys)
            for key in keys:
                if key <= self.ack_level:
                    out.append(False)
                    continue
                state = self._outstanding.get(key)
                if state is None:
                    self._outstanding[key] = _RUNNING
                    self._bump_read_locked(key)
                    out.append(True)
                elif state == _RETRY:
                    self._outstanding[key] = _RUNNING
                    if key == self._retry_min:
                        self._recompute_retry_min_locked()
                    out.append(True)
                else:
                    out.append(False)
        return out

    def _recompute_retry_min_locked(self) -> None:
        self._retry_min = min(
            (k for k, s in self._outstanding.items() if s == _RETRY),
            default=None,
        )

    def _bump_read_locked(self, level) -> None:
        """Advance the read level, but never past a fired retry: its
        ready() rewind happens ONCE, so skipping over it would strand
        the task (read but never re-read) and wedge the ack sweep."""
        if self._retry_min is not None and level >= self._retry_min:
            return
        if level > self.read_level:
            self.read_level = level

    def complete(self, key) -> None:
        with self._lock:
            if key in self._outstanding:
                self._outstanding[key] = _DONE

    def update_ack_level(self):
        """Advance over the finished prefix; checkpoint to the shard
        when the level moved OR a previous checkpoint failed (persisted
        level lagging). The checkpoint happens under the lock so a
        concurrent rewind() cannot be overwritten by a stale higher
        level; a checkpoint error propagates (the pump logs it) with
        the persisted marker unchanged, so the next sweep retries."""
        with self._lock:
            for key in sorted(self._outstanding):
                if self._outstanding[key] != _DONE:
                    break
                del self._outstanding[key]
                self.ack_level = key
            level = self.ack_level
            if (
                level != self._persisted_level
                and self._update_shard_ack is not None
            ):
                self._update_shard_ack(level)
                self._persisted_level = level
        return level

    def rewind(self, level) -> None:
        """Move the cursor back to ``level`` (failover reprocessing: the
        new active side re-reads from the standby cursor; verification-
        based handlers make re-execution idempotent). Persisted
        immediately (under the lock, so no concurrent checkpoint can
        overwrite it): a restart re-initializes from the shard cursor
        and the failover event will not re-fire."""
        with self._lock:
            if level >= self.ack_level:
                return
            self.ack_level = level
            if level < self.read_level:
                self.read_level = level
            # completed-but-unswept entries above the rewound level must
            # not let update_ack_level jump straight back over the span
            # being re-verified
            for key in [k for k in self._outstanding if k > level]:
                del self._outstanding[key]
            self._recompute_retry_min_locked()
            # invalidate any in-flight read batch: its remaining offers
            # would re-bump the read cursor over the rewound span
            self._generation += 1
            if self._update_shard_ack is not None:
                self._update_shard_ack(level)
                self._persisted_level = level
            hook = self.on_read_rewind
        if hook is not None:
            hook()

    def set_read_level(self, level, generation: Optional[int] = None) -> None:
        with self._lock:
            if generation is not None and generation != self._generation:
                return  # batch read before a rewind: cursor stays put
            self._bump_read_locked(level)

    def outstanding(self) -> int:
        """In-flight work items. Parked entries (DEFERRED/RETRY) are not
        counted — they still block the ack sweep, but drain()/quiesce
        checks must not wait on tasks that are parked indefinitely."""
        with self._lock:
            return sum(
                1 for s in self._outstanding.values()
                if s in (_RUNNING, _DONE)
            )

    def held(self) -> int:
        """Parked (DEFERRED/RETRY) entries — the standby hold depth: a
        passive-domain span awaiting replication/failover wedges the ack
        sweep exactly this deep (the task_held gauge's source)."""
        with self._lock:
            return sum(
                1 for s in self._outstanding.values()
                if s not in (_RUNNING, _DONE)
            )

    def defer(self, key, delay_s: float) -> None:
        """Hold a read-but-unprocessable task (passive domain / standby
        verification pending). The entry stays outstanding — blocking
        the ack sweep, so queue GC cannot delete the row — and becomes
        re-takeable (RETRY) after ``delay_s``, when the read level also
        rewinds so the pump re-reads it."""
        with self._lock:
            if self._outstanding.get(key) != _RUNNING:
                return
            self._outstanding[key] = _DEFERRED

        def ready() -> None:
            with self._lock:
                if self._outstanding.get(key) != _DEFERRED:
                    return
                self._outstanding[key] = _RETRY
                self.read_level = self.ack_level
                if self._retry_min is None or key < self._retry_min:
                    self._retry_min = key
                hook = self.on_read_rewind
            if hook is not None:
                hook()

        t = threading.Timer(delay_s, ready)
        t.daemon = True
        t.start()

    def abandon(self, key) -> None:
        """Un-register a task WITHOUT completing it. Unlike defer(),
        the entry is dropped entirely — only safe when the caller KNOWS
        the task will be re-read before the sweep passes it (legacy
        callers); prefer defer()."""
        with self._lock:
            if self._outstanding.pop(key, None) == _RETRY:
                self._recompute_retry_min_locked()
            self.read_level = self.ack_level
            hook = self.on_read_rewind
        if hook is not None:
            hook()
