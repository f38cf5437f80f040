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

A copy of the reference package's ``runtime/queues/ack.py``. Deviation:
the deferred entries of one manager share one timer thread, which turns
every entry whose delay has elapsed into RETRY at once and rewinds the
read level once for them all (the reference starts a ``threading.Timer``
per deferral and rewinds once per entry, so a standby plane holding H
tasks re-reads its held span H times per standby delay). An entry turns
RETRY at most ``DEFER_COALESCE_S`` after its delay. A pump that calls
``keep_deferred_tasks`` hands its deferred tasks in with ``defer`` and
takes them back with ``take_retries``, instead of re-reading its whole
held span from the ack level each time one of them is due.

A fault of the reference fixed here: its ``rewind`` returns when the
level is not below the ack level. A task above the level that was read
and completed before the failover (skipped as the standby's) stays DONE,
the sweep then passes it, and it never runs on the new active side: a
worker still running a task at or below the level holds the ack level
there, so both the failover listener's rewind and the standby plane's
handover rewind were no-ops and the live workflow's decision was lost.
``rewind`` now re-reads everything read above the level whatever the ack
level is, and moves the ack level only when the level is below it.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, Optional

from ...utils.locks import make_guarded, make_lock

_RUNNING = 0
_DONE = 1
_DEFERRED = 2
_RETRY = 3

# how late a deferred entry may turn RETRY, so that entries deferred
# close together are released (and re-read) together
DEFER_COALESCE_S = 0.05


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
        # deferred entries by deadline: (monotonic deadline, seq, key) in
        # a heap, the live seq of each key in _parked (a re-deferral
        # leaves its older heap entry stale); one wheel thread releases
        # them while any are parked
        self._deadlines: list = []
        self._parked: Dict[object, int] = {}
        self._seq = itertools.count()
        self._wheel_cv = threading.Condition(self._lock)
        self._wheel: Optional[threading.Thread] = None
        # keep_deferred_tasks: key -> task of each parked entry, the
        # RETRY keys not yet taken back, and the pump's wake-up
        self._held_tasks: Optional[Dict[object, object]] = None
        self._retry_ready: list = []
        self.on_retry: Optional[Callable[[], None]] = None
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
        # the generation each entry was last taken (RUNNING) under: an
        # executor wave collected before a rewind runs the entries the
        # rewind kept (``holds``) and skips the ones it dropped
        self._taken_gen: Dict[object, int] = {}

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
                self._taken_gen[key] = self._generation
                self._bump_read_locked(key)
                return True
            if state == _RETRY:
                self._outstanding[key] = _RUNNING
                self._taken_gen[key] = self._generation
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
                    self._taken_gen[key] = self._generation
                    self._bump_read_locked(key)
                    out.append(True)
                elif state == _RETRY:
                    self._outstanding[key] = _RUNNING
                    self._taken_gen[key] = self._generation
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
                self._taken_gen.pop(key, None)
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
        """Re-read everything read above ``level`` (failover
        reprocessing: the new active side re-reads from the standby
        cursor; verification-based handlers make re-execution
        idempotent). The ack level moves back only when ``level`` is
        below it, and is then persisted immediately (under the lock, so
        no concurrent checkpoint can overwrite it): a restart
        re-initializes from the shard cursor and the failover event
        will not re-fire. An ack level held at or below ``level`` by an
        entry still running does not make the rewind a no-op: the
        entries above ``level`` are dropped and re-read all the same."""
        with self._lock:
            above = [k for k in self._outstanding if k > level]
            behind = level < self.ack_level
            if not behind and not above and level >= self.read_level:
                return  # nothing was read past the level
            if behind:
                self.ack_level = level
            if level < self.read_level:
                self.read_level = level
            # completed-but-unswept entries above the rewound level must
            # not let update_ack_level jump straight back over the span
            # being re-verified
            for key in above:
                del self._outstanding[key]
                self._taken_gen.pop(key, None)
                if self._held_tasks is not None:
                    self._held_tasks.pop(key, None)
            # nor may a dropped entry's pending release hand a later
            # entry of the same key's task away (take_retries)
            if above:
                gone = set(above)
                self._retry_ready = [
                    k for k in self._retry_ready if k not in gone]
            self._recompute_retry_min_locked()
            # invalidate any in-flight read batch: its remaining offers
            # would re-bump the read cursor over the rewound span
            self._generation += 1
            if behind and self._update_shard_ack is not None:
                self._update_shard_ack(level)
                self._persisted_level = level
            hook = self.on_read_rewind
        if hook is not None:
            hook()

    def holds(self, key, generation: int) -> bool:
        """Whether ``key`` is still the entry taken under ``generation``:
        a rewind since then kept it (it lies at or below the rewound
        level), rather than dropping it or letting a re-read take it
        anew."""
        with self._lock:
            return (key in self._outstanding
                    and self._taken_gen.get(key) == generation)

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

    def keep_deferred_tasks(self, on_retry: Callable[[], None]) -> None:
        """Hold each deferred task beside its entry: when its delay
        elapses it waits in ``take_retries`` and ``on_retry`` wakes the
        pump, with no read rewind."""
        with self._lock:
            self._held_tasks = {}
            self.on_retry = on_retry

    def take_retries(self, generation: Optional[int] = None) -> list:
        """(key, task) of every held entry whose delay elapsed, each
        re-taken (RUNNING) as ``add()`` would re-take it; none when
        ``generation`` is given and a rewind has moved past it."""
        with self._lock:
            out = []
            if generation is not None and generation != self._generation:
                return out
            for key in self._retry_ready:
                if self._outstanding.get(key) != _RETRY:
                    continue  # re-taken by a read since: its task stays
                task = self._held_tasks.pop(key, None)
                if task is not None:
                    self._outstanding[key] = _RUNNING
                    self._taken_gen[key] = self._generation
                    out.append((key, task))
            self._retry_ready = []
            if out:
                self._recompute_retry_min_locked()
            return out

    def defer(self, key, delay_s: float, task=None) -> None:
        """Hold a read-but-unprocessable task (passive domain / standby
        verification pending). The entry stays outstanding — blocking
        the ack sweep, so queue GC cannot delete the row — and becomes
        re-takeable (RETRY) after ``delay_s``, when the read level also
        rewinds so the pump re-reads it (or, under
        ``keep_deferred_tasks``, ``take_retries`` hands ``task`` back)."""
        with self._lock:
            if self._outstanding.get(key) != _RUNNING:
                return
            self._outstanding[key] = _DEFERRED
            if self._held_tasks is not None and task is not None:
                self._held_tasks[key] = task
            seq = next(self._seq)
            self._parked[key] = seq
            heapq.heappush(
                self._deadlines, (time.monotonic() + delay_s, seq, key)
            )
            if self._wheel is None:
                self._wheel = threading.Thread(
                    target=self._release_deferred, name="ack-defer",
                    daemon=True,
                )
                self._wheel.start()
            else:
                self._wheel_cv.notify()

    def _release_deferred(self) -> None:
        """The wheel: sleep to the earliest deadline (plus the coalescing
        slack), turn every elapsed DEFERRED entry RETRY, rewind the read
        level once, tell the pump; exit when nothing is parked."""
        with self._lock:
            while self._parked:
                due = self._deadlines[0][0] + DEFER_COALESCE_S
                now = time.monotonic()
                if due > now:
                    self._wheel_cv.wait(due - now)
                    continue
                rewind = held = False
                while self._deadlines and self._deadlines[0][0] <= now:
                    _, seq, key = heapq.heappop(self._deadlines)
                    if self._parked.get(key) != seq:
                        continue  # re-deferred later: a stale deadline
                    del self._parked[key]
                    if self._outstanding.get(key) != _DEFERRED:
                        if self._held_tasks is not None:
                            self._held_tasks.pop(key, None)
                        continue
                    self._outstanding[key] = _RETRY
                    if self._retry_min is None or key < self._retry_min:
                        self._retry_min = key
                    if self._held_tasks is not None \
                            and key in self._held_tasks:
                        self._retry_ready.append(key)
                        held = True
                    else:
                        rewind = True
                hooks = []
                if rewind:
                    self.read_level = self.ack_level
                    hooks.append(self.on_read_rewind)
                if held:
                    hooks.append(self.on_retry)
                hooks = [h for h in hooks if h is not None]
                if hooks:
                    self._lock.release()
                    try:
                        for hook in hooks:
                            hook()
                    finally:
                        self._lock.acquire()
            self._deadlines.clear()
            self._wheel = None

    def abandon(self, key) -> None:
        """Un-register a task WITHOUT completing it. Unlike defer(),
        the entry is dropped entirely — only safe when the caller KNOWS
        the task will be re-read before the sweep passes it (legacy
        callers); prefer defer()."""
        with self._lock:
            self._taken_gen.pop(key, None)
            if self._outstanding.pop(key, None) == _RETRY:
                self._recompute_retry_min_locked()
            self.read_level = self.ack_level
            hook = self.on_read_rewind
        if hook is not None:
            hook()
