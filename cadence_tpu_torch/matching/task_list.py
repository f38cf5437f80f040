"""TaskListManager: per-task-list daemon — lease, backlog pump, GC.

Reference: Cadence service/matching/taskListManager.go:120-565
(lease + taskID block allocation), taskReader.go (backlog pump),
taskWriter.go (batched appends with block fencing), ackManager.go,
taskGC.go. One manager owns one (domain, name, task_type) queue:
producers sync-match through the TaskMatcher when a poller is waiting,
otherwise the task is persisted and later dispatched by the reader pump.

A copy of the reference package's ``matching/task_list.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..runtime.persistence.errors import ConditionFailedError
from ..runtime.queues.ack import QueueAckManager
from ..runtime.persistence.interfaces import TaskManager
from ..runtime.persistence.records import TaskInfo, TaskListInfo
from ..utils.clock import RealTimeSource, TimeSource
from ..utils.locks import make_guarded, make_lock
from ..utils.log import get_logger

# taskID block leased per rangeID bump (reference rangeSize=100k)
RANGE_SIZE = 100_000

TASK_TYPE_DECISION = 0
TASK_TYPE_ACTIVITY = 1


class TaskListID:
    """(domain_id, name, task_type) triple, partition-aware.

    Scalable task lists name partitions ``/__cadence_sys/{base}/{n}``
    (reference taskListID parsing, forwarder.go).
    """

    PARTITION_PREFIX = "/__cadence_sys/"

    def __init__(self, domain_id: str, name: str, task_type: int) -> None:
        self.domain_id = domain_id
        self.name = name
        self.task_type = task_type

    @property
    def is_partition(self) -> bool:
        return self.name.startswith(self.PARTITION_PREFIX)

    @property
    def base_name(self) -> str:
        if not self.is_partition:
            return self.name
        rest = self.name[len(self.PARTITION_PREFIX):]
        base, _, _ = rest.rpartition("/")
        return base

    @property
    def partition(self) -> int:
        if not self.is_partition:
            return 0
        _, _, n = self.name.rpartition("/")
        try:
            return int(n)
        except ValueError:
            return 0

    @classmethod
    def partition_name(cls, base: str, n: int) -> str:
        return base if n == 0 else f"{cls.PARTITION_PREFIX}{base}/{n}"

    def key(self) -> Tuple[str, str, int]:
        return (self.domain_id, self.name, self.task_type)

    def __repr__(self) -> str:
        return f"TaskListID({self.domain_id!r}, {self.name!r}, {self.task_type})"


class InternalTask:
    """A dispatched task: persisted backlog entry or ephemeral sync match."""

    __slots__ = ("info", "_finish", "finished", "sync", "started_response", "query")

    def __init__(
        self, info: TaskInfo, finish: Optional[Callable[[Optional[Exception]], None]],
        sync: bool = False,
    ) -> None:
        self.info = info
        self._finish = finish
        self.finished = False
        self.sync = sync
        self.started_response = None
        self.query = None  # sync query task payload (matcher.OfferQuery)

    def finish(self, error: Optional[Exception] = None) -> None:
        if self.finished:
            return
        self.finished = True
        if self._finish is not None:
            self._finish(error)


class _AppendRequest:
    """One producer's pending write, parked on the writer thread."""

    __slots__ = ("info", "done", "error")

    def __init__(self, info: TaskInfo) -> None:
        self.info = info
        self.done = threading.Event()
        self.error: Optional[Exception] = None


class TaskWriter:
    """Batched backlog appends (reference taskWriter.go:appendTasks).

    Producers park on a request queue; one writer thread drains up to
    ``MAX_BATCH`` requests, allocates their task ids inside the leased
    block, and persists them with ONE create_tasks call — under a task
    storm the store sees O(storm/batch) writes instead of O(storm),
    and the rangeID fencing condition is checked once per batch.
    """

    MAX_BATCH = 100

    def __init__(self, mgr: "TaskListManager") -> None:
        self._mgr = mgr
        self._lock = make_lock("TaskWriter._lock")
        self._queue: List[_AppendRequest] = make_guarded(
            [], "TaskWriter._queue", self._lock
        )
        self._signal = threading.Event()
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._write_pump,
            name=f"taskWriter-{mgr.id.name}",
            daemon=True,
        )
        self._thread.start()

    def append(self, info: TaskInfo, timeout_s: float = 30.0) -> None:
        """Park until the batch containing ``info`` is persisted."""
        req = _AppendRequest(info)
        with self._lock:
            if self._stopped.is_set():
                raise RuntimeError("task writer stopped")
            self._queue.append(req)
        self._signal.set()
        req.done.wait(timeout=timeout_s)
        if not req.done.is_set():
            # withdraw before raising: leaving the request queued means
            # it may persist AFTER the caller retries, guaranteeing a
            # duplicate backlog task on slow-store stalls.
            with self._lock:
                try:
                    self._queue.remove(req)
                    withdrawn = True
                except ValueError:
                    withdrawn = False  # already drained into a batch
            if withdrawn:
                raise TimeoutError("task append timed out")
            # in-flight persist: it will resolve; give it a short grace
            req.done.wait(timeout=5.0)
            if not req.done.is_set():
                raise TimeoutError(
                    "task append timed out (write in flight; the task "
                    "may still persist)"
                )
        if req.error is not None:
            raise req.error

    def _write_pump(self) -> None:
        mgr = self._mgr
        while True:
            self._signal.wait(timeout=0.1)
            self._signal.clear()
            if self._stopped.is_set():
                # emptiness must be read under the lock: append() also
                # checks _stopped under it, so either the request is
                # already queued here (drained below) or its producer
                # saw _stopped and raised — an append can no longer
                # slip between an off-lock check and the pump's exit
                # (found by the sanitizer's GUARDED-FIELD-RACE)
                with self._lock:
                    empty = not self._queue
                if empty:
                    return
            while True:
                with self._lock:
                    batch = self._queue[: self.MAX_BATCH]
                    del self._queue[: len(batch)]
                if not batch:
                    break
                try:
                    self._persist(batch)
                except Exception as e:  # surface to every parked producer
                    for req in batch:
                        req.error = e
                finally:
                    for req in batch:
                        req.done.set()
                mgr._backlog_signal.set()

    def _persist(self, batch: List[_AppendRequest]) -> None:
        mgr = self._mgr
        now = mgr._time.now()
        with mgr._write_lock:
            for req in batch:
                info = req.info
                info.task_id = mgr._allocate_task_id()
                mgr._last_written_id = info.task_id
                if info.created_time == 0:
                    info.created_time = now
                if (
                    info.schedule_to_start_timeout_seconds > 0
                    and info.expiry_time == 0
                ):
                    info.expiry_time = info.created_time + int(
                        info.schedule_to_start_timeout_seconds * 1e9
                    )
            infos = [r.info for r in batch]
            try:
                mgr._store.create_tasks(mgr._info, infos)
            except ConditionFailedError:
                # lost the lease (another owner); re-lease, re-id, retry
                # once — the whole batch moves to the new block
                mgr._release()
                for req in batch:
                    req.info.task_id = mgr._allocate_task_id()
                    mgr._last_written_id = req.info.task_id
                mgr._store.create_tasks(mgr._info, infos)

    def stop(self) -> None:
        self._stopped.set()
        self._signal.set()
        self._thread.join(timeout=5.0)
        with self._lock:
            drained = self._queue[:]
            self._queue.clear()
        for req in drained:
            req.error = RuntimeError("task writer stopped")
            req.done.set()


class TaskGC:
    """Throttled backlog GC (reference taskGC.go).

    Completed tasks are only acked in memory; the store rows below the
    ack level are range-deleted when enough completions accumulate or
    the GC interval elapses — not on every completion, which would turn
    each task into an extra store round-trip.
    """

    THRESHOLD = 100
    INTERVAL_S = 1.0

    def __init__(self, mgr: "TaskListManager") -> None:
        self._mgr = mgr
        self._since_gc = 0
        self._last_gc = mgr._time.now()
        self._last_deleted_level = mgr._ack.ack_level

    def run_now(self, ack_level: int) -> None:
        mgr = self._mgr
        if ack_level > self._last_deleted_level:
            # ack_level itself is completed; the store deletes < level
            mgr._store.complete_tasks_less_than(
                mgr.id.domain_id, mgr.id.name, mgr.id.task_type,
                ack_level + 1,
            )
            self._last_deleted_level = ack_level
        # _write_lock: the writer thread swaps mgr._info on block
        # rollover; persisting a stale range_id would self-fence
        with mgr._write_lock:
            mgr._info.ack_level = ack_level
            try:
                mgr._store.update_task_list(mgr._info)
            except ConditionFailedError:
                pass  # lease moved; new owner persists its own ack level
        self._since_gc = 0
        self._last_gc = mgr._time.now()

    def maybe_run(self, ack_level: int) -> None:
        self._since_gc += 1
        due = (
            self._since_gc >= self.THRESHOLD
            or self._mgr._time.now() - self._last_gc
            >= self.INTERVAL_S * 1e9
        )
        if due:
            self.run_now(ack_level)


class TaskListManager:
    def __init__(
        self,
        task_list_id: TaskListID,
        task_manager: TaskManager,
        matcher,
        time_source: Optional[TimeSource] = None,
        idle_tasklist_ttl_s: float = 300.0,
        max_sync_match_wait_s: float = 0.2,
    ) -> None:
        self.id = task_list_id
        self._store = task_manager
        self.matcher = matcher
        self._time = time_source or RealTimeSource()
        self._log = get_logger(
            "cadence_tpu_torch.matching.tasklist", task_list=task_list_id.name
        )
        self._write_lock = make_lock("TaskListManager._write_lock")
        self._info = self._lease()
        # leased block: (rangeID-1)*RANGE_SIZE+1 .. rangeID*RANGE_SIZE
        self._next_task_id = (self._info.range_id - 1) * RANGE_SIZE + 1
        self._max_task_id = self._info.range_id * RANGE_SIZE
        self._ack = QueueAckManager(self._info.ack_level)
        # highest task id persisted by THIS manager's writer; read_level
        # lags it while the reader pump is behind (backlog signal). A
        # restart starts at 0: pre-existing rows surface via read_level
        # within one pump interval
        self._last_written_id = 0
        self._backlog_signal = threading.Event()
        self._stopped = threading.Event()
        self._last_activity = self._time.now()
        self._max_sync_wait = max_sync_match_wait_s
        self.idle_ttl_s = idle_tasklist_ttl_s
        self._writer = TaskWriter(self)
        self._gc = TaskGC(self)
        self._reader = threading.Thread(
            target=self._read_pump, name=f"taskReader-{task_list_id.name}",
            daemon=True,
        )
        self._reader.start()

    # -- lease / block allocation (taskWriter block fencing) ------------

    def _lease(self) -> TaskListInfo:
        return self._store.lease_task_list(
            self.id.domain_id, self.id.name, self.id.task_type
        )

    def _release(self) -> None:
        # caller holds _write_lock: take a fresh lease + taskID block
        self._info = self._lease()
        self._next_task_id = (self._info.range_id - 1) * RANGE_SIZE + 1
        self._max_task_id = self._info.range_id * RANGE_SIZE

    def _allocate_task_id(self) -> int:
        # caller holds _write_lock
        if self._next_task_id > self._max_task_id:
            self._release()
        tid = self._next_task_id
        self._next_task_id += 1
        return tid

    # -- producer -------------------------------------------------------

    def add_task(self, info: TaskInfo) -> bool:
        """Sync-match if a poller waits and no backlog; else persist via
        the batched writer.

        Returns True when the task was sync-matched (never persisted).
        Reference taskListManager.AddTask: backlog present ⇒ skip sync
        match to preserve dispatch order.
        """
        self._touch()
        if not self._has_backlog():
            task = InternalTask(info, finish=None, sync=True)
            if self.matcher.offer(task, timeout=self._max_sync_wait):
                return True
        self._writer.append(info)
        return False

    # -- consumer -------------------------------------------------------

    def get_task(self, timeout: float) -> Optional[InternalTask]:
        self._touch()
        return self.matcher.poll(timeout)

    # -- backlog pump (taskReader) --------------------------------------

    def _has_backlog(self) -> bool:
        # three signals: read-but-unfinished span, in-flight tasks, and
        # PERSISTED-but-unread writes (the writer may be ahead of the
        # reader pump — sync-matching a fresh task past them would
        # break FIFO dispatch)
        return (
            self._ack.read_level > self._ack.ack_level
            or bool(self._outstanding_count())
            or self._last_written_id > self._ack.read_level
        )

    def _outstanding_count(self) -> int:
        return self._ack.outstanding()

    def _read_pump(self) -> None:
        while not self._stopped.is_set():
            self._backlog_signal.wait(timeout=0.1)
            self._backlog_signal.clear()
            if self._stopped.is_set():
                return
            while True:
                batch = self._store.get_tasks(
                    self.id.domain_id, self.id.name, self.id.task_type,
                    read_level=self._ack.read_level,
                    max_read_level=self._max_task_id,
                    batch_size=64,
                )
                if not batch:
                    break
                now = self._time.now()
                for info in batch:
                    self._ack.add(info.task_id)
                    if info.expiry_time and info.expiry_time < now:
                        self._complete(info.task_id)  # expired: ack + GC
                        continue
                    task = InternalTask(
                        info,
                        finish=lambda err, tid=info.task_id: self._on_finish(
                            tid, err
                        ),
                    )
                    if not self.matcher.must_offer(task):
                        return  # shutdown

    def _on_finish(self, task_id: int, error: Optional[Exception]) -> None:
        # both success and a stale-task error ack the task; a transient
        # error would re-deliver in the reference, we ack-and-log
        if error is not None:
            self._log.info(f"task {task_id} finished with error: {error}")
        self._complete(task_id)

    def _complete(self, task_id: int) -> None:
        # in-memory ack only; the throttled TaskGC range-deletes the
        # store rows + persists the ack level (reference taskGC.go)
        self._ack.complete(task_id)
        ack = self._ack.update_ack_level()
        try:
            self._gc.maybe_run(ack)
        except Exception:
            # GC is best-effort cleanup on the task-FINISH path, which
            # runs AFTER record_*_task_started succeeded — letting a
            # transient store error unwind here would destroy the poll
            # response for an already-started task (the worker never
            # sees it; the workflow stalls to its task timeout). Rows
            # stay until the next due GC pass.
            self._log.exception("task GC failed; deferring cleanup")

    # -- lifecycle ------------------------------------------------------

    def _touch(self) -> None:
        self._last_activity = self._time.now()

    def idle_since_s(self) -> float:
        return (self._time.now() - self._last_activity) / 1e9

    def describe(self) -> dict:
        return {
            "task_list": self.id.name,
            "task_type": self.id.task_type,
            "range_id": self._info.range_id,
            "ack_level": self._ack.ack_level,
            "read_level": self._ack.read_level,
            "backlog_hint": self._outstanding_count(),
        }

    def stop(self) -> None:
        self._stopped.set()
        self._backlog_signal.set()
        self._writer.stop()
        self.matcher.shutdown()
        # final GC pass so a clean shutdown leaves no acked rows behind;
        # best-effort — stop() runs under the engine lock during idle
        # unload, and a store error must not abort that sweep
        try:
            self._gc.run_now(self._ack.update_ack_level())
        except Exception:
            self._log.exception("final task GC failed on stop")
