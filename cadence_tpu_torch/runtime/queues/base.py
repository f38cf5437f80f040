"""Queue processor pump: batched reads → worker pool → ordered acks.

Reference: Cadence service/history/queueProcessor.go:160-257
(processBatch + pump), taskProcessor.go:119-313 (worker pool with
per-task retry). The pump wakes on notify or poll interval, reads a
batch past the read level, hands tasks to the pool, and periodically
checkpoints the ack level into shardInfo.

A copy of the reference package's ``runtime/queues/base.py``. Fault
injection (``make_fault_hook``) and the shared parallel executor's mode
wait for their planes.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import contextlib
import time as _time

from ...runtime.api import EntityNotExistsServiceError
from ...utils.locks import make_lock
from ...utils.log import get_logger
from ...utils.metrics import NOOP, Scope
from ...utils.tracing import NOOP_SPAN, TRACER

from .ack import QueueAckManager
from .allocator import DeferTask, defer_task
from .effects import task_effect_scope

_TASK_RETRY_COUNT = 3


class ResumeCursor:
    """Paged-read resume cursor with a drop generation.

    A forced read rewind (failover handover, a defer retry firing)
    must WIN over a scan already in flight: ``drop()`` bumps the
    generation, and ``store_if_current`` refuses to save a cursor
    computed before the drop. All transitions are locked — the pump
    thread and ack-hook threads race on this state."""

    def __init__(self) -> None:
        self._lock = make_lock("ResumeCursor._lock")
        self._key = None
        self._gen = 0

    def begin(self):
        with self._lock:
            return self._key, self._gen

    def store_if_current(self, key, gen) -> None:
        with self._lock:
            if gen == self._gen:
                self._key = key

    def drop(self) -> None:
        with self._lock:
            self._gen += 1
            self._key = None


def read_due_timers(
    execution, shard_id: int, min_ts: int, max_ts: int, batch_size: int,
    resume_key, offer, max_pages: int = 16,
):
    """Page the due-timer window with an exclusive (ts, id) resume
    cursor, shared by the active and standby timer pumps.

    Calls ``offer(task, key)`` for every row read. Pages at most
    ``max_pages`` per call; returns the cursor for the NEXT call —
    ``None`` when the window was fully scanned (the next wake restarts
    from the ack level, which also re-reads any fired defer-retries),
    else the last page's key so a held span larger than one call's
    budget keeps advancing instead of re-reading the same rows forever.
    """
    after = resume_key
    for _ in range(max_pages):
        batch = execution.get_timer_tasks(
            shard_id, min_ts, max_ts, batch_size, after_key=after
        )
        for task in batch:
            offer(task, (task.visibility_timestamp, task.task_id))
        if len(batch) < batch_size:
            return None
        after = (batch[-1].visibility_timestamp, batch[-1].task_id)
    return after


_ATTEMPT_BACKOFF_S = (0.05, 0.2)  # between in-line attempts
_EXHAUSTED_RETRY_DELAY_S = 5.0    # park interval after the budget


def sweep_ack(ack, log, name: str) -> None:
    """One ack sweep that survives a transient checkpoint failure: the
    in-memory level advanced and the ack manager retries the lagging
    shardInfo persist on its next sweep — the pump thread must outlive
    the error (shared by all three pump implementations)."""
    try:
        ack.update_ack_level()
    except Exception:
        log.exception(f"queue {name} ack sweep failed")


def run_task_attempts(
    process, task, key, ack, stopped, log, scope, name,
    retry_count: int = _TASK_RETRY_COUNT,
    exhausted_retry_delay_s: Optional[float] = None,
) -> bool:
    """Shared queue-task attempt loop (active transfer/timer + standby
    twins — ONE copy, they had drifted). Returns True when the caller
    should run its completion step (success, or the task is permanently
    stale); False when the task was parked or the processor is
    stopping.

    Transient failures back off between attempts, and an EXHAUSTED
    budget parks the task for a deferred retry instead of acking it
    away — a sub-second dependency outage must not permanently drop a
    task (the reference never acks an errored task). A genuinely
    poisoned task retries at the defer cadence until an operator
    removes it (admin remove-task).

    ``exhausted_retry_delay_s`` shrinks the park interval to test-scale
    (None = the production default)."""
    if exhausted_retry_delay_s is None:
        exhausted_retry_delay_s = _EXHAUSTED_RETRY_DELAY_S
    last_exc = None
    for attempt in range(retry_count):
        if stopped.is_set():
            return False
        try:
            # attribute persistence calls to this task for the effect
            # witness (testing/effect_witness.py); zero-cost when no
            # recorder is installed
            with task_effect_scope(name, getattr(task, "task_type", "")):
                process(task)
            return True
        except DeferTask:
            defer_task(ack, key)
            return False
        except EntityNotExistsServiceError:
            return True  # stale task: workflow/decision moved on
        except Exception as e:
            last_exc = e
            scope.inc("task_errors")
            if attempt < retry_count - 1:
                stopped.wait(_ATTEMPT_BACKOFF_S[
                    min(attempt, len(_ATTEMPT_BACKOFF_S) - 1)
                ])
    # log.error, not log.exception: this runs OUTSIDE the except block
    # (sys.exc_info is clear), so the final error — the operator's clue
    # for a poisoned task — rides in the message instead
    log.error(
        f"queue {name} task {key} failed {retry_count} attempts "
        f"(last: {type(last_exc).__name__}: {last_exc}); "
        f"parked for retry in {exhausted_retry_delay_s}s"
    )
    defer_task(ack, key, exhausted_retry_delay_s)
    return False


@contextlib.contextmanager
def timed_task(metrics: Scope, task):
    """Standard queue-task triple, tagged by task type: requests counter
    on entry, latency timer on exit; the yielded scope takes the error
    counter (shared by the transfer/timer/standby pipelines)."""
    scope = metrics.tagged(task_type=str(getattr(task, "task_type", "?")))
    scope.inc("task_requests")
    t0 = _time.perf_counter()
    try:
        yield scope
    finally:
        scope.record("task_latency", _time.perf_counter() - t0)


def task_span(queue_name: str, task):
    """Join the workflow's trace for one queue-task execution.

    Queue tasks run on pump-pool threads, so thread-local propagation
    cannot reach them; the engine binds ``("wf", workflow_id) →
    TraceContext`` at persist time (utils/tracing.py) and this lookup
    reconnects the asynchronous hop — the span (and everything the task
    does in this thread: persistence calls, matching add-task, fault
    annotations) lands in the SAME trace the frontend request started.
    No binding (the overwhelmingly common unsampled case) costs one
    len() check and returns the shared no-op. Shared by the active and
    standby processor families plus replication apply."""
    ctx = TRACER.lookup(("wf", getattr(task, "workflow_id", None)))
    if ctx is None:
        return NOOP_SPAN
    return TRACER.span(
        f"queue.{queue_name}", service="history_queue", parent=ctx,
        task_type=str(getattr(task, "task_type", "?")),
        task_id=getattr(task, "task_id", ""),
    )


class QueueProcessorBase:
    def __init__(
        self,
        name: str,
        ack: QueueAckManager,
        read_batch: Callable[[object, int], List[object]],
        process_task: Callable[[object], None],
        complete_task: Callable[[object], None],
        task_key: Callable[[object], object],
        worker_count: int = 4,
        batch_size: int = 64,
        poll_interval_s: float = 0.05,
        metrics: Optional[Scope] = None,
        exhausted_retry_delay_s: Optional[float] = None,
    ) -> None:
        self.name = name
        self.ack = ack
        self._exhausted_retry_delay_s = exhausted_retry_delay_s
        self._read_batch = read_batch
        self._process_task = process_task
        self._complete_task = complete_task
        self._task_key = task_key
        self._batch_size = batch_size
        self._poll_interval = poll_interval_s
        self._log = get_logger(f"cadence_tpu_torch.queue.{name}")
        self._metrics = (metrics or NOOP).tagged(
            service="history_queue", queue=name
        )
        self._notify = threading.Event()
        self._stopped = threading.Event()
        # reshard fence: intake paused (no new batch reads) while
        # in-flight tasks run to completion — the drain-to-watermark
        # step of an ownership handoff
        self._paused = threading.Event()
        self._pool = ThreadPoolExecutor(
            max_workers=worker_count,
            thread_name_prefix=f"{name}-worker",
        )
        self._pump_thread = threading.Thread(
            target=self._pump, name=f"{name}-pump", daemon=True
        )

    def start(self) -> None:
        self._pump_thread.start()

    def notify(self) -> None:
        self._notify.set()

    def stop(self) -> None:
        self._stopped.set()
        self._notify.set()
        self._pool.shutdown(wait=False)

    def drain(self, timeout_s: float = 5.0, *,
              deadline: Optional[float] = None) -> bool:
        """Wait until no tasks are outstanding (for tests/shutdown).
        ``deadline`` (time.monotonic value) overrides ``timeout_s`` —
        the reshard coordinator passes one shared deadline across every
        pump it drains."""
        import time

        if deadline is None:
            deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.ack.outstanding() == 0 and (
                self._paused.is_set() or not self._notify.is_set()
            ):
                return True
            time.sleep(0.01)
        return False

    # -- reshard fence -------------------------------------------------

    def pause_intake(self) -> None:
        """Stop reading new batches; in-flight tasks run to completion."""
        self._paused.set()

    def resume_intake(self) -> None:
        self._paused.clear()
        self._notify.set()

    def fence_drain(self, deadline: float):
        """Reshard handoff step (2): pause intake, drain in-flight work,
        and return the recorded ack watermark — everything at/below it
        is durably complete; everything above it moves with the shard.
        Raises TimeoutError when the pump cannot quiesce by ``deadline``
        (the coordinator rolls the handoff back)."""
        self.pause_intake()
        if not self.drain(deadline=deadline):
            raise TimeoutError(
                f"queue {self.name} failed to drain for reshard handoff "
                f"({self.ack.outstanding()} in flight)"
            )
        sweep_ack(self.ack, self._log, self.name)
        return self.ack.ack_level

    # -- pump ----------------------------------------------------------

    def _pump(self) -> None:
        while not self._stopped.is_set():
            self._notify.wait(timeout=self._poll_interval)
            self._notify.clear()
            if self._stopped.is_set():
                return
            try:
                self._process_batch()
            except Exception:
                self._log.exception(f"queue {self.name} batch failed")
            sweep_ack(self.ack, self._log, self.name)
            # in-flight depth + parked depth (standby "hold depth": a
            # DeferTask-parked span wedging the ack sweep; reference
            # defs.go task-type queue gauges)
            self._metrics.gauge("task_outstanding", self.ack.outstanding())
            self._metrics.gauge("task_held", self.ack.held())

    def _process_batch(self) -> None:
        while not self._stopped.is_set():
            if self._paused.is_set():
                return
            # generation BEFORE the read: a rewind (failover handover,
            # reshard fence) landing between this read and the offers
            # below invalidates the whole batch — otherwise the stale
            # offers re-bump the read cursor over the rewound span and
            # the ack sweep jumps it without re-processing a single
            # task of the handed-over span
            gen = self.ack.generation()
            batch = self._read_batch(self.ack.read_level, self._batch_size)
            if not batch:
                return
            for task in batch:
                key = self._task_key(task)
                if not self.ack.add(key, generation=gen):
                    continue  # already outstanding (or batch rewound)
                self._pool.submit(self._run_task, task, key)
            # advance the read cursor past everything READ, including
            # keys add() rejected (parked/running/done): add() only
            # advances it for newly-taken keys, so a full batch of
            # already-outstanding tasks would otherwise re-read the
            # identical rows forever and never leave this loop (no ack
            # sweep, 100% CPU). Parked tasks are still re-read later —
            # their retry timers rewind the read level to the ack level.
            self.ack.set_read_level(self._task_key(batch[-1]), generation=gen)
            if len(batch) < self._batch_size:
                return

    def _run_task(self, task, key) -> None:
        with task_span(self.name, task), \
                timed_task(self._metrics, task) as scope:
            finished = run_task_attempts(
                self._process_task, task, key, self.ack, self._stopped,
                self._log, scope, self.name,
                exhausted_retry_delay_s=self._exhausted_retry_delay_s,
            )
        if not finished:
            return  # parked (deferred / exhausted-retry) or stopping
        try:
            self._complete_task(task)
        except Exception:
            self._log.exception(f"queue {self.name} complete({key}) failed")
        self.ack.complete(key)
