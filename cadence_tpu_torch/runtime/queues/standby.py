"""Standby queue processors: verify-and-discharge for passive domains.

Reference: service/history/transferQueueStandbyProcessor.go and
timerQueueStandbyProcessor.go — each remote cluster gets a standby
variant of the transfer/timer pipelines with its own persisted ack
cursor. A standby processor never executes a task's active side effect
(no matching pushes, no timeout events); it *verifies* the task against
the replicated state:

  * the state shows replication already delivered the outcome (decision
    started, activity closed, timer fired, workflow closed) → the task
    is discharged and the standby cursor advances;
  * the outcome hasn't replicated yet → the task is held and re-read
    after a standby delay (``DeferTask``), converging when replication
    catches up (the rereplication path heals gaps);
  * side effects that DO belong on the standby side run here: visibility
    records (started/closed/upsert) and retention-driven deletion.

Timer standby fires against the REMOTE cluster's clock
(``RemoteTimerGate`` advanced by the replication stream's
``source_time_ns``), mirroring timerGate.go:164 — a standby cluster
whose local clock runs ahead must not judge a remote timer "due" before
the owning cluster would.

Failover: the processors are verification-based and idempotent, so the
active side takes over lost ground by rewinding its cursor to the
standby cursor (``QueueAckManager.rewind``) when a domain fails over to
this cluster — re-reading the span the active processor had skipped as
passive (ref transferQueueProcessor.go failover processor).

A copy of the reference package's ``runtime/queues/standby.py``. Both
standby variants take the shared parallel executor (``executor``); the
reference's transfer variant takes one and its timer variant does not,
and the reference's service hands it to neither. The timer variant in
executor mode reads its due window against the remote clock on the
executor's cycle, as its own pump would.
"""

from __future__ import annotations

import threading
from typing import Optional

from ...core.enums import TimerTaskType, TransferTaskType, WorkflowState
from ...core.ids import EMPTY_EVENT_ID
from ...core.tasks import TimerTask, TransferTask
from ...core.timer_sequence import TimerSequence
from ...runtime.api import EntityNotExistsServiceError
from ...runtime.persistence.records import VisibilityRecord
from ...utils.log import get_logger

from .ack import QueueAckManager
from .allocator import DeferTask, defer_task
from .base import (
    QueueProcessorBase,
    ResumeCursor,
    WaveGate,
    make_fault_hook,
    read_due_timers,
    run_task_attempts,
    sweep_ack,
    task_span,
    timed_task,
)
from .timer_gate import RemoteTimerGate


class QueueGC:
    """Range-deletes task rows below the MINIMUM ack level across the
    active processor and every standby cursor (ref
    transferQueueProcessor.go completeTransferLoop /
    timerQueueProcessor.go completeTimersLoop). Owns deletion whenever
    standby planes share the task stream — per-task deletes would starve
    the slower cursor."""

    def __init__(
        self,
        shard,
        transfer_active,
        timer_active,
        standby_clusters,
        interval_s: float = 0.1,
    ) -> None:
        self.shard = shard
        self.transfer_active = transfer_active
        self.timer_active = timer_active
        self.standby_clusters = list(standby_clusters)
        self._interval = interval_s
        self._stopped = threading.Event()
        # last collected levels: skip the range-delete round-trips when
        # no cursor moved since the previous tick
        self._last_transfer_min = 0
        self._last_timer_min = 0
        self._gclog = get_logger(
            "cadence_tpu_torch.queue.gc", shard=shard.shard_id
        )
        self._thread = threading.Thread(
            target=self._loop, name=f"queue-gc-{shard.shard_id}", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def notify(self) -> None:
        pass

    def stop(self) -> None:
        self._stopped.set()

    def drain(self, timeout_s: float = 5.0) -> bool:
        self.collect()
        return True

    def collect(self) -> None:
        transfer_min = min(
            [self.transfer_active.ack.ack_level]
            + [
                self.shard.get_cluster_transfer_ack_level(c)
                for c in self.standby_clusters
            ]
        )
        if transfer_min > self._last_transfer_min:
            self.shard.persistence.execution.range_complete_transfer_tasks(
                self.shard.shard_id, 0, transfer_min
            )
            self._last_transfer_min = transfer_min
        timer_min = min(
            [self.timer_active.ack.ack_level[0]]
            + [
                self.shard.get_cluster_timer_ack_level(c)
                for c in self.standby_clusters
            ]
        )
        if timer_min > self._last_timer_min:
            self.shard.persistence.execution.range_complete_timer_tasks(
                self.shard.shard_id, 0, timer_min
            )
            self._last_timer_min = timer_min

    def _loop(self) -> None:
        while not self._stopped.wait(self._interval):
            try:
                self.collect()
            except Exception:
                # with standby planes, GC is the ONLY row deletion; a
                # persistent failure means unbounded task-table growth
                self._gclog.exception("queue GC collect failed")


def _fv_increment(engine) -> int:
    """The topology's failover-version increment (0 when the engine
    carries no cluster metadata — the allocator then arms handovers
    from stood-by membership only)."""
    cm = getattr(engine, "cluster_metadata", None)
    return cm.failover_version_increment if cm is not None else 0


class _StandbyAllocator:
    """Owns a task iff its domain is ACTIVE in ``cluster`` (i.e. this
    cluster stands by for it)."""

    def __init__(self, domains, cluster: str,
                 local_cluster: str = "",
                 failover_version_increment: int = 0) -> None:
        self.domains = domains
        self.cluster = cluster
        self.local_cluster = local_cluster
        # cycle detection: fv >= increment means the domain has failed
        # over at least once (registration versions live in cycle 0) —
        # the arm condition for a plane that observes a flip-to-local
        # WITHOUT ever having stood by (its first read of the span can
        # race the flip; see classify)
        self._increment = failover_version_increment
        # domains this allocator has stood by for — a later flip to
        # locally-active means a failover whose held span must hand
        # over to the active processor
        self._stood_by: set = set()
        # newest failover version observed per domain: a worker that
        # read the record BEFORE a failover must not re-arm the claim
        # AFTER another worker consumed the handover (the stale re-add
        # would rewind the active cursor a second time)
        self._seen_version: dict = {}
        # failover version whose handover this plane already claimed:
        # the claim is once PER OBSERVED FAILOVER (keyed by version),
        # not per stood-by membership — a plane whose first read of a
        # task span lands AFTER the flip never stood by for it, yet the
        # active processor may have skipped that span as standby-owned
        # while the domain record still named the old owner. Without a
        # version-keyed claim that span is silently discharged by both
        # planes and its tasks are lost (the failover drill caught the
        # race: the handed-over decision task vanished and the
        # workflow never completed on the new active side).
        self._claimed_fv: dict = {}
        self._claim_lock = threading.Lock()

    def classify(self, domain_id: str) -> str:
        """'owned' (verify here) | 'handover' (domain just became
        locally active via a failover this plane has not handed over
        yet — give the span to the active plane, ONCE per failover
        observation) | 'other' (not ours)."""
        try:
            rec = self.domains.get_by_id(domain_id)
        except Exception:
            return "other"
        if not rec.is_global:
            return "other"
        active = rec.replication_config.active_cluster_name
        with self._claim_lock:
            fv = rec.failover_version
            if fv < self._seen_version.get(domain_id, -1):
                return "other"  # stale record from before a failover
            self._seen_version[domain_id] = fv
            if active == self.cluster:
                self._stood_by.add(domain_id)
                return "owned"
            if active == self.local_cluster:
                ever_failed_over = (
                    self._increment > 0 and fv >= self._increment
                )
                if (domain_id in self._stood_by or ever_failed_over) \
                        and self._claimed_fv.get(domain_id) != fv:
                    return "handover"
            return "other"

    def claim_handover(self, domain_id: str) -> bool:
        """Compare-and-consume: exactly ONE concurrent caller wins the
        handover for a domain's observed failover version (two pool
        workers can both classify 'handover' for the same failover).
        Without consumption, every future task of the now-local domain
        would rewind the active cursor forever."""
        with self._claim_lock:
            fv = self._seen_version.get(domain_id)
            armed = domain_id in self._stood_by or (
                self._increment > 0
                and fv is not None
                and fv >= self._increment
            )
            if not armed or fv is None \
                    or self._claimed_fv.get(domain_id) == fv:
                return False
            self._claimed_fv[domain_id] = fv
            self._stood_by.discard(domain_id)
            return True

    def rearm_handover(self, domain_id: str) -> None:
        """Give the claim back (the handover callback failed)."""
        with self._claim_lock:
            self._claimed_fv.pop(domain_id, None)
            self._stood_by.add(domain_id)


class TransferQueueStandbyProcessor(QueueProcessorBase):
    """Transfer standby variant for one remote cluster."""

    def __init__(
        self,
        shard,
        engine,
        cluster: str,
        visibility=None,
        worker_count: int = 2,
        batch_size: int = 64,
        local_cluster: str = "",
        on_handover=None,
        metrics=None,
        faults=None,
        exhausted_retry_delay_s=None,
        executor=None,
    ) -> None:
        self.shard = shard
        self.engine = engine
        self.cluster = cluster
        self.visibility = (
            visibility if visibility is not None
            else shard.persistence.visibility
        )
        self._slog = get_logger(
            "cadence_tpu_torch.queue.transfer-standby",
            shard=shard.shard_id, cluster=cluster,
        )
        # called with an ack LEVEL when a domain this plane stood by
        # for fails over HERE: rewinds the active cursor over the held
        # span (closes the race where a standby worker observes the
        # flipped domain before the failover listener rewinds, and the
        # rewind target has already moved past the held span)
        self._on_handover = on_handover
        self._allocator = _StandbyAllocator(
            engine.domains, cluster, local_cluster=local_cluster,
            failover_version_increment=_fv_increment(engine),
        )
        shard.ensure_cluster_ack_levels(cluster)
        ack = QueueAckManager(
            shard.get_cluster_transfer_ack_level(cluster),
            update_shard_ack=lambda lvl: shard.update_cluster_transfer_ack_level(
                cluster, lvl
            ),
        )
        super().__init__(
            name=f"transfer-standby-{cluster}-{shard.shard_id}",
            ack=ack,
            read_batch=lambda level, n: shard.persistence.execution.get_transfer_tasks(
                shard.shard_id, level, 2**62, n
            ),
            process_task=self._process,
            # the ACTIVE processor owns task-row deletion; standby only
            # advances its own cursor
            complete_task=lambda t: None,
            task_key=lambda t: t.task_id,
            worker_count=worker_count,
            batch_size=batch_size,
            metrics=metrics,
            faults=faults,
            exhausted_retry_delay_s=exhausted_retry_delay_s,
            shard_id=shard.shard_id,
            executor=executor,
        )

    # -- verification dispatch ----------------------------------------

    def _process(self, task: TransferTask) -> None:
        cls = self._allocator.classify(task.domain_id)
        if cls != "owned":
            if cls == "handover" and self._on_handover is not None \
                    and self._allocator.claim_handover(task.domain_id):
                try:
                    # rewind the active plane over the whole held span:
                    # this plane's ack level lower-bounds every task it
                    # has read but not discharged
                    self._on_handover(
                        min(task.task_id - 1, self.ack.ack_level)
                    )
                except Exception:
                    self._allocator.rearm_handover(task.domain_id)
                    raise
            return  # locally-active (or other-cluster) task: not ours
        handler = {
            TransferTaskType.DecisionTask: self._verify_decision,
            TransferTaskType.ActivityTask: self._verify_activity,
            TransferTaskType.CloseExecution: self._verify_close,
            TransferTaskType.CancelExecution: self._verify_cancel,
            TransferTaskType.SignalExecution: self._verify_signal,
            TransferTaskType.StartChildExecution: self._verify_start_child,
            TransferTaskType.RecordWorkflowStarted: self._record_started,
            TransferTaskType.UpsertWorkflowSearchAttributes: self._upsert,
            TransferTaskType.ResetWorkflow: lambda t: None,
        }.get(task.task_type)
        if handler is None:
            return
        handler(task)

    def _read(self, task, reader):
        try:
            return self.engine.with_workflow(
                task.domain_id, task.workflow_id, task.run_id,
                lambda ctx, ms: reader(ms),
            )
        except EntityNotExistsServiceError:
            return None  # workflow gone: task verified trivially

    def _verify_decision(self, task: TransferTask) -> None:
        # done once replication shows the decision started (or moved on)
        def read(ms):
            ei = ms.execution_info
            return (
                ms.has_pending_decision()
                and ei.decision_schedule_id == task.schedule_id
                and ei.decision_started_id == EMPTY_EVENT_ID
            )

        if self._read(task, read):
            raise DeferTask(task.domain_id)

    def _verify_activity(self, task: TransferTask) -> None:
        def read(ms):
            ai = ms.get_activity_info(task.schedule_id)
            return ai is not None and ai.started_id == EMPTY_EVENT_ID

        if self._read(task, read):
            raise DeferTask(task.domain_id)

    def _verify_close(self, task: TransferTask) -> None:
        # standby records closed visibility once the close replicated
        def read(ms):
            if ms.is_workflow_execution_running():
                return "running"
            ei = ms.execution_info
            return VisibilityRecord(
                domain_id=task.domain_id,
                workflow_id=task.workflow_id,
                run_id=task.run_id,
                workflow_type=ei.workflow_type_name,
                start_time=ei.start_timestamp,
                close_time=ei.last_updated_timestamp or self.shard.now(),
                close_status=int(ei.close_status),
                history_length=ms.next_event_id - 1,
                memo=dict(ei.memo),
                search_attributes=dict(ei.search_attributes),
            )

        rec = self._read(task, read)
        if rec == "running":
            raise DeferTask(task.domain_id)
        if rec is not None and self.visibility is not None:
            self.visibility.record_workflow_execution_closed(rec)

    def _verify_cancel(self, task: TransferTask) -> None:
        def read(ms):
            return ms.get_request_cancel_info(task.initiated_id) is not None

        if self._read(task, read):
            raise DeferTask(task.domain_id)

    def _verify_signal(self, task: TransferTask) -> None:
        def read(ms):
            return ms.get_signal_info(task.initiated_id) is not None

        if self._read(task, read):
            raise DeferTask(task.domain_id)

    def _verify_start_child(self, task: TransferTask) -> None:
        def read(ms):
            ci = ms.get_child_execution_info(task.initiated_id)
            return ci is not None and ci.started_id == EMPTY_EVENT_ID

        if self._read(task, read):
            raise DeferTask(task.domain_id)

    def _record_started(self, task: TransferTask) -> None:
        from .transfer import open_visibility_record

        rec = self._read(task, lambda ms: open_visibility_record(task, ms))
        if rec is not None and self.visibility is not None:
            self.visibility.record_workflow_execution_started(rec)

    def _upsert(self, task: TransferTask) -> None:
        from .transfer import open_visibility_record

        rec = self._read(task, lambda ms: open_visibility_record(task, ms))
        if rec is not None and self.visibility is not None:
            self.visibility.upsert_workflow_execution(rec)


class TimerQueueStandbyProcessor:
    """Timer standby variant for one remote cluster: fires against the
    remote cluster's clock, verifies outcomes against replicated state."""

    _TASK_RETRY_COUNT = 3

    def __init__(
        self,
        shard,
        engine,
        cluster: str,
        worker_count: int = 2,
        batch_size: int = 64,
        local_cluster: str = "",
        on_handover=None,
        metrics=None,
        faults=None,
        exhausted_retry_delay_s=None,
        executor=None,
    ) -> None:
        from ...utils.metrics import NOOP

        self.shard = shard
        self.engine = engine
        self.cluster = cluster
        self._on_handover = on_handover
        self._exhausted_retry_delay_s = exhausted_retry_delay_s
        self.name = f"timer-standby-{cluster}-{shard.shard_id}"
        self._fault_hook = make_fault_hook(
            faults, f"queue.{self.name}", shard_id=shard.shard_id
        )
        self._log = get_logger(
            "cadence_tpu_torch.queue.timer-standby",
            shard=shard.shard_id, cluster=cluster,
        )
        self._metrics = (metrics or NOOP).tagged(
            service="history_queue",
            queue=f"timer-standby-{cluster}-{shard.shard_id}",
        )
        shard.ensure_cluster_ack_levels(cluster)
        self.ack = QueueAckManager(
            (shard.get_cluster_timer_ack_level(cluster), 0),
            update_shard_ack=lambda lvl: shard.update_cluster_timer_ack_level(
                cluster, lvl[0]
            ),
        )
        # paged-read resume cursor; any forced read rewind (failover,
        # defer retry firing) must drop it or the span would be skipped
        self._resume = ResumeCursor()
        self.ack.on_read_rewind = self._drop_resume
        self.gate = RemoteTimerGate()
        self.gate.set_current_time(
            shard.get_remote_cluster_current_time(cluster)
        )
        shard.add_remote_time_listener(self._on_remote_time)
        self._allocator = _StandbyAllocator(
            engine.domains, cluster, local_cluster=local_cluster,
            failover_version_increment=_fv_increment(engine),
        )
        self._stopped = threading.Event()
        self._paused = threading.Event()  # reshard fence: intake off
        from concurrent.futures import ThreadPoolExecutor

        self._batch_size = batch_size
        self._executor = executor
        self._waves = WaveGate()
        if executor is None:
            self._pool = ThreadPoolExecutor(
                max_workers=worker_count,
                thread_name_prefix=(
                    f"timer-standby-{cluster}-{shard.shard_id}"),
            )
            self._pump_thread = threading.Thread(
                target=self._pump,
                name=f"timer-standby-{cluster}-{shard.shard_id}-pump",
                daemon=True,
            )
        else:
            self._pool = None
            self._pump_thread = None

    def _on_remote_time(self, cluster: str, now_ns: int) -> None:
        if cluster == self.cluster:
            self.gate.set_current_time(now_ns)

    def _drop_resume(self) -> None:
        self._resume.drop()
        self.gate.update(0)

    def start(self) -> None:
        if self._executor is not None:
            self._executor.register(self)
            return
        self._pump_thread.start()

    def notify(self) -> None:
        if self._executor is not None:
            self._executor.notify()
            return
        self.gate.update(0)

    def stop(self) -> None:
        self._stopped.set()
        self.gate.update(0)
        if self._executor is not None:
            self._executor.unregister(self)
        else:
            self._pool.shutdown(wait=False)
        # detach from the shard or this dead processor stays reachable
        # (and notified) through the remote-time listener list forever
        self.shard.remove_remote_time_listener(self._on_remote_time)

    def drain(self, timeout_s: float = 5.0, *, deadline=None) -> bool:
        import time

        if deadline is None:
            deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.ack.outstanding() == 0 and self._waves.idle():
                return True
            time.sleep(0.01)
        return False

    # -- reshard fence -------------------------------------------------

    def pause_intake(self) -> None:
        self._waves.pause(self._paused)

    def resume_intake(self) -> None:
        self._paused.clear()
        self.gate.update(0)

    def fence_drain(self, deadline: float):
        """Pause intake, drain in-flight verifications, return the
        standby (ts, id) ack watermark."""
        self.pause_intake()
        if not self.drain(deadline=deadline):
            raise TimeoutError(
                f"queue {self.name} failed to drain for reshard handoff "
                f"({self.ack.outstanding()} in flight)"
            )
        sweep_ack(self.ack, self._log, self.name)
        return self.ack.ack_level

    # -- pump (remote-clock-gated) ------------------------------------

    def _pump(self) -> None:
        while not self._stopped.is_set():
            self.gate.wait(max_wait_s=0.05)
            if self._stopped.is_set():
                return
            try:
                self._process_due()
            except Exception:
                self._log.exception("standby timer pump failed")
            sweep_ack(self.ack, self._log, self.name)
            self._metrics.gauge("task_outstanding", self.ack.outstanding())
            self._metrics.gauge("task_held", self.ack.held())

    def _process_due(self) -> None:
        if self._paused.is_set():
            return
        remote_now = self.gate.current_time()
        if remote_now <= 0:
            return  # no view of the remote clock yet: nothing is "due"
        # begin() BEFORE reading the ack level: a rewind between the
        # two bumps the generation and invalidates this scan's store
        key, gen = self._resume.begin()
        min_ts = self.ack.ack_level[0]

        def offer(task, key):
            if self.ack.add(key):
                self._pool.submit(self._run_task, task, key)

        # (ts, id)-cursor paging, persisted across wakes: a span of
        # HELD tasks (waiting on replication) must not hide the due
        # tasks behind it — retention deletes and other domains' timers
        # keep flowing during replication lag, however large the span
        self._resume.store_if_current(
            read_due_timers(
                self.shard.persistence.execution, self.shard.shard_id,
                min_ts, remote_now + 1, self._batch_size, key, offer,
            ),
            gen,
        )
        future = self.shard.persistence.execution.get_timer_tasks(
            self.shard.shard_id, remote_now + 1, 2**62, 1
        )
        if future:
            self.gate.update(future[0].visibility_timestamp)

    # -- parallel executor hooks ---------------------------------------

    def parallel_collect(self, limit: int):
        """Executor-mode read of the window due on the remote clock:
        ``_process_due``'s scan, collecting generation-stamped offers
        instead of submitting them. A non-empty collect holds the
        reshard fence until ``parallel_done``."""
        if not self._waves.open(self._paused, self._stopped):
            return [], 0
        out = []
        agen = 0
        try:
            remote_now = self.gate.current_time()
            if remote_now > 0:
                key, gen = self._resume.begin()
                agen = self.ack.generation()
                min_ts = self.ack.ack_level[0]

                def offer(task, k):
                    if self.ack.add(k, generation=agen):
                        out.append((task, k))

                self._resume.store_if_current(
                    read_due_timers(
                        self.shard.persistence.execution,
                        self.shard.shard_id, min_ts, remote_now + 1,
                        min(limit, self._batch_size), key, offer,
                    ),
                    gen,
                )
        except Exception:
            self._waves.close()
            raise
        if not out:
            self._waves.close()
        return out, agen

    def parallel_run(self, task, key) -> None:
        self._run_task(task, key)

    def parallel_done(self) -> None:
        self._waves.close()

    def _run_task(self, task: TimerTask, key) -> None:
        with task_span(self.name, task), \
                timed_task(self._metrics, task) as scope:
            finished = run_task_attempts(
                self._process, task, key, self.ack, self._stopped,
                self._log, scope, self.name,
                retry_count=self._TASK_RETRY_COUNT,
                exhausted_retry_delay_s=self._exhausted_retry_delay_s,
                fault_hook=self._fault_hook,
            )
        if not finished:
            return  # parked (deferred / exhausted-retry) or stopping
        # no task-row deletion on standby; cursor-only
        self.ack.complete(key)

    # -- verification handlers ----------------------------------------

    def _process(self, task: TimerTask) -> None:
        if task.task_type == TimerTaskType.DeleteHistoryEvent:
            # retention runs on every cluster (ref timerQueueStandby
            # taskExecutor executeDeleteHistoryEventTask)
            self._delete_history(task)
            return
        cls = self._allocator.classify(task.domain_id)
        if cls != "owned":
            if cls == "handover" and self._on_handover is not None \
                    and self._allocator.claim_handover(task.domain_id):
                try:
                    self._on_handover(
                        min(
                            (task.visibility_timestamp, task.task_id - 1),
                            self.ack.ack_level,
                        )
                    )
                except Exception:
                    self._allocator.rearm_handover(task.domain_id)
                    raise
            return
        handler = {
            TimerTaskType.UserTimer: self._verify_user_timer,
            TimerTaskType.ActivityTimeout: self._verify_activity_timeout,
            TimerTaskType.DecisionTimeout: self._verify_decision_timeout,
            TimerTaskType.WorkflowTimeout: self._verify_workflow_timeout,
            TimerTaskType.ActivityRetryTimer: lambda t: None,  # active-only
            TimerTaskType.WorkflowBackoffTimer: self._verify_backoff,
        }.get(task.task_type)
        if handler is None:
            return
        handler(task)

    def _read(self, task, reader):
        try:
            return self.engine.with_workflow(
                task.domain_id, task.workflow_id, task.run_id,
                lambda ctx, ms: reader(ms),
            )
        except EntityNotExistsServiceError:
            return None

    def _remote_now(self) -> int:
        return self.gate.current_time()

    def _verify_user_timer(self, task: TimerTask) -> None:
        remote_now = self._remote_now()

        def read(ms):
            if not ms.is_workflow_execution_running():
                return False
            for ti in ms.pending_timers.values():
                if ti.expiry_time <= remote_now:
                    return True  # fired remotely but not yet replicated
            return False

        if self._read(task, read):
            raise DeferTask(task.domain_id)

    def _verify_activity_timeout(self, task: TimerTask) -> None:
        remote_now = self._remote_now()

        def read(ms):
            if not ms.is_workflow_execution_running():
                return False
            seq = TimerSequence(ms)
            for expiry, _sid, _tt, _ai in seq._activity_timeout_candidates():
                if expiry <= remote_now:
                    return True
            return False

        if self._read(task, read):
            raise DeferTask(task.domain_id)

    def _verify_decision_timeout(self, task: TimerTask) -> None:
        def read(ms):
            ei = ms.execution_info
            return (
                ms.is_workflow_execution_running()
                and ms.has_pending_decision()
                and ei.decision_schedule_id == task.event_id
            )

        if self._read(task, read):
            raise DeferTask(task.domain_id)

    def _verify_workflow_timeout(self, task: TimerTask) -> None:
        remote_now = self._remote_now()

        def read(ms):
            if not ms.is_workflow_execution_running():
                return False
            ei = ms.execution_info
            if ei.workflow_timeout <= 0:
                return False
            expiry = ei.start_timestamp + ei.workflow_timeout * 1_000_000_000
            return expiry <= remote_now

        if self._read(task, read):
            raise DeferTask(task.domain_id)

    def _verify_backoff(self, task: TimerTask) -> None:
        def read(ms):
            return (
                ms.is_workflow_execution_running()
                and not ms.has_pending_decision()
                and ms.execution_info.last_processed_event == EMPTY_EVENT_ID
            )

        if self._read(task, read):
            raise DeferTask(task.domain_id)

    def _delete_history(self, task: TimerTask) -> None:
        from .retention import delete_workflow_retention

        delete_workflow_retention(self.shard, self.engine, task)
