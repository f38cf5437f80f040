"""Timer queue processor (active side).

Reference: Cadence service/history/timerQueueActiveProcessor.go
:244-687 + timerQueueProcessorBase.go — time-ordered pull pipeline over
timer tasks: user timers, the four activity timeout kinds, decision
timeouts, activity retry timers, workflow backoff (cron/retry) timers,
workflow timeout, retention-driven history deletion. The pump sleeps on
a LocalTimerGate armed with the earliest unfired deadline.

A copy of the reference package's ``runtime/queues/timer.py``, with the
shared parallel executor's mode (``executor``, ``parallel_collect``):
a non-empty collect holds the reshard fence until the executor has run
it (``parallel_done``), as ``QueueProcessorBase`` does.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ...core.active_transaction import WorkflowStateError
from ...core.enums import TimeoutType, TimerTaskType
from ...core.ids import EMPTY_EVENT_ID
from ...core.tasks import TimerTask
from ...core.timer_sequence import TimerSequence
from ...runtime.api import EntityNotExistsServiceError
from ...utils.log import get_logger

from ...utils.metrics import NOOP

from .ack import QueueAckManager
from .allocator import DeferTask, TaskAllocator, defer_task
from .base import (
    ResumeCursor,
    WaveGate,
    make_fault_hook,
    read_due_timers,
    run_task_attempts,
    sweep_ack,
    task_span,
    timed_task,
)
from .timer_gate import LocalTimerGate

_TIMEOUT_REASON = "cadenceInternal:Timeout"


class TimerQueueProcessor:
    """Pump + worker pool keyed on (visibility_timestamp, task_id)."""

    def __init__(
        self,
        shard,
        engine,
        matching=None,
        worker_count: int = 4,
        batch_size: int = 64,
        standby_clusters=(),
        metrics=None,
        faults=None,
        exhausted_retry_delay_s=None,
        executor=None,
    ) -> None:
        self.shard = shard
        self.engine = engine
        self.matching = matching
        self.standby_clusters = frozenset(standby_clusters)
        self.has_standby = bool(self.standby_clusters)
        self._exhausted_retry_delay_s = exhausted_retry_delay_s
        self.name = f"timer-{shard.shard_id}"
        self._fault_hook = make_fault_hook(
            faults, f"queue.{self.name}", shard_id=shard.shard_id
        )
        self._log = get_logger("cadence_tpu_torch.queue.timer", shard=shard.shard_id)
        self._metrics = (metrics or NOOP).tagged(
            service="history_queue", queue=f"timer-{shard.shard_id}"
        )
        self.ack = QueueAckManager(
            (shard.get_timer_ack_level(), 0),
            update_shard_ack=lambda lvl: shard.update_timer_ack_level(lvl[0]),
        )
        # paged-read resume cursor; any forced read rewind (failover,
        # defer retry firing) must drop it or the span would be skipped
        self._resume = ResumeCursor()
        self.ack.on_read_rewind = self._drop_resume
        self.gate = LocalTimerGate(time_source=shard.time_source)
        self._allocator = TaskAllocator(
            engine.domains, getattr(engine, "cluster_metadata", None)
        )
        self._stopped = threading.Event()
        self._paused = threading.Event()  # reshard fence: intake off
        self._batch_size = batch_size
        # executor mode (an executor handed in): the shared
        # ParallelQueueExecutor polls via parallel_collect; the gate,
        # pool, and pump thread stay unused
        self._executor = executor
        self._waves = WaveGate()
        if executor is None:
            self._pool = ThreadPoolExecutor(
                max_workers=worker_count,
                thread_name_prefix=f"timer-{shard.shard_id}",
            )
            self._pump_thread = threading.Thread(
                target=self._pump, name=f"timer-{shard.shard_id}-pump",
                daemon=True,
            )
        else:
            self._pool = None
            self._pump_thread = None

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
        # a new timer may be earlier than anything armed: wake now
        self.gate.update(0)

    def stop(self) -> None:
        self._stopped.set()
        self.gate.update(0)
        if self._executor is not None:
            self._executor.unregister(self)
            return
        self._pool.shutdown(wait=False)

    def drain(self, timeout_s: float = 5.0, *, deadline=None) -> bool:
        import time

        if deadline is None:
            deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._paused.is_set():
                # reshard fence: quiescent once nothing is in flight —
                # due-but-unread timers stay in the store and move to
                # the new owner past the recorded watermark
                if self.ack.outstanding() == 0 and self._waves.idle():
                    return True
                time.sleep(0.01)
                continue
            now = self.shard.now()
            batch = self.shard.persistence.execution.get_timer_tasks(
                self.shard.shard_id, self.ack.ack_level[0], now, 1
            )
            if not batch and self.ack.outstanding() == 0:
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
        """Pause intake, drain in-flight timers, return the (ts, id)
        ack watermark (see QueueProcessorBase.fence_drain)."""
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
            self.gate.wait(max_wait_s=0.05)
            if self._stopped.is_set():
                return
            try:
                self._process_due()
            except Exception:
                self._log.exception("timer pump failed")
            sweep_ack(self.ack, self._log, self.name)
            self._metrics.gauge("task_outstanding", self.ack.outstanding())
            self._metrics.gauge("task_held", self.ack.held())

    def _process_due(self) -> None:
        if self._paused.is_set():
            return
        now = self.shard.now()
        # begin() BEFORE reading the ack level: a rewind between the
        # two bumps the generation and invalidates this scan's store
        key, gen = self._resume.begin()
        min_ts = self.ack.ack_level[0]

        def offer(task, key):
            if self.ack.add(key):
                self._pool.submit(self._run_task, task, key)

        # (ts, id)-cursor paging, persisted across wakes: in-flight or
        # held tasks at the front of the window must not hide due tasks
        # behind them, however large the span
        self._resume.store_if_current(
            read_due_timers(
                self.shard.persistence.execution, self.shard.shard_id,
                min_ts, now + 1, self._batch_size, key, offer,
            ),
            gen,
        )
        # arm the gate with the next future deadline
        future = self.shard.persistence.execution.get_timer_tasks(
            self.shard.shard_id, now + 1, 2**62, 1
        )
        if future:
            self.gate.update(future[0].visibility_timestamp)

    # -- parallel executor hooks ---------------------------------------

    def parallel_collect(self, limit: int):
        """Executor-mode due-window read: the ``_process_due`` scan with
        collection instead of pool submission. Offers are stamped with
        the ack generation so a rewind between this collect and the wave
        execution rejects them (the sequential timer pump relies on the
        resume-cursor drop for the same property; the executor checks
        the generation explicitly before running the wave). No gate
        arming — the executor polls on its own interval. A non-empty
        collect holds the reshard fence until ``parallel_done``."""
        if not self._waves.open(self._paused, self._stopped):
            return [], 0
        out = []
        agen = 0
        try:
            now = self.shard.now()
            key, gen = self._resume.begin()
            agen = self.ack.generation()
            min_ts = self.ack.ack_level[0]

            def offer(task, k):
                if self.ack.add(k, generation=agen):
                    out.append((task, k))

            self._resume.store_if_current(
                read_due_timers(
                    self.shard.persistence.execution, self.shard.shard_id,
                    min_ts, now + 1, min(limit, self._batch_size), key,
                    offer,
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

    _TASK_RETRY_COUNT = 3

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
        if not self.has_standby:   # with standby planes, QueueGC deletes
            try:
                self.shard.persistence.execution.complete_timer_task(
                    self.shard.shard_id, task.visibility_timestamp,
                    task.task_id,
                )
            except Exception:
                self._log.exception(f"complete_timer_task failed for {key}")
        self.ack.complete(key)

    # -- handlers ------------------------------------------------------

    def _process(self, task: TimerTask) -> None:
        owner = self._allocator.owning_cluster(task.domain_id)
        if owner is not None:
            if owner in self.standby_clusters:
                # that cluster's standby variant owns it (incl.
                # retention deletes); failover rewinds this cursor to
                # the standby cursor
                return
            # no standby plane covers the owning cluster: hold the
            # task; it fires here only after a failover makes us active
            raise DeferTask(task.domain_id)
        handler = {
            TimerTaskType.UserTimer: self._process_user_timer,
            TimerTaskType.ActivityTimeout: self._process_activity_timeout,
            TimerTaskType.DecisionTimeout: self._process_decision_timeout,
            TimerTaskType.WorkflowTimeout: self._process_workflow_timeout,
            TimerTaskType.ActivityRetryTimer: self._process_activity_retry,
            TimerTaskType.WorkflowBackoffTimer: self._process_workflow_backoff,
            TimerTaskType.DeleteHistoryEvent: self._process_delete_history,
        }.get(task.task_type)
        if handler is None:
            self._log.info(f"unknown timer task type {task.task_type}")
            return
        handler(task)

    def _mutate(self, task: TimerTask, action) -> None:
        """Engine-locked mutation returning whether events were added."""

        def run(ctx, ms):
            if not ms.is_workflow_execution_running():
                return
            txn = self.engine._txn(ctx, ms, ms.current_version)
            now = self.shard.now()
            try:
                mutated = action(txn, ms, now)
            except WorkflowStateError as e:
                raise EntityNotExistsServiceError(str(e))
            if not mutated:
                return
            if (
                ms.is_workflow_execution_running()
                and not ms.has_pending_decision()
                and not txn.has_buffered_events()
            ):
                txn.add_decision_task_scheduled(now)
            result = txn.close()
            ctx.update_workflow(ms, result)
            self.engine._notify(result)

        self.engine.with_workflow(
            task.domain_id, task.workflow_id, task.run_id, run
        )

    def _process_user_timer(self, task: TimerTask) -> None:
        # processExpiredUserTimer (:302): fire every expired timer
        def action(txn, ms, now):
            fired = False
            for ti in sorted(
                ms.pending_timers.values(),
                key=lambda t: (t.expiry_time, t.started_id),
            ):
                if ti.expiry_time > now:
                    break
                txn.add_timer_fired(ti.timer_id, now)
                fired = True
            return fired

        self._mutate(task, action)

    def _process_activity_timeout(self, task: TimerTask) -> None:
        # processActivityTimeout (:355): sweep every expired armed
        # timeout; retry before recording the terminal timeout event;
        # then re-arm the next activity timer.
        def action(txn, ms, now):
            mutated = False
            seq = TimerSequence(ms)
            handled = set()  # at most one expiry per activity per sweep
            for expiry, schedule_id, timeout_type, ai in list(
                seq._activity_timeout_candidates()
            ):
                if expiry > now:
                    break
                if schedule_id in handled:
                    continue
                if ai.schedule_id not in ms.pending_activities:
                    continue  # closed earlier in this sweep
                handled.add(schedule_id)
                tt = TimeoutType(timeout_type)
                # ScheduleToClose spans all attempts — terminal, no retry
                if tt != TimeoutType.ScheduleToClose:
                    retry_task = ms.retry_activity(
                        ai, now, failure_reason=_TIMEOUT_REASON
                    )
                    if retry_task is not None:
                        txn.schedule_timer_task(retry_task)
                        mutated = True
                        continue
                txn.add_activity_task_timed_out(
                    schedule_id, now, tt,
                    details=ai.details if tt == TimeoutType.Heartbeat else b"",
                )
                mutated = True
            # heartbeat may have moved the deadline without an event:
            # clear created-bits and re-arm the earliest timeout so the
            # durable timer follows the live deadline
            for ai in ms.pending_activities.values():
                ai.timer_task_status = 0
            rearm = seq.activity_timer_task_if_needed()
            if rearm is not None:
                txn.schedule_timer_task(rearm)
                mutated = True
            return mutated

        self._mutate(task, action)

    def _process_decision_timeout(self, task: TimerTask) -> None:
        # processDecisionTimeout: StartToClose times out the in-flight
        # decision and schedules a retry attempt; ScheduleToStart fires
        # only for sticky dispatch and reschedules on the normal list.
        def action(txn, ms, now):
            ei = ms.execution_info
            if (
                not ms.has_pending_decision()
                or ei.decision_schedule_id != task.event_id
            ):
                return False
            tt = TimeoutType(task.timeout_type)
            if tt == TimeoutType.StartToClose:
                if ei.decision_started_id == EMPTY_EVENT_ID:
                    return False
                if ei.decision_attempt != task.schedule_attempt:
                    return False
                txn.add_decision_task_timed_out(
                    ei.decision_schedule_id, ei.decision_started_id, now
                )
                txn.add_decision_task_scheduled(now)
                return True
            # ScheduleToStart: only valid while not yet started (sticky)
            if ei.decision_started_id != EMPTY_EVENT_ID:
                return False
            ms.clear_stickiness()
            txn.add_decision_task_timed_out(
                ei.decision_schedule_id, EMPTY_EVENT_ID, now,
                timeout_type=TimeoutType.ScheduleToStart,
            )
            txn.add_decision_task_scheduled(now)
            return True

        self._mutate(task, action)

    def _process_workflow_timeout(self, task: TimerTask) -> None:
        # processWorkflowTimeout (:687): verify the run really expired;
        # a run with retry budget or a cron schedule restarts instead of
        # closing (reference retryWorkflow/cronWorkflow on timeout)
        from ...core.ids import FIRST_EVENT_ID
        from ...runtime.engine.cron_retry import (
            try_continue_after_close,
        )

        def run(ctx, ms):
            if not ms.is_workflow_execution_running():
                return
            ei = ms.execution_info
            if ei.workflow_timeout <= 0:
                return
            now = self.shard.now()
            expiry = ei.start_timestamp + ei.workflow_timeout * 1_000_000_000
            if expiry > now:
                return
            txn = self.engine._txn(ctx, ms, ms.current_version)
            try:
                if not try_continue_after_close(
                    txn, ms, lambda: ctx.get_event(ms, FIRST_EVENT_ID),
                    "timeout", now, error_reason=_TIMEOUT_REASON,
                ):
                    txn.add_workflow_execution_timed_out(now)
            except WorkflowStateError as e:
                raise EntityNotExistsServiceError(str(e))
            result = txn.close()
            ctx.update_workflow(ms, result)
            self.engine._notify(result)

        self.engine.with_workflow(
            task.domain_id, task.workflow_id, task.run_id, run
        )

    def _process_activity_retry(self, task: TimerTask) -> None:
        # processActivityRetryTimer (:610): push the next attempt
        def read(ms):
            ai = ms.get_activity_info(task.event_id)
            if (
                ai is None
                or ai.started_id != EMPTY_EVENT_ID
                or ai.attempt != task.schedule_attempt
            ):
                return None
            return (ai.task_list, ai.schedule_to_start_timeout)

        try:
            target = self.engine.with_workflow(
                task.domain_id, task.workflow_id, task.run_id,
                lambda ctx, ms: read(ms),
            )
        except EntityNotExistsServiceError:
            return
        if target is None or self.matching is None:
            return
        task_list, timeout = target
        self.matching.add_activity_task(
            task.domain_id, task.workflow_id, task.run_id,
            task_list, task.event_id,
            schedule_to_start_timeout_seconds=timeout,
        )

    def _process_workflow_backoff(self, task: TimerTask) -> None:
        # processWorkflowBackoffTimer: first decision after cron/retry
        def action(txn, ms, now):
            if ms.has_pending_decision():
                return False
            if ms.execution_info.last_processed_event != EMPTY_EVENT_ID:
                return False  # past the first decision already
            txn.add_decision_task_scheduled(now)
            return True

        self._mutate(task, action)

    def _process_delete_history(self, task: TimerTask) -> None:
        # retention GC (timerQueueProcessorBase deleteHistoryEvent)
        from .retention import delete_workflow_retention

        delete_workflow_retention(self.shard, self.engine, task)
