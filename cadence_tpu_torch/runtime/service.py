"""History service assembly: controller + engines + queue processors.

Reference: Cadence service/history/service.go + handler.go —
the history service owns a shard controller whose per-shard engines are
wired to transfer/timer queue processors, a matching client for task
pushes, and a history client for cross-shard workflow calls.

A copy of the reference package's ``runtime/service.py`` without the
planes later slices port: the standby queue processors and the queue GC,
the replication sources and verbs, the failover listener, the reshard
coordinator, the admin queue view, the capacity autopilot's hooks, the
shared parallel queue executor, fault injection and the ``checkpoints``
argument (its readers are the replication planes). The service takes no
device: the serving plane handed in carries its own, and its own
checkpoint plane, through which ``stop()`` drains it.
"""

from __future__ import annotations

from typing import Optional

from ..utils.clock import TimeSource
from ..utils.log import get_logger

from .controller import ShardController, _ShardHandle
from .domains import DomainCache
from .engine.engine import HistoryEngine
from .membership import Monitor
from .persistence.interfaces import PersistenceBundle
from .queues import TimerQueueProcessor, TransferQueueProcessor
from .shard import ShardContext


class HistoryService:
    """One history host: all shards this host owns, fully wired."""

    def __init__(
        self,
        num_shards: int,
        persistence: PersistenceBundle,
        domain_cache: DomainCache,
        monitor: Monitor,
        time_source: Optional[TimeSource] = None,
        queue_worker_count: int = 4,
        metrics=None,
        queue_exhausted_retry_delay_s: Optional[float] = None,
        serving=None,
        rate_limiter=None,
    ) -> None:
        from ..utils.metrics import Scope

        self.persistence = persistence
        self.domains = domain_cache
        self.monitor = monitor
        self._time = time_source
        self._queue_workers = queue_worker_count
        # per-task-type queue triples hang off this scope (reference
        # common/metrics/defs.go task-type scopes); a real registry by
        # default so tests can assert on it via service.metrics.registry
        self.metrics = metrics if metrics is not None else Scope()
        # queue_exhausted_retry_delay_s shrinks the park interval so a
        # park-then-drain run completes at test-scale (None = the
        # production default)
        self._queue_park_delay_s = queue_exhausted_retry_delay_s
        # serving.ResidentEngine (config `serving:` section): hot
        # workflows' state rows stay device-resident; every persisted
        # event batch marks the lane behind (O(1)), serving reads
        # answer from the resident row with the Δ composed; it carries
        # its device and its checkpoint plane. None = serving_read
        # raises
        self.serving = serving
        # overload control: a MultiStageRateLimiter every owned
        # shard's engine consults on ingress writes — sheds with
        # the retryable ServiceBusyError + retry-after. None = never
        # shed at this layer (the frontend's limiter still applies)
        self.rate_limiter = rate_limiter
        # the serving tick pump (serving/pump.py), started when the
        # engine carries a configured cadence (serving.tickIntervalMs)
        self._tick_pump = None
        self._log = get_logger(
            "cadence_tpu_torch.history.service", host=monitor.self_identity
        )
        # late-bound clients (wire() resolves the construction cycle:
        # processors need clients; clients need the controller)
        self.matching_client = None
        self.history_client = None
        self.controller = ShardController(
            num_shards, persistence, domain_cache, monitor,
            engine_factory=self._build_shard, time_source=time_source,
        )

    def wire(self, matching_client, history_client) -> "HistoryService":
        self.matching_client = matching_client
        self.history_client = history_client
        return self

    def start(self) -> None:
        if self.matching_client is None or self.history_client is None:
            raise RuntimeError("HistoryService.wire() must be called first")
        self.controller.acquire_shards()
        if (self.serving is not None
                and getattr(self.serving, "tick_interval_s", 0) > 0):
            from ..serving.pump import TickPump

            # bounded staleness: the pump composes write-heavy lanes'
            # persist-feed debt at the configured cadence even with
            # zero read traffic (serving_staleness_ms is the proof)
            self._tick_pump = TickPump(
                self.serving, self.serving.tick_interval_s,
                metrics=self.metrics,
            ).start()

    def stop(self) -> None:
        if self._tick_pump is not None:
            # pump drain-on-stop FIRST: its final tick composes Δs
            # staged since the last cycle, so the lane flush below
            # writes tip-accurate snapshots
            self._tick_pump.stop()
            self._tick_pump = None
        if self.serving is not None:
            # flush every resident lane back through the checkpoint
            # plane before the shards go away (clean drain: the next
            # boot's admissions resume suffix-only)
            self.serving.drain()
        self.controller.stop()

    # -- per-shard assembly --------------------------------------------

    def _build_shard(self, shard: ShardContext) -> _ShardHandle:
        # metrics must ride the CONSTRUCTOR: instrument_methods wraps
        # the per-op triple (and trace spans) at __init__ time, so a
        # post-construction `engine.metrics = ...` would leave every
        # history API latency in the NOOP registry
        engine = HistoryEngine(shard, self.domains, metrics=self.metrics)
        engine.serving = self.serving
        engine.rate_limiter = self.rate_limiter
        engine.matching_client = self.matching_client
        transfer = TransferQueueProcessor(
            shard, engine, self.matching_client, self.history_client,
            worker_count=self._queue_workers,
            metrics=self.metrics,
            exhausted_retry_delay_s=self._queue_park_delay_s,
        )
        timer = TimerQueueProcessor(
            shard, engine, matching=self.matching_client,
            worker_count=self._queue_workers,
            metrics=self.metrics,
            exhausted_retry_delay_s=self._queue_park_delay_s,
        )
        processors = [transfer, timer]
        engine._task_notifier = transfer.notify
        engine._timer_notifier = timer.notify
        for p in processors:
            p.start()
        return _ShardHandle(shard, engine, processors)

    # -- serving plane -------------------------------------------------

    def serving_read(
        self, domain_id: str, workflow_id: str, run_id: str = ""
    ):
        """Serving-plane decision/query read (config `serving:`): a hot
        workflow answers straight from its resident lane (Δs composed
        first); a miss seats the workflow — the next read is resident.
        Returns a serving.ResidentRead; None when the serving caps
        cannot pack the history (``serving_cold_read_failures`` — the
        rebuild verbs stay the recovery path); raises RuntimeError when
        the section is disabled (callers fall back to the rebuild
        path)."""
        import time as _time

        if self.serving is None:
            raise RuntimeError("serving: section not enabled")
        t0 = _time.perf_counter()
        engine = self.controller.get_engine(workflow_id)
        shard = engine.shard
        if not run_id:
            run_id = shard.persistence.execution.get_current_execution(
                shard.shard_id, domain_id, workflow_id
            ).run_id
        got = self.serving.resident_row(
            workflow_id, run_id, domain_id=domain_id
        )
        if got is not None:
            # same accounting as the engine's own read verbs, so
            # resident-hit latency never vanishes from the histogram
            # depending on which entry point answered
            scope = self.metrics.tagged(layer="serving")
            scope.inc("serving_resident_hits")
            scope.record(
                "serving_read_seconds", _time.perf_counter() - t0
            )
            return got
        resp = shard.persistence.execution.get_workflow_execution(
            shard.shard_id, domain_id, workflow_id, run_id
        )
        branch_token = resp.snapshot["execution_info"]["branch_token"]
        return self.serving.read_through(
            domain_id, workflow_id, run_id, branch_token
        )

    # -- introspection -------------------------------------------------

    def describe(self) -> dict:
        return self.controller.describe()

    def drain_queues(self, timeout_s: float = 10.0) -> bool:
        """Wait until every owned shard's queues are quiescent (tests)."""
        ok = True
        with self.controller._lock:
            handles = list(self.controller._handles.values())
        for handle in handles:
            for p in handle.processors:
                ok = p.drain(timeout_s) and ok
        return ok
