"""History service assembly: controller + engines + queue processors.

Reference: Cadence service/history/service.go + handler.go —
the history service owns a shard controller whose per-shard engines are
wired to transfer/timer queue processors, a matching client for task
pushes, and a history client for cross-shard workflow calls.

A copy of the reference package's ``runtime/service.py``: the shared
parallel queue executor (``queue_executor``), the host's one reshard
coordinator (``reshard_coordinator``), the capacity autopilot's hooks
and the admin queue view (``describe_queue_states``), with ``faults`` (a
``testing.faults.FaultSchedule``) threaded into every queue processor
and the replication planes as the reference threads it. Deviation: the
executor
also drives the standby transfer and timer processors, which the
reference's service leaves on their own pumps.

``device`` (default ``"cuda"``) is where the replication planes' state
rebuilders replay: the NDC replicator's conflict rebuilds, the snapshot
installer's and the replicator queue's snapshot server, and where the
reshard coordinator flushes and warms moving workflows. Without a card
the first device rebuild raises; it never slips onto the host route. The
serving plane handed in carries its own device and its own checkpoint
plane, through which ``stop()`` drains it.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..utils.clock import TimeSource
from ..utils.log import get_logger

from .controller import ShardController, _ShardHandle
from .domains import DomainCache
from .engine.engine import HistoryEngine
from .membership import Monitor
from .persistence.interfaces import PersistenceBundle
from .queues import (
    QueueGC,
    TimerQueueProcessor,
    TimerQueueStandbyProcessor,
    TransferQueueProcessor,
    TransferQueueStandbyProcessor,
)
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
        cluster_metadata=None,
        metrics=None,
        rebuild_chunk_size: int = 0,
        faults=None,
        queue_exhausted_retry_delay_s: Optional[float] = None,
        checkpoints=None,
        serving=None,
        rate_limiter=None,
        queue_executor=None,
        device="cuda",
    ) -> None:
        from ..utils.metrics import Scope

        self.cluster_metadata = cluster_metadata
        self.persistence = persistence
        self.domains = domain_cache
        self.monitor = monitor
        self._time = time_source
        self._queue_workers = queue_worker_count
        # per-task-type queue triples + standby hold depth + replication
        # lag all hang off this scope (reference common/metrics/defs.go
        # task-type scopes); a real registry by default so tests can
        # assert on it via service.metrics.registry
        self.metrics = metrics if metrics is not None else Scope()
        # rebuild_many device-chunk rows; 0 = the device's default
        self.rebuild_chunk_size = rebuild_chunk_size
        # where the replication planes' rebuilders replay
        self.device = device
        # chaos: a testing.faults.FaultSchedule threaded into every
        # queue processor and the replication planes; None in any
        # non-chaos deployment (no hook objects are even constructed).
        # queue_exhausted_retry_delay_s shrinks the park interval so a
        # park-then-drain run completes at test-scale (None = the
        # production default)
        self.faults = faults
        self._queue_park_delay_s = queue_exhausted_retry_delay_s
        # checkpoint.CheckpointManager: every shard's state rebuilder
        # resumes replays from durable snapshots and writes fresh ones.
        # None = cold rebuilds only.
        self.checkpoints = checkpoints
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
        # queues.ParallelQueueExecutor (the Onebox's queue_parallel):
        # the shared conflict-keyed wave scheduler every owned shard's
        # transfer/timer pumps (and here the standby pumps) register
        # with. None (the default) keeps the sequential per-queue pump
        # threads.
        self.queue_executor = queue_executor
        # config.ReshardingConfig (`resharding:` section) — read by the
        # admin reshard verbs; None = defaults (enabled)
        self.resharding_config = None
        # the ONE ReshardCoordinator per host: the admin verbs and the
        # capacity autopilot share it (two coordinators would each hold
        # their own lock — "one plan at a time" must be host-wide)
        self._resharder = None
        self._resharder_lock = threading.Lock()
        # runtime.autopilot.CapacityController (config `autopilot:`
        # section), attached by the Onebox; None = manual capacity
        self.autopilot = None
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
        # replication knobs (the reference's `replication:` config
        # section: adaptive transport + pump backoff); None = defaults
        # (adaptive on)
        self.replication_config = None
        # remote-cluster pull plane: cluster -> (client, fetcher,
        # transport); each owned shard gets a ReplicationTaskProcessor
        # per entry, all sharing the link's transport/estimator
        self._replication_sources: Dict[str, tuple] = {}
        # remote clusters this host stands by for (standby queue planes)
        self.standby_clusters: List[str] = []
        if cluster_metadata is not None:
            self.standby_clusters = list(
                cluster_metadata.enabled_remote_clusters()
            )
        self.controller = ShardController(
            num_shards, persistence, domain_cache, monitor,
            engine_factory=self._build_shard, time_source=time_source,
        )
        # failover: when a domain becomes active here, rewind the active
        # cursors to the standby cursor of the cluster it came from so
        # the skipped passive span is re-verified (idempotent handlers)
        domain_cache.add_failover_listener(self._on_domain_failover)

    def wire(self, matching_client, history_client) -> "HistoryService":
        self.matching_client = matching_client
        self.history_client = history_client
        return self

    def start(self) -> None:
        if self.matching_client is None or self.history_client is None:
            raise RuntimeError("HistoryService.wire() must be called first")
        if self.queue_executor is not None:
            # before acquire_shards: _build_shard registers each shard's
            # pumps with the executor, which must already be pumping
            # (start() is idempotent — a shared executor across services
            # starts once)
            self.queue_executor.start()
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
        if self.autopilot is not None:
            self.autopilot.start()

    def stop(self) -> None:
        if self.autopilot is not None:
            # the controller goes FIRST: a retune or reshard proposal
            # racing the drain below would act on shards mid-teardown
            self.autopilot.stop()
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
        if self.queue_executor is not None:
            self.queue_executor.stop()

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
        engine.cluster_metadata = self.cluster_metadata
        engine.rebuild_chunk_size = self.rebuild_chunk_size
        engine.device = self.device
        engine.faults = self.faults
        engine.checkpoints = self.checkpoints
        has_standby = bool(self.standby_clusters)
        transfer = TransferQueueProcessor(
            shard, engine, self.matching_client, self.history_client,
            worker_count=self._queue_workers,
            standby_clusters=self.standby_clusters,
            metrics=self.metrics,
            faults=self.faults,
            exhausted_retry_delay_s=self._queue_park_delay_s,
            executor=self.queue_executor,
        )
        timer = TimerQueueProcessor(
            shard, engine, matching=self.matching_client,
            worker_count=self._queue_workers,
            standby_clusters=self.standby_clusters,
            metrics=self.metrics,
            faults=self.faults,
            exhausted_retry_delay_s=self._queue_park_delay_s,
            executor=self.queue_executor,
        )
        processors = [transfer, timer]
        notifiers = [transfer.notify]
        timer_notifiers = [timer.notify]
        local_cluster = (
            self.cluster_metadata.current_cluster_name
            if self.cluster_metadata is not None else ""
        )

        def transfer_handover(level, _t=transfer):
            _t.ack.rewind(level)
            _t.notify()

        def timer_handover(level, _t=timer):
            _t.ack.rewind(level)
            _t.notify()

        for cluster in self.standby_clusters:
            ts = TransferQueueStandbyProcessor(
                shard, engine, cluster, local_cluster=local_cluster,
                on_handover=transfer_handover, metrics=self.metrics,
                faults=self.faults,
                exhausted_retry_delay_s=self._queue_park_delay_s,
                executor=self.queue_executor,
            )
            tm = TimerQueueStandbyProcessor(
                shard, engine, cluster, local_cluster=local_cluster,
                on_handover=timer_handover, metrics=self.metrics,
                faults=self.faults,
                exhausted_retry_delay_s=self._queue_park_delay_s,
                executor=self.queue_executor,
            )
            processors += [ts, tm]
            notifiers.append(ts.notify)
            timer_notifiers.append(tm.notify)
        if has_standby:
            processors.append(QueueGC(
                shard, transfer, timer, self.standby_clusters
            ))
        engine._task_notifier = lambda: [n() for n in notifiers]
        engine._timer_notifier = lambda: [n() for n in timer_notifiers]
        # pull-replication consumers: one per registered source cluster
        # (reference replicationTaskProcessor per shard per remote).
        # AFTER the notifier assignment: touching engine.ndc_replicator
        # materializes it with whatever notifiers exist at that moment
        for cluster, (client, fetcher, transport) in (
            self._replication_sources.items()
        ):
            from .replication import (
                HistoryRereplicator,
                ReplicationTaskProcessor,
            )

            rerepl = HistoryRereplicator(
                client, engine.ndc_replicator, transport=transport,
                metrics=self.metrics,
            )
            rc = self.replication_config
            processors.append(
                ReplicationTaskProcessor(
                    shard, engine.ndc_replicator, fetcher,
                    rereplicator=rerepl, metrics=self.metrics,
                    transport=transport,
                    backoff_max_s=(
                        rc.backoff_max_s if rc is not None else 5.0
                    ),
                )
            )
        for p in processors:
            p.start()
        return _ShardHandle(shard, engine, processors)

    def enable_replication_from(self, cluster: str, client) -> None:
        """Register a remote source cluster's pull client (an in-proc
        adapter or rpc.RemoteClusterRPCClient) BEFORE start(): every
        owned shard then runs a ReplicationTaskProcessor draining that
        cluster's replicator queue (reference replicationTaskFetcher +
        replicationTaskProcessor assembly, service/history/service.go).

        The link also gets one AdaptiveTransport (estimator + mode
        controller, shared across the shards' processors the way the
        fetcher is) unless the `replication:` config disables it."""
        from .replication import ReplicationTaskFetcher
        from .replication.transport import AdaptiveTransport

        rc = self.replication_config
        transport = None
        if rc is None or rc.adaptive:
            transport = AdaptiveTransport(
                client, cluster,
                hysteresis=rc.hysteresis if rc is not None else 1.5,
                min_dwell=rc.min_dwell if rc is not None else 2,
                min_gap_events=(
                    rc.min_gap_events if rc is not None else 32
                ),
                snapshot_bytes_prior=(
                    rc.snapshot_bytes_prior
                    if rc is not None else 64 * 1024.0
                ),
                metrics=self.metrics,
            )
        self._replication_sources[cluster] = (
            client, ReplicationTaskFetcher(cluster, client), transport
        )

    def _on_domain_failover(
        self, domain_id: str, old_cluster: str, new_cluster: str
    ) -> None:
        meta = self.cluster_metadata
        if meta is None or new_cluster != meta.current_cluster_name:
            return
        if old_cluster not in self.standby_clusters:
            return
        with self.controller._lock:
            handles = list(self.controller._handles.values())
        for handle in handles:
            shard = handle.shard
            for p in handle.processors:
                if isinstance(p, TransferQueueProcessor):
                    p.ack.rewind(
                        shard.get_cluster_transfer_ack_level(old_cluster)
                    )
                    p.notify()
                elif isinstance(p, TimerQueueProcessor):
                    p.ack.rewind(
                        (shard.get_cluster_timer_ack_level(old_cluster), 0)
                    )
                    p.notify()
        self._log.info(
            f"domain {domain_id} failed over {old_cluster}->{new_cluster}; "
            "rewound active queue cursors to standby levels"
        )

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

    # -- resharding ----------------------------------------------------

    def reshard_coordinator(self):
        """The host's ONE ReshardCoordinator, built lazily on this
        service's device: the admin verbs and the capacity autopilot
        both call through here, so their plans serialize on the same
        coordinator lock — one plan at a time is a host property, not a
        caller property."""
        with self._resharder_lock:
            if self._resharder is None:
                from .resharding import ReshardCoordinator

                cfg = self.resharding_config
                self._resharder = ReshardCoordinator(
                    self.persistence,
                    [self.controller],
                    metrics=self.metrics,
                    drain_timeout_s=(
                        cfg.drain_timeout_s if cfg is not None else 10.0
                    ),
                    checkpoint_flush=(
                        cfg.checkpoint_flush if cfg is not None else True
                    ),
                    time_source=self._time,
                    device=self.device,
                )
            return self._resharder

    # -- introspection -------------------------------------------------

    def describe(self) -> dict:
        return self.controller.describe()

    def describe_queue_states(self, shard_id: int) -> dict:
        """Per-queue cursor/depth view of one owned shard (reference
        tools/cli/adminQueueCommands.go DescribeQueue): each processor's
        ack level plus in-flight and parked (standby hold) depths — the
        operator view of a wedged ack sweep. Raises KeyError for a
        shard this host doesn't own (AdminHandler maps to 404)."""
        with self.controller._lock:
            handle = self.controller._handles.get(shard_id)
        if handle is None:
            raise KeyError(shard_id)

        def _level(v):
            return list(v) if isinstance(v, tuple) else v

        queues = []
        for p in handle.processors:
            ack = getattr(p, "ack", None)
            if ack is None:
                continue  # e.g. QueueGC / replication consumers
            queues.append({
                "queue": getattr(p, "name", type(p).__name__),
                "ack_level": _level(ack.ack_level),
                "read_level": _level(ack.read_level),
                "outstanding": ack.outstanding(),
                "held": ack.held(),
            })
        return {"shard_id": shard_id, "queues": queues}

    def drain_queues(self, timeout_s: float = 10.0) -> bool:
        """Wait until every owned shard's queues are quiescent (tests)."""
        ok = True
        with self.controller._lock:
            handles = list(self.controller._handles.values())
        for handle in handles:
            for p in handle.processors:
                ok = p.drain(timeout_s) and ok
        return ok

    # -- replication plane ---------------------------------------------
    # Reference: handler.go GetReplicationMessages / ReplicateEventsV2.

    def replicate_events_v2(self, task) -> None:
        engine = self.controller.get_engine(task.workflow_id)
        engine.replicate_events_v2(task)

    def get_replication_messages(
        self, shard_id: int, last_retrieved_id: int, cluster: str,
        max_tasks=None,
    ):
        engine = self.controller.get_engine_for_shard(shard_id)
        return engine.get_replication_messages(
            cluster, last_retrieved_id, max_tasks=max_tasks
        )

    def get_workflow_history_raw(
        self, domain_id: str, workflow_id: str, run_id: str,
        start_event_id: int, end_event_id: int,
    ):
        engine = self.controller.get_engine(workflow_id)
        return engine.get_workflow_history_raw(
            domain_id, workflow_id, run_id, start_event_id, end_event_id
        )

    def get_replication_backlog(
        self, shard_id: int, last_retrieved_id: int
    ):
        engine = self.controller.get_engine_for_shard(shard_id)
        return engine.get_replication_backlog(last_retrieved_id)

    def get_replication_checkpoint(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> bytes:
        engine = self.controller.get_engine(workflow_id)
        return engine.get_replication_checkpoint(
            domain_id, workflow_id, run_id
        )
