"""Onebox: a full cluster in one process.

Reference: host/onebox.go:69 — frontend + matching + history + worker
wired over real persistence with static membership (host/simpleMonitor
.go), the backbone of the reference's integration suite. Used here by
integration tests, the serving demo and the smoke run on the card.

A copy of the reference package's ``testing/onebox.py`` over the port's
modules. ``device`` (default ``"cuda"``, which raises without a card at
the first device replay) is where the ``ResidentEngine`` of
``serving=True`` runs and where the history service's replication planes
rebuild, and where the reshard coordinator that the admin verbs and the
capacity autopilot (``autopilot``) share flushes and warms the moving
workflows. ``queue_parallel`` drives the box's transfer, timer and
standby queues through one ``ParallelQueueExecutor``. ``start_worker``
(default True, as in the reference) starts the worker service on the
system domain at ``start()`` and puts its archival trigger on every
shard's close processor. ``faults`` (a ``testing.faults.FaultSchedule``)
wraps every store of the box, the checkpoint store and the serving
plane's history reads included, and is threaded into the history
service's queues and replication planes; ``sanitize`` installs the
concurrency sanitizer's store probe (pair it with a ``RaceWitness``
installed before the box is built).
"""

from __future__ import annotations

from typing import Optional

from ..client import HistoryClient, MatchingClient
from ..cluster import ClusterMetadata
from ..frontend import (
    AdminHandler,
    DomainHandler,
    WorkflowHandler,
)
from ..matching import MatchingEngine
from ..messaging import MessageBus
from ..runtime.domains import DomainCache
from ..runtime.membership import single_host_monitor
from ..runtime.persistence.memory import create_memory_bundle
from ..runtime.service import HistoryService
from ..visibility import AdvancedVisibilityStore
from ..worker.archiver import ArchivalClient
from ..worker.service import WorkerService


class Onebox:
    def __init__(
        self,
        num_shards: int = 4,
        persistence=None,
        cluster_metadata: Optional[ClusterMetadata] = None,
        host_identity: str = "onebox-0",
        start_worker: bool = True,
        queue_worker_count: int = 4,
        faults=None,
        time_source=None,
        poll_request_id_fn=None,
        checkpoints=None,
        serving=None,
        sanitize: bool = False,
        autopilot=None,
        queue_parallel: int = 0,
        device="cuda",
    ) -> None:
        self.faults = faults
        self.persistence = persistence or create_memory_bundle()
        # every Onebox carries a real metrics scope and a metrics-
        # wrapped bundle: per-store histogram latencies and the
        # persistence hop of request traces are observable in every
        # integration test, not just chaos runs (the MetricsClient's
        # untraced cost is a perf_counter pair per call). Fault
        # injection (chaos mode) additionally installs the fault client
        # innermost; the default path installs no fault machinery.
        from ..runtime.persistence.decorators import wrap_bundle
        from ..utils.metrics import Scope

        # sanitize: the concurrency sanitizer's store probe
        # (RUNTIME-LOCK-BLOCKING) — pair with a RaceWitness installed
        # via utils/locks.wrap_locks BEFORE constructing the box
        self.metrics = Scope()
        self.persistence = wrap_bundle(
            self.persistence, metrics=self.metrics, faults=faults,
            sanitize=sanitize,
        )
        self.bus = MessageBus()
        self.cluster_metadata = cluster_metadata or ClusterMetadata()
        self.domain_handler = DomainHandler(
            self.persistence.metadata, self.cluster_metadata,
            replication_producer=self.bus.new_producer("domain-replication"),
        )
        self.domains = DomainCache(self.persistence.metadata)
        self.monitor = single_host_monitor(host_identity)
        # checkpoints: True builds a CheckpointManager over the bundle's
        # checkpoint store; or pass a ready CheckpointManager;
        # None/False = cold rebuilds
        if checkpoints is True:
            from ..checkpoint import CheckpointManager

            checkpoints = (
                CheckpointManager(self.persistence.checkpoint)
                if self.persistence.checkpoint is not None else None
            )
        self.checkpoints = checkpoints or None
        # serving: True builds a ResidentEngine (continuous-batching
        # resident serving megabatch) on ``device`` over the wrapped
        # history manager + this box's checkpoint plane; or pass a ready
        # ResidentEngine; None/False = serving reads raise
        if serving is True:
            from ..serving import ResidentEngine

            serving = ResidentEngine(
                checkpoints=self.checkpoints,
                history=self.persistence.history,
                metrics=self.metrics,
                device=device,
            )
        self.serving = serving or None
        # queue_parallel > 0: the shared conflict-keyed wave executor
        # (the reference's queues.parallelism gate) over this box's
        # queue pumps. Built from the live footprint table (matrix=None
        # → ConflictMatrix.live()), so it is fresh by construction and
        # never degrades in-process.
        self.queue_executor = None
        if queue_parallel:
            from ..runtime.queues.parallel import ParallelQueueExecutor

            self.queue_executor = ParallelQueueExecutor(
                parallelism=queue_parallel, metrics=self.metrics
            )
        self.history = HistoryService(
            num_shards, self.persistence, self.domains, self.monitor,
            cluster_metadata=self.cluster_metadata,
            queue_worker_count=queue_worker_count,
            metrics=self.metrics,
            faults=faults,
            time_source=time_source,
            checkpoints=self.checkpoints,
            serving=self.serving,
            queue_executor=self.queue_executor,
            device=device,
        )
        self.history_client = HistoryClient(
            self.history.controller, metrics=self.metrics
        )
        # the clock and the poll nonce are the two entropy sources a
        # deterministic run must pin: matching shares history's time
        # source, and poll_request_id_fn replaces the per-poll uuid
        # with a caller-derived id
        self.matching = MatchingEngine(
            self.persistence.task, self.history_client,
            time_source=time_source,
            metrics=self.metrics,
            poll_request_id_fn=poll_request_id_fn,
        )
        self.matching_client = MatchingClient(self.matching)
        self.history.wire(self.matching_client, self.history_client)
        self.visibility = AdvancedVisibilityStore(self.persistence.visibility)
        self.frontend = WorkflowHandler(
            self.domain_handler, self.domains,
            self.history_client, self.matching_client,
            visibility=self.visibility,
            metrics=self.metrics,
        )
        self.admin = AdminHandler(self.history, self.domains, bus=self.bus)
        # autopilot: True builds an in-process CapacityController over
        # this box's registry + shared reshard coordinator (epoch loop
        # starts/stops with the history service); or pass an
        # AutopilotConfig for custom knobs; None/False = manual capacity
        self.autopilot = None
        if autopilot:
            from ..config.static import AutopilotConfig
            from ..runtime.autopilot import CapacityController

            ap_cfg = (
                autopilot if isinstance(autopilot, AutopilotConfig)
                else AutopilotConfig(enabled=True)
            )
            rate_hooks = {}
            initial_rates = {}
            if (self.serving is not None
                    and self.serving.admission_quota_rps() > 0):
                from ..runtime.autopilot import KEY_SERVING_QUOTA_RPS

                rate_hooks[KEY_SERVING_QUOTA_RPS] = (
                    self.serving.retune_admission
                )
                initial_rates[KEY_SERVING_QUOTA_RPS] = (
                    self.serving.admission_quota_rps()
                )
            self.autopilot = self.history.autopilot = CapacityController(
                ap_cfg,
                registry=self.metrics.registry,
                overrides=None,
                rate_hooks=rate_hooks,
                initial_rates=initial_rates,
                resharder=self.history.reshard_coordinator,
                history=self.history,
                monitor=self.monitor,
                metrics=self.metrics,
            )
        self.worker: Optional[WorkerService] = None
        self._start_worker = start_worker
        self._started = False

    def start(self) -> "Onebox":
        if self._started:
            return self
        self.history.start()
        if self._start_worker:
            self.worker = WorkerService(
                self.frontend, self.persistence,
                num_shards=self.history.controller.num_shards,
                bus=self.bus, domain_handler=self.domain_handler,
                history_service=self.history,
            )
            # archival trigger on every shard's close processor
            ArchivalClient(self.frontend, self.domains).attach(self.history)
            self.worker.start()
        self._started = True
        return self

    def stop(self) -> None:
        if self.worker is not None:
            self.worker.stop()
        self.history.stop()
        self.matching.shutdown()
        self.bus.close()
        self._started = False

    def __enter__(self) -> "Onebox":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

