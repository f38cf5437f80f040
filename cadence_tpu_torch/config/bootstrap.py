"""Service bootstrap: config + --services → a running host.

Reference: cmd/server/server.go:207-219 — one process starts only the
requested services; every service resolves its peers through the ring
(bootstrap hosts from config) and the cross-process gRPC plane
(rpc/server.py, client/routed.py). A host running only `frontend`
reaches remote history/matching hosts exactly as the reference's
stateless frontends do.

A copy of the reference package's ``config/bootstrap.py`` over the
port's services, assembled in the same order. ``start_services`` takes
``device`` (default ``"cuda"``): the history service's rebuilds and the
serving section's engine run there. A config whose chaos section is
enabled wraps the persistence bundle in its fault schedule and hands it
to the history service, as the reference does. A host that runs the
history and worker services puts the worker's archival trigger on its
shards' close processors, as the Onebox does; the reference's bootstrap
never did, so its hosts never archived.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .static import SERVICES, ConfigError, ServerConfig


@dataclasses.dataclass
class RunningServer:
    config: ServerConfig
    services: List[str]
    persistence: object
    domains: object
    monitor: object
    frontend: object = None
    admin: object = None
    history: object = None
    matching: object = None
    worker: object = None
    domain_handler: object = None
    history_client: object = None
    matching_client: object = None
    rpc_servers: Dict[str, object] = dataclasses.field(default_factory=dict)
    pprof: object = None
    failure_detector: object = None
    bus: object = None
    # the armed FaultSchedule when the config's chaos section is
    # enabled (operators flip it via faults.arm()/disarm()); None
    # otherwise. `metrics` is the shared Scope whose registry holds
    # faults_injected + the injected-error counters for that run
    faults: object = None
    metrics: object = None
    # CheckpointManager when the checkpoint section is enabled
    checkpoints: object = None
    # serving.ResidentEngine when the serving section is enabled
    # (history hosts only); drained by HistoryService.stop()
    serving: object = None
    # runtime.autopilot.CapacityController when the autopilot section
    # is enabled (history hosts only); stopped by HistoryService.stop()
    autopilot: object = None
    # the programmatic dynamicconfig override layer (InMemoryClient)
    # the autopilot writes rates through; always built so tests and
    # operators can inject overrides live even with autopilot off
    dyncfg_overrides: object = None

    @property
    def addresses(self) -> Dict[str, str]:
        return {name: s.address for name, s in self.rpc_servers.items()}

    def stop(self) -> None:
        if self.failure_detector is not None:
            self.failure_detector.stop()
        if self.pprof is not None:
            self.pprof.stop()
        for s in self.rpc_servers.values():
            s.stop()
        if self.worker is not None:
            self.worker.stop()
        if self.history is not None:
            self.history.stop()
        if self.matching is not None:
            self.matching.shutdown()
        for client in (self.history_client, self.matching_client):
            close = getattr(client, "close", None)
            if close:
                close()


def _build_persistence(cfg: ServerConfig):
    if cfg.persistence.default_store == "sqlite":
        from ..runtime.persistence.sqlite import (
            create_sqlite_bundle,
        )

        return create_sqlite_bundle(
            cfg.persistence.sqlite_path,
            auto_setup=cfg.persistence.auto_setup_schema,
        )
    from ..runtime.persistence.memory import create_memory_bundle

    return create_memory_bundle()


def start_services(
    cfg: ServerConfig,
    services: Optional[List[str]] = None,
    persistence=None,
    device="cuda",
) -> RunningServer:
    """Assemble and start the requested services (default: all) with
    the history host's replays on ``device``."""
    from ..client import (
        RoutedHistoryClient,
        RoutedMatchingClient,
    )
    from ..frontend import (
        AdminHandler,
        DomainHandler,
        WorkflowHandler,
    )
    from ..matching import MatchingEngine
    from ..runtime.domains import DomainCache
    from ..runtime.membership import Monitor
    from ..runtime.service import HistoryService
    from ..rpc.server import (
        FrontendRPCServer,
        HistoryRPCServer,
        MatchingRPCServer,
    )

    services = list(services or SERVICES)
    for s in services:
        if s not in SERVICES:
            raise ConfigError(f"unknown service '{s}'")

    persistence = persistence or _build_persistence(cfg)

    # telemetry section first: one metrics scope per host (registry
    # series cap from telemetry.maxSeries) shared by every service
    # plane, and the process tracer configured before any handler is
    # instrumented (utils/tracing.py; sampleRate 0 = no implicit roots).
    # The persistence bundle is always metrics-wrapped now — per-store
    # histogram latencies and the persistence hop of request traces are
    # a production surface, not a chaos-only one.
    from ..runtime.persistence.decorators import wrap_bundle
    from ..utils.metrics import Registry, Scope

    metrics = Scope(Registry(max_series=cfg.telemetry.max_series))
    cfg.telemetry.apply(metrics=metrics)

    # chaos section: fault-inject the whole persistence bundle before
    # anything else sees it, so every service plane on this host runs
    # against the same deterministic fault stream. The schedule, the
    # persistence decorators, and the history service share ONE metrics
    # scope so faults_injected and the injected-error counters land in
    # the same registry operators already read (metrics_defs.py
    # FAULT_METRICS promise)
    faults = None
    if cfg.chaos.enabled:
        faults = cfg.chaos.build_schedule(metrics=metrics)
    persistence = wrap_bundle(persistence, metrics=metrics, faults=faults)

    # checkpoint section: incremental-replay snapshots over the
    # bundle's checkpoint store. Built AFTER the chaos wrap, so a
    # chaos config's persistence.checkpoint rules fault-inject every
    # snapshot read/write this host performs (fallback: full replay)
    checkpoints = cfg.checkpoint.build_manager(
        store=getattr(persistence, "checkpoint", None)
    )

    # serving section: the continuous-batching resident engine over
    # the (chaos-wrapped) history manager + checkpoint plane — history
    # hosts only, since only they see the persist feed
    serving = None
    if "history" in services:
        serving = cfg.serving.build_engine(
            checkpoints=checkpoints,
            history=getattr(persistence, "history", None),
            metrics=metrics,
            device=device,
        )

    domains = DomainCache(persistence.metadata)
    cluster_metadata = cfg.build_cluster_metadata()

    # dynamic config: a programmatic override layer (the autopilot's
    # rate actuator — and the operator's live-injection surface) over
    # the file-watched base when configured (ref cmd/server wiring of
    # dynamicconfig fileBasedClient)
    from ..utils.dynamicconfig import (
        Collection,
        FileBasedClient,
        InMemoryClient,
        LayeredClient,
    )

    dyncfg_overrides = InMemoryClient()
    dyncfg = Collection(LayeredClient(
        dyncfg_overrides,
        FileBasedClient(cfg.dynamicconfig_path)
        if cfg.dynamicconfig_path else None,
    ))

    # the host's ring identity per service is its rpc bind address;
    # bootstrap hosts from config pre-populate the rings so a partial
    # host set still routes to its peers
    def addr(service: str) -> str:
        sc = cfg.services.get(service)
        return sc.rpc_address if sc else "127.0.0.1:0"

    monitor = Monitor(self_identity=addr("history"))
    for service, hosts in cfg.ring.bootstrap_hosts.items():
        monitor.resolver(service).set_hosts(list(hosts))
    for service in services:
        monitor.join(service, addr(service))

    # failure detection (SWIM stand-in): probe ring peers, evict the
    # dead, let the shard controller rebalance (ref rpMonitor.go:44)
    failure_detector = None
    if cfg.ring.probe_interval_seconds > 0:
        from ..rpc.client import grpc_ping
        from ..runtime.membership import FailureDetector

        failure_detector = FailureDetector(
            monitor, grpc_ping,
            own_identities={addr(s) for s in services},
            probe_interval_s=cfg.ring.probe_interval_seconds,
            failure_threshold=cfg.ring.failure_threshold,
        ).start()

    from ..messaging import MessageBus

    out = RunningServer(
        config=cfg, services=services, persistence=persistence,
        domains=domains, monitor=monitor,
        failure_detector=failure_detector,
        # messaging plane exists only where the worker runs: a bus on a
        # frontend/history-only host would make `admin dlq` report an
        # always-empty queue instead of "no message bus on this host"
        bus=MessageBus() if "worker" in services else None,
        faults=faults,
        metrics=metrics,
        checkpoints=checkpoints,
        serving=serving,
        dyncfg_overrides=dyncfg_overrides,
    )
    # one diagnostics endpoint per process (common/pprof.go Start):
    # first configured service's port wins, bound on that service's
    # rpc host (a container binding rpc on 0.0.0.0 wants pprof there
    # too). Diagnostics are non-essential: a bind failure logs and the
    # service plane boots without them, as the reference does.
    for s in services:
        sc = cfg.services.get(s)
        if sc is not None and sc.pprof_port:
            from ..utils.log import get_logger
            from ..utils.pprof import PProfServer

            host = sc.rpc_address.rsplit(":", 1)[0] or "127.0.0.1"
            try:
                out.pprof = PProfServer(
                    port=sc.pprof_port, host=host, device=device
                ).start()
            except OSError as e:
                get_logger("cadence_tpu_torch.pprof").warn(
                    f"pprof endpoint {host}:{sc.pprof_port} failed to "
                    f"bind ({e}); continuing without diagnostics"
                )
            break
    out.domain_handler = DomainHandler(
        persistence.metadata, cluster_metadata
    )

    # overload control: service-level limiters beyond the
    # frontend's. Domain rates read the dynamicconfig property per
    # call, so a file-watched edit takes effect live; the defaults are
    # effectively-unlimited (the limiter then never sheds)
    from ..utils.quotas import MultiStageRateLimiter

    history_domain_rps = dyncfg.float_property(
        "history.domainRps", 100000.0
    )
    history_limiter = MultiStageRateLimiter(
        global_rps=dyncfg.float_property("history.rps", 100000.0)(),
        domain_rps=lambda _d: history_domain_rps(),
    )
    matching_domain_rps = dyncfg.float_property(
        "matching.domainRps", 100000.0
    )
    matching_limiter = MultiStageRateLimiter(
        global_rps=dyncfg.float_property("matching.rps", 100000.0)(),
        domain_rps=lambda _d: matching_domain_rps(),
    )

    history = None
    if "history" in services:
        # parallel queue execution (config `queues:` section): one
        # shared conflict-keyed wave executor per host, or None when
        # queues.parallelism is 0 (sequential per-queue pumps). A stale
        # matrix artifact degrades the executor loudly to sequential —
        # it never blocks boot.
        queue_executor = cfg.queues.build_executor(metrics=metrics)
        history = HistoryService(
            cfg.persistence.num_history_shards, persistence, domains,
            monitor, cluster_metadata=cluster_metadata,
            # pass the property itself: the file-watched client then
            # serves runtime edits, not a boot-time snapshot
            rebuild_chunk_size=dyncfg.int_property(
                "history.rebuildChunkSize", 0
            ),
            faults=faults,
            metrics=metrics,
            checkpoints=checkpoints,
            serving=serving,
            rate_limiter=history_limiter,
            queue_executor=queue_executor,
            device=device,
        )
        # admin reshard verbs read the section off the service
        history.resharding_config = cfg.resharding
        # adaptive geo-replication knobs for the pull processors
        # (consumed by enable_replication_from / _build_shard)
        history.replication_config = cfg.replication
        out.history = history

        # capacity autopilot (config `autopilot:` section): closed-loop
        # retuning of the limiters above + reshard proposals through
        # the host's shared coordinator. Built BEFORE history.start()
        # (which starts its epoch loop); only the membership-elected
        # host actuates, so every history host wires one identically
        if cfg.autopilot.enabled:
            from ..runtime.autopilot import (
                KEY_HISTORY_DOMAIN_RPS,
                KEY_HISTORY_RPS,
                KEY_MATCHING_RPS,
                KEY_SERVING_QUOTA_RPS,
                CapacityController,
            )

            rate_hooks = {
                KEY_HISTORY_RPS: history_limiter.set_global_rate,
                KEY_MATCHING_RPS: matching_limiter.set_global_rate,
            }
            initial_rates = {
                KEY_HISTORY_RPS: history_limiter.global_rps,
                KEY_MATCHING_RPS: matching_limiter.global_rps,
                # domain rps needs no hook: the limiters re-read the
                # dynamicconfig property per call, and the override
                # layer shadows the file live
                KEY_HISTORY_DOMAIN_RPS: history_domain_rps(),
            }
            if serving is not None and serving.admission_quota_rps() > 0:
                # an unmetered quota (0) stays unmetered: minting a
                # finite cap where the operator set none is a semantic
                # change, not a retune
                rate_hooks[KEY_SERVING_QUOTA_RPS] = (
                    serving.retune_admission
                )
                initial_rates[KEY_SERVING_QUOTA_RPS] = (
                    serving.admission_quota_rps()
                )
            out.autopilot = history.autopilot = CapacityController(
                cfg.autopilot,
                registry=metrics.registry,
                overrides=dyncfg_overrides,
                rate_hooks=rate_hooks,
                initial_rates=initial_rates,
                resharder=(
                    history.reshard_coordinator
                    if cfg.resharding.enabled else None
                ),
                history=history,
                monitor=monitor,
                metrics=metrics,
            )

    hc = RoutedHistoryClient(
        monitor,
        history.controller if history else None,
        num_shards=cfg.persistence.num_history_shards,
        # the host scope: retry_budget_exhausted (layer=client) — the
        # retry-storm breaker firing — must land in the registry
        # operators actually scrape, not NOOP
        metrics=metrics,
    )
    out.history_client = hc

    matching = None
    if "matching" in services:
        matching = MatchingEngine(
            persistence.task, hc, config=dyncfg, metrics=metrics,
            rate_limiter=matching_limiter,
        )
        out.matching = matching
    mc = RoutedMatchingClient(
        monitor, matching, local_identity=addr("matching")
    )
    out.matching_client = mc

    if history is not None:
        history.wire(mc, hc)
        history.start()
        out.rpc_servers["history"] = HistoryRPCServer(
            history, address=addr("history")
        ).start()
    if matching is not None:
        out.rpc_servers["matching"] = MatchingRPCServer(
            matching, address=addr("matching")
        ).start()

    if "frontend" in services:
        visibility = None
        if persistence.visibility is not None:
            from ..visibility import AdvancedVisibilityStore

            visibility = AdvancedVisibilityStore(persistence.visibility)
        out.frontend = WorkflowHandler(
            out.domain_handler, domains, hc, mc, visibility=visibility,
            metrics=metrics,
        )
        out.admin = (
            AdminHandler(history, domains, bus=out.bus)
            if history is not None else None
        )
        out.rpc_servers["frontend"] = FrontendRPCServer(
            out.frontend, out.admin, address=addr("frontend")
        ).start()

    if "worker" in services:
        from ..worker.service import WorkerService

        worker_frontend = out.frontend
        if worker_frontend is None:
            # worker-only host: drive system workflows through a REMOTE
            # frontend (the reference's worker runs against the public
            # API, service/worker/service.go)
            fe_addr = addr("frontend")
            if fe_addr.endswith(":0"):
                raise ConfigError(
                    "worker without a local frontend needs "
                    "services.frontend.rpcAddress pointing at a "
                    "frontend host"
                )
            from ..rpc.client import RemoteFrontend

            worker_frontend = RemoteFrontend(fe_addr)
        out.worker = WorkerService(
            worker_frontend, persistence,
            num_shards=cfg.persistence.num_history_shards,
            bus=out.bus,
            domain_handler=out.domain_handler,
            history_service=history,
        )
        if history is not None:
            # archival trigger on every owned shard's close processor,
            # as the Onebox wires it: without it a closed run of an
            # archiving domain never reaches the archive (ROADMAP C.5)
            from ..worker.archiver import ArchivalClient

            ArchivalClient(worker_frontend, domains).attach(history)
        out.worker.start()

    return out
