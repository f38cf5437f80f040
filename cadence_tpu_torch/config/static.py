"""YAML config structs + loader.

Reference: common/service/config/config.go — the static (per-env YAML)
half of the config system; the hot-reload half is
utils/dynamicconfig.py. Unknown keys are rejected so a typo'd config
fails at boot, matching the reference's strict yaml decoding.

A copy of the reference package's ``config/static.py``, with the same
keys, checks and error text, and one departure: the device the serving
engine runs on is no config key (``config.bootstrap.start_services``
hands its ``device`` to ``ServingConfig.build_engine``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

SERVICES = ("frontend", "history", "matching", "worker")


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class PersistenceConfig:
    """ref config.go Persistence: defaultStore + numHistoryShards; the
    datastore plugins here are 'memory' and 'sqlite'."""

    default_store: str = "memory"        # memory | sqlite
    sqlite_path: str = ""                # required for sqlite
    num_history_shards: int = 4
    # True (dev/onebox): bring the schema to current at boot.
    # False (production): boot REFUSES to start unless the database is
    # already at this build's schema version — the operator runs
    # `cadence-tpu schema update` explicitly (ref cmd/server/cadence.go:66)
    auto_setup_schema: bool = True

    def validate(self) -> None:
        if self.default_store not in ("memory", "sqlite"):
            raise ConfigError(
                f"persistence.default_store: unknown store "
                f"'{self.default_store}'"
            )
        if self.default_store == "sqlite" and not self.sqlite_path:
            raise ConfigError("persistence.sqlite_path required for sqlite")
        if self.num_history_shards < 1:
            raise ConfigError("persistence.num_history_shards must be >= 1")


@dataclasses.dataclass
class ServiceConfig:
    """ref config.go Service{RPC, Metrics, PProf} — the rpc bind
    address doubles as the host's ring identity."""

    rpc_address: str = "127.0.0.1:0"
    # ref config.go Service.PProf.Port: 0 = diagnostics endpoint off
    pprof_port: int = 0


@dataclasses.dataclass
class RingConfig:
    """ref config.go Ringpop (bootstrapHosts): static host lists per
    service ring; identities are dial addresses. The failure detector
    (membership.FailureDetector, SWIM stand-in) probes ring peers and
    evicts dead hosts; interval 0 disables it."""

    bootstrap_hosts: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict
    )
    probe_interval_seconds: float = 1.0
    failure_threshold: int = 3


@dataclasses.dataclass
class ClusterEntry:
    initial_failover_version: int = 0
    enabled: bool = True
    rpc_address: str = ""


@dataclasses.dataclass
class ClusterConfig:
    """ref config.go ClusterMetadata."""

    enable_global_domain: bool = False
    failover_version_increment: int = 10
    master_cluster_name: str = ""
    current_cluster_name: str = ""
    cluster_info: Dict[str, ClusterEntry] = dataclasses.field(
        default_factory=dict
    )

    def validate(self) -> None:
        if not self.cluster_info:
            return
        for name in (self.master_cluster_name, self.current_cluster_name):
            if name and name not in self.cluster_info:
                raise ConfigError(
                    f"clusterMetadata: cluster '{name}' not in cluster_info"
                )


@dataclasses.dataclass
class ChaosConfig:
    """Deterministic fault injection (testing/faults.py), config-armed.

    ``rules`` are FaultRule field dicts (site/method patterns, shard
    pin, probability, after_calls/max_faults window, action, error,
    latency_s). Same seed + same workload → same fault sequence. OFF by
    default, and when off the fault decorator is never even installed —
    a production config pays nothing for this section existing."""

    enabled: bool = False
    seed: int = 0
    rules: List[Dict] = dataclasses.field(default_factory=list)

    def validate(self) -> None:
        if not self.enabled and not self.rules:
            return
        try:
            self.build_schedule(force=True)
        except (ValueError, TypeError) as e:
            raise ConfigError(f"chaos.rules: {e}")

    def build_schedule(self, metrics=None, force: bool = False):
        """The FaultSchedule this section describes, or None when
        disabled (``force`` builds regardless — validation)."""
        if not self.enabled and not force:
            return None
        from ..testing.faults import FaultSchedule
        from ..utils.metrics import NOOP

        return FaultSchedule.from_dicts(
            self.rules, seed=self.seed, metrics=metrics or NOOP
        )


@dataclasses.dataclass
class QueuesConfig:
    """Parallel queue execution (runtime/queues/parallel.py).

    ``parallelism`` > 0 replaces the per-queue sequential pump threads
    with one shared ParallelQueueExecutor draining every owned shard's
    transfer/timer queues in conflict-keyed waves of at most that many
    concurrent groups. 0 (the default) keeps the sequential pumps —
    the gate is OFF unless a config opts in. ``matrixPath`` names the
    commutativity-matrix artifact (``scripts/run_lint.sh`` regenerates
    it); empty uses the live in-process footprint table. A stale or
    missing artifact degrades loudly to sequential scheduling
    (``parqueue_matrix_stale``)."""

    parallelism: int = 0
    batch_size: int = 64
    poll_interval_ms: int = 50
    matrix_path: str = ""

    def validate(self) -> None:
        if self.parallelism < 0:
            raise ConfigError("queues.parallelism must be >= 0")
        if self.batch_size <= 0:
            raise ConfigError("queues.batchSize must be > 0")
        if self.poll_interval_ms <= 0:
            raise ConfigError("queues.pollIntervalMs must be > 0")

    def build_executor(self, metrics=None):
        """The ParallelQueueExecutor this section describes, or None
        when the gate is off (sequential pumps)."""
        if self.parallelism <= 0:
            return None
        from ..runtime.queues.parallel import (
            ParallelQueueExecutor,
        )

        return ParallelQueueExecutor(
            parallelism=self.parallelism,
            batch_size=self.batch_size,
            poll_interval_s=self.poll_interval_ms / 1000.0,
            matrix_path=self.matrix_path or None,
            metrics=metrics,
        )


@dataclasses.dataclass
class CheckpointConfig:
    """Checkpointed incremental replay (cadence_tpu/checkpoint/).

    When enabled, every history shard's state rebuilder resumes replays
    from the nearest durable snapshot and writes fresh ones —
    ``everyEvents`` sets the snapshot cadence (a new one only when the
    run tip advanced that many events), ``keepLast`` the per-run-tree
    retention. The store rides the persistence bundle (memory or
    sqlite, matching the configured datastore), so chaos rules on
    ``persistence.checkpoint`` exercise the full-replay fallback. OFF
    by default: a disabled section builds nothing."""

    enabled: bool = False
    every_events: int = 256
    keep_last: int = 2

    def validate(self) -> None:
        try:
            self._policy()
        except ValueError as e:
            raise ConfigError(f"checkpoint: {e}")

    def _policy(self):
        from ..checkpoint import CheckpointPolicy

        policy = CheckpointPolicy(
            every_events=self.every_events, keep_last=self.keep_last
        )
        policy.validate()
        return policy

    def build_manager(self, store=None):
        """The CheckpointManager this section describes, or None when
        disabled. ``store``: the persistence bundle's checkpoint store
        (falls back to a fresh in-memory store)."""
        if not self.enabled:
            return None
        from ..checkpoint import (
            CheckpointManager,
            MemoryCheckpointStore,
        )

        return CheckpointManager(
            store if store is not None else MemoryCheckpointStore(),
            policy=self._policy(),
        )


@dataclasses.dataclass
class ServingConfig:
    """Continuous-batching serving engine (cadence_tpu/serving/).

    When enabled, the history service keeps hot workflows' state rows
    resident in a fixed-``lanes`` device tensor: every persisted event
    batch marks the lane behind (O(1) on the persist path), the next
    serving tick composes just the Δ suffix through the assoc affine
    algebra, and serving reads answer from the resident row with no
    replay. ``idleTicks`` is the LRU eviction horizon (a lane untouched
    that many ticks flushes back through the checkpoint plane and its
    slot is recycled for the admission queue). OFF by default: a
    disabled section builds nothing and the persist path pays nothing.
    """

    enabled: bool = False
    lanes: int = 64
    idle_ticks: int = 256
    # overload control plane: the fair-admission refill —
    # per-domain base weights (missing domains use defaultWeight),
    # a per-domain refill quota (tokens/sec + burst; 0 = unmetered),
    # the deadline-aging boost (priority per refill round parked —
    # the starvation-free guarantee), and the age at which an aged bid
    # bypasses its domain quota entirely
    domain_weights: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    default_weight: float = 1.0
    quota_rps: float = 0.0
    quota_burst: int = 0
    aging_boost: float = 1.0
    starvation_recycles: int = 8
    # the background tick pump's cadence (ms); 0 disables the pump and
    # ticks ride reads/appends as before — write-heavy lanes then have
    # no staleness bound. NOTE: with a pump, ``idleTicks`` acquires a
    # wall-clock meaning — an untouched lane evicts after roughly
    # idleTicks × tickIntervalMs, so size the pair together
    tick_interval_ms: float = 0.0

    def validate(self) -> None:
        # validation is INLINE (mirroring AdmissionPolicy.validate) on
        # purpose: importing the serving package here would pull the
        # engine and its kernel loaders into every process that merely
        # loads a config — including frontend/matching-only hosts that
        # never build an engine
        if self.lanes < 1:
            raise ConfigError("serving.lanes must be >= 1")
        if self.idle_ticks < 1:
            raise ConfigError("serving.idleTicks must be >= 1")
        if self.tick_interval_ms < 0:
            raise ConfigError("serving.tickIntervalMs must be >= 0")
        if self.default_weight <= 0:
            raise ConfigError("serving.defaultWeight must be > 0")
        for dom, w in self.domain_weights.items():
            if w <= 0:
                raise ConfigError(
                    f"serving.domainWeights['{dom}'] must be > 0"
                )
        if self.quota_rps < 0 or self.quota_burst < 0:
            raise ConfigError("serving: negative quota")
        if self.aging_boost <= 0:
            raise ConfigError("serving.agingBoost must be > 0")
        if self.starvation_recycles < 1:
            raise ConfigError(
                "serving.starvationRecycles must be >= 1"
            )

    def _admission_policy(self):
        from ..serving import AdmissionPolicy

        policy = AdmissionPolicy(
            domain_weights=dict(self.domain_weights),
            default_weight=self.default_weight,
            quota_rps=self.quota_rps,
            quota_burst=self.quota_burst,
            aging_boost=self.aging_boost,
            starvation_recycles=self.starvation_recycles,
        )
        policy.validate()
        return policy

    def build_engine(self, checkpoints=None, history=None, metrics=None,
                     device="cuda"):
        """The ResidentEngine this section describes, or None when
        disabled. ``checkpoints``/``history``: the host's
        CheckpointManager (eviction flush + resume seeding; may be
        None) and the persistence bundle's history manager (admission
        reads + the persist-feed catch-up). ``device``: where the
        engine's lanes live and its replay kernel runs."""
        if not self.enabled:
            return None
        from ..serving import ResidentEngine

        return ResidentEngine(
            lanes=self.lanes, idle_ticks=self.idle_ticks,
            checkpoints=checkpoints, history=history, metrics=metrics,
            admission=self._admission_policy(),
            tick_interval_s=self.tick_interval_ms / 1e3,
            device=device,
        )


@dataclasses.dataclass
class ReshardingConfig:
    """Elastic resharding (runtime/resharding.py).

    ``drainTimeoutSeconds`` bounds the fence-drain step of a handoff —
    a shard whose queues cannot quiesce in time rolls the whole
    reconfiguration back. ``checkpointFlush`` ships ReplayCheckpoint
    snapshots to the new owner (suffix-only replay); off, the new owner
    cold-rebuilds from the execution store (still correct, just cold).
    Enabled by default: the coordinator only runs on explicit admin
    verbs, so an idle section costs nothing."""

    enabled: bool = True
    drain_timeout_s: float = 10.0
    checkpoint_flush: bool = True

    def validate(self) -> None:
        if self.drain_timeout_s <= 0:
            raise ConfigError(
                "resharding.drainTimeoutSeconds must be > 0"
            )


@dataclasses.dataclass
class ReplicationConfig:
    """Bandwidth-adaptive geo-replication (runtime/replication/
    transport.py).

    ``adaptive`` gates the whole transport: off, the consumer is the
    pre-adaptive pure event-stream puller. ``hysteresis``/``minDwell``
    damp the event-vs-snapshot mode controller (a switch requires the
    challenger to win the cost model by the factor, that many decisions
    in a row); ``minGapEvents`` floors the gap a snapshot may ever ship
    for; ``snapshotBytesPrior`` seeds the cost model before the first
    observed snapshot transfer. ``backoffMaxSeconds`` caps the pump's
    jittered exponential retry backoff on failed cycles."""

    adaptive: bool = True
    hysteresis: float = 1.5
    min_dwell: int = 2
    min_gap_events: int = 32
    snapshot_bytes_prior: float = 64 * 1024.0
    backoff_max_s: float = 5.0

    def validate(self) -> None:
        if self.hysteresis < 1.0:
            raise ConfigError("replication.hysteresis must be >= 1.0")
        if self.min_dwell < 1:
            raise ConfigError("replication.minDwell must be >= 1")
        if self.min_gap_events < 1:
            raise ConfigError("replication.minGapEvents must be >= 1")
        if self.snapshot_bytes_prior <= 0:
            raise ConfigError(
                "replication.snapshotBytesPrior must be > 0"
            )
        if self.backoff_max_s <= 0:
            raise ConfigError(
                "replication.backoffMaxSeconds must be > 0"
            )


@dataclasses.dataclass
class AutopilotConfig:
    """Capacity autopilot (runtime/autopilot.py) — closed-loop control
    from admission rates to shard topology.

    Off by default: the controller only ever runs when an operator
    turns the section on. ``targetP99Ms``/``targetShedFrac`` are the
    setpoints pressure is measured against; ``hysteresis``/``minDwell``
    damp the overload gate (challenger-must-win, like replication's
    mode controller); ``maxStepFrac`` bounds how far any rate moves per
    epoch; ``headroomFrac`` is the margin rates keep above observed
    load when healthy. ``cooldownEpochs``/``reshardCooldownEpochs``
    space actuations per plane; ``guardrailWindowEpochs``/
    ``guardrailRegression``/``freezeEpochs`` shape the do-no-harm
    freeze (p99 regressing past the factor after our own recent actions
    reverts to last-known-good and stops actuating). Shard heuristics:
    a shard is hot when its queue depth is ≥ ``hotShardDepth`` AND
    ``hotShardFactor`` × the mean; a pair is mergeable when both sit
    ≤ ``coldShardFrac`` × the mean. ``backoffMaxSeconds`` caps both the
    epoch loop's error backoff and the reshard-failure proposal block
    (a failed plan is never hot-retried)."""

    enabled: bool = False
    epoch_interval_s: float = 5.0
    target_p99_ms: float = 250.0
    target_shed_frac: float = 0.05
    max_step_frac: float = 0.25
    headroom_frac: float = 0.5
    ewma_alpha: float = 0.4
    hysteresis: float = 1.25
    min_dwell: int = 2
    cooldown_epochs: int = 2
    reshard_cooldown_epochs: int = 4
    max_plans_per_epoch: int = 2
    min_rps: float = 10.0
    max_rps: float = 1e6
    min_shards: int = 1
    max_shards: int = 64
    hot_shard_depth: int = 64
    hot_shard_factor: float = 4.0
    cold_shard_frac: float = 0.25
    guardrail_window: int = 3
    guardrail_regression: float = 1.5
    freeze_epochs: int = 4
    backoff_max_s: float = 60.0

    def validate(self) -> None:
        if self.epoch_interval_s <= 0:
            raise ConfigError(
                "autopilot.epochIntervalSeconds must be > 0"
            )
        if self.target_p99_ms <= 0:
            raise ConfigError("autopilot.targetP99Ms must be > 0")
        if not 0.0 < self.target_shed_frac <= 1.0:
            raise ConfigError(
                "autopilot.targetShedFrac must be in (0, 1]"
            )
        if not 0.0 < self.max_step_frac < 1.0:
            raise ConfigError(
                "autopilot.maxStepFrac must be in (0, 1)"
            )
        if self.headroom_frac < 0:
            raise ConfigError("autopilot.headroomFrac must be >= 0")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ConfigError("autopilot.ewmaAlpha must be in (0, 1]")
        if self.hysteresis < 1.0:
            raise ConfigError("autopilot.hysteresis must be >= 1.0")
        if self.min_dwell < 1:
            raise ConfigError("autopilot.minDwell must be >= 1")
        if self.cooldown_epochs < 0 or self.reshard_cooldown_epochs < 0:
            raise ConfigError("autopilot: negative cooldown")
        if self.max_plans_per_epoch < 1:
            raise ConfigError(
                "autopilot.maxPlansPerEpoch must be >= 1"
            )
        if not 0 < self.min_rps <= self.max_rps:
            raise ConfigError(
                "autopilot: need 0 < minRps <= maxRps"
            )
        if not 1 <= self.min_shards <= self.max_shards:
            raise ConfigError(
                "autopilot: need 1 <= minShards <= maxShards"
            )
        if self.hot_shard_depth < 1:
            raise ConfigError("autopilot.hotShardDepth must be >= 1")
        if self.hot_shard_factor < 1.0:
            raise ConfigError(
                "autopilot.hotShardFactor must be >= 1.0"
            )
        if not 0.0 <= self.cold_shard_frac < 1.0:
            raise ConfigError(
                "autopilot.coldShardFrac must be in [0, 1)"
            )
        if self.guardrail_window < 1:
            raise ConfigError(
                "autopilot.guardrailWindowEpochs must be >= 1"
            )
        if self.guardrail_regression <= 1.0:
            raise ConfigError(
                "autopilot.guardrailRegression must be > 1.0"
            )
        if self.freeze_epochs < 1:
            raise ConfigError("autopilot.freezeEpochs must be >= 1")
        if self.backoff_max_s <= 0:
            raise ConfigError(
                "autopilot.backoffMaxSeconds must be > 0"
            )


@dataclasses.dataclass
class TelemetryConfig:
    """Unified telemetry plane (utils/tracing.py + utils/metrics.py).

    ``sampleRate`` is the probability an RPC endpoint roots a new trace
    for a request that arrived without one (0.0, the default, disables
    implicit roots entirely — explicitly started traces still record);
    ``traceCapacity`` bounds the flight-recorder ring buffer (spans);
    ``maxSeries`` caps per-registry metric-series cardinality (overflow
    collapses into the ``overflow="true"`` sink and bumps
    ``metrics_dropped_series``). The unsampled path stays a thread-local
    read — the bench ``telemetry_overhead`` guard pins it at ≤3%."""

    sample_rate: float = 0.0
    trace_capacity: int = 4096
    max_series: int = 8192

    def validate(self) -> None:
        if not 0.0 <= self.sample_rate <= 1.0:
            raise ConfigError("telemetry.sampleRate must be in [0, 1]")
        if self.trace_capacity < 1:
            raise ConfigError("telemetry.traceCapacity must be >= 1")
        if self.max_series < 1:
            raise ConfigError("telemetry.maxSeries must be >= 1")

    def apply(self, metrics=None):
        """Configure the process tracer from this section; returns it."""
        from ..utils.tracing import configure

        return configure(
            sample_rate=self.sample_rate, capacity=self.trace_capacity,
            metrics=metrics,
        )


@dataclasses.dataclass
class ServerConfig:
    persistence: PersistenceConfig = dataclasses.field(
        default_factory=PersistenceConfig
    )
    services: Dict[str, ServiceConfig] = dataclasses.field(
        default_factory=lambda: {s: ServiceConfig() for s in SERVICES}
    )
    ring: RingConfig = dataclasses.field(default_factory=RingConfig)
    cluster: ClusterConfig = dataclasses.field(default_factory=ClusterConfig)
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)
    checkpoint: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )
    serving: ServingConfig = dataclasses.field(
        default_factory=ServingConfig
    )
    resharding: ReshardingConfig = dataclasses.field(
        default_factory=ReshardingConfig
    )
    replication: ReplicationConfig = dataclasses.field(
        default_factory=ReplicationConfig
    )
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig
    )
    autopilot: AutopilotConfig = dataclasses.field(
        default_factory=AutopilotConfig
    )
    queues: QueuesConfig = dataclasses.field(default_factory=QueuesConfig)
    dynamicconfig_path: str = ""
    archival_dir: str = ""

    def validate(self) -> None:
        self.persistence.validate()
        self.cluster.validate()
        self.chaos.validate()
        self.checkpoint.validate()
        self.serving.validate()
        self.resharding.validate()
        self.replication.validate()
        self.telemetry.validate()
        self.autopilot.validate()
        self.queues.validate()
        for name in self.services:
            if name not in SERVICES:
                raise ConfigError(f"services: unknown service '{name}'")

    def build_cluster_metadata(self):
        """ClusterMetadata from the config, or None (single cluster)."""
        if not self.cluster.cluster_info:
            return None
        from ..cluster import ClusterInformation, ClusterMetadata

        return ClusterMetadata(
            enable_global_domain=self.cluster.enable_global_domain,
            failover_version_increment=(
                self.cluster.failover_version_increment
            ),
            master_cluster_name=self.cluster.master_cluster_name,
            current_cluster_name=self.cluster.current_cluster_name,
            cluster_info={
                name: ClusterInformation(
                    initial_failover_version=e.initial_failover_version,
                    enabled=e.enabled,
                    rpc_address=e.rpc_address,
                )
                for name, e in self.cluster.cluster_info.items()
            },
        )


def _take(d: dict, allowed: Dict[str, object], where: str) -> dict:
    out = {}
    for k, v in d.items():
        if k not in allowed:
            raise ConfigError(f"{where}: unknown key '{k}'")
        out[allowed[k]] = v  # type: ignore[index]
    return out


def load_config_dict(raw: dict) -> ServerConfig:
    import copy

    cfg = ServerConfig()
    # deep copy: parsing pops nested keys and must not mutate the
    # caller's dict (a shared dict may build several hosts' configs)
    raw = copy.deepcopy(raw or {})

    p = raw.pop("persistence", None)
    if p:
        cfg.persistence = PersistenceConfig(**_take(p, {
            "defaultStore": "default_store",
            "sqlitePath": "sqlite_path",
            "numHistoryShards": "num_history_shards",
            "autoSetupSchema": "auto_setup_schema",
        }, "persistence"))

    services = raw.pop("services", None)
    if services is not None:
        cfg.services = {}
        for name, sc in (services or {}).items():
            cfg.services[name] = ServiceConfig(**_take(sc or {}, {
                "rpcAddress": "rpc_address",
                "pprofPort": "pprof_port",
            }, f"services.{name}"))

    ring = raw.pop("ring", None)
    if ring:
        cfg.ring = RingConfig(**_take(ring, {
            "bootstrapHosts": "bootstrap_hosts",
            "probeIntervalSeconds": "probe_interval_seconds",
            "failureThreshold": "failure_threshold",
        }, "ring"))

    cm = raw.pop("clusterMetadata", None)
    if cm:
        info = cm.pop("clusterInformation", {}) or {}
        cfg.cluster = ClusterConfig(**_take(cm, {
            "enableGlobalDomain": "enable_global_domain",
            "failoverVersionIncrement": "failover_version_increment",
            "masterClusterName": "master_cluster_name",
            "currentClusterName": "current_cluster_name",
        }, "clusterMetadata"))
        cfg.cluster.cluster_info = {
            name: ClusterEntry(**_take(e or {}, {
                "initialFailoverVersion": "initial_failover_version",
                "enabled": "enabled",
                "rpcAddress": "rpc_address",
            }, f"clusterMetadata.clusterInformation.{name}"))
            for name, e in info.items()
        }

    chaos = raw.pop("chaos", None)
    if chaos:
        cfg.chaos = ChaosConfig(**_take(chaos, {
            "enabled": "enabled",
            "seed": "seed",
            "rules": "rules",
        }, "chaos"))

    ckpt = raw.pop("checkpoint", None)
    if ckpt:
        cfg.checkpoint = CheckpointConfig(**_take(ckpt, {
            "enabled": "enabled",
            "everyEvents": "every_events",
            "keepLast": "keep_last",
        }, "checkpoint"))

    srv = raw.pop("serving", None)
    if srv:
        cfg.serving = ServingConfig(**_take(srv, {
            "enabled": "enabled",
            "lanes": "lanes",
            "idleTicks": "idle_ticks",
            "domainWeights": "domain_weights",
            "defaultWeight": "default_weight",
            "quotaRps": "quota_rps",
            "quotaBurst": "quota_burst",
            "agingBoost": "aging_boost",
            "starvationRecycles": "starvation_recycles",
            "tickIntervalMs": "tick_interval_ms",
        }, "serving"))

    rsh = raw.pop("resharding", None)
    if rsh:
        cfg.resharding = ReshardingConfig(**_take(rsh, {
            "enabled": "enabled",
            "drainTimeoutSeconds": "drain_timeout_s",
            "checkpointFlush": "checkpoint_flush",
        }, "resharding"))

    repl = raw.pop("replication", None)
    if repl:
        cfg.replication = ReplicationConfig(**_take(repl, {
            "adaptive": "adaptive",
            "hysteresis": "hysteresis",
            "minDwell": "min_dwell",
            "minGapEvents": "min_gap_events",
            "snapshotBytesPrior": "snapshot_bytes_prior",
            "backoffMaxSeconds": "backoff_max_s",
        }, "replication"))

    tel = raw.pop("telemetry", None)
    if tel:
        cfg.telemetry = TelemetryConfig(**_take(tel, {
            "sampleRate": "sample_rate",
            "traceCapacity": "trace_capacity",
            "maxSeries": "max_series",
        }, "telemetry"))

    ap = raw.pop("autopilot", None)
    if ap:
        cfg.autopilot = AutopilotConfig(**_take(ap, {
            "enabled": "enabled",
            "epochIntervalSeconds": "epoch_interval_s",
            "targetP99Ms": "target_p99_ms",
            "targetShedFrac": "target_shed_frac",
            "maxStepFrac": "max_step_frac",
            "headroomFrac": "headroom_frac",
            "ewmaAlpha": "ewma_alpha",
            "hysteresis": "hysteresis",
            "minDwell": "min_dwell",
            "cooldownEpochs": "cooldown_epochs",
            "reshardCooldownEpochs": "reshard_cooldown_epochs",
            "maxPlansPerEpoch": "max_plans_per_epoch",
            "minRps": "min_rps",
            "maxRps": "max_rps",
            "minShards": "min_shards",
            "maxShards": "max_shards",
            "hotShardDepth": "hot_shard_depth",
            "hotShardFactor": "hot_shard_factor",
            "coldShardFrac": "cold_shard_frac",
            "guardrailWindowEpochs": "guardrail_window",
            "guardrailRegression": "guardrail_regression",
            "freezeEpochs": "freeze_epochs",
            "backoffMaxSeconds": "backoff_max_s",
        }, "autopilot"))

    q = raw.pop("queues", None)
    if q:
        cfg.queues = QueuesConfig(**_take(q, {
            "parallelism": "parallelism",
            "batchSize": "batch_size",
            "pollIntervalMs": "poll_interval_ms",
            "matrixPath": "matrix_path",
        }, "queues"))

    dc = raw.pop("dynamicConfig", None)
    if dc:
        cfg.dynamicconfig_path = (dc or {}).get("filepath", "")

    arch = raw.pop("archival", None)
    if arch:
        cfg.archival_dir = (arch or {}).get("dir", "")

    if raw:
        raise ConfigError(f"unknown top-level keys: {sorted(raw)}")
    cfg.validate()
    return cfg


def load_config(path: str) -> ServerConfig:
    import yaml

    with open(path) as f:
        return load_config_dict(yaml.safe_load(f) or {})
