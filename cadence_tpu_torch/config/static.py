"""Static config structs the port's runtime reads.

A copy of the reference package's ``config/static.py`` trimmed to the
sections of the planes ported so far: ``ReshardingConfig`` (the reshard
coordinator's drain timeout and checkpoint shipping) and
``AutopilotConfig`` (the capacity autopilot's knobs). The YAML loader,
the server config and the other sections are not ported.
"""

from __future__ import annotations

import dataclasses


class ConfigError(ValueError):
    pass


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
