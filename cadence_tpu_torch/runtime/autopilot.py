"""Capacity autopilot: closed-loop control from admission rates to
shard topology.

Without it every plane ends its control story at a manual knob: the
overload plane's ``history.rps``/``matching.rps``/domain quotas are
operator-set constants, the serving engine's admission quota is frozen
at boot, and hot/cold shards wait for an operator to call the reshard
admin verbs. This module closes the loop. A ``CapacityController``
runs a sense → decide → actuate epoch:

* **sense** — one ``metrics.Window`` over the host registry yields the
  interval's REAL percentiles and rates (not cumulative-since-boot):
  admitted p99, shed fraction, serving staleness, observed admitted
  rps, per-domain rps, and per-shard queue depths;
* **decide** — per-signal EWMAs feed a hysteresis gate with the
  replication plane's challenger-must-win discipline (an overload /
  recovery verdict must win ``min_dwell`` CONSECUTIVE epochs to flip —
  a band-edge oscillation can never flap the gate). Each actuator has a
  cooldown (epochs) and a bounded step (``max_step_frac`` per epoch);
  a do-no-harm guardrail watches p99 after the controller's own recent
  actions and, on a self-inflicted regression, FREEZES actuation and
  reverts every rate to the last-known-good snapshot;
* **actuate** — two planes. Rates: programmatic dynamicconfig
  overrides (``dynamicconfig.LayeredClient``) + live hooks into the
  already-built limiters/engine, so ``history.rps``, ``matching.rps``,
  ``history.domainRps`` and the serving admission quota retune without
  a restart. Topology: split/merge/rebalance plans proposed to the
  (shared, one-per-host) ``ReshardCoordinator`` — several
  reconfigurations may be batched into one epoch, but plans execute
  strictly one at a time (the coordinator's own lock enforces it), and
  a failed plan backs the proposer off on a ``BackoffLadder`` — never a
  hot retry against a store that just aborted a handoff.

Deployment: in-process for the Onebox, and on real deployments every
history host runs the same controller but only the membership-elected
actuator (the host that ``resolver("history")`` hashes the
``capacity-autopilot`` key to) actuates; the rest sense and stand by —
a host loss moves the key, and the next epoch elects the survivor.
Operators keep the last word: ``autopilot_pause`` / ``autopilot_resume``
/ ``autopilot_status`` admin verbs, and every decision is traced (a
tracer span per epoch) and counted in ``AUTOPILOT_METRICS``.

A copy of the reference package's ``runtime/autopilot.py`` over the
port's modules. The topology plane reaches the card through the
coordinator it is handed: a split or merge flushes and warms the moving
workflows with ``rebuild_many`` on the coordinator's device.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..utils import locks
from ..utils.backoff import BackoffLadder
from ..utils.log import get_logger
from ..utils.metrics import NOOP, Scope, Window
from ..utils.tracing import TRACER

# the dynamicconfig keys the rate plane actuates (the same keys
# operators set by hand in the dynamicconfig file; the override layer
# shadows the file, remove_value un-shadows it)
KEY_HISTORY_RPS = "history.rps"
KEY_HISTORY_DOMAIN_RPS = "history.domainRps"
KEY_MATCHING_RPS = "matching.rps"
KEY_SERVING_QUOTA_RPS = "serving.quotaRps"

RATE_KEYS = (
    KEY_HISTORY_RPS,
    KEY_HISTORY_DOMAIN_RPS,
    KEY_MATCHING_RPS,
    KEY_SERVING_QUOTA_RPS,
)

ELECTION_KEY = "capacity-autopilot"


class Ewma:
    """Exponentially-weighted moving average; seeded by the first
    observation (no zero-bias warmup — the first epoch's reading IS the
    state, which matters for a controller that must not actuate off an
    artificial ramp from zero)."""

    def __init__(self, alpha: float) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError("ewma: alpha must be in (0, 1]")
        self.alpha = float(alpha)
        self.value: Optional[float] = None

    def observe(self, sample: float) -> float:
        if self.value is None:
            self.value = float(sample)
        else:
            self.value += self.alpha * (float(sample) - self.value)
        return self.value

    def get(self, default: float = 0.0) -> float:
        return self.value if self.value is not None else default


class HysteresisGate:
    """Two-state overload gate with the challenger-must-win discipline
    (``ReplicationModeController``): flipping requires the challenger
    state to win ``min_dwell`` CONSECUTIVE observations; any
    non-winning observation resets the streak. Engage above ``hi``;
    disengage below ``hi / hysteresis``. A signal oscillating at the
    band edge alternates win/non-win and can never accumulate a streak
    — the no-flap property test pins this."""

    def __init__(
        self, hi: float, hysteresis: float, min_dwell: int
    ) -> None:
        if hi <= 0:
            raise ValueError("hysteresis gate: hi must be > 0")
        if hysteresis < 1.0:
            raise ValueError("hysteresis gate: hysteresis must be >= 1")
        if min_dwell < 1:
            raise ValueError("hysteresis gate: min_dwell must be >= 1")
        self.hi = float(hi)
        self.lo = float(hi) / float(hysteresis)
        self.min_dwell = int(min_dwell)
        self.engaged = False
        self.switches = 0
        self._streak = 0

    def observe(self, value: float) -> bool:
        """Feed one epoch's pressure reading; returns the (possibly
        flipped) engaged state."""
        if self.engaged:
            challenger_wins = value < self.lo
        else:
            challenger_wins = value > self.hi
        if challenger_wins:
            self._streak += 1
            if self._streak >= self.min_dwell:
                self.engaged = not self.engaged
                self.switches += 1
                self._streak = 0
        else:
            self._streak = 0
        return self.engaged


def derive_rate(
    current: float,
    observed_rps: float,
    overloaded: bool,
    *,
    max_step_frac: float,
    headroom_frac: float,
    min_rps: float,
    max_rps: float,
) -> float:
    """One epoch's rate derivation — pure, so the property tests can
    pin it directly.

    Overloaded: step DOWN by the full bounded step (shedding load is
    the point; half-measures prolong the brownout). Healthy: track the
    observed admitted rate plus headroom, clamped to one bounded step
    from ``current`` in either direction, so the limit follows traffic
    down in quiet phases and opens up under growth — monotone in
    ``observed_rps`` and never moving more than ``max_step_frac`` per
    epoch (modulo the absolute min/max clamps)."""
    if overloaded:
        desired = current * (1.0 - max_step_frac)
    else:
        target = observed_rps * (1.0 + headroom_frac)
        desired = min(
            max(target, current * (1.0 - max_step_frac)),
            current * (1.0 + max_step_frac),
        )
    return min(max(desired, min_rps), max_rps)


@dataclasses.dataclass
class EpochReading:
    """What one sense pass saw (the decide stage's only input, and the
    ``status()`` payload's ``last_reading``)."""

    span_s: float = 0.0
    admitted: int = 0
    shed: int = 0
    shed_frac: float = 0.0
    p99_ms: float = 0.0
    staleness_p99_ms: float = 0.0
    observed_rps: float = 0.0
    domain_rps: Dict[str, float] = dataclasses.field(default_factory=dict)
    shard_depths: Dict[int, int] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["shard_depths"] = {str(k): v for k, v in self.shard_depths.items()}
        return d


@dataclasses.dataclass
class _Action:
    """One past actuation, kept for the guardrail's lookback."""

    epoch: int
    kind: str          # "rate" | "reshard"
    key: str
    pre_p99_ms: float  # the p99 EWMA the controller saw BEFORE acting


class CapacityController:
    """The sense → decide → actuate epoch loop (one per history host).

    Construction wires the actuation surface explicitly so the Onebox,
    the bootstrap, and the tests all feed the same controller:

    * ``registry`` — the host ``metrics.Registry`` to sense from;
    * ``overrides`` — the ``dynamicconfig.InMemoryClient`` override
      layer rates are written through (so late-bound readers of the
      dynamicconfig keys see the controller's values);
    * ``rate_hooks`` — key → callable(rps) applied on top of the
      override write for limiters sized at boot
      (``MultiStageRateLimiter.set_global_rate``,
      ``ResidentEngine.retune_admission``);
    * ``resharder`` — the shared per-host ``ReshardCoordinator`` (or a
      zero-arg factory returning it, resolved lazily so construction
      never races shard acquisition); None disables the topology plane;
    * ``shard_load_fn`` — zero-arg callable returning {shard_id:
      queue depth}; defaults to summing outstanding+held over the
      ``history`` service's owned shards; injectable for tests;
    * ``monitor`` — membership for single-actuator election; None means
      standalone (always the actuator).
    """

    def __init__(
        self,
        config=None,
        *,
        registry=None,
        overrides=None,
        rate_hooks: Optional[Dict[str, Callable[[float], None]]] = None,
        initial_rates: Optional[Dict[str, float]] = None,
        resharder=None,
        history=None,
        monitor=None,
        shard_load_fn: Optional[Callable[[], Dict[int, int]]] = None,
        metrics: Optional[Scope] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        from ..config.static import AutopilotConfig

        self.config = config if config is not None else AutopilotConfig()
        self.config.validate()
        cfg = self.config
        self._registry = registry
        self._window = Window(registry) if registry is not None else None
        self.overrides = overrides
        self.rate_hooks = dict(rate_hooks or {})
        self._resharder = resharder
        self.history = history
        self.monitor = monitor
        self._shard_load_fn = shard_load_fn
        self._metrics = (
            metrics if metrics is not None else NOOP
        ).tagged(layer="autopilot")
        self._clock = clock
        self._log = get_logger("cadence_tpu_torch.autopilot")

        self._lock = locks.make_lock("CapacityController._lock")
        # the rate plane's current setpoints (key -> rps). Seeded from
        # initial_rates (bootstrap passes the boot-time dynamicconfig
        # values) so epoch 0 steps from the operator's config, not from
        # a built-in constant
        self._rates: Dict[str, float] = locks.make_guarded(
            {}, "CapacityController._rates", self._lock
        )
        for key, rps in (initial_rates or {}).items():
            self._rates[key] = float(rps)
        # actuator key -> first epoch it may act again
        self._cooldowns: Dict[str, int] = locks.make_guarded(
            {}, "CapacityController._cooldowns", self._lock
        )

        self._epoch = 0
        self._p99 = Ewma(cfg.ewma_alpha)
        self._shed = Ewma(cfg.ewma_alpha)
        # demand = OFFERED rate (admitted + shed per second), smoothed.
        # Tracking admitted alone could never discover latent demand
        # above the current limit — a too-low limit sheds the excess,
        # admitted equals the limit, and the loop locks itself down.
        # Shed traffic IS demand; count it
        self._demand = Ewma(cfg.ewma_alpha)
        # sticky: set the first time an interval carries any offered
        # traffic. Merges are gated on it — "cold" is only evidence
        # relative to load the controller has actually seen, so an
        # idle-at-boot cluster keeps its operator-provisioned topology
        # instead of collapsing to min_shards on zero information
        self._saw_traffic = False
        self._gate = HysteresisGate(1.0, cfg.hysteresis, cfg.min_dwell)
        self._last_reading: Optional[EpochReading] = None
        # guardrail state: recent actions (bounded lookback) + the
        # last-known-good rate snapshot taken at the end of every
        # healthy, freeze-free epoch
        self._recent_actions: "deque[_Action]" = deque(
            maxlen=cfg.guardrail_window * 8
        )
        self._last_known_good: Dict[str, float] = dict(self._rates)
        self._frozen_until_epoch = -1
        self.guardrail_freezes = 0
        # reshard plane: its own ladder — a failed plan must never be
        # hot-retried; block proposals until the ladder's horizon
        self._reshard_ladder = BackoffLadder(
            max(cfg.epoch_interval_s, 0.001), cfg.backoff_max_s
            if cfg.backoff_max_s >= cfg.epoch_interval_s
            else cfg.epoch_interval_s,
        )
        self._reshard_block_until = 0.0
        self.reshard_failures = 0

        self._paused = False
        self._pause_reason = ""
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.epochs_run = 0
        self.errors = 0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "CapacityController":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="capacity-autopilot", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None

    def _run(self) -> None:
        # the third BackoffLadder adoption site: an epoch that BLOWS UP
        # (sense path raising through a sick store, a dead resolver)
        # must not spin the loop at full cadence against the failure
        ladder = BackoffLadder(
            self.config.epoch_interval_s,
            max(self.config.backoff_max_s, self.config.epoch_interval_s),
            jitter=0.25,
        )
        delay = self.config.epoch_interval_s
        while not self._stop.wait(delay):
            try:
                self.run_epoch_once()
                ladder.success()
                delay = self.config.epoch_interval_s
            except Exception as e:  # noqa: BLE001 — loop must survive
                self.errors += 1
                self._metrics.inc("autopilot_errors")
                self._log.warn(f"autopilot epoch failed ({e}); backoff")
                delay = ladder.failure()

    # -- operator verbs ------------------------------------------------

    def pause(self, reason: str = "") -> None:
        with self._lock:
            self._paused = True
            self._pause_reason = reason or "operator pause"
        self._metrics.inc("autopilot_pauses")
        self._log.info(f"autopilot paused: {self._pause_reason}")

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._pause_reason = ""
        self._metrics.inc("autopilot_resumes")
        self._log.info("autopilot resumed")

    def status(self) -> dict:
        with self._lock:
            rates = dict(self._rates)
            cooldowns = dict(self._cooldowns)
            paused, reason = self._paused, self._pause_reason
        reading = self._last_reading
        return {
            "enabled": True,
            "paused": paused,
            "pause_reason": reason,
            "leader": self._is_leader(),
            "epoch": self._epoch,
            "epochs_run": self.epochs_run,
            "errors": self.errors,
            "overloaded": self._gate.engaged,
            "saw_traffic": self._saw_traffic,
            "gate_switches": self._gate.switches,
            "p99_ewma_ms": self._p99.get(),
            "shed_ewma_frac": self._shed.get(),
            "frozen": self._is_frozen(),
            "guardrail_freezes": self.guardrail_freezes,
            "reshard_failures": self.reshard_failures,
            "rates": rates,
            "cooldowns": cooldowns,
            "last_known_good": dict(self._last_known_good),
            "last_reading": reading.to_dict() if reading else None,
        }

    # -- election ------------------------------------------------------

    def _is_leader(self) -> bool:
        """Single-actuator election: the membership ring hashes the
        well-known key to exactly one history host; everyone computes
        it, exactly one matches. No monitor (standalone / Onebox) or an
        empty ring (boot) -> act."""
        if self.monitor is None:
            return True
        try:
            resolver = self.monitor.resolver("history")
            if resolver.member_count() == 0:
                return True
            owner = resolver.lookup(ELECTION_KEY)
            return owner.identity == self.monitor.whoami().identity
        except Exception:  # noqa: BLE001 — a sick ring must not actuate
            return False

    # -- the epoch -----------------------------------------------------

    def run_epoch_once(self) -> dict:
        """One full sense → decide → actuate pass (the loop body; also
        the test/bench entry point — no thread required). Returns a
        summary dict of what happened."""
        t0 = time.perf_counter()
        self._epoch += 1
        span = TRACER.trace(
            "autopilot.epoch", service="autopilot",
            epoch=str(self._epoch),
        )
        summary = {
            "epoch": self._epoch, "acted": False, "retunes": 0,
            "plans": 0, "froze": False, "skipped": None,
        }
        with span:
            reading = self._sense()
            self._last_reading = reading
            overloaded = self._decide(reading)
            span.annotate(
                f"p99_ewma={self._p99.get():.1f}ms "
                f"shed_ewma={self._shed.get():.3f} "
                f"overloaded={overloaded}"
            )
            with self._lock:
                paused = self._paused
            if paused:
                summary["skipped"] = "paused"
                self._metrics.inc("autopilot_skipped_epochs")
                span.annotate("skipped: paused")
            elif not self._is_leader():
                # non-leaders sense (their EWMAs stay warm for a
                # failover) but never actuate
                summary["skipped"] = "not-leader"
                self._metrics.inc("autopilot_skipped_epochs")
                span.annotate("skipped: not leader")
            elif self._guardrail_trips():
                self._freeze_and_revert(span)
                summary["froze"] = True
            elif self._is_frozen():
                summary["skipped"] = "frozen"
                self._metrics.inc("autopilot_skipped_epochs")
                span.annotate("skipped: frozen")
            else:
                summary["retunes"] = self._actuate_rates(
                    reading, overloaded, span
                )
                summary["plans"] = self._actuate_topology(reading, span)
                summary["acted"] = (
                    summary["retunes"] + summary["plans"] > 0
                )
                # a healthy epoch refreshes the revert target — but
                # only once its OWN actions' dust has settled (nothing
                # still inside the guardrail's lookback pending
                # judgment), so a freeze can never revert INTO the
                # rates that caused the regression
                cutoff = self._epoch - self.config.guardrail_window
                settled = not any(
                    a.epoch >= cutoff for a in self._recent_actions
                )
                if not self._gate.engaged and settled:
                    with self._lock:
                        self._last_known_good = dict(self._rates)
        self.epochs_run += 1
        self._metrics.inc("autopilot_epochs")
        self._metrics.record(
            "autopilot_epoch_seconds", time.perf_counter() - t0
        )
        self._metrics.gauge(
            "autopilot_overload_engaged", 1.0 if self._gate.engaged else 0.0
        )
        self._metrics.gauge(
            "autopilot_frozen", 1.0 if self._is_frozen() else 0.0
        )
        with self._lock:
            now_paused = self._paused
        self._metrics.gauge(
            "autopilot_paused", 1.0 if now_paused else 0.0
        )
        return summary

    # -- sense ---------------------------------------------------------

    def _sense(self) -> EpochReading:
        if self._window is None:
            return EpochReading(shard_depths=self._shard_depths())
        r = self._window.advance()
        span_s = max(r.span_s, 1e-9)

        decision = r.timer_stats("serve_decision")
        admitted = decision.count
        p99_ms = decision.p99 * 1000.0
        if admitted == 0:
            # no serving traffic this interval — fall back to the
            # history op latency plane so the controller still senses
            # an ingest-only workload. Exclude non-workload ops:
            # worker long-polls are SUPPLY asking for work (an idle
            # cluster with workers attached long-polls continuously)
            # and domain CRUD is the operator's control plane —
            # counting either would feed phantom rps into the demand
            # EWMA and open the cold-merge gate on a cluster that has
            # never executed a workflow
            def _workload(t):
                op = dict(t).get("operation", "")
                return not (op.startswith("poll_for_") or "domain" in op)

            lat = r.timer_stats("latency", where=_workload)
            admitted = lat.count
            p99_ms = lat.p99 * 1000.0
        shed = r.counter("serve_shed") + r.counter("frontend_requests_shed")
        shed_frac = shed / max(1, shed + admitted)
        staleness = r.timer_stats("serving_staleness_ms")

        domain_rps: Dict[str, float] = {}
        for tags in r.timer_tags("serve_decision"):
            dom = dict(tags).get("domain")
            if dom:
                st = r.timer_stats("serve_decision", dict(tags))
                domain_rps[dom] = domain_rps.get(dom, 0.0) + (
                    st.count / span_s
                )

        reading = EpochReading(
            span_s=span_s,
            admitted=admitted,
            shed=shed,
            shed_frac=shed_frac,
            p99_ms=p99_ms,
            # serving_staleness_ms is recorded in ms already
            staleness_p99_ms=staleness.p99,
            observed_rps=admitted / span_s,
            domain_rps=domain_rps,
            shard_depths=self._shard_depths(),
        )
        self._metrics.gauge("autopilot_sensed_p99_ms", reading.p99_ms)
        self._metrics.gauge(
            "autopilot_sensed_shed_frac", reading.shed_frac
        )
        return reading

    def _shard_depths(self) -> Dict[int, int]:
        if self._shard_load_fn is not None:
            try:
                return dict(self._shard_load_fn())
            except Exception:  # noqa: BLE001
                return {}
        if self.history is None:
            return {}
        depths: Dict[int, int] = {}
        try:
            controller = self.history.controller
            with controller._lock:
                shard_ids = list(controller._handles.keys())
            for sid in shard_ids:
                try:
                    desc = self.history.describe_queue_states(sid)
                except KeyError:
                    continue  # lost between listing and describing
                depths[sid] = sum(
                    q["outstanding"] + q["held"] for q in desc["queues"]
                )
        except Exception:  # noqa: BLE001 — sensing must never throw
            return depths
        return depths

    # -- decide --------------------------------------------------------

    def _decide(self, reading: EpochReading) -> bool:
        cfg = self.config
        # epochs with zero admitted traffic carry no latency signal;
        # hold the p99 EWMA rather than decaying it toward 0 (which
        # would disengage the gate during a total brownout)
        if reading.admitted > 0:
            self._p99.observe(reading.p99_ms)
        if reading.admitted + reading.shed > 0:
            self._saw_traffic = True
        self._shed.observe(reading.shed_frac)
        self._demand.observe(
            (reading.admitted + reading.shed)
            / max(reading.span_s, 1e-9)
        )
        self._metrics.gauge("autopilot_demand_rps", self._demand.get())
        # shed with HEALTHY latency is the limiter being the
        # bottleneck, not the backend — the cure is opening the limit
        # up, so it must not engage the gate (feeding raw shed into
        # the pressure would be a death spiral: lower limit -> more
        # shed -> more pressure -> lower limit, all the way to
        # min_rps). Shed escalates pressure only once latency is at
        # or past target: then the backend really is saturated
        p99_pressure = self._p99.get() / cfg.target_p99_ms
        pressure = p99_pressure
        if p99_pressure >= 1.0:
            pressure = max(
                pressure, self._shed.get() / cfg.target_shed_frac
            )
        self._metrics.gauge("autopilot_pressure", pressure)
        return self._gate.observe(pressure)

    # -- guardrail -----------------------------------------------------

    def _is_frozen(self) -> bool:
        return self._epoch <= self._frozen_until_epoch

    def _guardrail_trips(self) -> bool:
        """Do-no-harm: did p99 regress past ``guardrail_regression`` ×
        the level it held BEFORE our recent actions, while also above
        target? Correlation, not causation — the controller prefers a
        false freeze (operators' config keeps working) over a feedback
        loop chasing its own tail."""
        if self._is_frozen():
            return False
        cfg = self.config
        cutoff = self._epoch - cfg.guardrail_window
        recent = [a for a in self._recent_actions if a.epoch >= cutoff]
        if not recent:
            return False
        baseline = min(a.pre_p99_ms for a in recent)
        now = self._p99.get()
        return (
            now > cfg.target_p99_ms
            and now > max(baseline, 1e-9) * cfg.guardrail_regression
        )

    def _freeze_and_revert(self, span) -> None:
        cfg = self.config
        self._frozen_until_epoch = self._epoch + cfg.freeze_epochs
        self.guardrail_freezes += 1
        self._metrics.inc("autopilot_guardrail_freezes")
        with self._lock:
            good = dict(self._last_known_good)
        reverted = 0
        for key, rps in good.items():
            if self._apply_rate(key, rps):
                reverted += 1
        self._metrics.inc("autopilot_reverts", max(reverted, 1))
        self._recent_actions.clear()
        span.annotate(
            f"GUARDRAIL FREEZE: reverted {reverted} rates to "
            f"last-known-good; frozen until epoch "
            f"{self._frozen_until_epoch}"
        )
        self._log.warn(
            "autopilot guardrail tripped: p99 regressed after our own "
            f"actions; reverted {reverted} rates, frozen "
            f"{cfg.freeze_epochs} epochs"
        )

    # -- actuate: rates ------------------------------------------------

    def _apply_rate(self, key: str, rps: float) -> bool:
        """Write one setpoint through the override layer + live hook.
        Returns True when the setpoint materially changed."""
        with self._lock:
            cur = self._rates.get(key)
            if cur is not None and abs(rps - cur) <= 0.01 * max(cur, 1e-9):
                return False
            self._rates[key] = rps
        if self.overrides is not None:
            self.overrides.set_value(key, rps)
        hook = self.rate_hooks.get(key)
        if hook is not None:
            hook(rps)
        self._metrics.tagged(key=key).gauge("autopilot_rate_rps", rps)
        return True

    def _actuate_rates(
        self, reading: EpochReading, overloaded: bool, span
    ) -> int:
        cfg = self.config
        retunes = 0
        pre_p99 = self._p99.get()
        n_domains = max(len(reading.domain_rps), 1)
        for key in RATE_KEYS:
            with self._lock:
                if self._cooldowns.get(key, 0) > self._epoch:
                    cooling = True
                else:
                    cooling = False
                current = self._rates.get(key)
            if current is None:
                continue  # no setpoint wired for this key on this host
            if cooling:
                self._metrics.inc("autopilot_cooldown_skips")
                continue
            if key == KEY_HISTORY_DOMAIN_RPS:
                # per-domain cap follows the HOTTEST domain + headroom
                observed = max(
                    reading.domain_rps.values(),
                    default=self._demand.get() / n_domains,
                )
            else:
                # smoothed OFFERED rate: shed traffic is demand too
                observed = self._demand.get()
            new = derive_rate(
                current, observed, overloaded,
                max_step_frac=cfg.max_step_frac,
                headroom_frac=cfg.headroom_frac,
                min_rps=cfg.min_rps,
                max_rps=cfg.max_rps,
            )
            if self._apply_rate(key, new):
                retunes += 1
                with self._lock:
                    self._cooldowns[key] = (
                        self._epoch + 1 + cfg.cooldown_epochs
                    )
                self._recent_actions.append(_Action(
                    epoch=self._epoch, kind="rate", key=key,
                    pre_p99_ms=pre_p99,
                ))
                self._metrics.inc("autopilot_rate_retunes")
                span.annotate(
                    f"retune {key}: {current:.1f} -> {new:.1f} rps"
                )
        return retunes

    # -- actuate: topology ---------------------------------------------

    def _resolve_resharder(self):
        r = self._resharder
        return r() if callable(r) else r

    def _actuate_topology(self, reading: EpochReading, span) -> int:
        cfg = self.config
        resharder = self._resolve_resharder()
        if resharder is None or not reading.shard_depths:
            return 0
        if self._clock() < self._reshard_block_until:
            self._metrics.inc("autopilot_cooldown_skips")
            span.annotate("reshard plane: backing off after failure")
            return 0
        with self._lock:
            if self._cooldowns.get("reshard", 0) > self._epoch:
                self._metrics.inc("autopilot_cooldown_skips")
                return 0

        depths = reading.shard_depths
        mean = sum(depths.values()) / len(depths)
        n_shards = len(depths)
        plans: List[tuple] = []

        # hot shards: depth over the absolute floor AND a clear outlier
        hot = sorted(
            (
                sid for sid, d in depths.items()
                if d >= cfg.hot_shard_depth
                and d > cfg.hot_shard_factor * max(mean, 1.0)
            ),
            key=lambda s: -depths[s],
        )
        for sid in hot:
            if n_shards + len([p for p in plans if p[0] == "split"]) \
                    >= cfg.max_shards:
                break
            plans.append(("split", sid))

        # cold pairs: only when the gate is disengaged (never shrink
        # capacity during an overload), both shards are near-idle, AND
        # the controller has seen real traffic at least once — "cold"
        # relative to a load that never existed is not evidence, and an
        # idle-at-boot cluster must keep its provisioned topology
        if not self._gate.engaged and not plans and self._saw_traffic:
            cold = sorted(
                (
                    sid for sid, d in depths.items()
                    if d <= cfg.cold_shard_frac * max(mean, 1.0)
                ),
                key=lambda s: depths[s],
            )
            while (
                len(cold) >= 2
                and n_shards - len(plans) > cfg.min_shards
            ):
                src, tgt = cold.pop(0), cold.pop(0)
                plans.append(("merge", src, tgt))
                cold.insert(0, tgt)  # the survivor can absorb again

        executed = 0
        for plan in plans[: cfg.max_plans_per_epoch]:
            try:
                # one-plan-at-a-time: the coordinator's lock serializes;
                # we just submit sequentially and stop on first failure
                if plan[0] == "split":
                    resharder.split(plan[1])
                    span.annotate(f"split shard {plan[1]}")
                else:
                    resharder.merge(plan[1], plan[2])
                    span.annotate(
                        f"merge shard {plan[1]} -> {plan[2]}"
                    )
                executed += 1
                self._metrics.inc("autopilot_reshard_plans")
                self._recent_actions.append(_Action(
                    epoch=self._epoch, kind="reshard",
                    key=f"{plan[0]}:{plan[1]}",
                    pre_p99_ms=self._p99.get(),
                ))
                self._reshard_ladder.success()
            except Exception as e:  # noqa: BLE001 — incl. ReshardError
                # the coordinator already rolled the plan back; OUR job
                # is to not hot-retry a store that just aborted a
                # handoff — back off on the ladder and stop this epoch
                self.reshard_failures += 1
                self._metrics.inc("autopilot_reshard_failures")
                self._reshard_block_until = (
                    self._clock() + self._reshard_ladder.failure()
                )
                span.annotate(
                    f"reshard {plan[0]} failed ({e}); backing off"
                )
                self._log.warn(
                    f"autopilot reshard {plan} failed ({e}); "
                    "backing off, no hot retry"
                )
                break
        if executed:
            with self._lock:
                self._cooldowns["reshard"] = (
                    self._epoch + 1 + cfg.reshard_cooldown_epochs
                )
        return executed
