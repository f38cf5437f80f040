"""Deterministic fault injection for chaos/recovery testing.

The validation backbone the reconfigurable-SMR literature treats as
mandatory for replicated state machines: recovery invariants are only
credible when the fault schedule that exercises them is reproducible.
A ``FaultSchedule`` is a seeded RNG plus an ordered rule list; every
instrumented call site asks the schedule whether to misbehave, and the
schedule's answers are a pure function of (seed, rule list, call
sequence) — same seed, same workload, same faults, every run.

Three ways faults reach the system:

  * ``FaultInjectionClient`` — a persistence decorator in the same
    ``_Wrapped`` proxy family as the metrics/rate-limit clients
    (runtime/persistence/decorators.py). ``wrap_bundle(faults=...)``
    installs it INNERMOST (closest to the store) so the metrics client
    above it counts injected errors exactly like real backend errors.
    Sites are named ``persistence.<manager>`` and the method name is
    the persistence API name.
  * queue processors — ``QueueProcessorBase`` (and the timer twins)
    accept ``faults=`` and fire ``queue.<name>`` before every task
    attempt, exercising the in-line retry + park-on-exhaustion path.
  * replication — ``NDCHistoryReplicator`` fires
    ``replication.ndc``/``apply_events`` per applied task and
    ``ReplicatorQueueProcessor`` fires ``replication.replicator_queue``
    per fetch, exercising the at-least-once re-fetch contract.

Actions: raise one of the persistence error taxonomy (``error``), delay
the call (``latency``), or — the torn-write simulation — let the write
LAND and then raise as if the connection died on the response
(``torn_write``). Torn writes are the at-least-once storage reality
every retry loop must survive; point them at idempotent APIs.

A schedule can be armed/disarmed at runtime, so a chaos run can drive a
clean warm-up, flip faults on mid-workload, and flip them off to assert
the system drains back to a quiescent state.

Geographic link modeling (``LinkProfile``/``SimulatedLink``): the
degraded-WAN half of the chaos layer. A profile describes one
cross-cluster link — a bytes/sec budget, fixed latency, seeded jitter,
and partition windows over the transfer sequence — and ``chaos_link``
installs it over a replication ``RemoteClusterClient`` so every
``ReplicationTaskFetcher.fetch`` / ``get_workflow_history_raw`` /
snapshot transfer pays the link's cost (a real, bounded sleep) or hits
a partition (``LinkPartitionedError``). Determinism contract mirrors
``FaultSchedule``: delays and partitions are a pure function of
(profile, seed, transfer index), so the same workload sees the same
degraded link every run.

A copy of the reference package's ``testing/faults.py``: the same seed,
rules and call sequence plan the same faults in both packages. The
errors a rule raises are the port's persistence error classes.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..runtime.persistence.decorators import (
    PersistenceBusyError,
    _Wrapped,
)
from ..runtime.persistence.errors import (
    ConditionFailedError,
    EntityNotExistsError,
    PersistenceError,
    ShardOwnershipLostError,
)
from ..utils import tracing
from ..utils.metrics import NOOP, Scope

ACTIONS = ("error", "latency", "torn_write")

# error taxonomy a rule may raise, by name (config/YAML friendly)
_ERRORS = {
    "PersistenceError": lambda msg, sid: PersistenceError(msg),
    "ConditionFailedError": lambda msg, sid: ConditionFailedError(msg),
    "EntityNotExistsError": lambda msg, sid: EntityNotExistsError(msg),
    "ShardOwnershipLostError": lambda msg, sid: ShardOwnershipLostError(
        sid if sid is not None else 0, msg
    ),
    "PersistenceBusyError": lambda msg, sid: PersistenceBusyError(msg),
    "TimeoutError": lambda msg, sid: TimeoutError(msg),
}


@dataclasses.dataclass
class FaultRule:
    """One match-and-misbehave rule.

    ``site``/``method`` are fnmatch patterns against the call site
    (``persistence.execution``, ``queue.transfer-0``,
    ``replication.ndc``) and the operation name. At ``persistence.*``
    sites the operation is the manager API name (``update_*``); at
    ``queue.*`` sites it is the task's ``task_type`` VALUE (e.g.
    ``"0"``) — queue attempts have no API name, so the task type is
    the discriminator; leave ``method="*"`` to hit every task.
    ``shard_id`` pins the rule to one shard (None = any). ``after_calls`` skips the first N
    matching calls (let the workload ramp up), ``max_faults`` stops
    injecting after N hits (bound the blast radius), ``probability`` is
    the per-call injection chance drawn from the schedule's seeded RNG.
    """

    site: str = "*"
    method: str = "*"
    shard_id: Optional[int] = None
    probability: float = 1.0
    after_calls: int = 0
    max_faults: Optional[int] = None
    action: str = "error"            # error | latency | torn_write
    error: str = "PersistenceError"  # key into the error taxonomy
    latency_s: float = 0.0
    message: str = ""

    def validate(self) -> None:
        if self.action not in ACTIONS:
            raise ValueError(f"fault rule: unknown action '{self.action}'")
        if self.action != "latency" and self.error not in _ERRORS:
            raise ValueError(f"fault rule: unknown error '{self.error}'")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError("fault rule: probability must be in [0, 1]")
        if self.after_calls < 0 or self.latency_s < 0:
            raise ValueError("fault rule: negative after_calls/latency_s")
        if self.max_faults is not None and self.max_faults < 0:
            # -1 is a plausible typo for "unlimited" (that's None); a
            # negative cap would silently disable the rule in plan()
            raise ValueError("fault rule: max_faults must be >= 0 or None")

    def matches(self, site: str, method: str, shard_id) -> bool:
        if self.shard_id is not None and shard_id != self.shard_id:
            return False
        return fnmatch.fnmatchcase(site, self.site) and fnmatch.fnmatchcase(
            method, self.method
        )


class _Plan:
    """One decided injection: what to do around the intercepted call."""

    __slots__ = ("action", "exc", "latency_s")

    def __init__(self, action, exc=None, latency_s=0.0):
        self.action = action
        self.exc = exc
        self.latency_s = latency_s


class FaultSchedule:
    """Seeded, rule-driven fault decider; thread-safe.

    Determinism contract: decisions are a function of (seed, rules,
    the sequence of matching calls). Concurrent callers serialize on
    the schedule lock, so two runs that present the same call sequence
    get the same fault sequence; a multi-threaded workload is
    deterministic up to its own interleaving.
    """

    def __init__(
        self,
        seed: int = 0,
        rules: Sequence[FaultRule] = (),
        metrics: Scope = NOOP,
        armed: bool = True,
    ) -> None:
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self.seed = seed
        self.rules: List[FaultRule] = []
        self._matched: List[int] = []
        self._injected: List[int] = []
        self._armed = armed
        self._metrics = metrics.tagged(layer="fault_injection")
        for r in rules:
            self.add_rule(r)

    # -- lifecycle -----------------------------------------------------

    def add_rule(self, rule: FaultRule) -> "FaultSchedule":
        rule.validate()
        with self._lock:
            self.rules.append(rule)
            self._matched.append(0)
            self._injected.append(0)
        return self

    def arm(self) -> None:
        """Enable injection (chaos phase of a run)."""
        with self._lock:
            self._armed = True

    def disarm(self) -> None:
        """Stop injecting; in-flight latency injections finish."""
        with self._lock:
            self._armed = False

    @property
    def armed(self) -> bool:
        with self._lock:
            return self._armed

    @classmethod
    def from_dicts(
        cls, specs: Sequence[Dict[str, Any]], seed: int = 0,
        metrics: Scope = NOOP,
    ) -> "FaultSchedule":
        """Build from config-shaped rule dicts (keys = FaultRule fields)."""
        names = {f.name for f in dataclasses.fields(FaultRule)}
        rules = []
        for i, spec in enumerate(specs):
            unknown = set(spec) - names
            if unknown:
                raise ValueError(
                    f"fault rule #{i}: unknown keys {sorted(unknown)}"
                )
            rules.append(FaultRule(**spec))
        return cls(seed=seed, rules=rules, metrics=metrics)

    # -- decision ------------------------------------------------------

    def plan(
        self, site: str, method: str = "", shard_id: Optional[int] = None
    ) -> Optional[_Plan]:
        """Decide whether this call misbehaves. First matching rule
        wins; every matching call consumes exactly one RNG draw whether
        or not it fires, so adding ``after_calls``/``max_faults`` to a
        rule does not shift the draws of later calls."""
        with self._lock:
            if not self._armed:
                return None
            for i, rule in enumerate(self.rules):
                if not rule.matches(site, method, shard_id):
                    continue
                self._matched[i] += 1
                draw = self._rng.random()
                if self._matched[i] <= rule.after_calls:
                    return None
                if (
                    rule.max_faults is not None
                    and self._injected[i] >= rule.max_faults
                ):
                    return None
                if draw >= rule.probability:
                    return None
                self._injected[i] += 1
                plan = self._build_plan(rule, site, method, shard_id)
                break
            else:
                return None
        self._metrics.tagged(site=site, action=plan.action).inc(
            "faults_injected"
        )
        # a sampled trace passing through this call site records the
        # injection as a span annotation (utils/tracing.py) — a chaos
        # failure's trace shows WHERE the faults landed next to the
        # retries they caused, instead of hand-correlating logs
        tracing.annotate(
            f"fault_injected site={site} method={method} "
            f"action={plan.action}"
        )
        return plan

    def _build_plan(self, rule, site, method, shard_id) -> _Plan:
        if rule.action == "latency":
            return _Plan("latency", latency_s=rule.latency_s)
        msg = rule.message or (
            f"[fault-injected] {rule.error} at {site}.{method}"
        )
        exc = _ERRORS[rule.error](msg, shard_id)
        return _Plan(rule.action, exc=exc)

    def fire(
        self, site: str, method: str = "", shard_id: Optional[int] = None
    ) -> None:
        """Hook form for call sites with no wrapped write to tear:
        raise or delay per the schedule (torn_write degenerates to a
        plain post-hoc error here)."""
        plan = self.plan(site, method, shard_id)
        if plan is None:
            return
        if plan.action == "latency":
            time.sleep(plan.latency_s)
            return
        raise plan.exc

    # -- observability -------------------------------------------------

    def injected_total(self) -> int:
        with self._lock:
            return sum(self._injected)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Per-rule (matched, injected) counts — the chaos suite's
        assertion surface and the operator's blast-radius view."""
        with self._lock:
            return [
                {
                    "site": r.site,
                    "method": r.method,
                    "action": r.action,
                    "matched": m,
                    "injected": j,
                }
                for r, m, j in zip(self.rules, self._matched, self._injected)
            ]


def hook(schedule: Optional[FaultSchedule], site: str,
         shard_id: Optional[int] = None):
    """``schedule.fire`` bound to one site (and optionally a default
    shard id, for call sites that belong to one shard), or None when no
    schedule is configured — what the queue/replication layers store so
    the disabled path is a single ``is None`` check."""
    if schedule is None:
        return None

    def fire(method: str = "", sid: Optional[int] = None) -> None:
        schedule.fire(site, method, sid if sid is not None else shard_id)

    return fire


# ---------------------------------------------------------------------------
# geographic link modeling
# ---------------------------------------------------------------------------


class LinkPartitionedError(ConnectionError):
    """The simulated WAN link is inside a partition window — the
    transfer never happened (nothing was delivered, nothing acked)."""


@dataclasses.dataclass
class LinkProfile:
    """One cross-cluster link's degradation envelope.

    ``bytes_per_s`` is the link budget (0 = unthrottled): a transfer of
    N bytes sleeps ``N / bytes_per_s`` before returning, which is what
    makes replication-lag-under-constrained-bandwidth measurable in
    real wall time. ``latency_s`` adds a fixed per-transfer RTT;
    ``jitter_s`` adds a uniform seeded draw in ``[0, jitter_s)``.
    ``partitions`` are half-open ``[start, end)`` windows over the
    TRANSFER INDEX (deterministic under frozen clocks, unlike
    wall-time windows): transfer k inside a window raises
    ``LinkPartitionedError`` instead of delivering. ``max_sleep_s``
    caps any single injected sleep so a mis-sized test profile cannot
    wedge a suite (0 = uncapped, what the bench uses)."""

    bytes_per_s: float = 0.0
    latency_s: float = 0.0
    jitter_s: float = 0.0
    partitions: Sequence[Tuple[int, int]] = ()
    max_sleep_s: float = 0.0

    def validate(self) -> None:
        if self.bytes_per_s < 0 or self.latency_s < 0 or self.jitter_s < 0:
            raise ValueError("link profile: negative budget/latency/jitter")
        if self.max_sleep_s < 0:
            raise ValueError("link profile: negative max_sleep_s")
        for w in self.partitions:
            if len(w) != 2 or w[0] < 0 or w[1] < w[0]:
                raise ValueError(f"link profile: bad partition window {w}")


class SimulatedLink:
    """Seeded, thread-safe link shaper; one instance = one direction of
    one geographic link. ``transfer(nbytes)`` consumes exactly one
    transfer index and one RNG draw whether or not the transfer lands,
    so reordering unrelated profile knobs never shifts later draws —
    the same determinism discipline as ``FaultSchedule.plan``."""

    def __init__(self, profile: LinkProfile, seed: int = 0) -> None:
        profile.validate()
        self.profile = profile
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._transfers = 0
        self._forced_partition = False
        self.bytes_total = 0
        self.partitioned_calls = 0
        self.slept_s = 0.0

    def force_partition(self, on: bool) -> None:
        """Manual region-loss switch for drill choreography ("the WAN
        segment is down NOW, heal it THERE") — deterministic as long as
        the caller toggles it at deterministic points, unlike wall-time
        windows and unconstrained by the transfer index the profile
        windows key on. Forced-partitioned transfers still consume
        their transfer index and RNG draw, so toggling never shifts
        later draws."""
        with self._lock:
            self._forced_partition = bool(on)

    def _partitioned(self, index: int) -> bool:
        if self._forced_partition:
            return True
        return any(a <= index < b for a, b in self.profile.partitions)

    def transfer(self, nbytes: int) -> float:
        """Charge one transfer of ``nbytes`` against the link; returns
        the delay applied (seconds). Raises ``LinkPartitionedError``
        inside a partition window."""
        p = self.profile
        with self._lock:
            index = self._transfers
            self._transfers += 1
            jitter = self._rng.random() * p.jitter_s
            if self._partitioned(index):
                self.partitioned_calls += 1
                tracing.annotate(
                    f"link_partitioned transfer={index}"
                )
                raise LinkPartitionedError(
                    f"[link-chaos] transfer {index} dropped "
                    f"(partition window)"
                )
            self.bytes_total += max(0, int(nbytes))
            delay = p.latency_s + jitter
            if p.bytes_per_s > 0:
                delay += max(0, int(nbytes)) / p.bytes_per_s
            if p.max_sleep_s > 0:
                delay = min(delay, p.max_sleep_s)
            self.slept_s += delay
        if delay > 0:
            time.sleep(delay)
        return delay

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "transfers": self._transfers,
                "bytes_total": self.bytes_total,
                "partitioned_calls": self.partitioned_calls,
                "slept_s": self.slept_s,
            }


class ChaosLinkClient:
    """``RemoteClusterClient`` decorator that ships every response over
    a ``SimulatedLink`` — the installation point for link chaos at the
    replication fetch sites (``ReplicationTaskFetcher.fetch`` and the
    rereplicator/backfill ``get_workflow_history_raw`` both dial
    through the wrapped client, as does the adaptive snapshot plane).

    The response is serialized through the replication wire-size
    estimator to charge the link with honest byte counts, then the link
    sleeps (bandwidth + latency + jitter) or raises
    ``LinkPartitionedError`` — exactly what a dead WAN segment does to
    a puller: no data, no cursor movement, retry later."""

    def __init__(self, base: Any, link: SimulatedLink) -> None:
        self._base = base
        self.link = link

    def _shipped(self, payload):
        from ..runtime.replication.transport import wire_size

        self.link.transfer(wire_size(payload))
        return payload

    def get_replication_messages(self, shard_id, last_retrieved_id,
                                 max_tasks=None):
        return self._shipped(
            self._base.get_replication_messages(
                shard_id, last_retrieved_id, max_tasks=max_tasks
            )
        )

    def get_workflow_history_raw(self, domain_id, workflow_id, run_id,
                                 start_event_id, end_event_id):
        return self._shipped(self._base.get_workflow_history_raw(
            domain_id, workflow_id, run_id, start_event_id, end_event_id
        ))

    def get_replication_backlog(self, shard_id, last_retrieved_id):
        return self._shipped(self._base.get_replication_backlog(
            shard_id, last_retrieved_id
        ))

    def get_replication_checkpoint(self, domain_id, workflow_id, run_id):
        return self._shipped(self._base.get_replication_checkpoint(
            domain_id, workflow_id, run_id
        ))

    def __getattr__(self, name: str):
        # anything beyond the replication surface passes through unshaped
        return getattr(self._base, name)


def chaos_link(client: Any, profile: LinkProfile,
               seed: int = 0) -> ChaosLinkClient:
    """Wrap a remote-cluster client in a seeded degraded link."""
    return ChaosLinkClient(client, SimulatedLink(profile, seed=seed))


class FaultInjectionClient(_Wrapped):
    """Persistence decorator that consults a FaultSchedule per call.

    Installed innermost by ``wrap_bundle(faults=...)`` — the metrics
    client above it observes injected errors/latency exactly like real
    backend misbehavior. ``torn_write`` executes the real call and then
    raises, simulating a write that landed while the response was lost;
    callers' retries then face the duplicate-write reality.
    """

    def __init__(
        self, base: Any, schedule: FaultSchedule, manager: str = "",
    ) -> None:
        super().__init__(base)
        self._schedule = schedule
        self._site = f"persistence.{manager or type(base).__name__}"

    @staticmethod
    def _shard_id(args, kwargs) -> Optional[int]:
        """Best-effort shard resolution across the manager APIs: an
        explicit kwarg, the shard_id-first convention of the execution
        manager, or a record argument carrying .shard_id (ShardInfo in
        update_shard/create_shard) — without the last one, a
        shard-pinned rule on persistence.shard would silently never
        match and the chaos run would be vacuous."""
        sid = kwargs.get("shard_id")
        if sid is None and args:
            if isinstance(args[0], int):
                sid = args[0]
            else:
                sid = getattr(args[0], "shard_id", None)
        return sid

    def _invoke(self, name, method, args, kwargs):
        plan = self._schedule.plan(
            self._site, name, self._shard_id(args, kwargs)
        )
        if plan is None:
            return method(*args, **kwargs)
        if plan.action == "latency":
            time.sleep(plan.latency_s)
            return method(*args, **kwargs)
        if plan.action == "torn_write":
            method(*args, **kwargs)  # the write LANDS; the ack is lost
            raise plan.exc
        raise plan.exc
