"""Domain failover coordinator: managed handover, forced region-loss
promotion, and failback over the two-cluster xdc topology.

Reference: the failover-version design of common/cluster/metadata.go +
common/domain/handler.go UpdateDomain (PAPER.md §cluster metadata): a
global domain's ownership is a ``failover_version`` that moves in
increments whose residue identifies the owning cluster. This module
composes that static arithmetic into a *reconfigurable* whole — the
"Reconfigurable State Machine Replication from Non-Reconfigurable
Building Blocks" move (PAPERS.md): each drill is a sequence of
already-proven static steps (queue drain, replication drain, guarded
domain-record merge, cursor rewind via the standby handover listeners)
whose composition is what the failover drills validate.

Three drill shapes (the scenario zoo in tests/test_failover_drills.py
and the ``failover_drill`` bench config drive all three):

* **managed handover** — the graceful path: drain the old active
  side's queue pipelines (in-flight decisions settle), drain the
  target's replication pull plane to state-current, bump
  ``failover_version`` through ``ClusterMetadata.next_failover_version``
  and flip ``active_cluster_name`` on every reachable cluster (old
  active FIRST, so it stops minting before anyone else starts), then
  wait for the new active's domain cache to observe its own ownership —
  that observation fires the ``_on_domain_failover`` listeners that
  rewind the active queue cursors over the standby-held span, so no
  passive-side task is ever lost;
* **forced failover** — region loss: the old active is unreachable, so
  nothing drains; the domain record is flipped on the reachable
  clusters only, with divergent branches knowingly outstanding. The
  report carries the replication lag *known at promote time* (the
  estimator's last view of the dead link — exactly what an operator
  sees) and the NDC conflict-resolution storm that follows the heal is
  measured via the ``replication_conflicts_resolved`` counter;
* **failback** — after the lost region recovers: re-sync its domain
  record (guarded merge, same rules as the domain-replication topic),
  drain both directions to convergence (the conflict storm resolves
  here), then run a managed handover back.

Every drill emits the ``FAILOVER_METRICS`` family through the
histogram plane: ``failover_handover_ms`` (end-to-end drill wall time),
``failover_unavailability_ms`` (flip start → new active observes
ownership: the window where neither side safely mints),
``failover_replication_lag_at_promote`` and
``failover_conflicts_resolved`` (registry delta across the drill), plus
a ``domain_failovers`` counter tagged ``kind=managed|forced|failback``.

A copy of the reference package's ``runtime/replication/failover.py``;
``make_lock`` is the port's plain-lock constructor (no lock-order
tracking).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

from ...utils.locks import make_lock
from ...utils.log import get_logger
from ...utils.metrics import NOOP

logger = get_logger("cadence_tpu_torch.replication.failover")

# one counter name, one definition: what "a resolved conflict" means to
# both the NDC replicator (emit side) and the drill reports (read side)
CONFLICTS_RESOLVED = "replication_conflicts_resolved"


@dataclasses.dataclass
class ClusterHandle:
    """What the coordinator needs from ONE cluster of the topology.

    ``processors`` are the cluster's replication consumers (its pull
    planes FROM the peers — ``ReplicationTaskProcessor``); draining
    them makes this cluster state-current. ``transport`` is the
    cluster's inbound ``AdaptiveTransport`` when wired (the lag view at
    promote time); ``registry`` a ``utils.metrics.Registry`` whose
    ``replication_conflicts_resolved`` counter the drill reports read.
    ``history`` (a ``HistoryService``) is optional — without it the
    graceful drain skips the queue pipelines of that cluster."""

    name: str
    metadata: object                 # persistence MetadataManager
    domains: object                  # runtime.domains.DomainCache
    history: object = None           # runtime.service.HistoryService
    processors: Sequence = ()        # inbound ReplicationTaskProcessors
    transport: object = None         # inbound AdaptiveTransport
    registry: object = None          # utils.metrics.Registry


@dataclasses.dataclass
class FailoverReport:
    """One drill's outcome — the assertion surface of the scenario zoo
    and the rows of the ``failover_drill`` bench record."""

    kind: str                        # managed | forced | failback
    domain: str
    from_cluster: str
    to_cluster: str
    failover_version: int
    handover_ms: float = 0.0         # end-to-end drill wall time
    unavailability_ms: float = 0.0   # flip start -> ownership observed
    replication_lag_at_promote: int = 0   # events known outstanding
    conflicts_resolved: int = 0      # registry delta across the drill
    drained_tasks: int = 0           # replication tasks applied in-drill
    unreachable: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FailoverDrillError(RuntimeError):
    """A drill step failed in a way that leaves ownership ambiguous —
    the drill harness must treat the topology as poisoned."""


class DomainFailoverCoordinator:
    """Drives domain ownership changes across an in-process (or test /
    bench) multi-cluster topology.

    The coordinator is an *operator*, not a service: it owns no
    background threads and mutates nothing outside the domain records
    and the drains it is asked to run. One drill at a time (guarded) —
    overlapping ownership changes for the same domain are exactly the
    split-brain the failover-version arithmetic exists to prevent."""

    def __init__(
        self,
        cluster_metadata,
        handles: Sequence[ClusterHandle],
        metrics=None,
        drain_timeout_s: float = 30.0,
    ) -> None:
        if not handles:
            raise ValueError("failover coordinator needs cluster handles")
        self.cluster_metadata = cluster_metadata
        self.handles: Dict[str, ClusterHandle] = {}
        for h in handles:
            if h.name in self.handles:
                raise ValueError(f"duplicate cluster handle {h.name!r}")
            self.handles[h.name] = h
        self.drain_timeout_s = drain_timeout_s
        self._metrics = (metrics or NOOP).tagged(layer="failover")
        self._lock = make_lock("DomainFailoverCoordinator._lock")

    @contextlib.contextmanager
    def _one_drill(self):
        """Non-blocking exclusivity: a second concurrent drill fails
        loudly instead of queueing behind the first — overlapping
        ownership changes are the split-brain the failover-version
        arithmetic exists to prevent. Try-lock, never held across a
        wait the caller didn't ask for."""
        if not self._lock.acquire(blocking=False):
            raise FailoverDrillError(
                "another failover drill is already in progress"
            )
        try:
            yield
        finally:
            self._lock.release()

    # -- domain record plumbing ---------------------------------------

    def _newest_record(self, domain: str, reachable: Sequence[str]):
        """The authoritative record: max failover_version among the
        reachable clusters (ties keep the first handle's copy)."""
        best = None
        for name in reachable:
            try:
                rec = self.handles[name].metadata.get_domain(name=domain)
            except Exception:
                continue
            if best is None or rec.failover_version > best.failover_version:
                best = rec
        if best is None:
            raise FailoverDrillError(
                f"domain {domain!r} not found on any reachable cluster"
            )
        return best

    def _apply_record(self, handle: ClusterHandle, rec) -> None:
        """Guarded merge of ``rec`` into one cluster's metadata — the
        same failover-version monotonicity rule the domain-replication
        topic applies (domain_handler.apply_replication_record): a
        stale flip can never regress ownership."""
        fresh = copy.deepcopy(rec)
        try:
            existing = handle.metadata.get_domain(name=rec.info.name)
        except Exception:
            handle.metadata.create_domain(fresh)
            return
        if fresh.failover_version <= existing.failover_version and (
            existing.replication_config.active_cluster_name
            == fresh.replication_config.active_cluster_name
        ):
            return  # already at/past this ownership state
        if fresh.failover_version < existing.failover_version:
            return  # stale: never regress
        handle.metadata.update_domain(fresh)

    def _poke_cache(self, handle: ClusterHandle, domain: str) -> None:
        """Force the cluster's domain cache to observe the new record
        NOW (a lookup triggers the staleness refresh, which fires the
        failover listeners that rewind the active queue cursors)."""
        try:
            handle.domains.get_by_name(domain)
        except Exception:
            pass

    def propagate_domain(
        self, domain: str, reachable: Optional[Sequence[str]] = None
    ) -> None:
        """Push the newest record to every reachable cluster and poke
        their caches — what the domain-replication topic does in a real
        deployment; here the drill step that re-syncs a recovered
        region before failback."""
        names = list(reachable if reachable is not None else self.handles)
        rec = self._newest_record(domain, names)
        for name in names:
            self._apply_record(self.handles[name], rec)
            self._poke_cache(self.handles[name], domain)

    # -- drains --------------------------------------------------------

    def _drain_replication(
        self, handle: ClusterHandle, timeout_s: Optional[float] = None,
        swallow: tuple = (),
    ) -> int:
        """Pull this cluster's inbound replication planes until one full
        round applies nothing; returns tasks applied. ``swallow`` lets a
        drill keep draining through transfer-indexed partition windows
        (the link heals by index, not wall time)."""
        deadline = time.monotonic() + (
            timeout_s if timeout_s is not None else self.drain_timeout_s
        )
        total = 0
        while time.monotonic() < deadline:
            round_applied = 0
            faulted = False
            for proc in handle.processors:
                try:
                    round_applied += proc.process_once()
                except swallow:
                    # a swallowed fault (partition window, injected
                    # write error) means the cycle held its cursor —
                    # the round is a retry, never quiescence
                    faulted = True
            total += round_applied
            if round_applied == 0 and not faulted:
                return total
        raise FailoverDrillError(
            f"replication into {handle.name!r} never drained "
            f"within {timeout_s or self.drain_timeout_s}s"
        )

    def _drain_queues(self, handle: ClusterHandle,
                      timeout_s: float = 10.0) -> None:
        if handle.history is None:
            return
        if not handle.history.drain_queues(timeout_s):
            raise FailoverDrillError(
                f"queue pipelines on {handle.name!r} did not quiesce"
            )

    def _lag_at_promote(self, handle: ClusterHandle) -> int:
        t = handle.transport
        if t is None:
            return 0
        return int(t.estimator.lag_events)

    def _conflicts(self, names: Sequence[str]) -> int:
        total = 0
        for name in names:
            reg = self.handles[name].registry
            if reg is None:
                continue
            try:
                total += int(reg.counter_value(CONFLICTS_RESOLVED))
            except Exception:
                pass
        return total

    # -- the flip ------------------------------------------------------

    def _flip(
        self, domain: str, to_cluster: str, reachable: Sequence[str],
        observe_timeout_s: float = 10.0,
    ) -> tuple:
        """Bump the failover version, write the flipped record to every
        reachable cluster (old active first — it must stop minting
        before anyone else starts), and wait for the TARGET cluster's
        domain cache to observe its own ownership. Returns
        (new_failover_version, unavailability_ms)."""
        rec = self._newest_record(domain, reachable)
        if not rec.is_global:
            raise FailoverDrillError(
                f"domain {domain!r} is not global; nothing to fail over"
            )
        if to_cluster not in rec.replication_config.clusters:
            raise FailoverDrillError(
                f"target {to_cluster!r} not in domain clusters"
            )
        old_active = rec.replication_config.active_cluster_name
        new_version = self.cluster_metadata.next_failover_version(
            to_cluster, rec.failover_version + 1
        )
        flipped = copy.deepcopy(rec)
        flipped.replication_config.active_cluster_name = to_cluster
        flipped.failover_version = new_version
        flipped.failover_notification_version = rec.notification_version

        t_flip = time.monotonic()
        ordered = [n for n in reachable if n == old_active] + [
            n for n in reachable if n != old_active
        ]
        for name in ordered:
            self._apply_record(self.handles[name], flipped)
            self._poke_cache(self.handles[name], domain)
        # unavailability ends when the new active OBSERVES ownership:
        # from that moment its frontends accept and its queue cursors
        # have been rewound over the standby-held span
        target = self.handles[to_cluster]
        deadline = time.monotonic() + observe_timeout_s
        while time.monotonic() < deadline:
            try:
                cur = target.domains.get_by_name(domain)
                if (
                    cur.replication_config.active_cluster_name == to_cluster
                    and cur.failover_version >= new_version
                ):
                    break
            except Exception:
                pass
            time.sleep(0.005)
        else:
            raise FailoverDrillError(
                f"{to_cluster!r} never observed ownership of {domain!r}"
            )
        return new_version, (time.monotonic() - t_flip) * 1000.0

    # -- drills --------------------------------------------------------

    def managed_handover(
        self, domain: str, to_cluster: str, kind: str = "managed",
        swallow: tuple = (), _emit: bool = True,
    ) -> FailoverReport:
        """The graceful path: drain, flip, observe — zero lost progress
        by construction (everything in flight settled before the flip;
        the handover listeners rewind over anything the standby held)."""
        with self._one_drill():
            t0 = time.monotonic()
            reachable = list(self.handles)
            conflicts0 = self._conflicts(reachable)
            rec = self._newest_record(domain, reachable)
            old_active = rec.replication_config.active_cluster_name
            if to_cluster == old_active:
                raise FailoverDrillError(
                    f"domain {domain!r} already active in {to_cluster!r}"
                )
            target = self.handles[to_cluster]
            # 1. in-flight decisions/timers on the old active settle
            if old_active in self.handles:
                self._drain_queues(self.handles[old_active])
            # 2. the target catches up to state-current
            drained = self._drain_replication(target, swallow=swallow)
            lag = self._lag_at_promote(target)
            # 3. flip + observe
            version, unavail_ms = self._flip(
                domain, to_cluster, reachable
            )
            # 4. residual drain: anything minted between 2 and the flip
            drained += self._drain_replication(target, swallow=swallow)
            report = FailoverReport(
                kind=kind, domain=domain, from_cluster=old_active,
                to_cluster=to_cluster, failover_version=version,
                handover_ms=(time.monotonic() - t0) * 1000.0,
                unavailability_ms=unavail_ms,
                replication_lag_at_promote=lag,
                conflicts_resolved=(
                    self._conflicts(reachable) - conflicts0
                ),
                drained_tasks=drained,
            )
        if _emit:
            self._emit(report)
        return report

    def forced_failover(
        self, domain: str, to_cluster: str,
        lost_clusters: Sequence[str] = (),
    ) -> FailoverReport:
        """Region loss: promote ``to_cluster`` with the lost clusters
        unreachable and divergent branches knowingly outstanding. No
        drain of the lost side is possible; the target's inbound lag
        view at promote time is reported as-is."""
        with self._one_drill():
            t0 = time.monotonic()
            lost = set(lost_clusters)
            reachable = [n for n in self.handles if n not in lost]
            if to_cluster not in reachable:
                raise FailoverDrillError(
                    f"cannot promote unreachable cluster {to_cluster!r}"
                )
            conflicts0 = self._conflicts(reachable)
            rec = self._newest_record(domain, reachable)
            old_active = rec.replication_config.active_cluster_name
            lag = self._lag_at_promote(self.handles[to_cluster])
            version, unavail_ms = self._flip(
                domain, to_cluster, reachable
            )
            report = FailoverReport(
                kind="forced", domain=domain, from_cluster=old_active,
                to_cluster=to_cluster, failover_version=version,
                handover_ms=(time.monotonic() - t0) * 1000.0,
                unavailability_ms=unavail_ms,
                replication_lag_at_promote=lag,
                conflicts_resolved=(
                    self._conflicts(reachable) - conflicts0
                ),
                unreachable=sorted(lost),
            )
        self._emit(report)
        return report

    def await_convergence(
        self, domain: str, timeout_s: Optional[float] = None,
        swallow: tuple = (),
    ) -> int:
        """Drain every cluster's inbound replication, round-robin, until
        one full round applies nothing anywhere — the conflict storm
        after a healed partition resolves inside this loop (divergent
        branches fork, higher-version branches win, reapplied signals
        replicate back). Returns total tasks applied."""
        deadline = time.monotonic() + (
            timeout_s if timeout_s is not None else self.drain_timeout_s
        )
        self.propagate_domain(domain)
        total = 0
        while time.monotonic() < deadline:
            round_applied = 0
            faulted = False
            for handle in self.handles.values():
                for proc in handle.processors:
                    try:
                        round_applied += proc.process_once()
                    except swallow:
                        faulted = True
            total += round_applied
            if round_applied == 0 and not faulted:
                return total
        raise FailoverDrillError(
            f"replication never converged within "
            f"{timeout_s or self.drain_timeout_s}s"
        )

    def failback(
        self, domain: str, to_cluster: str, swallow: tuple = (),
    ) -> FailoverReport:
        """Return ownership to a recovered region: re-sync its domain
        record, converge both directions (the conflict-resolution storm
        drains here), then a managed handover back. The report's
        conflict count covers the whole failback, convergence
        included."""
        reachable = list(self.handles)
        conflicts0 = self._conflicts(reachable)
        t0 = time.monotonic()
        drained = self.await_convergence(domain, swallow=swallow)
        # the inner handover must not emit: its window excludes the
        # convergence phase, so its handover_ms/conflicts would land in
        # the histogram plane as a fraction of the real drill — the
        # final report below is emitted once, convergence included
        report = self.managed_handover(
            domain, to_cluster, kind="failback", swallow=swallow,
            _emit=False,
        )
        report.handover_ms = (time.monotonic() - t0) * 1000.0
        report.drained_tasks += drained
        report.conflicts_resolved = self._conflicts(reachable) - conflicts0
        self._emit(report)
        return report

    # -- metrics -------------------------------------------------------

    def _emit(self, report: FailoverReport) -> None:
        scope = self._metrics.tagged(
            kind=report.kind, domain=report.domain
        )
        scope.inc("domain_failovers")
        scope.record("failover_handover_ms", report.handover_ms)
        scope.record(
            "failover_unavailability_ms", report.unavailability_ms
        )
        scope.gauge(
            "failover_replication_lag_at_promote",
            report.replication_lag_at_promote,
        )
        if report.conflicts_resolved > 0:
            scope.inc(
                "failover_conflicts_resolved", report.conflicts_resolved
            )
        logger.info(
            f"failover drill {report.kind}: {report.domain} "
            f"{report.from_cluster}->{report.to_cluster} "
            f"v{report.failover_version} "
            f"handover={report.handover_ms:.1f}ms "
            f"unavail={report.unavailability_ms:.1f}ms "
            f"lag@promote={report.replication_lag_at_promote} "
            f"conflicts={report.conflicts_resolved}"
        )
