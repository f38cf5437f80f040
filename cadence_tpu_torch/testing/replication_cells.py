"""The reference bench's two replication cells, over the port.

``replication_lag``: geo-replication catch-up of a backlog over a
throttled WAN link, three arms (event shipping, snapshot shipping,
adaptive). ``failover_drill``: a managed handover, a forced region-loss
promotion with a conflict storm, and a failback, with the ``slo`` block.
Both build two port clusters whose history services rebuild on
``device``; the snapshot arms serve and install snapshots through
``StateRebuilder.rebuild_many`` there.

Copies of ``_bench_replication_lag`` and ``_bench_failover_drill`` of the
reference repository's ``bench.py``, with the same arguments, JSON keys
and arithmetic, plus ``device``.
"""

from __future__ import annotations

import time


def replication_lag(workflows: int, signals_each: int,
                    bytes_per_s: float, payload: int = 96,
                    device="cuda"):
    """Geo-replication catch-up under a throttled WAN link: event-ship
    vs snapshot-ship vs adaptive (runtime/replication/transport.py).

    Per arm, a fresh two-cluster pair: the active side accumulates a
    replication backlog (starts + signals, no worker — every write
    mints a replication task), then the standby drains it through a
    seeded ``SimulatedLink`` with a ``bytes_per_s`` budget.

      events    the pre-adaptive pull plane (no transport): the full
                hydrated event backlog pages over the throttled link
      snapshot  mode controller pinned to snapshot shipping: one
                backlog probe, then per-run delta-compressed
                ReplayCheckpoints + deferred history backfill
      adaptive  the controller decides per measured budget (the
                mode-switch count proves it actually switched)

    ``catch_up_s`` is time-to-state-current (every standby run's state
    tip matches the active tip — what failover readiness means);
    ``converged_s`` additionally drains the history backfill debt so
    the standby is byte-identical. For the events arm the two
    coincide. ``events_replayed_saved`` on the snapshot arms proves the
    suffix-only resume path carried the installs.
    """
    import uuid as _uuid

    from ..client import HistoryClient, MatchingClient
    from ..cluster import ClusterInformation, ClusterMetadata
    from ..matching import MatchingEngine
    from ..runtime.api import SignalRequest, StartWorkflowRequest
    from ..runtime.domains import DomainCache, register_domain
    from ..runtime.membership import single_host_monitor
    from ..runtime.persistence.memory import create_memory_bundle
    from ..runtime.replication import (
        AdaptiveTransport,
        HistoryRereplicator,
        ReplicationTaskFetcher,
        ReplicationTaskProcessor,
    )
    from ..runtime.service import HistoryService
    from ..testing.faults import LinkProfile, chaos_link
    from ..utils.metrics import Scope

    DOMAIN = "repl-bench"

    def make_cluster(name, domain_id, metrics=None):
        meta = ClusterMetadata(
            failover_version_increment=10,
            master_cluster_name="active", current_cluster_name=name,
            cluster_info={
                "active": ClusterInformation(initial_failover_version=1),
                "standby": ClusterInformation(initial_failover_version=2),
            },
        )
        persistence = create_memory_bundle()
        register_domain(
            persistence.metadata, DOMAIN, is_global=True,
            clusters=["active", "standby"], active_cluster="active",
            domain_id=domain_id, failover_version=1,
        )
        domains = DomainCache(persistence.metadata)
        svc = HistoryService(
            1, persistence, domains, single_host_monitor(f"{name}-h"),
            cluster_metadata=meta, metrics=metrics, device=device,
        )
        hc = HistoryClient(svc.controller)
        matching = MatchingEngine(persistence.task, hc)
        svc.wire(MatchingClient(matching), hc)
        svc.start()
        return {"svc": svc, "hc": hc, "matching": matching,
                "persistence": persistence, "domain_id": domain_id}

    class Adapter:
        def __init__(self, svc):
            self.svc = svc

        def get_replication_messages(self, shard_id, last, max_tasks=None):
            return self.svc.get_replication_messages(
                shard_id, last, cluster="standby", max_tasks=max_tasks)

        def get_workflow_history_raw(self, *a):
            return self.svc.get_workflow_history_raw(*a)

        def get_replication_backlog(self, shard_id, last):
            return self.svc.get_replication_backlog(shard_id, last)

        def get_replication_checkpoint(self, *a):
            return self.svc.get_replication_checkpoint(*a)

    def run_arm(arm):
        domain_id = str(_uuid.uuid4())
        scope = Scope()
        active = make_cluster("active", domain_id)
        # one registry for the whole standby side: the transport's
        # counters and the rebuilder's events_replayed_saved must land
        # together for the record to read coherently
        standby = make_cluster("standby", domain_id, metrics=scope)
        runs = {}
        try:
            for i in range(workflows):
                wid = f"lag-wf-{i}"
                rid = active["hc"].start_workflow_execution(
                    StartWorkflowRequest(
                        domain=DOMAIN, workflow_id=wid,
                        workflow_type="echo", task_list="tl",
                        request_id=f"req-{wid}",
                        execution_start_to_close_timeout_seconds=600,
                    ))
                for k in range(signals_each):
                    active["hc"].signal_workflow_execution(SignalRequest(
                        domain=DOMAIN, workflow_id=wid,
                        signal_name=f"s{k}", input=b"x" * payload,
                        identity="bench",
                    ))
                runs[wid] = rid
            tips = {}
            total_events = 0
            for wid, rid in runs.items():
                resp = active["persistence"].execution.\
                    get_workflow_execution(0, domain_id, wid, rid)
                tips[wid] = resp.next_event_id - 1
                total_events += tips[wid]
            # small fetch pages: the first page is the link probe, not
            # the whole hydrated backlog in one transfer
            emit = active["svc"].controller.get_engine_for_shard(0)\
                .replicator_queue
            emit.batch_size = 8
            if arm != "events":
                # absorb the snapshot server's first device rebuild
                # (the kernel's build and load) outside the timed window
                wid0 = next(iter(runs))
                active["svc"].get_replication_checkpoint(
                    domain_id, wid0, runs[wid0])

            link = chaos_link(
                Adapter(active["svc"]),
                LinkProfile(bytes_per_s=bytes_per_s), seed=7,
            )
            fetcher = ReplicationTaskFetcher("active", link)
            engine = standby["svc"].controller.get_engine_for_shard(0)
            transport = None
            if arm != "events":
                transport = AdaptiveTransport(
                    link, "active",
                    min_gap_events=8, min_dwell=1,
                    snapshot_bytes_prior=4096,
                    force_mode=("snapshot" if arm == "snapshot" else None),
                    metrics=scope,
                )
            rerepl = HistoryRereplicator(
                link, engine.ndc_replicator, transport=transport,
                metrics=scope,
            )
            proc = ReplicationTaskProcessor(
                engine.shard, engine.ndc_replicator, fetcher,
                rereplicator=rerepl, metrics=scope, transport=transport,
            )

            def state_current():
                ex = standby["persistence"].execution
                for wid, rid in runs.items():
                    try:
                        resp = ex.get_workflow_execution(
                            0, domain_id, wid, rid)
                    except Exception:
                        return False
                    if resp.next_event_id - 1 < tips[wid]:
                        return False
                return True

            t0 = time.monotonic()
            catch_up_s = None
            deadline = t0 + 300.0
            while time.monotonic() < deadline:
                n = proc.process_once()
                if catch_up_s is None and state_current():
                    catch_up_s = time.monotonic() - t0
                if n == 0 and catch_up_s is not None:
                    break
            converged_s = time.monotonic() - t0
            # byte-parity sanity: every replicated event landed
            standby_events = 0
            for wid, rid in runs.items():
                ev, _ = engine.get_workflow_execution_history(
                    DOMAIN, wid, rid)
                standby_events += len(ev)
            reg = scope.registry
            return {
                "catch_up_s": round(catch_up_s or converged_s, 3),
                "converged_s": round(converged_s, 3),
                "bytes_shipped": link.link.bytes_total,
                "backlog_events": total_events,
                "converged": standby_events == total_events,
                "mode_switches": (
                    transport.controller.switches if transport else 0
                ),
                "snapshots_shipped": reg.counter_value(
                    "replication_snapshots_shipped"),
                "events_replayed_saved": reg.counter_value(
                    "events_replayed_saved"),
            }
        finally:
            standby["svc"].stop()
            standby["matching"].shutdown()
            active["svc"].stop()
            active["matching"].shutdown()

    out = {}
    for arm in ("events", "snapshot", "adaptive"):
        out[arm] = run_arm(arm)
    ev, ad = out["events"], out["adaptive"]
    out["adaptive_vs_events"] = round(
        ad["catch_up_s"] / max(ev["catch_up_s"], 1e-9), 3
    )
    out["link_bytes_per_s"] = bytes_per_s
    return out


def failover_drill(workflows: int, signals_each: int,
                   bytes_per_s: float,
                   unavailability_slo_ms: float = 5000.0,
                   payload: int = 96, device="cuda"):
    """Domain failover drills over a throttled WAN link
    (runtime/replication/failover.py).

    One two-cluster pair runs all three drill shapes in sequence:

      managed   graceful handover active->standby: the handover pays
                the backlog catch-up through the throttled link before
                the flip (handover_ms), with a metadata-only
                unavailability window (unavailability_ms) and a
                drained link at promote time (lag 0)
      forced    region loss: the link partitions with divergent events
                outstanding on the now-active side, the survivor is
                promoted blind (unavailability_ms = flip->observed)
      failback  the recovered region re-syncs, the version-branch
                storm resolves (conflicts_resolved — the NDC
                rebuild-at-LCA path), and ownership returns home

    The ``slo`` block is the contract the smoke test pins: every
    drill's unavailability window inside ``unavailability_slo_ms``,
    at least one conflict actually resolved, and zero replication lag
    after the final convergence.
    """
    import uuid as _uuid

    from ..client import HistoryClient, MatchingClient
    from ..cluster import ClusterInformation, ClusterMetadata
    from ..matching import MatchingEngine
    from ..runtime.api import SignalRequest, StartWorkflowRequest
    from ..runtime.domains import DomainCache, register_domain
    from ..runtime.membership import single_host_monitor
    from ..runtime.persistence.memory import create_memory_bundle
    from ..runtime.replication import (
        AdaptiveTransport,
        ClusterHandle,
        DomainFailoverCoordinator,
        HistoryRereplicator,
        ReplicationTaskFetcher,
        ReplicationTaskProcessor,
    )
    from ..runtime.service import HistoryService
    from ..testing.faults import (
        LinkPartitionedError,
        LinkProfile,
        chaos_link,
    )
    from ..utils.metrics import Scope

    DOMAIN = "fo-bench"
    domain_id = str(_uuid.uuid4())

    def meta(name):
        return ClusterMetadata(
            failover_version_increment=10,
            master_cluster_name="active", current_cluster_name=name,
            cluster_info={
                "active": ClusterInformation(initial_failover_version=1),
                "standby": ClusterInformation(initial_failover_version=2),
            },
        )

    def make_cluster(name):
        scope = Scope()
        persistence = create_memory_bundle()
        register_domain(
            persistence.metadata, DOMAIN, is_global=True,
            clusters=["active", "standby"], active_cluster="active",
            domain_id=domain_id, failover_version=1,
        )
        domains = DomainCache(persistence.metadata)
        svc = HistoryService(
            1, persistence, domains, single_host_monitor(f"fo-{name}"),
            cluster_metadata=meta(name), metrics=scope, device=device,
        )
        hc = HistoryClient(svc.controller)
        matching = MatchingEngine(persistence.task, hc)
        svc.wire(MatchingClient(matching), hc)
        svc.start()
        svc.controller.get_engine_for_shard(0)\
            .replicator_queue.batch_size = 8
        return {"svc": svc, "hc": hc, "matching": matching,
                "persistence": persistence, "domains": domains,
                "scope": scope}

    class Adapter:
        def __init__(self, svc, consumer):
            self.svc = svc
            self.consumer = consumer

        def get_replication_messages(self, shard_id, last, max_tasks=None):
            return self.svc.get_replication_messages(
                shard_id, last, cluster=self.consumer,
                max_tasks=max_tasks)

        def get_workflow_history_raw(self, *a):
            return self.svc.get_workflow_history_raw(*a)

        def get_replication_backlog(self, shard_id, last):
            return self.svc.get_replication_backlog(shard_id, last)

        def get_replication_checkpoint(self, *a):
            return self.svc.get_replication_checkpoint(*a)

    clusters = {n: make_cluster(n) for n in ("active", "standby")}
    links, processors = {}, {}
    for consumer, source in (("standby", "active"), ("active", "standby")):
        wrapped = chaos_link(
            Adapter(clusters[source]["svc"], consumer),
            LinkProfile(bytes_per_s=bytes_per_s, max_sleep_s=1.0),
            seed=7,
        )
        links[consumer] = wrapped.link
        engine = clusters[consumer]["svc"].controller\
            .get_engine_for_shard(0)
        transport = AdaptiveTransport(
            wrapped, source, min_gap_events=1 << 30,
            metrics=clusters[consumer]["scope"],
        )
        rerepl = HistoryRereplicator(
            wrapped, engine.ndc_replicator, transport=transport,
            metrics=clusters[consumer]["scope"],
        )
        processors[consumer] = ReplicationTaskProcessor(
            engine.shard, engine.ndc_replicator,
            ReplicationTaskFetcher(source, wrapped),
            rereplicator=rerepl,
            metrics=clusters[consumer]["scope"], transport=transport,
        )
        clusters[consumer]["transport"] = transport

    fo_scope = Scope()
    coordinator = DomainFailoverCoordinator(
        meta("active"),
        [ClusterHandle(
            name=n, metadata=clusters[n]["persistence"].metadata,
            domains=clusters[n]["domains"], history=clusters[n]["svc"],
            processors=[processors[n]],
            transport=clusters[n].get("transport"),
            registry=clusters[n]["scope"].registry,
        ) for n in ("active", "standby")],
        metrics=fo_scope, drain_timeout_s=240.0,
    )
    retryable = (LinkPartitionedError,)

    def signal(cluster, wid, name):
        clusters[cluster]["hc"].signal_workflow_execution(SignalRequest(
            domain=DOMAIN, workflow_id=wid, signal_name=name,
            input=b"x" * payload, identity="fo-bench",
        ))

    try:
        # backlog on the home region
        wids = [f"fo-wf-{i}" for i in range(workflows)]
        for wid in wids:
            clusters["active"]["hc"].start_workflow_execution(
                StartWorkflowRequest(
                    domain=DOMAIN, workflow_id=wid, workflow_type="echo",
                    task_list="fo-tl", request_id=f"req-{wid}",
                    execution_start_to_close_timeout_seconds=600,
                ))
            for k in range(signals_each):
                signal("active", wid, f"s{k}")

        # drill 1: managed handover pays the backlog catch-up
        r_managed = coordinator.managed_handover(DOMAIN, "standby")

        # drill 2: divergence on the new active side, then region loss
        coordinator.await_convergence(DOMAIN, swallow=retryable)
        for wid in wids:
            signal("standby", wid, "orphan")
        for link in links.values():
            link.force_partition(True)
        t_loss = time.monotonic()
        r_forced = coordinator.forced_failover(
            DOMAIN, "active", lost_clusters=["standby"]
        )
        detect_to_promote_ms = (time.monotonic() - t_loss) * 1000.0
        for wid in wids:
            signal("active", wid, "promoted")

        # drill 3: the lost region recovers; storm resolves; failback
        for link in links.values():
            link.force_partition(False)
        t_heal = time.monotonic()
        r_failback = coordinator.failback(
            DOMAIN, "standby", swallow=retryable
        )
        converged_s = time.monotonic() - t_heal
        lag_final = max(
            int(c["transport"].estimator.lag_events)
            for c in clusters.values() if "transport" in c
        )

        def row(r, extra=None):
            d = {
                "handover_ms": round(r.handover_ms, 2),
                "unavailability_ms": round(r.unavailability_ms, 2),
                "lag_at_promote_events": r.replication_lag_at_promote,
                "conflicts_resolved": r.conflicts_resolved,
            }
            if extra:
                d.update(extra)
            return d

        unavail = [r_managed.unavailability_ms,
                   r_forced.unavailability_ms,
                   r_failback.unavailability_ms]
        return {
            "managed": row(r_managed,
                           {"drained_tasks": r_managed.drained_tasks}),
            "forced": row(r_forced, {
                "detect_to_promote_ms": round(detect_to_promote_ms, 2),
            }),
            "failback": row(r_failback, {
                "converged_s": round(converged_s, 3),
            }),
            "slo": {
                "unavailability_ms_bound": unavailability_slo_ms,
                "unavailability_ms_worst": round(max(unavail), 2),
                "met": bool(
                    max(unavail) < unavailability_slo_ms
                    and r_failback.conflicts_resolved >= 1
                    and lag_final == 0
                ),
            },
            "conflicts_resolved_total": r_failback.conflicts_resolved,
            "replication_lag_events_final": lag_final,
            "link_bytes_per_s": bytes_per_s,
            "bytes_shipped": sum(l.bytes_total for l in links.values()),
        }
    finally:
        for c in clusters.values():
            c["svc"].stop()
            c["matching"].shutdown()
