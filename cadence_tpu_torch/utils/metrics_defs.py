"""Per-API metric scope catalog + mechanical instrumentation.

The shape of the reference's scope catalog
(Cadence common/metrics/defs.go — ~2k lines of per-operation
scope definitions indexed by service): here the catalog is the
operation lists below, and every listed API gets the standard triple —
``requests`` counter, ``latency`` histogram timer, ``errors`` counter —
recorded under tags (service=..., operation=...).
``instrument_methods`` applies it mechanically to a handler object's
bound methods, mirroring how the reference wraps every Thrift handler
method in a scoped metrics client; since the telemetry plane landed it
ALSO opens a child span per call when (and only when) the calling
thread carries a sampled trace (utils/tracing.py — the unsampled path
is one thread-local read).

A copy of the reference package's ``utils/metrics_defs.py`` cut to the
host runtime: the frontend, history and matching operation lists, the
instrumentation, and the name catalogs of the planes ported so far:
replication and failover (``REPLICATION_METRICS``, ``FAILOVER_METRICS``),
the parallel queue executor (``PARQUEUE_METRICS``), resharding
(``RESHARD_METRICS``), the capacity autopilot (``AUTOPILOT_METRICS``),
fault injection (``FAULT_METRICS``), checkpoints (``CHECKPOINT_METRICS``),
the history engine (``ENGINE_METRICS``), the serving engine and its
harness (``SERVING_METRICS``, ``OVERLOAD_METRICS``), the device step
(``DEVICE_METRICS``) and the tracing
plane's self-telemetry (``TELEMETRY_METRICS``), plus the port's own
rebuilder and tick timers (``REBUILD_METRICS``,
``SERVING_TICK_METRICS``). The analysis gate's
``METRIC-UNDECLARED`` holds every literal emission to them.
``DEVICE_METRICS`` comes from the dispatcher (``ops/dispatch.py``) when a
scope is wired into it, directly, through ``replay_stream(metrics=)`` or
through ``StateRebuilder(metrics=)``.
"""

from __future__ import annotations

import time
from typing import Iterable

from .metrics import Scope
from . import tracing as _tracing

# --------------------------------------------------------------------------
# Scope catalog (reference: common/metrics/defs.go scope enums per service)
# --------------------------------------------------------------------------

FRONTEND_OPS = (
    "register_domain", "describe_domain", "list_domains", "update_domain",
    "deprecate_domain", "failover_domain",
    "start_workflow_execution", "signal_workflow_execution",
    "signal_with_start_workflow_execution",
    "terminate_workflow_execution", "request_cancel_workflow_execution",
    "reset_workflow_execution",
    "poll_for_decision_task", "poll_for_activity_task",
    "respond_decision_task_completed", "respond_decision_task_failed",
    "respond_activity_task_completed", "respond_activity_task_failed",
    "respond_activity_task_canceled", "record_activity_task_heartbeat",
    "respond_query_task_completed", "query_workflow",
    "get_workflow_execution_history", "describe_workflow_execution",
    "describe_task_list", "reset_sticky_task_list",
    "list_open_workflow_executions", "list_closed_workflow_executions",
    "list_workflow_executions", "scan_workflow_executions",
    "count_workflow_executions", "get_search_attributes",
    "list_archived_workflow_executions", "health",
    "list_task_list_partitions", "get_cluster_info",
)

HISTORY_OPS = (
    "start_workflow_execution", "signal_workflow_execution",
    "signal_with_start_workflow_execution",
    "terminate_workflow_execution", "request_cancel_workflow_execution",
    "reset_workflow_execution", "reset_sticky_task_list",
    "record_decision_task_started", "record_activity_task_started",
    "respond_decision_task_completed", "respond_decision_task_failed",
    "respond_activity_task_completed", "respond_activity_task_failed",
    "respond_activity_task_canceled", "record_activity_task_heartbeat",
    "record_child_execution_completed",
    "record_external_cancel_result", "record_external_signal_result",
    "record_child_execution_started", "record_start_child_execution_failed",
    "get_workflow_execution_history", "describe_workflow_execution",
    "query_workflow", "replicate_events_v2", "get_replication_messages",
    "sync_shard_status",
)

MATCHING_OPS = (
    "add_decision_task", "add_activity_task",
    "poll_for_decision_task", "poll_for_activity_task",
    "query_workflow", "respond_query_task_completed",
    "describe_task_list", "cancel_outstanding_polls",
    "list_task_list_partitions",
)


# Adaptive geo-replication (runtime/replication/transport.py) extends
# the consumer side: replication_lag_events / replication_lag_seconds
# gauge how far the standby's APPLIED STATE trails the source (events
# known outstanding on the link; seconds between the source clock and
# the newest applied event), replication_mode gauges the controller's
# link-wide mode (0 = event shipping, 1 = snapshot shipping) with
# replication_mode_switches counting transitions (hysteresis-damped),
# replication_bytes_shipped (tagged mode=) accounts every transfer,
# replication_snapshots_shipped / replication_snapshot_fallbacks count
# snapshot catch-ups and their event-path fallbacks (torn transfer,
# stale fingerprint, divergent branch), replication_backfill_events
# counts the deferred history bytes a snapshot owed, and
# replication_pump_backoffs counts failed pump cycles entering the
# capped jittered exponential backoff.
REPLICATION_METRICS = (
    "replication_ack_lag", "replication_tasks_applied",
    "replication_apply_latency",
    "replication_lag_events", "replication_lag_seconds",
    "replication_mode", "replication_mode_switches",
    "replication_bytes_shipped",
    "replication_snapshots_shipped", "replication_snapshot_fallbacks",
    "replication_backfill_events", "replication_pump_backoffs",
    # NDC conflict-resolution observability (runtime/replication/ndc.py):
    # branches_forked counts divergence points materialized (a fork at
    # the LCA), conflicts_resolved counts resolutions — the incoming
    # higher-version branch winning a rebuild-and-apply (inline or via
    # the batched drain) or a stale lower-version batch archived onto a
    # non-current branch. The failover drill reports read the counter
    # as "how big was the version-branch storm this failover caused".
    "replication_branches_forked", "replication_conflicts_resolved",
    # continue-as-new chain successors materialized by a catch-up heal
    # (rereplicator.py — the successor's first batch rides the
    # predecessor's task, which snapshot/raw-history catch-ups bypass)
    "replication_chain_heals",
    # dynamic per-link fetch paging (transport.page_size): the emit-page
    # cap last derived from the bandwidth/bytes-per-task EWMAs
    "replication_fetch_page_limit",
)

# domain failover drills (runtime/replication/failover.py), emitted by
# the coordinator under tags (layer=failover, kind=managed|forced|
# failback, domain=...): domain_failovers counts completed drills,
# failover_handover_ms times each drill end-to-end (histogram),
# failover_unavailability_ms times the flip-start → new-active-observes
# window (the span where neither side safely mints decisions),
# failover_replication_lag_at_promote gauges the events known
# outstanding on the inbound link when ownership flipped (0 for a
# drained managed handover; the dead link's last view for a forced
# promotion), and failover_conflicts_resolved accumulates the NDC
# version-branch resolutions each drill's heal phase caused (the
# registry delta of replication_conflicts_resolved across the drill).
FAILOVER_METRICS = (
    "domain_failovers",
    "failover_handover_ms",
    "failover_unavailability_ms",
    "failover_replication_lag_at_promote",
    "failover_conflicts_resolved",
)


# queue task-execution metrics are tagged (queue=..., task_type=...);
# task_outstanding gauges in-flight depth, task_held gauges the parked
# (DeferTask/retry) depth — the standby planes' hold depth. Replication
# emits replication_ack_lag (source side, tagged cluster=) plus
# replication_tasks_applied / replication_apply_latency (consumer side).
# Reference: common/metrics/defs.go task-type queue + replication scopes.
QUEUE_METRICS = (
    "task_requests", "task_latency", "task_errors", "task_outstanding",
    "task_held",
)
# Parallel queue executor (runtime/queues/parallel.py), scope tagged
# queue="parallel". parqueue_cycles / parqueue_tasks / parqueue_waves
# count pump cycles, tasks collected, and conflict groups executed;
# parqueue_wave_width records groups-per-cycle (the concurrency the
# matrix actually unlocked) and parqueue_conflict_frac the fraction of
# a cycle's tasks that conflicted into shared groups (1 - waves/tasks);
# parqueue_cycle_latency times one collect→schedule→execute round.
# parqueue_queues gauges registered pumps. The failure plane:
# parqueue_matrix_stale counts a commutativity-matrix artifact rejected
# at construction (version/fingerprint mismatch vs the live footprint
# table) with parqueue_degraded gauging the resulting sequential-only
# mode (1 = degraded — alert on it; the executor WARNS but will not
# resume parallel waves until rebuilt against a fresh artifact), and
# parqueue_stale_skipped counts tasks rejected wave-whole because their
# queue's ack generation moved (rewind/fence) between collect and run.
PARQUEUE_METRICS = (
    "parqueue_cycles", "parqueue_tasks", "parqueue_waves",
    "parqueue_wave_width", "parqueue_conflict_frac",
    "parqueue_cycle_latency", "parqueue_queues",
    "parqueue_matrix_stale", "parqueue_degraded",
    "parqueue_stale_skipped",
)

# chaos/fault-injection plane (testing/faults.py): every injected fault
# increments faults_injected under tags (layer=fault_injection,
# site=..., action=error|latency|torn_write), so a chaos run's blast
# radius is observable in the same registry as the errors it causes —
# the per-manager `<api>.errors.<ExcType>` counters from the metrics
# decorator count injected and real backend failures identically.
FAULT_METRICS = ("faults_injected",)

# elastic resharding (runtime/resharding.py), emitted by the coordinator
# under tags (layer=resharding): reshard_epoch gauges the committed
# routing epoch, handoff_ms times each reconfiguration end-to-end,
# checkpoints_shipped counts the snapshots flushed for the new owner,
# and suffix_events_replayed counts the events the new owner actually
# re-ran (total moved events minus events_replayed_saved — the
# "checkpoints, not histories" shipping proof the chaos suite asserts).
RESHARD_METRICS = (
    "reshard_epoch",
    "handoff_ms",
    "reshard_pause_ms",
    "checkpoints_shipped",
    "suffix_events_replayed",
    "reshard_commits",
    "reshard_rollbacks",
)

# capacity autopilot (runtime/autopilot.py), tagged (layer=autopilot).
# The epoch loop: autopilot_epochs/autopilot_epoch_seconds count and
# time every sense→decide→actuate pass; autopilot_skipped_epochs are
# passes that sensed but did not actuate (paused / not the elected
# actuator / frozen); autopilot_errors are passes that raised (the loop
# backs off and keeps going). Sensing: autopilot_sensed_p99_ms /
# autopilot_sensed_shed_frac are the raw interval readings,
# autopilot_demand_rps the smoothed OFFERED rate (admitted + shed —
# shed traffic is demand) the rate plane tracks, autopilot_pressure
# the EWMA'd p99/target (escalated by shed/target only once latency
# is at target — shed alone must not spiral the gate) the gate sees,
# autopilot_overload_engaged the gate state (1 = overloaded).
# Rate plane: autopilot_rate_retunes counts setpoint changes,
# autopilot_rate_rps (key=...) gauges each current setpoint,
# autopilot_cooldown_skips counts actuations suppressed by a cooldown
# or reshard backoff. Topology plane: autopilot_reshard_plans counts
# committed split/merge plans, autopilot_reshard_failures aborted ones
# (each engages the proposal backoff — never a hot retry). Guardrail:
# autopilot_guardrail_freezes counts do-no-harm trips,
# autopilot_reverts the rates restored to last-known-good,
# autopilot_frozen the freeze state gauge. Operator plane:
# autopilot_pauses/autopilot_resumes count the admin verbs,
# autopilot_paused gauges the current pause state.
AUTOPILOT_METRICS = (
    "autopilot_epochs",
    "autopilot_epoch_seconds",
    "autopilot_skipped_epochs",
    "autopilot_errors",
    "autopilot_sensed_p99_ms",
    "autopilot_sensed_shed_frac",
    "autopilot_demand_rps",
    "autopilot_pressure",
    "autopilot_overload_engaged",
    "autopilot_rate_retunes",
    "autopilot_rate_rps",
    "autopilot_cooldown_skips",
    "autopilot_reshard_plans",
    "autopilot_reshard_failures",
    "autopilot_guardrail_freezes",
    "autopilot_reverts",
    "autopilot_frozen",
    "autopilot_pauses",
    "autopilot_resumes",
    "autopilot_paused",
)

# checkpointed incremental replay (checkpoint/), emitted by
# the state rebuilder under tags (layer=checkpoint): every rebuild_many
# lookup counts exactly one of hit / miss / invalidated (invalidated =
# candidates existed but all failed validation: stale fingerprint,
# capacity mismatch, or NDC divergence before the snapshot), and
# events_replayed_saved accumulates the events a hit skipped — the
# direct measure of the O(depth) → O(new events) conversion.
CHECKPOINT_METRICS = (
    "checkpoint_hit",
    "checkpoint_miss",
    "checkpoint_invalidated",
    "events_replayed_saved",
)

# history engine workload counters (runtime/engine/engine.py), tagged
# (service=history, shard=...): today just the start rate; grows with
# the serving-path work (METRIC-UNDECLARED keeps this list honest).
ENGINE_METRICS = ("workflow_started",)

# device-step kernel telemetry (ops/dispatch.py), emitted per staged and
# replayed batch when the dispatcher has a metrics scope, under tags
# (layer=device, kernel=cuda|plain, mode=hist|lanes|hist_assoc|
# lanes_assoc): kernel=cuda for a batch on the card (the hand-written
# kernels), kernel=plain for one on the CPU (their plain versions). The
# reference package's xla|pallas name its two routes; the port's routes
# are these two. jit_cache_entries / jit_retraces read the port's
# counterpart of a compile: the kernel libraries ops/_build.py has loaded
# (0 on the CPU), and a library loaded after a batch is a "retrace":
#
#   device_batches       counter — batches replayed
#   host_stage_seconds   histogram — pack + H2D staging wall time
#   device_step_seconds  histogram — the batch's replay on the device:
#                        on the card the elapsed time of a timing-event
#                        pair on the replay's stream around it (read
#                        once the end event completes; no synchronise
#                        per batch), on the CPU the host's time of it
#   batch_width          histogram — padded batch width per dispatch
#                        (the compiled-executable grid in action)
#   padding_frac         gauge — padded slots ÷ real events of the last
#                        batch (the lane packer's waste)
#   lane_occupancy       gauge — histories per lane of the last
#                        lane-packed batch
#   jit_cache_entries    gauge — kernel libraries loaded in this
#                        process (ops/_build.py)
#   jit_retraces         counter — growth of that count observed after a
#                        batch (a build on the serving path shows up
#                        here first)
DEVICE_METRICS = (
    "device_batches",
    "host_stage_seconds",
    "device_step_seconds",
    "batch_width",
    "padding_frac",
    "lane_occupancy",
    "jit_cache_entries",
    "jit_retraces",
)

# the state rebuilder (runtime/replication/rebuilder.py), tagged
# (layer=rebuild): host_fallbacks counts the runs the host oracle
# rebuilt after the packer refused their batch; the timers
# history_read (checkpoint consult and history read), dispatch_wait
# (waiting on the dispatcher's packed and replayed batches), rehydrate
# (rows to MutableStates, task refresh, checkpoint writes) and
# host_fallback split a rebuild_many call's wall.
REBUILD_METRICS = (
    "host_fallbacks",
    "history_read",
    "dispatch_wait",
    "rehydrate",
    "host_fallback",
)

# the serving engine's split of a compose group's wall (serving/
# engine.py), tagged (layer=serving): the pack of its Δs, the replay
# on the device, the commit of its rows into the lanes.
SERVING_TICK_METRICS = (
    "serving_tick_pack",
    "serving_tick_replay",
    "serving_tick_commit",
)

# continuous-batching serving engine (serving/), emitted
# under tags (layer=serving) by the ResidentEngine and
# (layer=serving_harness) by the open-loop load harness:
#
#   serving_admits            counter — workflows seated into lanes
#   serving_admit_cold        counter — seats that cold-replayed the prefix
#   serving_admit_resume      counter — seats rehydrated from a checkpoint
#   serving_admit_queued      counter — admits parked (all lanes busy)
#   serving_admit_failures    counter — seats dropped (unpackable history)
#   serving_appends           counter — Δ suffixes staged
#   serving_append_events     counter — events across staged Δs
#   serving_stale_appends     counter — generation-stamp rejections (a
#                             stale ticket/in-flight step on a recycled
#                             slot — the invariant, observable)
#   serving_gapped_appends    counter — appends refused because events
#                             between the staged tip and the batch
#                             never arrived (bare lanes only; history-
#                             backed lanes record the debt and the
#                             catch-up heals it)
#   serving_ticks             counter — fused device steps run
#   serving_tick_seconds      histogram — per-tick wall time
#   serving_append_width      counter per grid-rounded width tag —
#                             lanes composed per tick (the batch shape)
#   serving_events_replayed   counter — events composed (O(Δ) proof:
#                             ≈ serving_append_events, never O(depth))
#   serving_compose_failures  counter — lanes whose Δ was unreplayable
#                             (lane freed; readmit-from-store recovers)
#   serving_lane_occupancy    gauge — seated lanes ÷ S
#   serving_evictions         counter — lanes flushed + freed
#   serving_recycles          counter — freed slots refilled from the
#                             admission queue
#   serving_flush_failures    counter — eviction flushes that did not
#                             land (readmit degrades to cold replay)
#   serving_resident_hits     counter — reads answered from a lane
#   serving_cold_misses       counter — reads that fell to cold replay
#   serving_cold_read_failures counter — cold reads the serving caps
#                             could not pack/replay (returned None;
#                             the rebuild verbs stay the recovery path)
#   serving_read_seconds      histogram — read wall time
#   serve_decision            histogram — open-loop decision latency
#                             (scheduled arrival → read done; p50/p99
#                             in the bench serve_continuous record)
#   serve_shed                counter — arrivals shed by the admission
#                             token bucket / a failed seat
#   serving_admit_starvation_age_ms histogram — how long a parked
#                             admission waited before the fair refill
#                             seated it (deadline aging bounds the p100:
#                             TestOverloadChaos's no-starvation proof)
#   serving_staleness_ms      histogram — first-dirty → composed per
#                             lane; the tick pump holds its p99 under
#                             the configured staleness bound even for
#                             write-heavy/read-light lanes
#   serving_tick_pump_errors  counter — pump cycles that failed (the
#                             pump logs, backs off capped, keeps going)
SERVING_METRICS = (
    "serving_admits",
    "serving_admit_cold",
    "serving_admit_resume",
    "serving_admit_queued",
    "serving_admit_failures",
    "serving_appends",
    "serving_append_events",
    "serving_stale_appends",
    "serving_gapped_appends",
    "serving_ticks",
    "serving_tick_seconds",
    "serving_append_width",
    "serving_events_replayed",
    "serving_compose_failures",
    "serving_lane_occupancy",
    "serving_evictions",
    "serving_recycles",
    "serving_flush_failures",
    "serving_resident_hits",
    "serving_cold_misses",
    "serving_cold_read_failures",
    "serving_read_seconds",
    "serve_decision",
    "serve_shed",
    "serving_admit_starvation_age_ms",
    "serving_staleness_ms",
    "serving_tick_pump_errors",
)

# overload control plane, emitted by the layers that shed
# or give up: frontend_requests_shed counts frontend rate-limit
# rejections under tags (service=frontend, domain=...) — each carries
# a retry-after hint on the ServiceBusyError; retry_budget_exhausted
# counts the moments a client's success-refilled retry budget denied a
# ServiceBusy re-offer (layer=client) or the open-loop harness's
# simulated client did the same (layer=serving_harness) — the
# retry-storm breaker firing, i.e. load that was offered once and NOT
# multiplied.
OVERLOAD_METRICS = (
    "frontend_requests_shed",
    "retry_budget_exhausted",
)

# tracing plane self-telemetry (utils/tracing.py + utils/metrics.py),
# tagged (layer=telemetry): traces_sampled counts sampled roots,
# spans_recorded/spans_dropped account the flight-recorder ring buffer
# (dropped = evicted by capacity before export), and
# metrics_dropped_series counts emissions the registry's max-series cap
# collapsed into the overflow sink (a tag-cardinality explosion is
# observable instead of an OOM).
TELEMETRY_METRICS = (
    "traces_sampled",
    "spans_recorded",
    "spans_dropped",
    "metrics_dropped_series",
)

# the standard per-operation triple
REQUESTS = "requests"
LATENCY = "latency"
ERRORS = "errors"


def raw_method(fn):
    """The pre-instrumentation bound method (identity if unwrapped).
    Internal delegations use this so one RPC never phantom-counts as
    several; unwraps through layered wrapping."""
    while hasattr(fn, "__wrapped__"):
        fn = fn.__wrapped__
    return fn


def instrument_methods(
    obj, scope: Scope, operations: Iterable[str],
) -> None:
    """Wrap each existing bound method in the standard triple plus a
    trace span. Missing names are skipped so the catalog can list the
    full API surface while handlers grow into it.

    The span piggybacks on the same mechanical wrapping: when the
    calling thread carries a sampled trace (utils/tracing.py), the call
    records a child span named after the operation under the scope's
    service tag — frontend → history → matching hops all run in the
    caller's thread, so this single hook links the whole in-process
    chain. With no active trace, ``TRACER.span`` returns the shared
    no-op after one thread-local read — the unsampled cost the bench
    ``telemetry_overhead`` guard pins at ≤3%."""
    service = getattr(scope, "_tags", {}).get("service", "")
    tracer = _tracing.TRACER
    for op in operations:
        fn = getattr(obj, op, None)
        if fn is None or not callable(fn):
            continue
        op_scope = scope.tagged(operation=op)

        def wrapped(*args, __fn=fn, __scope=op_scope, __op=op,
                    __tls=tracer._tls, **kwargs):
            __scope.inc(REQUESTS)
            t0 = time.perf_counter()
            if getattr(__tls, "span", None) is None:
                # unsampled fast path: one thread-local read, no span
                # machinery at all (the bench telemetry_overhead guard
                # pins this branch at ≤3% vs the metrics-only wrapper)
                try:
                    return __fn(*args, **kwargs)
                except Exception:
                    __scope.inc(ERRORS)
                    raise
                finally:
                    __scope.record(LATENCY, time.perf_counter() - t0)
            with tracer.span(__op, service=service):
                try:
                    return __fn(*args, **kwargs)
                except Exception:
                    __scope.inc(ERRORS)
                    raise
                finally:
                    __scope.record(LATENCY, time.perf_counter() - t0)

        wrapped.__name__ = op
        wrapped.__wrapped__ = fn
        setattr(obj, op, wrapped)
