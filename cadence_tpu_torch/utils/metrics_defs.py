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
history host: the history and matching operation lists and the
instrumentation. The reference's ``*_METRICS`` name catalogs are read
only by its lint pass (``METRIC-UNDECLARED``), which is not ported.
"""

from __future__ import annotations

import time
from typing import Iterable

from .metrics import Scope
from . import tracing as _tracing

# --------------------------------------------------------------------------
# Scope catalog (reference: common/metrics/defs.go scope enums per service)
# --------------------------------------------------------------------------

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
