"""Persistence decorator clients: metrics + rate limiting.

Reference: common/persistence/persistenceMetricClients.go (per-API
latency/error counters around every manager) and
persistenceRateLimitedClients.go (token-bucket QPS guards returning
ServiceBusyError when saturated). Decorators are generic:
they wrap any manager object and intercept its public methods, so one
implementation covers all five managers — the factory stacks them the
same way the reference's persistence-factory does.

A copy of the reference package's ``runtime/persistence/decorators.py``.
``wrap_bundle`` installs the testing clients (fault injection, the
effect witness, the sanitizer's probe) in the reference's order when
asked for, and none of them by default.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from ...utils.metrics import NOOP, Scope
from ...utils.quotas import TokenBucket


class PersistenceBusyError(Exception):
    """QPS limit hit (reference: ServiceBusyError from rate-limited
    persistence clients)."""


class _Wrapped:
    """Base proxy: public methods pass through hooks."""

    def __init__(self, base: Any) -> None:
        self._base = base

    def _invoke(self, name: str, method, args, kwargs):
        return method(*args, **kwargs)

    def __getattr__(self, name: str):
        attr = getattr(self._base, name)
        if not callable(attr) or name.startswith("_"):
            return attr

        def call(*args, **kwargs):
            return self._invoke(name, attr, args, kwargs)

        return call


class MetricsClient(_Wrapped):
    """Latency + error counters per persistence API, plus a trace span
    per call when the calling thread carries a sampled trace
    (utils/tracing.py) — the store hop of the end-to-end request trace.
    The untraced path adds one current-span check; the span name and
    the span machinery are only built when a trace is live."""

    def __init__(self, base: Any, metrics: Scope = NOOP,
                 manager: str = "") -> None:
        super().__init__(base)
        self._manager = manager or type(base).__name__
        self._metrics = metrics.tagged(
            layer="persistence", manager=self._manager
        )

    def _invoke(self, name, method, args, kwargs):
        from ...utils.tracing import NOOP_SPAN, TRACER

        span = (
            NOOP_SPAN if TRACER.current() is None
            else TRACER.span(
                f"{self._manager}.{name}", service="persistence"
            )
        )
        start = time.monotonic()
        try:
            with span:
                out = method(*args, **kwargs)
        except Exception as e:
            self._metrics.inc(f"{name}.errors")
            self._metrics.inc(f"{name}.errors.{type(e).__name__}")
            raise
        finally:
            self._metrics.record(
                f"{name}.latency", time.monotonic() - start
            )
        self._metrics.inc(f"{name}.calls")
        return out


class RateLimitedClient(_Wrapped):
    """Token-bucket QPS guard in front of a manager."""

    def __init__(self, base: Any, max_qps: float = 2000.0,
                 bucket: Optional[TokenBucket] = None) -> None:
        super().__init__(base)
        self._bucket = bucket or TokenBucket(max_qps)

    def _invoke(self, name, method, args, kwargs):
        if not self._bucket.allow():
            raise PersistenceBusyError(
                f"persistence QPS limit hit on {name}"
            )
        return method(*args, **kwargs)


def wrap_bundle(bundle, metrics: Scope = NOOP,
                max_qps: Optional[float] = None,
                faults=None, effects=False, sanitize=False):
    """Layer metrics (and optionally rate limits) over every manager in
    a PersistenceBundle, mirroring persistence-factory/factory.go.

    ``faults`` (a testing.faults.FaultSchedule) installs the fault-
    injection client INNERMOST — under the metrics client, so injected
    errors/latency are counted like real backend misbehavior, and under
    the rate limiter, so an injected PersistenceBusyError surfaces to
    the caller untranslated. Nothing is installed when it is None: the
    default factory stack pays zero overhead for the chaos machinery.

    ``effects=True`` installs the effect-witness recording client
    (testing/effect_witness.py) BELOW the fault client — the witness
    must see the real store calls, so an injected error that never
    reached the backend is not recorded while a torn write that landed
    is. Testing-only, like ``faults``.

    ``sanitize=True`` installs the concurrency sanitizer's store probe
    (testing/race_witness.SanitizerProbeClient) OUTERMOST — every
    attempted store call made while the caller holds a tracked lock is
    a RUNTIME-LOCK-BLOCKING observation, injected faults included (a
    fault that stalls the caller under a lock is as real a stall as a
    slow backend). Testing-only, like ``faults``/``effects``.
    """
    from .interfaces import PersistenceBundle

    fault_client = None
    if faults is not None:
        # lazy import: the runtime layer must not depend on the testing
        # package unless fault injection is actually configured
        from ...testing.faults import FaultInjectionClient

        fault_client = FaultInjectionClient
    effect_client = None
    if effects:
        from ...testing.effect_witness import (
            EffectRecordingClient,
        )

        effect_client = EffectRecordingClient
    sanitize_client = None
    if sanitize:
        from ...testing.race_witness import SanitizerProbeClient

        sanitize_client = SanitizerProbeClient

    def deco(mgr, name):
        if mgr is None:
            return None
        out = mgr
        if effect_client is not None:
            out = effect_client(out, manager=name)
        if fault_client is not None:
            out = fault_client(out, faults, manager=name)
        out = MetricsClient(out, metrics, manager=name)
        if max_qps is not None:
            out = RateLimitedClient(out, max_qps)
        if sanitize_client is not None:
            out = sanitize_client(out, manager=name)
        return out

    return PersistenceBundle(
        shard=deco(bundle.shard, "shard"),
        execution=deco(bundle.execution, "execution"),
        history=deco(bundle.history, "history"),
        task=deco(bundle.task, "task"),
        metadata=deco(bundle.metadata, "metadata"),
        visibility=deco(bundle.visibility, "visibility"),
        # chaos rules on persistence.checkpoint exercise the replay
        # plane's degrade-to-full-replay fallback
        checkpoint=deco(getattr(bundle, "checkpoint", None), "checkpoint"),
    )
