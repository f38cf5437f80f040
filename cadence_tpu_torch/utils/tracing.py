"""End-to-end request tracing: spans, trace contexts, flight recorder.

The missing third leg of the observability plane (metrics.py counts,
log.py narrates, nothing *connects*): a ``Tracer`` hands out ``Span``s
with monotonic timings and parent/child links, and a ``TraceContext``
(trace_id, span_id, sampled) small enough to ride every existing hop —
gRPC metadata on the cross-process paths (rpc/client.py injects,
rpc/server.py extracts), the thread itself on the in-process paths
(frontend → history → matching all run in the caller's thread, so a
thread-local "current span" is the propagation), and a bounded
workflow-keyed binding table for the asynchronous hops (queue task
processing and replication apply run on pump threads; the engine binds
``workflow_id → context`` at persist time and the pump joins the trace
by lookup).

Completed spans land in a bounded in-process flight recorder (a ring
buffer — old traces fall off, memory never grows), read back with
``Tracer.spans()`` / ``traces()``.

Cost discipline (the serving path must not pay for disabled
telemetry): nothing here creates implicit root traces. A root exists
only when (a) code explicitly enters ``tracer.trace(...)`` (tests, the
serving demo, the canary), or (b) an RPC server roots one at the
configured ``sample_rate`` (``telemetry:`` YAML section through
bootstrap). Every other entry point — ``span()``, ``annotate()``,
``bind()`` — first reads the thread-local current span and returns the
shared no-op immediately when there is none: the unsampled path is one
attribute lookup and a None check.

A copy of the reference package's ``utils/tracing.py`` without what the
port has no caller for yet: the wire form of a context and the gRPC
metadata helpers (with the rpc layer), the Chrome-trace export and the
module-level shortcuts (with the pprof endpoints, A.14).
"""

from __future__ import annotations

import itertools
import random
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from .metrics import NOOP, Scope

class TraceContext:
    """The propagated identity of a position in a trace: enough to
    parent a child span anywhere the context can be carried."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 sampled: bool = True) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def __repr__(self) -> str:  # debugging aid only
        return (f"TraceContext({self.trace_id}:{self.span_id}:"
                f"{int(self.sampled)})")


class _NoopSpan:
    """Shared do-nothing span: what every tracing entry point returns
    on the unsampled path, so call sites never branch on None."""

    __slots__ = ()
    ctx = None
    trace_id = ""
    span_id = ""
    sampled = False

    def annotate(self, text: str) -> None:
        pass

    def set_tag(self, key: str, value) -> None:
        pass

    def finish(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NOOP_SPAN = _NoopSpan()

_span_counter = itertools.count(1)


def _new_span_id() -> str:
    # counter + thread id: unique within the process without an entropy
    # syscall per span (trace ids carry the global uniqueness)
    return f"{threading.get_ident() & 0xffff:x}.{next(_span_counter)}"


class Span:
    """One timed operation in a trace. Context-manager: entering makes
    it the thread's current span (children created on this thread nest
    under it), exiting finishes it into the flight recorder."""

    __slots__ = (
        "tracer", "name", "service", "trace_id", "span_id", "parent_id",
        "tags", "annotations", "thread", "start_us", "_t0", "dur_us",
        "_prev", "error",
    )

    def __init__(self, tracer: "Tracer", name: str, service: str,
                 trace_id: str, parent_id: str,
                 tags: Optional[Dict[str, Any]] = None) -> None:
        self.tracer = tracer
        self.name = name
        self.service = service or "app"
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.tags: Dict[str, Any] = dict(tags) if tags else {}
        self.annotations: List[Tuple[float, str]] = []
        self.thread = threading.current_thread().name
        # wall clock anchors the Chrome-trace timeline; the monotonic
        # clock owns every duration and annotation offset
        self.start_us = time.time() * 1e6
        self._t0 = time.perf_counter()
        self.dur_us: float = 0.0
        self._prev = None
        self.error: str = ""

    sampled = True

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id, True)

    def annotate(self, text: str) -> None:
        """Timestamped breadcrumb (retries, fault injections, fallback
        decisions) — rendered as an instant event on the timeline."""
        self.annotations.append(
            ((time.perf_counter() - self._t0) * 1e6, str(text))
        )

    def set_tag(self, key: str, value) -> None:
        self.tags[key] = value

    def finish(self) -> None:
        if self.dur_us:
            return  # idempotent: a double finish must not double-record
        self.dur_us = max((time.perf_counter() - self._t0) * 1e6, 0.01)
        self.tracer._record(self)

    def __enter__(self) -> "Span":
        self._prev = self.tracer._activate(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.error = exc_type.__name__
            self.tags.setdefault("error", exc_type.__name__)
        self.tracer._deactivate(self._prev)
        self.finish()


class Tracer:
    """Span factory + thread-local context + flight recorder; one per
    process (module singleton ``TRACER``), thread-safe."""

    def __init__(self, sample_rate: float = 0.0, capacity: int = 4096,
                 bind_capacity: int = 2048, bind_ttl_s: float = 60.0,
                 metrics: Scope = NOOP,
                 seed: Optional[int] = None) -> None:
        self.sample_rate = float(sample_rate)
        self.capacity = int(capacity)
        self._bind_capacity = int(bind_capacity)
        self._bind_ttl_s = float(bind_ttl_s)
        self._metrics = metrics.tagged(layer="telemetry")
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)
        # key -> (context, bound-at monotonic time); LRU + TTL
        self._bindings: "OrderedDict[Any, Tuple[TraceContext, float]]" = (
            OrderedDict()
        )
        self._tls = threading.local()

    # -- configuration -------------------------------------------------

    def configure(self, sample_rate: Optional[float] = None,
                  capacity: Optional[int] = None,
                  metrics: Optional[Scope] = None) -> "Tracer":
        """Re-point the live tracer (bootstrap's ``telemetry:`` section
        and tests share the process singleton)."""
        with self._lock:
            if sample_rate is not None:
                self.sample_rate = float(sample_rate)
            if capacity is not None and int(capacity) != self.capacity:
                self.capacity = int(capacity)
                self._spans = deque(self._spans, maxlen=self.capacity)
            if metrics is not None:
                self._metrics = metrics.tagged(layer="telemetry")
        return self

    # -- context plumbing ----------------------------------------------

    def current(self) -> Optional[Span]:
        """The thread's active span (None on the unsampled path). THE
        hot-path check: one thread-local attribute read."""
        return getattr(self._tls, "span", None)

    def current_context(self) -> Optional[TraceContext]:
        span = getattr(self._tls, "span", None)
        return span.ctx if span is not None else None

    def _activate(self, span: Optional[Span]) -> Optional[Span]:
        prev = getattr(self._tls, "span", None)
        self._tls.span = span
        return prev

    def _deactivate(self, prev: Optional[Span]) -> None:
        self._tls.span = prev

    # -- span creation -------------------------------------------------

    def trace(self, name: str, sampled: Optional[bool] = None,
              service: str = "app", **tags):
        """Root a new trace. ``sampled=None`` rolls ``sample_rate``;
        tests and the demo pass ``sampled=True`` explicitly. Returns the
        shared no-op when the roll loses — callers always get a span."""
        if sampled is None:
            sampled = (
                self.sample_rate > 0.0
                and self._rng.random() < self.sample_rate
            )
        if not sampled:
            return NOOP_SPAN
        self._metrics.inc("traces_sampled")
        return Span(
            self, name, service, uuid.uuid4().hex[:16], "", tags=tags
        )

    def span(self, name: str, service: str = "",
             parent: Optional[object] = None, **tags):
        """Child span under ``parent`` (a Span or TraceContext) or the
        thread's current span. No parent → no-op: children never root
        traces implicitly."""
        if parent is None:
            parent = getattr(self._tls, "span", None)
            if parent is None:
                return NOOP_SPAN
        ctx = parent.ctx if isinstance(parent, Span) else parent
        if ctx is None or not ctx.sampled:
            return NOOP_SPAN
        return Span(
            self, name, service, ctx.trace_id, ctx.span_id, tags=tags
        )

    def annotate(self, text: str) -> None:
        """Breadcrumb on the current span, if any (the fault injector's
        and retry loops' one-liner)."""
        span = getattr(self._tls, "span", None)
        if span is not None:
            span.annotate(text)

    # -- workflow-keyed binding (async hop joining) --------------------

    def bind(self, key, ctx: Optional[TraceContext] = None) -> None:
        """Associate ``key`` (e.g. a workflow id) with ``ctx`` (default:
        the current span's context) so pump threads can join the trace.
        Bounded LRU with a TTL — a binding outliving its request cannot
        keep pumping spans into a long-dead trace (a cron workflow's
        timers would otherwise join one ancient sampled request
        forever), and an abandoned binding ages out, never leaks."""
        if ctx is None:
            span = getattr(self._tls, "span", None)
            if span is None:
                return
            ctx = span.ctx
        with self._lock:
            self._bindings.pop(key, None)
            self._bindings[key] = (ctx, time.monotonic())
            while len(self._bindings) > self._bind_capacity:
                self._bindings.popitem(last=False)

    def lookup(self, key) -> Optional[TraceContext]:
        if not self._bindings:  # len() is atomic: lock-free fast path
            return None
        with self._lock:
            entry = self._bindings.get(key)
            if entry is None:
                return None
            ctx, bound_at = entry
            if time.monotonic() - bound_at > self._bind_ttl_s:
                del self._bindings[key]
                return None
            return ctx

    # -- flight recorder ----------------------------------------------

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self.capacity:
                self._metrics.inc("spans_dropped")
            self._spans.append(span)
        self._metrics.inc("spans_recorded")

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def traces(self) -> Dict[str, List[Span]]:
        """Finished spans grouped by trace, oldest trace first."""
        out: Dict[str, List[Span]] = {}
        for s in self.spans():
            out.setdefault(s.trace_id, []).append(s)
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._bindings.clear()


# the process tracer every layer shares (bootstrap configures it from
# the telemetry: YAML section; tests reconfigure + clear per test)
TRACER = Tracer()
