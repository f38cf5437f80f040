"""Counters, gauges and histogram timers for the rebuild and serving
paths.

A trimmed copy of the reference package's ``utils/metrics.py``: a
thread-safe ``Registry`` of counters, last-value gauges and
exponential-bucket histogram timers, and the tagged ``Scope`` the
rebuilder, the checkpoint plane and the serving engine write to. Timers
bucket by powers of two from 1 µs; ``timer_stats`` returns
``(count, total_s, max_s)`` with ``p50``/``p99``/``avg`` (linear
interpolation inside the winning bucket, clamped to the observed max);
``snapshot()`` is the registry's debug dump, which the replication tests
read. ``Window`` / ``WindowReading`` give interval deltas over a
registry (the capacity autopilot's sense step reads them).

Cardinality is bounded: a Registry admits at most ``max_series``
distinct (name, tags) series per kind; past the cap, new series
collapse into an ``overflow="true"`` sink series per metric name and
``metrics_dropped_series`` counts the suppressed writes — a tag
explosion (e.g. a runaway per-workflow tag) degrades percentile
attribution, never process memory. The device metrics plane of the
reference module is not ported.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from .locks import make_guarded, make_lock

TagTuple = Tuple[Tuple[str, str], ...]

# where writes land once the series cap is hit (per metric name)
OVERFLOW_TAGS: TagTuple = (("overflow", "true"),)
DROPPED_SERIES = "metrics_dropped_series"

_DEFAULT_MAX_SERIES = 8192

# bucket i holds values in (2^(i-1), 2^i] µs; bucket 0 holds <= 1 µs
_BUCKET0_S = 1e-6
_NBUCKETS = 64


def _tags_key(tags: Optional[Dict[str, str]]) -> TagTuple:
    return tuple(sorted((tags or {}).items()))


def _bucket_index(seconds: float) -> int:
    if seconds <= _BUCKET0_S:
        return 0
    # v = m * 2^e with m in [0.5, 1.0); an exact power of two (m == 0.5)
    # belongs to the lower bucket (bounds are upper-inclusive)
    m, e = math.frexp(seconds / _BUCKET0_S)
    if m == 0.5:
        e -= 1
    return e if e < _NBUCKETS else _NBUCKETS - 1


def bucket_bounds(index: int) -> Tuple[float, float]:
    """(lo_s, hi_s] covered by bucket ``index``."""
    hi = _BUCKET0_S * (2.0 ** index)
    lo = 0.0 if index == 0 else hi / 2.0
    return lo, hi


class Histogram:
    """One series' distribution; the registry lock guards it."""

    __slots__ = ("counts", "count", "total", "max")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * _NBUCKETS
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds
        self.counts[_bucket_index(seconds)] += 1

    def merge(self, other: "Histogram") -> None:
        self.count += other.count
        self.total += other.total
        if other.max > self.max:
            self.max = other.max
        for i, c in enumerate(other.counts):
            if c:
                self.counts[i] += c

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]."""
        if self.count == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            cum += c
            if cum >= target:
                lo, hi = bucket_bounds(i)
                hi = min(hi, self.max)
                lo = min(lo, hi)
                return lo + (hi - lo) * (target - (cum - c)) / c
        return self.max


class TimerStats(tuple):
    """``(count, total_s, max_s)`` with ``max_s``, ``p50``/``p95``/
    ``p99``/``avg`` (seconds) and ``quantile(q)`` as attributes."""

    def __new__(cls, hist: Optional[Histogram] = None):
        h = hist if hist is not None else Histogram()
        self = super().__new__(cls, (h.count, h.total, h.max))
        self._hist = h
        return self

    @property
    def count(self) -> int:
        return self[0]

    @property
    def total_s(self) -> float:
        return self[1]

    @property
    def max_s(self) -> float:
        return self[2]

    @property
    def avg(self) -> float:
        return self[1] / self[0] if self[0] else 0.0

    def quantile(self, q: float) -> float:
        return self._hist.quantile(q)

    @property
    def p50(self) -> float:
        return self._hist.quantile(0.50)

    @property
    def p95(self) -> float:
        return self._hist.quantile(0.95)

    @property
    def p99(self) -> float:
        return self._hist.quantile(0.99)


class Registry:
    """Thread-safe store of counters and timers, cardinality-capped."""

    def __init__(self, max_series: int = _DEFAULT_MAX_SERIES) -> None:
        self._lock = make_lock("Registry._lock")
        self._max_series = max(int(max_series), 1)
        self._series = 0
        self._counters: Dict[Tuple[str, TagTuple], int] = make_guarded(
            defaultdict(int), "Registry._counters", self._lock
        )
        self._gauges: Dict[Tuple[str, TagTuple], float] = make_guarded(
            {}, "Registry._gauges", self._lock
        )
        self._timers: Dict[Tuple[str, TagTuple], Histogram] = make_guarded(
            {}, "Registry._timers", self._lock
        )

    def _admit(self, table, name: str, tags: TagTuple):
        """Series admission under the lock: an existing key passes; a
        new key past the cap collapses into the per-name overflow sink
        and bumps the dropped-writes counter."""
        key = (name, tags)
        if key in table:
            return key
        if self._series >= self._max_series and tags != OVERFLOW_TAGS:
            self._counters[(DROPPED_SERIES, ())] += 1
            # the sink series itself is admitted uncounted: names are
            # code-bounded, tags are what explode
            return (name, OVERFLOW_TAGS)
        if tags != OVERFLOW_TAGS:
            self._series += 1
        return key

    def inc(self, name: str, tags: TagTuple, delta: int = 1) -> None:
        with self._lock:
            self._counters[self._admit(self._counters, name, tags)] += delta

    def gauge(self, name: str, tags: TagTuple, value: float) -> None:
        with self._lock:
            self._gauges[self._admit(self._gauges, name, tags)] = value

    def record(self, name: str, tags: TagTuple, seconds: float) -> None:
        with self._lock:
            key = self._admit(self._timers, name, tags)
            hist = self._timers.get(key)
            if hist is None:
                hist = self._timers[key] = Histogram()
            hist.record(seconds)

    def series_count(self) -> int:
        with self._lock:
            return self._series

    def counter_value(
        self, name: str, tags: Optional[Dict[str, str]] = None,
    ) -> int:
        """One series (``tags`` given) or the sum over every series of
        ``name``."""
        with self._lock:
            if tags is not None:
                return self._counters.get((name, _tags_key(tags)), 0)
            return sum(v for (n, _), v in self._counters.items()
                       if n == name)

    def gauge_value(
        self, name: str, tags: Optional[Dict[str, str]] = None,
        default: float = 0.0,
    ) -> float:
        """The last value of one series (``tags`` given) or the largest
        last value over every series of ``name``."""
        with self._lock:
            if tags is not None:
                return self._gauges.get((name, _tags_key(tags)), default)
            vals = [v for (n, _), v in self._gauges.items() if n == name]
        return max(vals) if vals else default

    def timer_stats(
        self, name: str, tags: Optional[Dict[str, str]] = None,
    ) -> TimerStats:
        """Stats for one series (``tags`` given) or the merged
        distribution of every series of ``name``."""
        agg = Histogram()
        with self._lock:
            for (n, t), hist in self._timers.items():
                if n == name and (tags is None or t == _tags_key(tags)):
                    agg.merge(hist)
        return TimerStats(agg)

    def timer_quantile(
        self, name: str, q: float, tags: Optional[Dict[str, str]] = None,
    ) -> float:
        """Histogram-backed quantile in seconds (0.0 when unobserved)."""
        return self.timer_stats(name, tags).quantile(q)

    def snapshot(self) -> Dict[str, Dict]:
        # copy raw state under the lock, then do the expensive part —
        # per-series quantile walks and key formatting — OUTSIDE it: a
        # debug snapshot over thousands of series must not stall every
        # serving thread's inc()/record() on the shared registry
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            timers_raw = [
                (n, t, h.count, h.total, h.max, list(h.counts))
                for (n, t), h in self._timers.items()
            ]
        timers = {}
        for n, t, count, total, mx, counts in timers_raw:
            h = Histogram()
            h.count, h.total, h.max, h.counts = count, total, mx, counts
            timers[f"{n}{dict(t)}"] = {
                "count": count, "total_s": total, "max_s": mx,
                "p50_s": h.quantile(0.50), "p99_s": h.quantile(0.99),
            }
        return {
            "counters": {
                f"{n}{dict(t)}": v for (n, t), v in counters.items()
            },
            "gauges": {
                f"{n}{dict(t)}": v for (n, t), v in gauges.items()
            },
            "timers": timers,
        }


class WindowReading:
    """One interval's worth of samples: the difference between two
    consecutive ``Window.advance()`` snapshots. Counters are deltas,
    timers are delta histograms (real interval percentiles), gauges are
    the point-in-time value at the closing snapshot."""

    def __init__(
        self,
        counters: Dict[Tuple[str, TagTuple], int],
        gauges: Dict[Tuple[str, TagTuple], float],
        timers: Dict[Tuple[str, TagTuple], Histogram],
        span_s: float,
    ) -> None:
        self._counters = counters
        self._gauges = gauges
        self._timers = timers
        self.span_s = span_s

    def counter(self, name: str, tags: Optional[Dict[str, str]] = None) -> int:
        if tags is not None:
            return self._counters.get((name, _tags_key(tags)), 0)
        return sum(v for (n, _), v in self._counters.items() if n == name)

    def gauge(
        self, name: str, tags: Optional[Dict[str, str]] = None,
        default: float = 0.0,
    ) -> float:
        if tags is not None:
            return self._gauges.get((name, _tags_key(tags)), default)
        vals = [v for (n, _), v in self._gauges.items() if n == name]
        return max(vals) if vals else default

    def timer_stats(
        self, name: str, tags: Optional[Dict[str, str]] = None,
        where: Optional[Callable[[TagTuple], bool]] = None,
    ) -> TimerStats:
        """Interval stats for ``name``. With ``tags``, one exact series;
        otherwise all series merged — optionally filtered by ``where``,
        a predicate over each series' tag tuple (lets a consumer merge
        "every series except …" without touching internals)."""
        agg = Histogram()
        if tags is not None:
            hist = self._timers.get((name, _tags_key(tags)))
            if hist is not None:
                agg.merge(hist)
        else:
            for (n, t), hist in self._timers.items():
                if n == name and (where is None or where(t)):
                    agg.merge(hist)
        return TimerStats(agg)

    def timer_tags(self, name: str) -> List[TagTuple]:
        """Tag tuples of every series of ``name`` active this interval."""
        return [t for (n, t), h in self._timers.items() if n == name and h.count]


class Window:
    """Interval-delta view over a cumulative ``Registry``.

    Registry histograms accumulate since process start — useless for
    control ("what is p99 *now*?"). A ``Window`` snapshots raw bucket
    counts on every ``advance()`` and returns the difference as a
    ``WindowReading``: exactly the samples recorded between the two
    snapshots, with real interval percentiles. One Window per consumer;
    advancing one never perturbs another (or the registry itself)."""

    def __init__(self, registry: Registry) -> None:
        self.registry = registry
        self._prev_counters: Dict[Tuple[str, TagTuple], int] = {}
        self._prev_timers: Dict[
            Tuple[str, TagTuple], Tuple[int, float, float, List[int]]
        ] = {}
        self._prev_at = time.monotonic()

    def advance(self) -> WindowReading:
        reg = self.registry
        with reg._lock:
            counters = dict(reg._counters)
            gauges = dict(reg._gauges)
            timers_raw = {
                key: (h.count, h.total, h.max, list(h.counts))
                for key, h in reg._timers.items()
            }
        now = time.monotonic()
        span = max(now - self._prev_at, 0.0)

        counter_deltas = {
            key: v - self._prev_counters.get(key, 0)
            for key, v in counters.items()
        }
        timer_deltas: Dict[Tuple[str, TagTuple], Histogram] = {}
        for key, (count, total, mx, buckets) in timers_raw.items():
            pcount, ptotal, _pmx, pbuckets = self._prev_timers.get(
                key, (0, 0.0, 0.0, None)
            )
            h = Histogram()
            h.count = count - pcount
            h.total = total - ptotal
            if pbuckets is None:
                h.counts = list(buckets)
            else:
                h.counts = [c - p for c, p in zip(buckets, pbuckets)]
            # the cumulative max may predate this interval; clamp to the
            # upper bound of the highest bucket that saw a delta sample
            # (never above the all-time max)
            top = 0.0
            for i in range(_NBUCKETS - 1, -1, -1):
                if h.counts[i]:
                    top = bucket_bounds(i)[1]
                    break
            h.max = min(mx, top)
            timer_deltas[key] = h

        self._prev_counters = counters
        self._prev_timers = timers_raw
        self._prev_at = now
        return WindowReading(counter_deltas, gauges, timer_deltas, span)


class Timer:
    def __init__(self, registry: Registry, name: str, tags: TagTuple) -> None:
        self._registry, self._name, self._tags = registry, name, tags
        self._start = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._registry.record(
            self._name, self._tags, time.perf_counter() - self._start)


class Scope:
    """A tag context; sub-scopes add tags."""

    def __init__(
        self, registry: Optional[Registry] = None,
        tags: Optional[Dict[str, str]] = None,
    ) -> None:
        self.registry = registry or Registry()
        self._tags = dict(tags or {})
        self._key = _tags_key(self._tags)

    def tagged(self, **tags: str) -> "Scope":
        merged = dict(self._tags)
        merged.update(tags)
        return Scope(self.registry, merged)

    def inc(self, name: str, delta: int = 1) -> None:
        self.registry.inc(name, self._key, delta)

    def gauge(self, name: str, value: float) -> None:
        self.registry.gauge(name, self._key, value)

    def timer(self, name: str) -> Timer:
        return Timer(self.registry, name, self._key)

    def record(self, name: str, seconds: float) -> None:
        self.registry.record(name, self._key, seconds)


NOOP = Scope()  # shared default; the registry is thread-safe
