"""Counters and histogram timers for the rebuild path.

A trimmed copy of the reference package's ``utils/metrics.py``: a
thread-safe ``Registry`` of counters and exponential-bucket histogram
timers, and the tagged ``Scope`` the rebuilder and the checkpoint plane
write to. Timers bucket by powers of two from 1 µs; ``timer_stats``
returns ``(count, total_s, max_s)`` with ``p50``/``p99``/``avg``
(linear interpolation inside the winning bucket, clamped to the observed
max). Gauges, windows, the series cap and the device metrics plane of the
reference module are not ported.
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

TagTuple = Tuple[Tuple[str, str], ...]

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
    """``(count, total_s, max_s)`` with ``p50``/``p99``/``avg``
    (seconds) and ``quantile(q)`` as attributes."""

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
    def avg(self) -> float:
        return self[1] / self[0] if self[0] else 0.0

    def quantile(self, q: float) -> float:
        return self._hist.quantile(q)

    @property
    def p50(self) -> float:
        return self._hist.quantile(0.50)

    @property
    def p99(self) -> float:
        return self._hist.quantile(0.99)


class Registry:
    """Thread-safe store of counters and timers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, TagTuple], int] = defaultdict(int)
        self._timers: Dict[Tuple[str, TagTuple], Histogram] = {}

    def inc(self, name: str, tags: TagTuple, delta: int = 1) -> None:
        with self._lock:
            self._counters[(name, tags)] += delta

    def record(self, name: str, tags: TagTuple, seconds: float) -> None:
        with self._lock:
            hist = self._timers.get((name, tags))
            if hist is None:
                hist = self._timers[(name, tags)] = Histogram()
            hist.record(seconds)

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

    def timer(self, name: str) -> Timer:
        return Timer(self.registry, name, self._key)

    def record(self, name: str, seconds: float) -> None:
        self.registry.record(name, self._key, seconds)


NOOP = Scope()  # shared default; the registry is thread-safe
