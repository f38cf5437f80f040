"""Token-bucket rate limiting.

A copy of the reference package's ``utils/quotas.py`` (Cadence
common/quotas and common/tokenbucket): a token bucket, the multi-stage
limiter (a global rate cap plus per-domain caps, both of which must admit
a request) and the success-refilled retry budget. The serving plane's
admission queue meters each domain's refill of freed lanes with a
``TokenBucket``, and the open-loop harness admits arrivals through a
bucket or a ``MultiStageRateLimiter`` and paces re-offers of shed
arrivals through a ``RetryBudget``, so rejected work backs off instead of
multiplying an overload.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional


class TokenBucket:
    def __init__(
        self,
        rps: float,
        burst: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.rps = float(rps)
        # remember whether the caller sized the burst: a later
        # set_rate(rps) must not silently clobber an explicit burst
        # back to int(rps)
        self._explicit_burst = burst is not None
        self.burst = burst if burst is not None else max(1, int(rps))
        self._tokens = float(self.burst)
        self._last = clock()
        self._clock = clock
        self._lock = threading.Lock()

    def set_rate(self, rps: float, burst: Optional[int] = None) -> None:
        """Live rate change. A caller-supplied burst (here or at
        construction) is preserved; only a derived burst re-derives."""
        with self._lock:
            self.rps = float(rps)
            if burst is not None:
                self._explicit_burst = True
                self.burst = int(burst)
            elif not self._explicit_burst:
                self.burst = max(1, int(rps))
            self._tokens = min(self._tokens, float(self.burst))

    def allow(self, n: int = 1) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rps
            )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after_s(self, n: int = 1) -> float:
        """Seconds until ``n`` tokens accrue at the current rate, the
        shed response's retry-after hint. 0.0 when tokens are already
        available (a bucket that cannot refill, rps <= 0, hints one
        second rather than infinity)."""
        with self._lock:
            now = self._clock()
            tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rps
            )
            if tokens >= n:
                return 0.0
            if self.rps <= 0:
                return 1.0
            return (n - tokens) / self.rps


class MultiStageRateLimiter:
    """Global + per-domain token buckets; both must admit the request.

    The per-domain table is bounded (``max_domains``, LRU-evicted), so a
    churn of short-lived domain names cannot grow it without bound. An
    evicted domain that returns mints a fresh full bucket (more
    permissive for one burst, which is safe)."""

    def __init__(
        self,
        global_rps: float,
        domain_rps: Callable[[str], float],
        clock: Callable[[], float] = time.monotonic,
        max_domains: int = 1024,
        global_burst: Optional[int] = None,
    ) -> None:
        if max_domains < 1:
            raise ValueError("quotas: max_domains must be >= 1")
        self._global = TokenBucket(
            global_rps, burst=global_burst, clock=clock
        )
        self._domain_rps = domain_rps
        self._domains: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._max_domains = int(max_domains)
        self._clock = clock
        self._lock = threading.Lock()

    def _domain_bucket(self, domain: str) -> TokenBucket:
        rps = self._domain_rps(domain)
        with self._lock:
            bucket = self._domains.get(domain)
            if bucket is None:
                bucket = TokenBucket(rps, clock=self._clock)
                self._domains[domain] = bucket
                while len(self._domains) > self._max_domains:
                    self._domains.popitem(last=False)
            else:
                self._domains.move_to_end(domain)
                if bucket.rps != rps:
                    # dynamic-config changes take effect live
                    bucket.set_rate(rps)
        return bucket

    def set_global_rate(self, rps: float) -> None:
        """Live retune of the global stage. Per-domain stages follow
        their ``domain_rps`` callable per call; the global bucket is
        sized once at construction, so a closed-loop controller needs
        this explicit hook."""
        self._global.set_rate(rps)

    @property
    def global_rps(self) -> float:
        return self._global.rps

    def allow(self, domain: str = "") -> bool:
        # the domain bucket first (Cadence's multiStageRateLimiter): a
        # throttled domain must not drain the global budget and starve
        # compliant domains
        if domain:
            if not self._domain_bucket(domain).allow():
                return False
        return self._global.allow()

    def retry_after_s(self, domain: str = "") -> float:
        """The shed hint: the longer of the domain's and the global
        bucket's refill horizon."""
        hint = self._global.retry_after_s()
        if domain:
            hint = max(hint, self._domain_bucket(domain).retry_after_s())
        return hint

    def domain_count(self) -> int:
        with self._lock:
            return len(self._domains)


class RetryBudget:
    """Success-refilled retry pacing (the retry-storm breaker).

    Every success deposits ``ratio`` retry tokens (capped at ``cap``);
    every retry withdraws one. Under overload successes dry up, the
    budget drains, and rejected work stops re-offering itself: total
    offered load converges to admitted load × (1 + ratio) instead of
    amplifying. ``initial`` seeds the bucket so cold clients can retry
    transient blips before their first success."""

    def __init__(
        self, ratio: float = 0.1, cap: float = 8.0, initial: float = 4.0,
    ) -> None:
        if ratio < 0 or cap <= 0:
            raise ValueError("retry budget: ratio >= 0, cap > 0 required")
        self.ratio = float(ratio)
        self.cap = float(cap)
        self._tokens = min(float(initial), self.cap)
        self._lock = threading.Lock()

    def record_success(self) -> None:
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)

    def can_retry(self) -> bool:
        """Withdraw one retry token; False means the budget is exhausted
        and the caller must surface the error instead of re-offering."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def tokens(self) -> float:
        with self._lock:
            return self._tokens
