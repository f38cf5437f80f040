"""Retry-policy interval math, the pump loops' backoff ladder and the
host-operation retry loop.

A copy of the reference package's ``utils/backoff.py``:
the retry-policy validation the history host applies to a start request
and to a ScheduleActivityTask decision, the interval math
``MutableState.retry_activity`` and the cron/retry continuation use
(given a retry policy and the attempt that just failed, when does the
next attempt start, and does the error or the expiration stop retrying;
Cadence service/history/retry.go, getBackoffInterval), and
``BackoffLadder``, the error backoff of the serving tick pump and the
replication pump, and the host-operation retry loop (``retry`` over an
``ExponentialRetryPolicy``; Cadence common/backoff/retry.go) the routed
service clients wrap every cross-host call in.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, Optional, Sequence, TypeVar

SECOND = 1_000_000_000

NO_INTERVAL = -1  # stop retrying


@dataclasses.dataclass
class RetryPolicy:
    """Workflow/activity retry policy (reference idl RetryPolicy;
    validation mirrors common/util.go ValidateRetryPolicy)."""

    initial_interval_seconds: int = 1
    backoff_coefficient: float = 2.0
    maximum_interval_seconds: int = 0      # 0 = uncapped
    maximum_attempts: int = 0              # 0 = unlimited
    expiration_seconds: int = 0            # 0 = no expiry
    non_retriable_errors: Sequence[str] = ()

    def validate(self) -> None:
        validate_retry_policy(self)


def validate_retry_policy(policy) -> None:
    """Reject malformed user retry policies before they reach the FSM.

    Mirrors ValidateRetryPolicy (Cadence common/util.go:357-384);
    raises ValueError (callers map to BadRequest / decision failure).
    A None policy is valid (no retry). Accepts either retry-policy
    shape (core.events.RetryPolicy uses expiration_interval_seconds,
    this module's uses expiration_seconds)."""
    if policy is None:
        return
    # wire-decoded policies can carry explicit nulls; treat them as the
    # reference's thrift Get* accessors do (nil -> zero value) so they
    # fail validation as BadRequest, not as a server-side TypeError
    def _n(v):
        return 0 if v is None else v

    initial = _n(policy.initial_interval_seconds)
    coefficient = _n(policy.backoff_coefficient)
    max_interval = _n(policy.maximum_interval_seconds)
    max_attempts = _n(policy.maximum_attempts)
    expiration = _n(getattr(policy, "expiration_interval_seconds",
                            getattr(policy, "expiration_seconds", 0)))
    if initial <= 0:
        raise ValueError(
            "InitialIntervalInSeconds must be greater than 0 on retry policy")
    if coefficient < 1:
        raise ValueError(
            "BackoffCoefficient cannot be less than 1 on retry policy")
    if max_interval < 0:
        raise ValueError(
            "MaximumIntervalInSeconds cannot be less than 0 on retry policy")
    if max_interval > 0 and max_interval < initial:
        raise ValueError("MaximumIntervalInSeconds cannot be less than "
                         "InitialIntervalInSeconds on retry policy")
    if max_attempts < 0:
        raise ValueError(
            "MaximumAttempts cannot be less than 0 on retry policy")
    if expiration < 0:
        raise ValueError(
            "ExpirationIntervalInSeconds cannot be less than 0 on retry policy")
    if max_attempts == 0 and expiration == 0:
        raise ValueError(
            "MaximumAttempts and ExpirationIntervalInSeconds are both 0; "
            "at least one must be specified on retry policy")



def next_backoff_interval_seconds(
    policy: RetryPolicy,
    attempt: int,
    expiration_ts_ns: int,
    now_ns: int,
    error_reason: str = "",
) -> int:
    """Seconds until the next attempt, or NO_INTERVAL to stop.

    ``attempt`` is 0-based (the attempt that just failed)."""
    if policy.maximum_attempts == 0 and policy.expiration_seconds == 0:
        return NO_INTERVAL
    if policy.maximum_attempts > 0 and attempt >= policy.maximum_attempts - 1:
        return NO_INTERVAL
    if error_reason and error_reason in tuple(policy.non_retriable_errors):
        return NO_INTERVAL
    if policy.initial_interval_seconds <= 0:
        # unvalidated policies default to 0 (core/events.RetryPolicy);
        # math.log below would raise: keep the stop semantics
        return NO_INTERVAL
    # guard the exponentiation: coefficient ** attempt overflows a float
    # near attempt ~1000. Exact power below the guard so small intervals
    # stay bit-exact (2.0**3 == 8, not exp-log 7.999...)
    if policy.backoff_coefficient <= 1.0:
        interval = float(policy.initial_interval_seconds)
    elif (
        math.log(policy.initial_interval_seconds)
        + attempt * math.log(policy.backoff_coefficient)
    ) > 30:  # e^30 s is about 340k years: beyond any cap or expiration
        interval = float(1 << 40)
    else:
        interval = policy.initial_interval_seconds * (
            policy.backoff_coefficient ** attempt
        )
    if policy.maximum_interval_seconds:
        interval = min(interval, policy.maximum_interval_seconds)
    interval = int(interval)
    if interval <= 0:
        return NO_INTERVAL
    if expiration_ts_ns and now_ns + interval * SECOND > expiration_ts_ns:
        return NO_INTERVAL
    return interval


@dataclasses.dataclass
class ExponentialRetryPolicy:
    """Host-operation retry schedule (common/backoff/retrypolicy.go)."""

    initial_interval_s: float = 0.05
    backoff_coefficient: float = 2.0
    maximum_interval_s: float = 10.0
    expiration_interval_s: float = 60.0    # 0 = none
    maximum_attempts: int = 0              # 0 = unlimited
    jitter: float = 0.2

    def compute_next_delay(self, attempt: int, elapsed_s: float) -> float:
        """Delay in seconds before attempt ``attempt`` (1-based), or < 0."""
        if self.maximum_attempts and attempt >= self.maximum_attempts:
            return -1.0
        if self.expiration_interval_s and elapsed_s >= self.expiration_interval_s:
            return -1.0
        d = self.initial_interval_s * (self.backoff_coefficient ** (attempt - 1))
        d = min(d, self.maximum_interval_s)
        if self.jitter:
            d *= 1 + random.uniform(-self.jitter, self.jitter)
        return d


class BackoffLadder:
    """Error-backoff ladder for pump loops (the replication pump and the
    serving tick pump).

    * ``failure()`` returns the delay to sleep after a failed cycle (the
      current rung, jittered down by up to ``jitter``) and doubles the
      rung, capped at ``cap_s``;
    * ``success()`` resets the ladder to ``base_s`` so a healed
      dependency resumes at full cadence at once;
    * jitter is multiplicative-down (``d * (1 - jitter * rng())``) so
      concurrent loops sharing one dead dependency don't retry in phase,
      and the returned delay never exceeds the cap.
    """

    def __init__(
        self,
        base_s: float,
        cap_s: float,
        jitter: float = 0.0,
        rng: Optional[random.Random] = None,
    ) -> None:
        if base_s <= 0:
            raise ValueError("backoff ladder: base_s must be > 0")
        if cap_s < base_s:
            raise ValueError("backoff ladder: cap_s must be >= base_s")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("backoff ladder: jitter must be in [0, 1)")
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.jitter = float(jitter)
        self._rng = rng if rng is not None else random.Random()
        self._delay = self.base_s
        self.failures = 0

    @property
    def current_s(self) -> float:
        """The rung the next ``failure()`` will sleep (unjittered)."""
        return self._delay

    def failure(self) -> float:
        """Record a failed cycle; return the (jittered) sleep delay."""
        self.failures += 1
        d = self._delay
        self._delay = min(self._delay * 2.0, self.cap_s)
        if self.jitter:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    def success(self) -> None:
        """Reset: the next failure starts back at ``base_s``."""
        self._delay = self.base_s


T = TypeVar("T")


class NonRetriableError(Exception):
    """Wrap an error to break out of Retry immediately."""


def retry(
    op: Callable[[], T],
    policy: Optional[ExponentialRetryPolicy] = None,
    is_retriable: Callable[[Exception], bool] = lambda e: True,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Run ``op`` with exponential backoff until success/exhaustion."""
    policy = policy or ExponentialRetryPolicy()
    start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return op()
        except NonRetriableError as e:
            raise (e.__cause__ or e)
        except Exception as e:  # noqa: BLE001 — predicate decides
            if not is_retriable(e):
                raise
            delay = policy.compute_next_delay(
                attempt, time.monotonic() - start
            )
            if delay < 0:
                raise
            sleep(delay)
