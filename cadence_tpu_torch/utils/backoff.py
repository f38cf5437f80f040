"""Activity retry-policy interval math and the pump loops' backoff ladder.

A copy of two parts of the reference package's ``utils/backoff.py``: the
interval math ``MutableState.retry_activity`` uses (given a retry policy
and the attempt that just failed, when does the next attempt start, and
does the error or the expiration stop retrying; Cadence
service/history/retry.go, getBackoffInterval), and ``BackoffLadder``, the
error backoff of the serving tick pump. The host-operation retry loop of
that module is not needed here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

SECOND = 1_000_000_000

NO_INTERVAL = -1  # stop retrying


@dataclasses.dataclass
class RetryPolicy:
    """Workflow/activity retry policy (reference idl RetryPolicy)."""

    initial_interval_seconds: int = 1
    backoff_coefficient: float = 2.0
    maximum_interval_seconds: int = 0      # 0 = uncapped
    maximum_attempts: int = 0              # 0 = unlimited
    expiration_seconds: int = 0            # 0 = no expiry
    non_retriable_errors: Sequence[str] = ()


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


class BackoffLadder:
    """Error-backoff ladder for pump loops.

    * ``failure()`` returns the delay to sleep after a failed cycle (the
      current rung) and doubles the rung, capped at ``cap_s``;
    * ``success()`` resets the ladder to ``base_s`` so a healed
      dependency resumes at full cadence at once.

    The reference's ladder also jitters the delay down; its only caller
    here, the serving tick pump, asks for no jitter, so the port leaves
    it out.
    """

    def __init__(self, base_s: float, cap_s: float) -> None:
        if base_s <= 0:
            raise ValueError("backoff ladder: base_s must be > 0")
        if cap_s < base_s:
            raise ValueError("backoff ladder: cap_s must be >= base_s")
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self._delay = self.base_s

    def failure(self) -> float:
        """Record a failed cycle; return the sleep delay."""
        d = self._delay
        self._delay = min(self._delay * 2.0, self.cap_s)
        return d

    def success(self) -> None:
        """Reset: the next failure starts back at ``base_s``."""
        self._delay = self.base_s
