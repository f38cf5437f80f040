"""Cron schedule parsing for workflow cron restarts.

Reference: the reference validates and evaluates ``cronSchedule`` with
robfig/cron (common/util.go ValidateCronSchedule; the backoff
computation in service/history/mutableStateBuilder.go
GetCronBackoffDuration). This build implements the same surface
natively: the standard 5-field spec ``minute hour day-of-month month
day-of-week`` (``*``, lists, ranges, ``/step``) plus robfig's
``@every <N>(s|m|h)`` fixed-interval form, which the canary uses for
sub-minute probe cadence.

All evaluation is UTC, matching the reference.

A copy of the reference package's ``utils/cron.py``.
"""

from __future__ import annotations

import calendar
import re
import time
from typing import Optional, Set

_EVERY_RE = re.compile(r"@every\s+(\d+)(s|m|h)$")

_FIELD_RANGES = (
    (0, 59),   # minute
    (0, 23),   # hour
    (1, 31),   # day of month
    (1, 12),   # month
    (0, 6),    # day of week (0 = Sunday)
)


def _parse_field(field: str, lo: int, hi: int) -> Optional[Set[int]]:
    """One cron field → the set of matching values, or None on error."""
    out: Set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            if not step_s.isdigit() or int(step_s) <= 0:
                return None
            step = int(step_s)
        if part == "*":
            start, end = lo, hi
        elif "-" in part:
            a, _, b = part.partition("-")
            if not (a.isdigit() and b.isdigit()):
                return None
            start, end = int(a), int(b)
        elif part.isdigit():
            start = int(part)
            # a bare value with a step ("3/5") ranges to the max,
            # following the de-facto cron convention
            end = hi if step > 1 else start
        else:
            return None
        if start < lo or end > hi or start > end:
            return None
        out.update(range(start, end + 1, step))
    return out


class CronSchedule:
    """A parsed 5-field cron spec or @every interval."""

    def __init__(self, spec: str) -> None:
        spec = spec.strip()
        self.spec = spec
        self.every_seconds = 0
        self.fields = None
        m = _EVERY_RE.match(spec)
        if m:
            n = int(m.group(1))
            self.every_seconds = n * {"s": 1, "m": 60, "h": 3600}[m.group(2)]
            if self.every_seconds <= 0:
                raise ValueError(f"invalid @every interval in {spec!r}")
            return
        parts = spec.split()
        if len(parts) != 5:
            raise ValueError(
                f"cron spec {spec!r}: want 5 fields or '@every <dur>'"
            )
        fields = []
        for part, (lo, hi) in zip(parts, _FIELD_RANGES):
            vals = _parse_field(part, lo, hi)
            if vals is None:
                raise ValueError(f"cron spec {spec!r}: bad field {part!r}")
            fields.append(vals)
        self.fields = fields
        # dom/dow OR rule: when both are restricted, either may match
        self.dom_star = parts[2] == "*"
        self.dow_star = parts[4] == "*"

    def _day_matches(self, tm: time.struct_time) -> bool:
        _, _, dom, month, dow = self.fields
        if tm.tm_mon not in month:
            return False
        dom_ok = tm.tm_mday in dom
        # cron encodes Sunday as 0; struct_tm wday has Monday == 0
        dow_ok = ((tm.tm_wday + 1) % 7) in dow
        if self.dom_star or self.dow_star:
            return dom_ok and dow_ok
        # both restricted: either matches (standard cron OR rule)
        return dom_ok or dow_ok

    def next_delay_seconds(self, now_s: float, anchor_s: float = None) -> int:
        """Whole seconds from ``now_s`` (epoch) until the next fire; the
        reference's GetCronBackoffDuration equivalent. Always > 0.

        ``anchor_s`` is the run's execution-start time: '@every N'
        fires stay aligned to anchor + k*N (the reference steps
        schedule.Next from start past close, backoff/cron.go:56-63)
        instead of drifting later by each run's own duration. Field
        specs are wall-clock anchored already, so anchor_s is moot there.

        Scans day-by-day (≤ ~1830 iterations over a 5-year horizon, the
        same horizon robfig/cron uses) so sparse specs like a leap-day
        '0 0 29 2 *' resolve without a minute-by-minute year walk.
        """
        if self.every_seconds:
            if anchor_s is not None and anchor_s <= now_s:
                k = int((now_s - anchor_s) // self.every_seconds) + 1
                import math

                return max(1, int(
                    math.ceil(anchor_s + k * self.every_seconds - now_s)))
            return self.every_seconds
        minute, hour, _, _, _ = self.fields
        minutes = sorted(minute)
        hours = sorted(hour)
        t = (int(now_s) // 60 + 1) * 60  # next whole minute
        tm = time.gmtime(t)
        # midnight of the starting day
        day0 = t - tm.tm_hour * 3600 - tm.tm_min * 60 - tm.tm_sec
        for day in range(366 * 5 + 1):
            day_t = day0 + day * 86400
            day_tm = time.gmtime(day_t)
            if not self._day_matches(day_tm):
                continue
            for h in hours:
                for m in minutes:
                    fire = day_t + h * 3600 + m * 60
                    if fire >= t:
                        return max(1, fire - int(now_s))
        raise ValueError(f"cron spec {self.spec!r} never fires")


def validate_cron_schedule(spec: str) -> None:
    """Raise ValueError on a bad spec (frontend request validation)."""
    if spec:
        CronSchedule(spec)


def next_cron_delay_seconds(
    spec: str, now_s: float, anchor_s: float = None,
) -> int:
    """Seconds until the next cron fire, or 0 when spec is empty/bad."""
    if not spec:
        return 0
    try:
        return CronSchedule(spec).next_delay_seconds(now_s, anchor_s)
    except ValueError:
        return 0
