"""Open-loop SLO load harness for the resident serving engine.

A port of the reference package's ``serving/harness.py``. Closed-loop
benches (issue N requests, wait, repeat) hide queueing: when the server
slows down, the load generator slows down with it. This harness is
open-loop: arrival times are drawn from an arrival process (Poisson or
bursty) at a sustained target QPS before the run starts, and every
request's latency is measured from its scheduled arrival to completion,
so falling behind shows up as queueing delay in the p99, as it would for
real users.

Admission rides the token buckets of ``utils/quotas``: a request the
bucket rejects counts as shed load, not latency. A
``MultiStageRateLimiter`` admits per (domain, global) budget, and a
rejected arrival may re-offer itself after the limiter's retry-after hint
while the ``RetryBudget`` (success-refilled) has tokens. Latency for a
retried arrival still counts from its original scheduled time.

Per arrival (the serving hot path): ``append(Δ)`` → one engine tick for
all due arrivals (the continuous batch) → ``read()``. The decision
latency lands in the metrics registry's exponential-bucket timer
``serve_decision`` (tagged ``domain=``), where p50/p99 are read with
``Registry.timer_stats``. ``clock`` and ``sleep`` are injectable, so a
virtual clock drives the harness deterministically.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
import time as _time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.metrics import NOOP, Scope
from ..utils.quotas import RetryBudget, TokenBucket


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Deterministic (seeded) open-loop arrival schedule.

    ``kind``: ``poisson`` (exponential inter-arrivals at ``qps``) or
    ``bursty`` (Poisson base with ``burst_factor``× rate inside
    periodic burst windows covering ``burst_frac`` of the run — the
    thundering-herd shape an SLO has to survive)."""

    qps: float
    kind: str = "poisson"
    seed: int = 0
    burst_factor: float = 4.0
    burst_frac: float = 0.2
    burst_period_s: float = 1.0

    def validate(self) -> None:
        if self.qps <= 0:
            raise ValueError("arrival process: qps must be > 0")
        if self.kind not in ("poisson", "bursty"):
            raise ValueError(
                f"arrival process: unknown kind '{self.kind}'"
            )
        if self.kind == "bursty":
            if not 0.0 < self.burst_frac < 1.0:
                raise ValueError(
                    "arrival process: burst_frac must be in (0, 1)"
                )
            if self.burst_factor <= 1.0:
                raise ValueError(
                    "arrival process: burst_factor must be > 1"
                )

    def schedule(self, n: int) -> List[float]:
        """The first ``n`` arrival offsets (seconds from start)."""
        self.validate()
        rng = random.Random(self.seed)
        out: List[float] = []
        t = 0.0
        while len(out) < n:
            if self.kind == "poisson":
                rate = self.qps
            else:
                # burst windows: [0, burst_frac) of every period runs
                # at burst_factor × the off-window rate; the average
                # over a period is the target qps
                f, k = self.burst_frac, self.burst_factor
                base = self.qps / (f * k + (1.0 - f))
                in_burst = (t % self.burst_period_s) < (
                    f * self.burst_period_s
                )
                rate = base * (k if in_burst else 1.0)
            t += rng.expovariate(rate)
            out.append(t)
        return out


@dataclasses.dataclass
class ServeWorkload:
    """One workflow's serve trajectory: the admit prefix plus the Δ
    suffixes the open-loop arrivals will append, in order."""

    domain_id: str
    workflow_id: str
    run_id: str
    branch_token: bytes
    prefix: List            # batches replayed at admit
    deltas: List[List]      # per-arrival Δ (each a list of batches)

    @property
    def total_events(self) -> int:
        return sum(len(b) for b in self.prefix) + sum(
            len(b) for d in self.deltas for b in d
        )


class OpenLoopHarness:
    """Drive a ResidentEngine with an open-loop arrival schedule.

    ``run()`` admits every workload (the warm phase — bulk, through
    the dispatcher), then walks the arrival schedule: all arrivals due
    by "now" append their Δs, ONE engine tick composes them (the
    continuous batch), and each request's read completes it. Latency
    is recorded scheduled-arrival → read-complete into
    ``metrics.timer("serve_decision")``.

    Overload controls (all optional, all off by default):

    * ``admission_bucket`` — a single token bucket;
    * ``limiter`` — a ``MultiStageRateLimiter``: per-domain + global
      admission, shed responses carry its retry-after hint;
    * ``retry_budget`` — a ``RetryBudget``: a rejected arrival
      re-offers itself at now + retry-after while the budget holds;
      exhausted, it sheds permanently (``retry_budget_exhausted``).
    """

    def __init__(
        self,
        engine,
        workloads: Sequence[ServeWorkload],
        process: ArrivalProcess,
        metrics: Optional[Scope] = None,
        admission_bucket: Optional[TokenBucket] = None,
        limiter=None,
        retry_budget: Optional[RetryBudget] = None,
        clock: Callable[[], float] = _time.monotonic,
        sleep: Callable[[float], None] = _time.sleep,
        max_wait_s: float = 0.25,
    ) -> None:
        self.engine = engine
        self.workloads = list(workloads)
        self.process = process
        self.metrics = (
            metrics if metrics is not None else NOOP
        ).tagged(layer="serving_harness")
        self.bucket = admission_bucket
        self.limiter = limiter
        self.retry_budget = retry_budget
        self._clock = clock
        self._sleep = sleep
        self._max_wait_s = max_wait_s

    def admit_all(self) -> Dict:
        """Warm phase: seat every workload in one bulk admission."""
        tickets = self.engine.admit_many([
            dict(domain_id=w.domain_id, workflow_id=w.workflow_id,
                 run_id=w.run_id, branch_token=w.branch_token,
                 batches=w.prefix)
            for w in self.workloads
        ])
        return tickets

    @staticmethod
    def _through(w: ServeWorkload, k: int) -> List:
        """The full event stream up to and including Δ ``k`` — the
        re-seat batches after a shed/stale gap."""
        return list(w.prefix) + [
            b for d in w.deltas[: k + 1] for b in d
        ]

    # -- admission controls --------------------------------------------

    def _admitted(self, domain_id: str) -> bool:
        if self.limiter is not None and not self.limiter.allow(domain_id):
            return False
        if self.bucket is not None and not self.bucket.allow():
            return False
        return True

    def _retry_after_s(self, domain_id: str) -> float:
        hint = 0.0
        if self.limiter is not None:
            hint = self.limiter.retry_after_s(domain_id)
        elif self.bucket is not None:
            get = getattr(self.bucket, "retry_after_s", None)
            if get is not None:
                hint = get()
        # floor at one mean inter-arrival so a zero hint cannot busy-
        # spin the re-offer against a still-saturated bucket
        return max(hint, 1.0 / self.process.qps)

    def run(self) -> Dict:
        """The open-loop drive; returns the run's SLO stats."""
        tickets = self.admit_all()
        # one arrival per available Δ, round-robin over workloads
        order: List[Tuple[ServeWorkload, List, int]] = []
        max_deltas = max(
            (len(w.deltas) for w in self.workloads), default=0
        )
        for k in range(max_deltas):
            for w in self.workloads:
                if k < len(w.deltas):
                    order.append((w, w.deltas[k], k))
        schedule = self.process.schedule(len(order))
        # the live arrival queue: (due time, seq, arrival index).
        # Retries re-push the same index at now + retry-after; latency
        # ALWAYS measures from schedule[i], the original arrival
        heap: List[Tuple[float, int, int]] = [
            (schedule[i], i, i) for i in range(len(order))
        ]
        seq = len(order)
        t_start = self._clock()
        shed = completed = retries = 0
        offered = len(order)
        domains: Dict[str, Dict[str, int]] = {}

        def dom_stats(d: str) -> Dict[str, int]:
            s = domains.get(d)
            if s is None:
                s = domains[d] = {
                    "completed": 0, "shed": 0, "retries": 0,
                }
            return s

        def reject(i: int, w: ServeWorkload, now: float) -> None:
            """One rejection — limiter shed, failed seat, or a lane
            lost between append and read: re-offer at now + the
            retry-after hint while the budget holds, else shed
            permanently. Python's closure-over-nonlocal keeps the
            three call sites honest about the same accounting."""
            nonlocal shed, retries, offered, seq
            self.metrics.inc("serve_shed")
            budget = self.retry_budget
            if budget is not None and budget.can_retry():
                retries += 1
                offered += 1
                dom_stats(w.domain_id)["retries"] += 1
                seq += 1
                heapq.heappush(heap, (
                    now + self._retry_after_s(w.domain_id), seq, i,
                ))
            else:
                if budget is not None:
                    self.metrics.inc("retry_budget_exhausted")
                shed += 1
                dom_stats(w.domain_id)["shed"] += 1

        while heap:
            now = self._clock() - t_start
            if heap[0][0] > now:
                self._sleep(
                    min(heap[0][0] - now, self._max_wait_s)
                )
                continue
            # continuous batch: every arrival due by now appends first,
            # then ONE tick composes all of them
            due: List[Tuple[int, ServeWorkload]] = []
            processed = 0
            while heap and heap[0][0] <= now:
                processed += 1
                _, _, i = heapq.heappop(heap)
                w, delta, k = order[i]
                if not self._admitted(w.domain_id):
                    # shed-then-retry: back off by the limiter's hint,
                    # re-offer at the same arrival index
                    reject(i, w, now)
                    continue
                key = (w.workflow_id, w.run_id)
                t = tickets.get(key)
                if t is None:
                    # queued admission: retry the seat at THIS
                    # arrival's position (earlier arrivals may have
                    # been shed while unseated — seating the bare
                    # prefix would leave a permanent gap)
                    t = self.engine.admit(
                        w.domain_id, w.workflow_id, w.run_id,
                        branch_token=w.branch_token,
                        batches=self._through(w, k),
                    )
                    tickets[key] = t
                    ok = t is not None
                elif not self.engine.append(t, delta):
                    # stale ticket (recycled lane) or the gap a shed
                    # arrival left behind: re-seat at this position —
                    # the O(depth) re-admit is honest latency, never a
                    # frozen lane or divergent resident state
                    self.engine.evict(w.workflow_id, w.run_id)
                    t = self.engine.admit(
                        w.domain_id, w.workflow_id, w.run_id,
                        branch_token=w.branch_token,
                        batches=self._through(w, k),
                    )
                    tickets[key] = t
                    ok = t is not None
                else:
                    ok = True
                if not ok:
                    # every lane occupied: the admission parked in the
                    # engine's fair queue — the arrival re-offers and
                    # meets its seated lane at a later refill
                    reject(i, w, now)
                    continue
                due.append((i, w))
            if not due:
                if processed:
                    # rejected-only round: still drive one tick so
                    # eviction + fair-queue refill progress — an
                    # all-parked cohort would otherwise livelock
                    # (no completion → no tick → no refill → every
                    # re-offer parks again, forever)
                    self.engine.tick()
                continue
            self.engine.tick()
            for j, w in due:
                got = self.engine.read(w.workflow_id, w.run_id)
                t_read = self._clock() - t_start
                if got is None:
                    # the LRU recycled this lane between the arrival's
                    # append and its read (aggressive idle horizons
                    # under overload churn — the re-seat ticks of
                    # OTHER arrivals in the same batch age it out):
                    # the arrival re-offers like any shed, its Δ
                    # duplicate-trims on the healed lane
                    reject(j, w, self._clock() - t_start)
                    continue
                # open-loop latency: scheduled arrival → read done
                # (queueing delay from falling behind — and retry
                # backoff — is IN the number)
                self.metrics.tagged(domain=w.domain_id).record(
                    "serve_decision", t_read - schedule[j]
                )
                completed += 1
                dom_stats(w.domain_id)["completed"] += 1
                if self.retry_budget is not None:
                    self.retry_budget.record_success()
        wall = self._clock() - t_start
        return {
            "requests": len(order),
            "completed": completed,
            "shed": shed,
            "retries": retries,
            # total offered load = arrivals + retries: the retry-budget
            # boundedness observable (offered / requests stays near 1 +
            # budget even under sustained rejection)
            "offered": offered,
            "wall_s": wall,
            "qps_sustained": completed / wall if wall > 0 else 0.0,
            "qps_target": self.process.qps,
            "domains": domains,
        }
