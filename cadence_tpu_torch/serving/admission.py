"""Fair admission for the resident serving engine: weighted,
starvation-free refill with per-domain quotas and deadline aging.

A port of the reference package's ``serving/admission.py``, with the same
names, take order and validation. Freed lanes are a scarce fixed-shape
resource, and the refill order decides whether every domain keeps making
progress (the lane-refill discipline of vectorized-MCMC continuous
batching). Policy, per freed slot:

* every domain with parked admissions bids its head entry (per-domain
  order stays FIFO: reordering inside a domain would starve its own
  oldest work);
* a bid's priority is ``weight(domain) + aging_boost × age``, where age
  counts refill rounds parked, so a parked admission's priority grows
  without bound and must eventually exceed any fixed weight: seating
  within K recycles is guaranteed for any weight assignment (K ≤
  starvation_recycles + (max_weight − min_weight) / aging_boost +
  #domains for a single-slot refill);
* a per-domain token-bucket quota gates how fast one domain may consume
  freed slots; a quota-rejected domain is skipped, not waited on, so a
  quota-exhausted domain can never block a quota-available one;
* aging overrides quota: a bid parked ≥ ``starvation_recycles`` rounds
  seats regardless of its domain's bucket.

Concurrency: the queue owns no lock. The owning ``ResidentEngine``
passes its engine lock in as the guard and every verb is called with it
held. The parked table is declared through the lock sanitizer
(``utils/locks.make_guarded``, ``race_witness.GUARDED_FIELDS``), as in
the reference, so a sanitized run checks that every access holds the
engine lock.
"""

from __future__ import annotations

import dataclasses
import time as _time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..utils import locks
from ..utils.quotas import TokenBucket


@dataclasses.dataclass
class AdmissionPolicy:
    """The admission fairness knobs.

    ``domain_weights`` maps domain → base priority weight (missing
    domains use ``default_weight``); ``quota_rps``/``quota_burst`` size
    each domain's refill token bucket (0 = unmetered); ``aging_boost``
    is priority gained per refill round parked; ``starvation_recycles``
    is the age at which a bid bypasses its domain quota entirely."""

    domain_weights: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    default_weight: float = 1.0
    quota_rps: float = 0.0
    quota_burst: int = 0
    aging_boost: float = 1.0
    starvation_recycles: int = 8

    def validate(self) -> None:
        if self.default_weight <= 0:
            raise ValueError("admission: default_weight must be > 0")
        for dom, w in self.domain_weights.items():
            if w <= 0:
                raise ValueError(
                    f"admission: weight for domain '{dom}' must be > 0"
                )
        if self.quota_rps < 0 or self.quota_burst < 0:
            raise ValueError("admission: negative quota")
        if self.aging_boost <= 0:
            # zero aging would reintroduce unbounded starvation for
            # low-weight domains — the exact failure this replaces
            raise ValueError("admission: aging_boost must be > 0")
        if self.starvation_recycles < 1:
            raise ValueError(
                "admission: starvation_recycles must be >= 1"
            )

    def weight(self, domain_id: str) -> float:
        return self.domain_weights.get(domain_id, self.default_weight)


class _Parked:
    """One parked admission + its aging bookkeeping. ``attempts``
    counts failed seat attempts (a taken entry whose replay failed and
    came back) so a poisoned history cannot re-park forever."""

    __slots__ = ("adm", "enq_round", "enq_t", "attempts")

    def __init__(self, adm, enq_round: int, enq_t: float,
                 attempts: int = 0) -> None:
        self.adm = adm
        self.enq_round = enq_round
        self.enq_t = enq_t
        self.attempts = attempts


class FairAdmissionQueue:
    """Per-domain parked admissions + the weighted/aged/quota'd refill.

    Every verb below MUST be called with the guard lock (the engine
    lock) held — this class never blocks and never acquires."""

    def __init__(
        self,
        policy: Optional[AdmissionPolicy],
        guard,
        clock=_time.monotonic,
    ) -> None:
        self.policy = policy or AdmissionPolicy()
        self.policy.validate()
        self._clock = clock
        # domain → FIFO list of _Parked (head bids at refill); guarded
        # by ``guard``, the engine lock its caller holds
        self._parked: Dict[str, List[_Parked]] = locks.make_guarded(
            {}, "FairAdmissionQueue._parked", guard
        )
        # per-domain refill quota buckets: LRU-bounded like the
        # MultiStage limiter's domain table (churn of short-lived
        # domains cannot grow it). Buckets SURVIVE the backlog
        # emptying — dropping one there would refund a full burst to
        # any domain whose queue oscillates to empty between recycles,
        # letting it consume freed slots far above quotaRps
        self._quota: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._max_quota_domains = 1024
        self._round = 0
        self._count = 0

    # -- parking -------------------------------------------------------

    def park(self, adm, requeued_from: Optional[_Parked] = None) -> None:
        """Caller holds the guard. ``requeued_from``: the original
        parked entry when a taken admission failed to seat and comes
        back — its age is preserved (and its attempt count bumped) so
        re-queueing can never reset the starvation clock."""
        entry = _Parked(
            adm,
            requeued_from.enq_round if requeued_from is not None
            else self._round,
            requeued_from.enq_t if requeued_from is not None
            else self._clock(),
            attempts=(
                requeued_from.attempts + 1
                if requeued_from is not None else 0
            ),
        )
        self._parked.setdefault(adm.domain_id, []).append(entry)
        self._count += 1

    def has_key(self, key) -> bool:
        """Caller holds the guard: is an admission with this
        (workflow_id, run_id) key currently parked?"""
        return any(
            e.adm.key == key
            for entries in self._parked.values()
            for e in entries
        )

    # -- the refill ----------------------------------------------------

    def take(self, n: int) -> List[_Parked]:
        """Caller holds the guard. Pop up to ``n`` parked admissions in
        fairness order; advances the aging round once per call (a call
        == one recycle round)."""
        self._round += 1
        pol = self.policy
        out: List[_Parked] = []
        while len(out) < n and self._count:
            bids: List[Tuple[float, int, str]] = []
            for dom, entries in self._parked.items():
                if not entries:
                    continue
                head = entries[0]
                age = self._round - head.enq_round
                bids.append((
                    pol.weight(dom) + pol.aging_boost * age, age, dom,
                ))
            if not bids:
                break
            # highest priority first; FIFO (older round) breaks ties
            bids.sort(key=lambda b: (-b[0], -b[1], b[2]))
            seated_one = False
            for _, age, dom in bids:
                if len(out) >= n:
                    break
                if (pol.quota_rps > 0
                        and age < pol.starvation_recycles
                        and not self._quota_bucket(dom).allow()):
                    continue  # skipped, never waited on
                entries = self._parked[dom]
                out.append(entries.pop(0))
                self._count -= 1
                seated_one = True
                if not entries:
                    del self._parked[dom]
            if not seated_one:
                break  # every remaining bid is quota-parked this round
        return out

    def set_quota_rps(
        self, rps: float, burst: Optional[int] = None
    ) -> None:
        """Caller holds the guard. Live retune of the per-domain refill
        quota (the autopilot's serving actuator): updates the policy so
        future buckets mint at the new rate, and ``set_rate``s every
        existing bucket so retuning takes effect this recycle, not at
        the next domain-table miss."""
        if rps < 0:
            raise ValueError("admission: negative quota")
        self.policy.quota_rps = float(rps)
        if burst is not None:
            self.policy.quota_burst = int(burst)
        for bucket in self._quota.values():
            bucket.set_rate(rps, burst=burst)

    def _quota_bucket(self, dom: str) -> TokenBucket:
        bucket = self._quota.get(dom)
        if bucket is None:
            pol = self.policy
            bucket = self._quota[dom] = TokenBucket(
                pol.quota_rps,
                burst=pol.quota_burst or None,
                clock=self._clock,
            )
            while len(self._quota) > self._max_quota_domains:
                self._quota.popitem(last=False)
        else:
            self._quota.move_to_end(dom)
        return bucket

    # -- introspection / drain -----------------------------------------

    def __len__(self) -> int:
        return self._count

    def parked_age_s(self, entry: _Parked) -> float:
        return max(0.0, self._clock() - entry.enq_t)

    def oldest_age_rounds(self) -> int:
        """Caller holds the guard: the oldest bid's age in refill
        rounds (the starvation gauge's input)."""
        oldest = 0
        for entries in self._parked.values():
            if entries:
                oldest = max(oldest, self._round - entries[0].enq_round)
        return oldest

    def drain(self) -> int:
        """Caller holds the guard: drop everything (shutdown)."""
        n = self._count
        self._parked.clear()
        self._quota.clear()
        self._count = 0
        return n
