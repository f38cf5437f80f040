"""Geographic link modeling for replication chaos runs.

A profile (``LinkProfile``) describes one cross-cluster link: a
bytes/sec budget, fixed latency, seeded jitter, and partition windows over
the transfer sequence. ``chaos_link`` installs it over a replication
``RemoteClusterClient`` so every ``ReplicationTaskFetcher.fetch`` /
``get_workflow_history_raw`` / snapshot transfer pays the link's cost (a
real, bounded sleep) or hits a partition (``LinkPartitionedError``).
Delays and partitions are a pure function of (profile, seed, transfer
index), so the same workload sees the same degraded link every run.

A copy of the link simulator of the reference package's
``testing/faults.py``. Its fault schedules (``FaultRule``,
``FaultSchedule``) and the persistence fault client wait for the port's
testing slice.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Dict, Sequence, Tuple

from ..utils import tracing


class LinkPartitionedError(ConnectionError):
    """The simulated WAN link is inside a partition window — the
    transfer never happened (nothing was delivered, nothing acked)."""


@dataclasses.dataclass
class LinkProfile:
    """One cross-cluster link's degradation envelope.

    ``bytes_per_s`` is the link budget (0 = unthrottled): a transfer of
    N bytes sleeps ``N / bytes_per_s`` before returning, which is what
    makes replication-lag-under-constrained-bandwidth measurable in
    real wall time. ``latency_s`` adds a fixed per-transfer RTT;
    ``jitter_s`` adds a uniform seeded draw in ``[0, jitter_s)``.
    ``partitions`` are half-open ``[start, end)`` windows over the
    TRANSFER INDEX (deterministic under frozen clocks, unlike
    wall-time windows): transfer k inside a window raises
    ``LinkPartitionedError`` instead of delivering. ``max_sleep_s``
    caps any single injected sleep so a mis-sized test profile cannot
    wedge a suite (0 = uncapped, what the bench uses)."""

    bytes_per_s: float = 0.0
    latency_s: float = 0.0
    jitter_s: float = 0.0
    partitions: Sequence[Tuple[int, int]] = ()
    max_sleep_s: float = 0.0

    def validate(self) -> None:
        if self.bytes_per_s < 0 or self.latency_s < 0 or self.jitter_s < 0:
            raise ValueError("link profile: negative budget/latency/jitter")
        if self.max_sleep_s < 0:
            raise ValueError("link profile: negative max_sleep_s")
        for w in self.partitions:
            if len(w) != 2 or w[0] < 0 or w[1] < w[0]:
                raise ValueError(f"link profile: bad partition window {w}")


class SimulatedLink:
    """Seeded, thread-safe link shaper; one instance = one direction of
    one geographic link. ``transfer(nbytes)`` consumes exactly one
    transfer index and one RNG draw whether or not the transfer lands,
    so reordering unrelated profile knobs never shifts later draws —
    the same determinism discipline as ``FaultSchedule.plan``."""

    def __init__(self, profile: LinkProfile, seed: int = 0) -> None:
        profile.validate()
        self.profile = profile
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._transfers = 0
        self._forced_partition = False
        self.bytes_total = 0
        self.partitioned_calls = 0
        self.slept_s = 0.0

    def force_partition(self, on: bool) -> None:
        """Manual region-loss switch for drill choreography ("the WAN
        segment is down NOW, heal it THERE") — deterministic as long as
        the caller toggles it at deterministic points, unlike wall-time
        windows and unconstrained by the transfer index the profile
        windows key on. Forced-partitioned transfers still consume
        their transfer index and RNG draw, so toggling never shifts
        later draws."""
        with self._lock:
            self._forced_partition = bool(on)

    def _partitioned(self, index: int) -> bool:
        if self._forced_partition:
            return True
        return any(a <= index < b for a, b in self.profile.partitions)

    def transfer(self, nbytes: int) -> float:
        """Charge one transfer of ``nbytes`` against the link; returns
        the delay applied (seconds). Raises ``LinkPartitionedError``
        inside a partition window."""
        p = self.profile
        with self._lock:
            index = self._transfers
            self._transfers += 1
            jitter = self._rng.random() * p.jitter_s
            if self._partitioned(index):
                self.partitioned_calls += 1
                tracing.annotate(
                    f"link_partitioned transfer={index}"
                )
                raise LinkPartitionedError(
                    f"[link-chaos] transfer {index} dropped "
                    f"(partition window)"
                )
            self.bytes_total += max(0, int(nbytes))
            delay = p.latency_s + jitter
            if p.bytes_per_s > 0:
                delay += max(0, int(nbytes)) / p.bytes_per_s
            if p.max_sleep_s > 0:
                delay = min(delay, p.max_sleep_s)
            self.slept_s += delay
        if delay > 0:
            time.sleep(delay)
        return delay

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "transfers": self._transfers,
                "bytes_total": self.bytes_total,
                "partitioned_calls": self.partitioned_calls,
                "slept_s": self.slept_s,
            }


class ChaosLinkClient:
    """``RemoteClusterClient`` decorator that ships every response over
    a ``SimulatedLink`` — the installation point for link chaos at the
    replication fetch sites (``ReplicationTaskFetcher.fetch`` and the
    rereplicator/backfill ``get_workflow_history_raw`` both dial
    through the wrapped client, as does the adaptive snapshot plane).

    The response is serialized through the replication wire-size
    estimator to charge the link with honest byte counts, then the link
    sleeps (bandwidth + latency + jitter) or raises
    ``LinkPartitionedError`` — exactly what a dead WAN segment does to
    a puller: no data, no cursor movement, retry later."""

    def __init__(self, base: Any, link: SimulatedLink) -> None:
        self._base = base
        self.link = link

    def _shipped(self, payload):
        from ..runtime.replication.transport import wire_size

        self.link.transfer(wire_size(payload))
        return payload

    def get_replication_messages(self, shard_id, last_retrieved_id,
                                 max_tasks=None):
        return self._shipped(
            self._base.get_replication_messages(
                shard_id, last_retrieved_id, max_tasks=max_tasks
            )
        )

    def get_workflow_history_raw(self, domain_id, workflow_id, run_id,
                                 start_event_id, end_event_id):
        return self._shipped(self._base.get_workflow_history_raw(
            domain_id, workflow_id, run_id, start_event_id, end_event_id
        ))

    def get_replication_backlog(self, shard_id, last_retrieved_id):
        return self._shipped(self._base.get_replication_backlog(
            shard_id, last_retrieved_id
        ))

    def get_replication_checkpoint(self, domain_id, workflow_id, run_id):
        return self._shipped(self._base.get_replication_checkpoint(
            domain_id, workflow_id, run_id
        ))

    def __getattr__(self, name: str):
        # anything beyond the replication surface passes through unshaped
        return getattr(self._base, name)


def chaos_link(client: Any, profile: LinkProfile,
               seed: int = 0) -> ChaosLinkClient:
    """Wrap a remote-cluster client in a seeded degraded link."""
    return ChaosLinkClient(client, SimulatedLink(profile, seed=seed))
