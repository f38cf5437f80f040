"""Task allocator: should THIS cluster process a task actively?

Reference: service/history/taskAllocator.go — during/after failover,
each queue task is checked against the domain's active cluster; a
standby cluster must not fire timers or dispatch tasks for a domain it
is passive for (the active side does; the standby's state converges via
replication instead).

A copy of the reference package's ``runtime/queues/allocator.py``;
``defer_task`` also hands the task to the ack manager.
"""

from __future__ import annotations


class TaskAllocator:
    def __init__(self, domains, cluster_metadata=None) -> None:
        self.domains = domains
        self.cluster_metadata = cluster_metadata

    def should_process(self, domain_id: str) -> bool:
        """True if the task's domain is active here (or local-only, or
        the cluster is single-cluster)."""
        return self.owning_cluster(domain_id) is None

    def owning_cluster(self, domain_id: str) -> "str | None":
        """None when the task's domain is active here; otherwise the
        remote cluster the domain is active in (whose standby plane —
        if one runs here — owns the task)."""
        if self.cluster_metadata is None:
            return None
        try:
            rec = self.domains.get_by_id(domain_id)
        except Exception:
            return None  # unknown domain: let the handler surface it
        if not rec.is_global:
            return None
        active = rec.replication_config.active_cluster_name
        if active == self.cluster_metadata.current_cluster_name:
            return None
        return active


class DeferTask(Exception):
    """Raised by a processor handler when the task must NOT be executed
    or completed now (domain is passive here). The runner abandons the
    task back to the queue after a standby delay — mirroring the
    reference's standby task processors, which hold tasks until the
    domain fails over or replication catches up."""


STANDBY_RETRY_DELAY_S = 0.5


def defer_task(ack, key, delay_s: float = STANDBY_RETRY_DELAY_S,
               task=None) -> None:
    """Hold a deferred (passive-domain / standby-unverified) task: the
    ack entry stays outstanding — blocking the ack sweep so queue GC
    cannot delete the row — and becomes re-readable after the standby
    delay (QueueAckManager.defer; ``task`` rides along for a pump that
    takes its retries back instead of re-reading them)."""
    ack.defer(key, delay_s, task)
