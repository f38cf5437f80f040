"""Domain cache + registry operations.

Reference: common/cache/domainCache.go (notification-version-driven LRU)
+ common/domain/handler.go (CRUD/failover). The cache refreshes entries
when the metadata notification version moves — same contract, simpler
machinery.

A copy of the reference package's ``runtime/domains.py``.
"""

from __future__ import annotations

import logging
import uuid
from typing import Dict, List, Optional

from ..utils.locks import make_guarded, make_rlock

from .persistence.errors import EntityNotExistsError
from .persistence.interfaces import MetadataManager
from .persistence.records import (
    DomainConfig,
    DomainInfo,
    DomainRecord,
    DomainReplicationConfig,
)


class DomainCache:
    def __init__(self, metadata: MetadataManager) -> None:
        self.metadata = metadata
        self._lock = make_rlock("DomainCache._lock")
        self._by_id: Dict[str, DomainRecord] = make_guarded(
            {}, "DomainCache._by_id", self._lock
        )
        self._by_name: Dict[str, DomainRecord] = make_guarded(
            {}, "DomainCache._by_name", self._lock
        )
        self._version = -1
        self._failover_listeners: List = []
        # active-cluster snapshot per domain, taken at refresh time —
        # records can be mutated in place by callers, so the comparison
        # baseline must be the immutable string captured at insert
        self._active_cluster: Dict[str, str] = make_guarded(
            {}, "DomainCache._active_cluster", self._lock
        )

    def add_failover_listener(self, fn) -> None:
        """fn(domain_id, old_active_cluster, new_active_cluster) — fired
        when a refresh observes a domain's active cluster change (ref
        domainCache.go RegisterDomainChangeCallback driving the queue
        processors' failover handling)."""
        with self._lock:
            self._failover_listeners.append(fn)

    def _refresh_if_stale(self) -> None:
        v = self.metadata.get_metadata_version()
        with self._lock:
            if v <= self._version:
                return
        # read the store OUTSIDE the lock: every domain lookup funnels
        # through this cache, and a slow metadata scan under the lock
        # would stall all of them (queue workers, allocators, frontend)
        # behind one refresher. The version recheck below makes a
        # concurrent refresh benign: whoever applies last wins only if
        # its snapshot is newer.
        records = self.metadata.list_domains()
        failovers = []
        with self._lock:
            if v <= self._version:
                return
            # copy-then-clear instead of rebinding: the guarded proxy
            # (sanitizer mode) must stay the canonical container
            old_active = dict(self._active_cluster)
            self._active_cluster.clear()
            self._by_id.clear()
            self._by_name.clear()
            for rec in records:
                self._by_id[rec.info.id] = rec
                self._by_name[rec.info.name] = rec
                new_cluster = rec.replication_config.active_cluster_name
                self._active_cluster[rec.info.id] = new_cluster
                old_cluster = old_active.get(rec.info.id)
                if old_cluster is not None and old_cluster != new_cluster:
                    failovers.append((rec.info.id, old_cluster, new_cluster))
            self._version = v
            listeners = list(self._failover_listeners)
        for domain_id, old_cluster, new_cluster in failovers:
            for fn in listeners:
                try:
                    fn(domain_id, old_cluster, new_cluster)
                except Exception:
                    # the version transition is one-shot; a lost rewind
                    # must at least be visible
                    logging.getLogger("cadence_tpu_torch.domains").exception(
                        "failover listener failed for domain %s (%s->%s)",
                        domain_id, old_cluster, new_cluster,
                    )

    def get_by_id(self, domain_id: str) -> DomainRecord:
        self._refresh_if_stale()
        with self._lock:
            rec = self._by_id.get(domain_id)
        if rec is None:
            raise EntityNotExistsError(f"domain {domain_id}")
        return rec

    def get_by_name(self, name: str) -> DomainRecord:
        self._refresh_if_stale()
        with self._lock:
            rec = self._by_name.get(name)
        if rec is None:
            raise EntityNotExistsError(f"domain {name}")
        return rec

    def get_domain_id(self, name: str) -> str:
        return self.get_by_name(name).info.id

    def resolve(self, name_or_id: str) -> DomainRecord:
        self._refresh_if_stale()
        with self._lock:
            rec = self._by_name.get(name_or_id) or self._by_id.get(name_or_id)
        if rec is None:
            raise EntityNotExistsError(f"domain {name_or_id}")
        return rec


def register_domain(
    metadata: MetadataManager,
    name: str,
    retention_days: int = 7,
    description: str = "",
    is_global: bool = False,
    clusters: Optional[List[str]] = None,
    active_cluster: str = "active",
    domain_id: Optional[str] = None,
    failover_version: int = 0,
) -> str:
    """Domain registration (reference: domain/handler.go RegisterDomain).

    ``domain_id``/``failover_version`` are set explicitly when the domain
    record is replicated from another cluster — the ID must be identical
    cluster-wide (domainReplicationTaskHandler.go)."""
    rec = DomainRecord(
        info=DomainInfo(
            id=domain_id or str(uuid.uuid4()), name=name,
            description=description,
        ),
        config=DomainConfig(retention_days=retention_days),
        replication_config=DomainReplicationConfig(
            active_cluster_name=active_cluster,
            clusters=list(clusters or [active_cluster]),
        ),
        is_global=is_global,
        failover_version=failover_version,
    )
    return metadata.create_domain(rec)
