"""Domain CRUD, failover, archival state machine, bad binaries.

Reference: common/domain/handler.go:85 (RegisterDomain/UpdateDomain/
DescribeDomain/ListDomains/DeprecateDomain), attrValidator.go (name /
cluster / retention validation), archivalConfigStateMachine.go (the
never-enabled → enabled → disabled transitions with an immutable URI).
Domain metadata changes on a global domain are published to the domain-
replication topic so other clusters converge
(service/worker/replicator/domainReplicationTaskHandler.go).

A copy of the reference package's ``frontend/domain_handler.py``.
"""

from __future__ import annotations

import dataclasses
import re
import uuid
from typing import Any, Dict, List, Optional

from ..cluster import ClusterMetadata
from ..runtime.api import BadRequestError, EntityNotExistsServiceError
from ..runtime.persistence.errors import EntityNotExistsError
from ..runtime.persistence.interfaces import MetadataManager
from ..runtime.persistence.records import (
    DomainConfig,
    DomainInfo,
    DomainRecord,
    DomainReplicationConfig,
)

DOMAIN_REPLICATION_TOPIC = "domain-replication"

_NAME_RE = re.compile(r"^[a-zA-Z0-9][a-zA-Z0-9_.-]*$")
_MIN_RETENTION_DAYS = 1
_MAX_BAD_BINARIES = 16


class DomainAlreadyExistsError(Exception):
    pass


class ArchivalStatus:
    NEVER_ENABLED = 0
    DISABLED = 1
    ENABLED = 2


def _next_archival_state(
    status: int, uri: str, req_status: Optional[int], req_uri: str,
    kind: str = "history",
) -> tuple:
    """(status', uri') — reference archivalConfigStateMachine.getNextState:
    the URI is write-once; enabling requires a URI; disable keeps it."""
    if req_uri and uri and req_uri != uri:
        raise BadRequestError("archival URI is immutable once set")
    if req_uri and not uri:
        # validate at SET time against the archiver registry for the
        # RIGHT kind — the URI is write-once, so accepting a history
        # scheme as a visibility URI (or a typo) permanently breaks
        # the domain's archival
        from ..archival import ArchiverProvider, URI

        try:
            parsed = URI.parse(req_uri)
            provider = ArchiverProvider.default()
            if kind == "visibility":
                provider.get_visibility_archiver(parsed.scheme)
            else:
                provider.get_history_archiver(parsed.scheme)
        except Exception as e:
            raise BadRequestError(f"invalid archival URI {req_uri!r}: {e}")
    new_uri = uri or req_uri
    if req_status is None:
        return status, new_uri
    if req_status == ArchivalStatus.ENABLED and not new_uri:
        raise BadRequestError("cannot enable archival without a URI")
    if req_status == ArchivalStatus.NEVER_ENABLED:
        raise BadRequestError("cannot transition back to never-enabled")
    return req_status, new_uri


class DomainHandler:
    def __init__(
        self,
        metadata: MetadataManager,
        cluster_metadata: Optional[ClusterMetadata] = None,
        replication_producer=None,  # messaging.Producer on the domain topic
    ) -> None:
        self.metadata = metadata
        self.cluster = cluster_metadata or ClusterMetadata()
        self._producer = replication_producer

    # -- validation (attrValidator.go) ---------------------------------

    def _validate_name(self, name: str) -> None:
        if not name or len(name) > 256 or not _NAME_RE.match(name):
            raise BadRequestError(f"invalid domain name {name!r}")

    def _validate_retention(self, days: int) -> None:
        if days < _MIN_RETENTION_DAYS:
            raise BadRequestError(
                f"retention {days}d below minimum {_MIN_RETENTION_DAYS}d"
            )

    def _validate_clusters(
        self, clusters: List[str], active: str, is_global: bool
    ) -> None:
        known = self.cluster.all_cluster_info()
        for c in clusters:
            if c not in known:
                raise BadRequestError(f"unknown cluster {c!r}")
        if active not in clusters:
            raise BadRequestError(
                f"active cluster {active!r} not in replication clusters"
            )
        if is_global and not self.cluster.is_global_domain_enabled:
            raise BadRequestError("global domains are disabled")
        if is_global and len(clusters) < 2:
            raise BadRequestError("a global domain needs >= 2 clusters")
        if not is_global and len(clusters) > 1:
            raise BadRequestError("a local domain cannot span clusters")

    # -- CRUD ----------------------------------------------------------

    def register_domain(
        self,
        name: str,
        description: str = "",
        owner_email: str = "",
        retention_days: int = 7,
        emit_metric: bool = True,
        clusters: Optional[List[str]] = None,
        active_cluster: str = "",
        is_global: bool = False,
        data: Optional[Dict[str, str]] = None,
        history_archival_status: Optional[int] = None,
        history_archival_uri: str = "",
        visibility_archival_status: Optional[int] = None,
        visibility_archival_uri: str = "",
        domain_id: str = "",
        failover_version: Optional[int] = None,
    ) -> str:
        """Reference handler.go RegisterDomain. Returns the domain id."""
        if is_global and not self.cluster.is_master_cluster and failover_version is None:
            raise BadRequestError(
                "global domains register on the master cluster only"
            )
        self._validate_name(name)
        self._validate_retention(retention_days)
        active = active_cluster or self.cluster.current_cluster_name
        cluster_list = list(clusters or [active])
        self._validate_clusters(cluster_list, active, is_global)
        try:
            self.metadata.get_domain(name=name)
            raise DomainAlreadyExistsError(f"domain {name} exists")
        except EntityNotExistsError:
            pass

        h_status, h_uri = _next_archival_state(
            ArchivalStatus.NEVER_ENABLED, "", history_archival_status,
            history_archival_uri,
        )
        v_status, v_uri = _next_archival_state(
            ArchivalStatus.NEVER_ENABLED, "", visibility_archival_status,
            visibility_archival_uri, kind="visibility",
        )
        if failover_version is None:
            failover_version = (
                self.cluster.next_failover_version(active, 0)
                if is_global
                else 0
            )
        rec = DomainRecord(
            info=DomainInfo(
                id=domain_id or str(uuid.uuid4()), name=name,
                description=description, owner_email=owner_email,
                data=dict(data or {}),
            ),
            config=DomainConfig(
                retention_days=retention_days,
                emit_metric=emit_metric,
                history_archival_status=h_status,
                history_archival_uri=h_uri,
                visibility_archival_status=v_status,
                visibility_archival_uri=v_uri,
            ),
            replication_config=DomainReplicationConfig(
                active_cluster_name=active, clusters=cluster_list
            ),
            is_global=is_global,
            failover_version=failover_version,
        )
        out = self.metadata.create_domain(rec)
        self._replicate(rec, operation="create")
        return out

    def describe_domain(
        self, name: str = "", id: str = ""
    ) -> DomainRecord:
        try:
            return self.metadata.get_domain(id=id, name=name)
        except EntityNotExistsError:
            raise EntityNotExistsServiceError(f"domain {name or id} not found")

    def list_domains(self) -> List[DomainRecord]:
        return self.metadata.list_domains()

    def deprecate_domain(self, name: str) -> None:
        rec = self.describe_domain(name=name)
        rec.info.status = 1
        rec.config_version += 1
        self.metadata.update_domain(rec)
        self._replicate(rec, operation="update")

    # -- update / failover ---------------------------------------------

    def update_domain(
        self,
        name: str,
        description: Optional[str] = None,
        owner_email: Optional[str] = None,
        retention_days: Optional[int] = None,
        emit_metric: Optional[bool] = None,
        data: Optional[Dict[str, str]] = None,
        active_cluster: Optional[str] = None,
        clusters: Optional[List[str]] = None,
        history_archival_status: Optional[int] = None,
        history_archival_uri: str = "",
        visibility_archival_status: Optional[int] = None,
        visibility_archival_uri: str = "",
        add_bad_binary: Optional[Dict[str, str]] = None,
        remove_bad_binary: str = "",
    ) -> DomainRecord:
        """Reference handler.go UpdateDomain — config updates are master-
        only for global domains; a pure failover (active_cluster change)
        is allowed from any cluster."""
        rec = self.describe_domain(name=name)
        config_changed = any(
            v is not None
            for v in (
                description, owner_email, retention_days, emit_metric,
                data, clusters, history_archival_status,
                visibility_archival_status,
            )
        ) or bool(
            history_archival_uri or visibility_archival_uri
            or add_bad_binary or remove_bad_binary
        )
        failover = (
            active_cluster is not None
            and active_cluster != rec.replication_config.active_cluster_name
        )
        if (
            rec.is_global
            and config_changed
            and not self.cluster.is_master_cluster
        ):
            raise BadRequestError(
                "global domain config updates are master-cluster only"
            )
        if config_changed and failover:
            raise BadRequestError(
                "cannot combine a config update with a failover"
            )

        if description is not None:
            rec.info.description = description
        if owner_email is not None:
            rec.info.owner_email = owner_email
        if data is not None:
            rec.info.data.update(data)
        if retention_days is not None:
            self._validate_retention(retention_days)
            rec.config.retention_days = retention_days
        if emit_metric is not None:
            rec.config.emit_metric = emit_metric
        if clusters is not None:
            self._validate_clusters(
                clusters, rec.replication_config.active_cluster_name,
                rec.is_global,
            )
            rec.replication_config.clusters = list(clusters)

        rec.config.history_archival_status, rec.config.history_archival_uri = (
            _next_archival_state(
                rec.config.history_archival_status,
                rec.config.history_archival_uri,
                history_archival_status, history_archival_uri,
            )
        )
        (
            rec.config.visibility_archival_status,
            rec.config.visibility_archival_uri,
        ) = _next_archival_state(
            rec.config.visibility_archival_status,
            rec.config.visibility_archival_uri,
            visibility_archival_status, visibility_archival_uri,
            kind="visibility",
        )

        if add_bad_binary:
            if len(rec.config.bad_binaries) >= _MAX_BAD_BINARIES:
                raise BadRequestError(
                    f"bad binaries limit {_MAX_BAD_BINARIES} reached"
                )
            checksum = add_bad_binary.get("checksum", "")
            if not checksum:
                raise BadRequestError("bad binary needs a checksum")
            rec.config.bad_binaries[checksum] = {
                "reason": add_bad_binary.get("reason", ""),
                "operator": add_bad_binary.get("operator", ""),
            }
        if remove_bad_binary:
            rec.config.bad_binaries.pop(remove_bad_binary, None)

        if failover:
            if active_cluster not in rec.replication_config.clusters:
                raise BadRequestError(
                    f"failover target {active_cluster!r} not in domain clusters"
                )
            if not rec.is_global:
                raise BadRequestError("local domains cannot fail over")
            rec.replication_config.active_cluster_name = active_cluster
            rec.failover_version = self.cluster.next_failover_version(
                active_cluster, rec.failover_version + 1
            )
            rec.failover_notification_version = rec.notification_version
        if config_changed:
            rec.config_version += 1

        self.metadata.update_domain(rec)
        self._replicate(rec, operation="update")
        return self.describe_domain(name=name)

    def failover_domain(self, name: str, target_cluster: str) -> DomainRecord:
        return self.update_domain(name, active_cluster=target_cluster)

    # -- cross-cluster propagation -------------------------------------

    def _replicate(self, rec: DomainRecord, operation: str) -> None:
        if self._producer is None or not rec.is_global:
            return
        self._producer.publish(
            rec.info.name,
            {"operation": operation, "record": _record_to_dict(rec)},
        )

    def apply_replication_record(self, payload: Dict[str, Any]) -> None:
        """Apply a domain-replication message from the master cluster
        (reference: domainReplicationTaskHandler.go) — upsert by id."""
        rec = _record_from_dict(payload["record"])
        try:
            existing = self.metadata.get_domain(id=rec.info.id)
        except EntityNotExistsError:
            self.metadata.create_domain(rec)
            return
        # PER-FIELD merge (reference domainReplicationTaskExecutor):
        # failover state and config state version independently — a
        # pure failover published by a cluster that hasn't seen the
        # latest config update must still land (an OR-reject would
        # silently drop it and the clusters would diverge on the
        # active cluster forever)
        if (
            rec.failover_version <= existing.failover_version
            and rec.config_version <= existing.config_version
        ):
            return
        merged = rec
        if rec.config_version < existing.config_version:
            # keep the newer local config, take the newer failover
            merged = dataclasses.replace(
                existing,
                replication_config=rec.replication_config,
                failover_version=rec.failover_version,
                failover_notification_version=(
                    rec.failover_notification_version
                ),
            )
        elif rec.failover_version < existing.failover_version:
            # keep the newer local failover, take the newer config
            merged = dataclasses.replace(
                rec,
                replication_config=existing.replication_config,
                failover_version=existing.failover_version,
                failover_notification_version=(
                    existing.failover_notification_version
                ),
            )
        self.metadata.update_domain(merged)


def _record_to_dict(rec: DomainRecord) -> Dict[str, Any]:
    return {
        "info": dataclasses.asdict(rec.info),
        "config": dataclasses.asdict(rec.config),
        "replication_config": dataclasses.asdict(rec.replication_config),
        "is_global": rec.is_global,
        "config_version": rec.config_version,
        "failover_version": rec.failover_version,
        "failover_notification_version": rec.failover_notification_version,
    }


def _record_from_dict(d: Dict[str, Any]) -> DomainRecord:
    return DomainRecord(
        info=DomainInfo(**d["info"]),
        config=DomainConfig(**d["config"]),
        replication_config=DomainReplicationConfig(**d["replication_config"]),
        is_global=d.get("is_global", False),
        config_version=d.get("config_version", 0),
        failover_version=d.get("failover_version", 0),
        failover_notification_version=d.get(
            "failover_notification_version", 0
        ),
    )
