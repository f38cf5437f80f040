"""Cluster topology + failover-version arithmetic.

Reference: common/cluster/metadata.go — every cluster owns a distinct
``initial_failover_version``; a domain's failover version moves in steps
of ``failover_version_increment`` and
``version % increment == cluster_initial_version`` identifies the owning
cluster (metadata.go GetNextFailoverVersion /
ClusterNameForFailoverVersion). The empty version (-24) means "no
version" (common/constants.go EmptyVersion).

A copy of the reference package's ``cluster/metadata.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..core.ids import EMPTY_VERSION


@dataclasses.dataclass(frozen=True)
class ClusterInformation:
    """Per-cluster static info (config.ClusterInformation)."""

    enabled: bool = True
    initial_failover_version: int = 0
    rpc_name: str = ""
    rpc_address: str = ""


class ClusterMetadata:
    """Answers "which cluster does failover version V belong to?" and
    "what is the next failover version for cluster C?"."""

    def __init__(
        self,
        *,
        enable_global_domain: bool = True,
        failover_version_increment: int = 10,
        master_cluster_name: str = "active",
        current_cluster_name: str = "active",
        cluster_info: Optional[Dict[str, ClusterInformation]] = None,
    ) -> None:
        if cluster_info is None:
            cluster_info = {"active": ClusterInformation(initial_failover_version=0)}
        if master_cluster_name not in cluster_info:
            raise ValueError(f"master cluster {master_cluster_name!r} not in cluster_info")
        if current_cluster_name not in cluster_info:
            raise ValueError(f"current cluster {current_cluster_name!r} not in cluster_info")
        versions = {}
        for name, info in cluster_info.items():
            if not 0 <= info.initial_failover_version < failover_version_increment:
                raise ValueError(
                    f"cluster {name}: initial version {info.initial_failover_version} "
                    f"outside [0, {failover_version_increment})"
                )
            if info.initial_failover_version in versions:
                raise ValueError(
                    f"clusters {versions[info.initial_failover_version]!r} and {name!r} "
                    "share an initial failover version"
                )
            versions[info.initial_failover_version] = name
        self._enable_global_domain = enable_global_domain
        self._increment = failover_version_increment
        self._master = master_cluster_name
        self._current = current_cluster_name
        self._info = dict(cluster_info)
        self._version_to_cluster = versions

    # -- identity ---------------------------------------------------------

    @property
    def is_global_domain_enabled(self) -> bool:
        return self._enable_global_domain

    @property
    def is_master_cluster(self) -> bool:
        return self._master == self._current

    @property
    def master_cluster_name(self) -> str:
        return self._master

    @property
    def current_cluster_name(self) -> str:
        return self._current

    @property
    def failover_version_increment(self) -> int:
        return self._increment

    def all_cluster_info(self) -> Dict[str, ClusterInformation]:
        return dict(self._info)

    def enabled_remote_clusters(self) -> list:
        return [
            name
            for name, info in self._info.items()
            if info.enabled and name != self._current
        ]

    # -- failover version arithmetic --------------------------------------

    def next_failover_version(self, cluster: str, current_version: int) -> int:
        """Smallest version >= current_version owned by ``cluster``
        (metadata.go GetNextFailoverVersion)."""
        info = self._info.get(cluster)
        if info is None:
            raise ValueError(f"unknown cluster {cluster!r}")
        # Sentinel inputs (e.g. EMPTY_VERSION = -24) land in cycle 0,
        # i.e. the cluster's initial failover version. This deliberately
        # deviates from the reference (whose truncating arithmetic can
        # return a negative version like -19 for -24, which no cluster
        # owns): a negative version means "no failover has happened", so
        # the next version owned by `cluster` is its cycle-0 version.
        current_version = max(current_version, 0)
        failed_version = info.initial_failover_version + (
            current_version // self._increment
        ) * self._increment
        if failed_version < current_version:
            failed_version += self._increment
        return failed_version

    def is_version_from_same_cluster(self, v1: int, v2: int) -> bool:
        return (v1 - v2) % self._increment == 0

    def cluster_name_for_failover_version(self, version: int) -> str:
        if version == EMPTY_VERSION:
            return self._current
        if version < 0:
            # Python's % yields a non-negative residue, so a corrupt
            # negative version would silently map onto a REAL cluster
            # (the Go reference's negative modulo fails the lookup);
            # surface the corruption instead of mis-routing it
            raise ValueError(
                f"invalid negative failover version {version}"
            )
        initial = version % self._increment
        name = self._version_to_cluster.get(initial)
        if name is None:
            raise ValueError(
                f"no cluster with initial failover version {initial} "
                f"(failover version {version})"
            )
        return name


# A two-cluster topology used throughout the tests (mirrors the reference's
# cluster.TestActiveClusterMetadata / host/xdc fixtures).
TEST_CLUSTER_METADATA = ClusterMetadata(
    failover_version_increment=10,
    master_cluster_name="active",
    current_cluster_name="active",
    cluster_info={
        "active": ClusterInformation(initial_failover_version=1),
        "standby": ClusterInformation(initial_failover_version=2),
    },
)
