"""Multi-cluster topology metadata.

Reference: common/cluster/metadata.go (failover version arithmetic,
master/current cluster, per-cluster info).

A copy of the reference package's ``cluster/__init__.py``.
"""

from .metadata import ClusterInformation, ClusterMetadata, TEST_CLUSTER_METADATA

__all__ = ["ClusterInformation", "ClusterMetadata", "TEST_CLUSTER_METADATA"]
