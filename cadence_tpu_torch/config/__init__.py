"""Static server configuration (YAML) + service bootstrap.

Reference: common/service/config/config.go (the YAML config structs:
persistence, ringpop, per-service rpc/metrics, clusterMetadata,
archival, dynamicconfig) and cmd/server/server.go:207-219 (the
--services switch assembling only the requested services in one
process). See config/development.yaml for a sample.

A copy of the reference package's ``config/__init__.py``; the port also
exports ``AutopilotConfig`` and ``ReshardingConfig``, which its runtime
imported from here before the loader was ported.
"""

from .static import (
    AutopilotConfig,
    ChaosConfig,
    ClusterConfig,
    ConfigError,
    ClusterEntry,
    PersistenceConfig,
    ReshardingConfig,
    RingConfig,
    ServerConfig,
    ServiceConfig,
    load_config,
    load_config_dict,
)
from .bootstrap import RunningServer, start_services

__all__ = [
    "AutopilotConfig",
    "ChaosConfig",
    "ClusterConfig",
    "ConfigError",
    "ClusterEntry",
    "PersistenceConfig",
    "ReshardingConfig",
    "RingConfig",
    "ServerConfig",
    "ServiceConfig",
    "RunningServer",
    "load_config",
    "load_config_dict",
    "start_services",
]
