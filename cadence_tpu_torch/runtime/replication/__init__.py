"""Cross-cluster replication plane.

Reference: service/history/replicatorQueueProcessor.go (emit side),
replicationTaskFetcher.go / replicationTaskProcessor.go (consume side),
nDCHistoryReplicator.go + nDCBranchMgr / nDCConflictResolver /
nDCStateRebuilder / nDCEventsReapplier / nDCTransactionMgr (apply),
common/xdc/historyRereplicator.go (gap fill).

A copy of the reference package's ``runtime/replication`` with the same
exports. Every state rebuilder these planes build replays on the device
they are handed (default ``"cuda"``): a batched drain's conflict rebuilds,
a snapshot's serve and its install run the CUDA FSM kernel through
``StateRebuilder.rebuild_many``, and a fault of that replay raises.
"""

from .failover import (
    ClusterHandle,
    DomainFailoverCoordinator,
    FailoverDrillError,
    FailoverReport,
)
from .messages import (
    HistoryTaskV2,
    ReplicationMessages,
    RetryTaskV2Error,
)
from .replicator_queue import ReplicatorQueueProcessor
from .rebuilder import StateRebuilder
from .ndc import NDCHistoryReplicator
from .processor import ReplicationTaskFetcher, ReplicationTaskProcessor
from .rereplicator import HistoryRereplicator
from .transport import (
    MODE_EVENTS,
    MODE_SNAPSHOT,
    AdaptiveTransport,
    LinkEstimator,
    ReplicationModeController,
)

__all__ = [
    "ClusterHandle",
    "DomainFailoverCoordinator",
    "FailoverDrillError",
    "FailoverReport",
    "HistoryTaskV2",
    "ReplicationMessages",
    "RetryTaskV2Error",
    "ReplicatorQueueProcessor",
    "StateRebuilder",
    "NDCHistoryReplicator",
    "ReplicationTaskFetcher",
    "ReplicationTaskProcessor",
    "HistoryRereplicator",
    "MODE_EVENTS",
    "MODE_SNAPSHOT",
    "AdaptiveTransport",
    "LinkEstimator",
    "ReplicationModeController",
]
