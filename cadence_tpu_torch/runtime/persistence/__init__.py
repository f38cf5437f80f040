"""Persistence: the five-manager storage contract + backends.

Reference model: Cadence common/persistence/dataInterfaces.go (manager
interfaces at :1470-1596) with Cassandra and SQL plugins; here a memory
backend (tests, onebox) and a SQLite backend (durable single node)
implement the identical contract, exercised by one conformance suite
(the reference package's tests/test_persistence.py, run on this package
too) — the reference's persistence-tests pattern.

A copy of the reference package's ``runtime/persistence/__init__.py``.
"""

from .errors import (
    ConditionFailedError,
    DomainAlreadyExistsError,
    EntityNotExistsError,
    PersistenceError,
    ShardAlreadyExistsError,
    ShardOwnershipLostError,
    TaskListLeaseLostError,
    WorkflowAlreadyStartedError,
)
from .interfaces import (
    ExecutionManager,
    HistoryManager,
    MetadataManager,
    PersistenceBundle,
    ShardManager,
    TaskManager,
    VisibilityManager,
)
from .memory import create_memory_bundle
from .records import (
    BranchAncestor,
    BranchToken,
    CreateWorkflowMode,
    CurrentExecution,
    DomainConfig,
    DomainInfo,
    DomainRecord,
    DomainReplicationConfig,
    GetWorkflowResponse,
    ShardInfo,
    TaskInfo,
    TaskListInfo,
    TaskType,
    VisibilityRecord,
    WorkflowSnapshot,
)
from .sqlite import create_sqlite_bundle
