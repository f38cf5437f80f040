"""Worker service: background daemons + the replay-based worker SDK.

Reference: service/worker/ — replicator, archiver, indexer, scanner,
batcher, parent-close-policy. The reference runs most of these *as
Cadence workflows* against the public frontend API via the Go client
SDK; this package ships a deterministic generator-based mini-SDK
(sdk.py) and implements the daemons as workflows on top of it.

A copy of the reference package's ``worker/__init__.py``: the SDK is
exported here, the daemons and the ``WorkerService`` that assembles them
live in their own modules (``archiver``, ``scanner``, ``batcher``,
``parent_close_policy``, ``indexer``, ``replicator``, ``service``).
"""

from .sdk import (
    ActivityWorker,
    DecisionWorker,
    Worker,
    WorkflowRegistry,
    activity_method,
)

__all__ = [
    "ActivityWorker",
    "DecisionWorker",
    "Worker",
    "WorkflowRegistry",
    "activity_method",
]
