"""Checkpointed incremental replay: resumable state snapshots.

A copy of the reference package's checkpoint plane over the port's replay
contract. A checkpoint holds one run's replayed state row at a
transaction-batch boundary, the packer's continuation and side table, the
version history at the snapshot and the fingerprint of the transition
contract, so a rebuild reads and replays only the event suffix past the
newest valid snapshot: a repeat rebuild costs O(new events).

* :mod:`record`: the durable :class:`ReplayCheckpoint` and its JSON form;
* :mod:`fingerprint`: the hash of the replay contract's sources (the CUDA
  kernels included), stamped on every record;
* :mod:`store`: the :class:`CheckpointStore` contract and its memory
  backend;
* :mod:`manager`: lookup (fingerprint, capacities and NDC-LCA
  validation), write policy, retention, and the conversions to the
  packer's resume states. Every store interaction is failure-isolated: a
  broken checkpoint plane degrades to a full replay, never to a wrong
  rebuild.
"""

from .fingerprint import transition_fingerprint
from .manager import (
    CheckpointManager,
    CheckpointPolicy,
    checkpoint_from_replay,
)
from .record import ReplayCheckpoint
from .store import CheckpointStore, MemoryCheckpointStore

__all__ = [
    "CheckpointManager",
    "CheckpointPolicy",
    "CheckpointStore",
    "MemoryCheckpointStore",
    "ReplayCheckpoint",
    "checkpoint_from_replay",
    "transition_fingerprint",
]
