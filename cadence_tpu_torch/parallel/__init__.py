"""Process-group parallelism for batched history replay.

The counterpart of the reference package's ``parallel/``. The reference
scales horizontally by hashing workflowID to a shard and spreading
shards over hosts; here the same dimension is the batch axis of the
event tensor, split over the ranks of a ``torch.distributed`` process
group (the "shard" axis), with a "seq" axis for the time-pipelined
long-history path. Collectives (all_gather, all_reduce, point-to-point
hand-offs) take the place of the reference's cross-host fan-out for the
NDC replication-storm snapshot exchange (BASELINE config 5).

``launch.run_ranks`` starts the ranks (the reference runs its mesh in
one process; this one is a process a rank).
"""

from .mesh import make_mesh, shard_spec
from .replay_sharded import (
    ndc_snapshot_exchange,
    replay_packed_sharded,
    replay_sharded_fn,
)
from .pipeline import replay_pipelined

__all__ = [
    "make_mesh",
    "shard_spec",
    "replay_sharded_fn",
    "replay_packed_sharded",
    "ndc_snapshot_exchange",
    "replay_pipelined",
]
