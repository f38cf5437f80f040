"""Epoch-versioned shard routing.

A copy of the routing half of the reference package's
``runtime/resharding.py``: the ``ShardMap`` every history resolver holds
(a partition of the 32-bit workflow-hash space into residue classes
``hash % modulus == residue``, each owned by one shard id) and
``load_reshard_state``, which reads a committed map back from the shard
store. The initial map (``residue i mod N -> shard i``) routes
``fnv1a32(workflow_id) % N``, so both packages place a workflow on the
same shard. The reconfiguration half (split and merge, the write-ahead
plan and its coordinator) waits for a later slice of the port; a stored
plan is returned as its raw dict.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Tuple

from ..utils.hashing import fnv1a32


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """A partition of the workflow-hash space into residue classes.

    ``entries``: tuples ``(residue, modulus, shard_id)`` — workflow w
    routes to the entry with ``fnv1a32(w) % modulus == residue``.
    """

    epoch: int
    entries: Tuple[Tuple[int, int, int], ...]

    @classmethod
    def initial(cls, num_shards: int) -> "ShardMap":
        """Epoch-0 map: workflow w routes to ``fnv1a32(w) % num_shards``."""
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        return cls(
            epoch=0,
            entries=tuple((i, num_shards, i) for i in range(num_shards)),
        )

    # -- lookup --------------------------------------------------------

    def shard_for(self, workflow_id: str) -> int:
        return self.shard_for_hash(fnv1a32(workflow_id))

    def shard_for_hash(self, h: int) -> int:
        for residue, modulus, shard_id in self.entries:
            if h % modulus == residue:
                return shard_id
        raise RuntimeError(f"shard map does not cover hash {h}")

    def shard_ids(self) -> List[int]:
        return sorted({s for _, _, s in self.entries})

    @property
    def num_shards(self) -> int:
        return len({s for _, _, s in self.entries})

    # -- serde ---------------------------------------------------------

    def to_dict(self) -> dict:
        return {"epoch": self.epoch,
                "entries": [list(e) for e in self.entries]}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardMap":
        return cls(
            epoch=int(d["epoch"]),
            entries=tuple(tuple(int(x) for x in e) for e in d["entries"]),
        )


def load_reshard_state(shard_manager):
    """(ShardMap, in-flight plan dict or None) from the store, or
    (None, None) when no reconfiguration was ever committed. Never
    raises: a broken store reads as 'no state' (the epoch-0 map)."""
    try:
        row = shard_manager.get_reshard_state()
    except Exception:
        return None, None
    if row is None:
        return None, None
    _, blob = row
    try:
        d = json.loads(blob)
        return ShardMap.from_dict(d["map"]), d.get("plan")
    except Exception:
        return None, None
