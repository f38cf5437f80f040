"""History-tree records: branch tokens and their ancestors.

A copy of the two records of the reference package's
``runtime/persistence/records.py`` that the rebuild path uses (Cadence
historyV2Store.go branch token + ancestors). ``BranchToken.to_json`` is
byte-identical to the reference's: a branch token is the key of every
checkpoint, so both packages must spell it the same way.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List


@dataclasses.dataclass
class BranchAncestor:
    branch_id: str
    begin_node_id: int                  # inclusive
    end_node_id: int                    # exclusive


@dataclasses.dataclass
class BranchToken:
    """Identifies a branch in a workflow's history tree."""

    tree_id: str
    branch_id: str
    ancestors: List[BranchAncestor] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {
                "tree_id": self.tree_id,
                "branch_id": self.branch_id,
                "ancestors": [dataclasses.asdict(a) for a in self.ancestors],
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "BranchToken":
        d = json.loads(s)
        return cls(
            tree_id=d["tree_id"],
            branch_id=d["branch_id"],
            ancestors=[BranchAncestor(**a) for a in d.get("ancestors", [])],
        )
