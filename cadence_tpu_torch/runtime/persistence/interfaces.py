"""The history store contract.

A copy of the reference package's ``HistoryManager`` interface (Cadence
common/persistence/dataInterfaces.go, historyV2Store.go): a workflow's
history is a tree of append-only branches of event-batch nodes, where a
node's id is the first event id of its batch.
"""

from __future__ import annotations

from typing import List, Tuple

from ...core.events import HistoryEvent
from .records import BranchToken


class HistoryManager:
    """History-as-tree: append-only branches of event-batch nodes."""

    def new_history_branch(self, tree_id: str) -> BranchToken:
        raise NotImplementedError

    def append_history_nodes(
        self,
        branch: BranchToken,
        events: List[HistoryEvent],
        transaction_id: int,
    ) -> int:
        """Returns stored size in bytes. Highest transaction_id wins on
        node-id collision (the reference's fork/conflict discipline)."""
        raise NotImplementedError

    def read_history_branch(
        self,
        branch: BranchToken,
        min_event_id: int,
        max_event_id: int,
        page_size: int = 0,
        next_token: int = 0,
    ) -> Tuple[List[List[HistoryEvent]], int]:
        """Batches with min_event_id <= first event id < max_event_id.
        Returns (batches, next_token); next_token 0 == done."""
        raise NotImplementedError

    def fork_history_branch(
        self, branch: BranchToken, fork_node_id: int
    ) -> BranchToken:
        """New branch whose ancestor chain covers [..., fork_node_id)."""
        raise NotImplementedError

    def delete_history_branch(self, branch: BranchToken) -> None:
        raise NotImplementedError

    def get_history_tree(self, tree_id: str) -> List[BranchToken]:
        raise NotImplementedError
