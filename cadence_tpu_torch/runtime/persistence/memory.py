"""In-memory history store.

A copy of the reference package's ``MemoryHistoryManager``: branches of
event-batch nodes kept as encoded blobs, so a read decodes fresh events
exactly as a durable store would. It guards its maps with a plain
``threading`` lock (the reference's lock-order tracking is not ported).
"""

from __future__ import annotations

import copy
import threading
import uuid
from typing import Dict, List, Tuple

from ...core.events import HistoryEvent, decode_batch, encode_batch
from .interfaces import HistoryManager
from .records import BranchAncestor, BranchToken


class MemoryHistoryManager(HistoryManager):
    """The history store in a dict, under one re-entrant lock."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        # (tree_id, branch_id) -> {node_id -> (transaction_id, blob)}
        self._nodes: Dict[Tuple[str, str], Dict[int, Tuple[int, bytes]]] = {}
        # tree_id -> {branch_id -> BranchToken}
        self._branches: Dict[str, Dict[str, BranchToken]] = {}

    def new_history_branch(self, tree_id: str) -> BranchToken:
        with self._lock:
            token = BranchToken(tree_id=tree_id, branch_id=str(uuid.uuid4()))
            self._branches.setdefault(tree_id, {})[token.branch_id] = token
            self._nodes.setdefault((tree_id, token.branch_id), {})
            return copy.deepcopy(token)

    def append_history_nodes(
        self,
        branch: BranchToken,
        events: List[HistoryEvent],
        transaction_id: int,
    ) -> int:
        if not events:
            raise ValueError("empty event batch")
        node_id = events[0].event_id
        blob = encode_batch(events)
        with self._lock:
            nodes = self._nodes.setdefault(
                (branch.tree_id, branch.branch_id), {}
            )
            tree = self._branches.setdefault(branch.tree_id, {})
            if branch.branch_id not in tree:
                # copied once, when the branch is first seen (a copy per
                # append was half of an append's cost)
                tree[branch.branch_id] = copy.deepcopy(branch)
            existing = nodes.get(node_id)
            if existing is None or existing[0] < transaction_id:
                nodes[node_id] = (transaction_id, blob)
            return len(blob)

    def _branch_node_ranges(
        self, branch: BranchToken
    ) -> List[Tuple[str, int, int]]:
        """(branch_id, begin, end) segments composing this branch's view."""
        segments = [
            (a.branch_id, a.begin_node_id, a.end_node_id)
            for a in branch.ancestors
        ]
        segments.append((branch.branch_id, 1 if not branch.ancestors else
                         branch.ancestors[-1].end_node_id, 2**62))
        return segments

    def read_history_branch(
        self,
        branch: BranchToken,
        min_event_id: int,
        max_event_id: int,
        page_size: int = 0,
        next_token: int = 0,
    ) -> Tuple[List[List[HistoryEvent]], int]:
        with self._lock:
            collected: List[Tuple[int, bytes]] = []
            for branch_id, begin, end in self._branch_node_ranges(branch):
                nodes = self._nodes.get((branch.tree_id, branch_id), {})
                for node_id, (_, blob) in nodes.items():
                    if begin <= node_id < end and (
                        min_event_id <= node_id < max_event_id
                    ) and node_id >= next_token:
                        collected.append((node_id, blob))
            collected.sort(key=lambda x: x[0])
            if page_size and len(collected) > page_size:
                page = collected[:page_size]
                token = collected[page_size][0]
            else:
                page, token = collected, 0
            return [decode_batch(blob) for _, blob in page], token

    def fork_history_branch(
        self, branch: BranchToken, fork_node_id: int
    ) -> BranchToken:
        with self._lock:
            ancestors: List[BranchAncestor] = []
            for a in branch.ancestors:
                if a.end_node_id <= fork_node_id:
                    ancestors.append(copy.deepcopy(a))
                else:
                    ancestors.append(
                        BranchAncestor(
                            a.branch_id, a.begin_node_id, fork_node_id
                        )
                    )
                    break
            else:
                begin = (
                    branch.ancestors[-1].end_node_id if branch.ancestors else 1
                )
                ancestors.append(
                    BranchAncestor(branch.branch_id, begin, fork_node_id)
                )
            token = BranchToken(
                tree_id=branch.tree_id,
                branch_id=str(uuid.uuid4()),
                ancestors=ancestors,
            )
            self._branches.setdefault(branch.tree_id, {})[
                token.branch_id
            ] = token
            self._nodes.setdefault((branch.tree_id, token.branch_id), {})
            return copy.deepcopy(token)

    def delete_history_branch(self, branch: BranchToken) -> None:
        with self._lock:
            tree = self._branches.get(branch.tree_id) or {}
            tree.pop(branch.branch_id, None)
            if branch.tree_id in self._branches and not tree:
                del self._branches[branch.tree_id]
            # Sweep every node range in the tree no surviving branch
            # owns or references as an ancestor segment (shared fork
            # prefix — reference historyV2 deleteBranch keeps shared
            # ranges). Whole-tree sweep also reclaims ranges a
            # previously-deleted ancestor left behind, orphaned exactly
            # when its last descendant goes.
            live: dict = {}  # branch_id -> protected end (0 = whole)
            for bid, token in tree.items():
                live[bid] = 0
                for anc in token.ancestors:
                    if live.get(anc.branch_id, 1) != 0:
                        live[anc.branch_id] = max(
                            live.get(anc.branch_id, 0), anc.end_node_id
                        )
            # candidate ranges only (not a store-wide key scan): the
            # deleted branch, its full ancestor chain, and every live
            # branch id cover all ranges this delete can orphan —
            # an orphan outside this set would have been swept when ITS
            # last descendant was deleted (induction)
            candidates = {branch.branch_id}
            candidates.update(a.branch_id for a in branch.ancestors)
            candidates.update(live)
            for bid in candidates:
                key = (branch.tree_id, bid)
                if key not in self._nodes:
                    continue
                end = live.get(bid)
                if end == 0:
                    continue  # a live branch owns the whole range
                if end is None:
                    self._nodes.pop(key, None)
                else:
                    nodes = self._nodes[key]
                    for nid in [n for n in nodes if n >= end]:
                        del nodes[nid]

    def get_history_tree(self, tree_id: str) -> List[BranchToken]:
        with self._lock:
            return [
                copy.deepcopy(t)
                for t in self._branches.get(tree_id, {}).values()
            ]
