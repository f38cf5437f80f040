"""Forwarder: child partition → parent partition task/poll forwarding.

Reference: Cadence service/matching/forwarder.go:123-281 — in a
scalable task list, partitions form a tree (degree ``forwarder_tree_degree``)
rooted at the unpartitioned name; children forward unmatched adds and idle
polls toward the root, each direction behind a token bucket.

A copy of the reference package's ``matching/forwarder.py``.
"""

from __future__ import annotations

from typing import Optional

from ..utils.quotas import TokenBucket

from .task_list import TaskListID

TREE_DEGREE = 20


def parent_partition_name(tl_id: TaskListID, degree: int = TREE_DEGREE) -> Optional[str]:
    """Name of the parent partition, or None at the root."""
    if not tl_id.is_partition:
        return None
    p = tl_id.partition
    parent = (p - 1) // degree if p > 0 else 0
    return TaskListID.partition_name(tl_id.base_name, parent)


class Forwarder:
    def __init__(
        self,
        tl_id: TaskListID,
        engine,  # MatchingEngine; resolves the parent manager lazily
        forward_task_rps: float = 10.0,
        forward_poll_rps: float = 10.0,
    ) -> None:
        self.id = tl_id
        self._engine = engine
        self._parent = parent_partition_name(tl_id)
        self._task_tokens = TokenBucket(rps=forward_task_rps, burst=int(forward_task_rps))
        self._poll_tokens = TokenBucket(rps=forward_poll_rps, burst=int(forward_poll_rps))

    @property
    def enabled(self) -> bool:
        return self._parent is not None

    def _parent_mgr(self):
        return self._engine._get_manager(
            TaskListID(self.id.domain_id, self._parent, self.id.task_type)
        )

    def forward_offer(self, task, timeout: float) -> bool:
        if not self.enabled or not self._task_tokens.allow():
            return False
        return self._parent_mgr().matcher.offer(task, timeout)

    def forward_poll(self, timeout: float):
        if not self.enabled or not self._poll_tokens.allow():
            return None
        return self._parent_mgr().matcher.poll(timeout)
