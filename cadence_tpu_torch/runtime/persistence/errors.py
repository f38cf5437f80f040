"""Persistence error taxonomy (reference: common/persistence/dataInterfaces.go
error types + workflow service errors the managers surface).

A copy of the reference package's ``runtime/persistence/errors.py``.
"""

from __future__ import annotations


class PersistenceError(Exception):
    pass


class EntityNotExistsError(PersistenceError):
    pass


class ConditionFailedError(PersistenceError):
    """Optimistic-concurrency condition (next_event_id / range_id block)
    failed — caller reloads and retries (the Update_History_Loop,
    reference decisionHandler.go:291)."""


class ShardAlreadyExistsError(PersistenceError):
    pass


class ShardOwnershipLostError(PersistenceError):
    """Write fenced by a newer range_id: another host stole the shard
    (reference: ShardOwnershipLostError, handled by shardController)."""

    def __init__(self, shard_id: int, msg: str = "") -> None:
        super().__init__(msg or f"shard {shard_id} ownership lost")
        self.shard_id = shard_id


class WorkflowAlreadyStartedError(PersistenceError):
    def __init__(
        self, msg: str, start_request_id: str, run_id: str,
        state: int = 0, close_status: int = 0, last_write_version: int = 0,
    ) -> None:
        super().__init__(msg)
        self.start_request_id = start_request_id
        self.run_id = run_id
        self.state = state
        self.close_status = close_status
        self.last_write_version = last_write_version


class DomainAlreadyExistsError(PersistenceError):
    pass


class TaskListLeaseLostError(ConditionFailedError):
    """Task-list range_id condition failed — another matching host owns
    it. A ConditionFailedError so lease-fencing recovery paths (the
    task writer's re-lease-and-retry, taskGC's ack-level suppression)
    catch it with the rest of the optimistic-concurrency family."""
