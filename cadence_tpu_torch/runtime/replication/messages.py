"""Replication wire types.

Reference: the ReplicationTask / HistoryTaskV2Attributes thrift shapes
(idl replicator.thrift) carried by GetReplicationMessages
(service/history/replicatorQueueProcessor.go getHistoryTaskV2) and the
RetryTaskV2Error the passive side raises when events arrive out of order
(common/persistence serviceerrors → xdc rereplication).

A copy of the reference package's ``runtime/replication/messages.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ...core.events import HistoryEvent


@dataclasses.dataclass
class HistoryTaskV2:
    """One replicated transaction batch for one workflow run."""

    task_id: int
    domain_id: str
    workflow_id: str
    run_id: str
    version_history_items: List[Dict[str, int]]  # [{"event_id", "version"}]
    events: List[HistoryEvent]
    new_run_events: List[HistoryEvent] = dataclasses.field(default_factory=list)
    new_run_id: str = ""

    @property
    def first_event_id(self) -> int:
        return self.events[0].event_id if self.events else 0

    @property
    def next_event_id(self) -> int:
        return self.events[-1].event_id + 1 if self.events else 0

    @property
    def version(self) -> int:
        return self.events[0].version if self.events else 0


@dataclasses.dataclass
class ReplicationMessages:
    """One pull response: tasks after ``last_retrieved_id`` plus whether
    the emitter has more backlog."""

    tasks: List[HistoryTaskV2]
    last_retrieved_id: int
    has_more: bool = False
    # emitter's clock at serve time — advances the consumer's view of the
    # remote cluster (ref syncShardStatus / shardContext.SetCurrentTime),
    # which gates standby timer processing
    source_time_ns: int = 0


class RetryTaskV2Error(Exception):
    """Passive side is missing earlier events — the caller must
    re-replicate [start_event_id, end_event_id) first and retry."""

    def __init__(
        self,
        msg: str,
        domain_id: str = "",
        workflow_id: str = "",
        run_id: str = "",
        start_event_id: int = 0,
        start_event_version: int = 0,
        end_event_id: int = 0,
        end_event_version: int = 0,
    ) -> None:
        super().__init__(msg)
        self.domain_id = domain_id
        self.workflow_id = workflow_id
        self.run_id = run_id
        self.start_event_id = start_event_id
        self.start_event_version = start_event_version
        self.end_event_id = end_event_id
        self.end_event_version = end_event_version
