"""Archiver contracts.

Reference: common/archiver/interface.go:73 (HistoryArchiver: Archive /
Get / ValidateURI) and :119 (VisibilityArchiver: Archive / Query /
ValidateURI).

A copy of the reference package's ``archival/interfaces.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..core.events import HistoryEvent

from .uri import URI


@dataclasses.dataclass
class ArchiveHistoryRequest:
    domain_id: str
    domain_name: str
    workflow_id: str
    run_id: str
    branch_token: bytes = b""
    next_event_id: int = 0
    close_failover_version: int = 0


@dataclasses.dataclass
class ArchiveVisibilityRequest:
    domain_id: str
    domain_name: str
    workflow_id: str
    run_id: str
    workflow_type: str = ""
    start_time: int = 0
    execution_time: int = 0
    close_time: int = 0
    close_status: int = 0
    history_length: int = 0
    memo: Dict[str, Any] = dataclasses.field(default_factory=dict)
    search_attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)


class HistoryArchiver:
    def validate_uri(self, uri: URI) -> None:
        raise NotImplementedError

    def archive(
        self, uri: URI, request: ArchiveHistoryRequest,
        batches: List[List[HistoryEvent]],
    ) -> None:
        raise NotImplementedError

    def get(
        self, uri: URI, domain_id: str, workflow_id: str, run_id: str,
        page_size: int = 0, next_token: int = 0,
    ) -> Tuple[List[List[HistoryEvent]], int]:
        raise NotImplementedError


class VisibilityArchiver:
    def validate_uri(self, uri: URI) -> None:
        raise NotImplementedError

    def archive(self, uri: URI, request: ArchiveVisibilityRequest) -> None:
        raise NotImplementedError

    def query(
        self, uri: URI, domain_id: str, query: str = "",
        page_size: int = 100, next_token: int = 0,
    ):
        raise NotImplementedError
