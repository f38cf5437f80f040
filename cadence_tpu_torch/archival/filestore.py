"""File-backed archivers.

Reference: common/archiver/filestore/historyArchiver.go +
visibilityArchiver.go — archives land as JSON files under the URI path:
``<path>/<domain_id>/<workflow_id>/<run_id>/history.json`` and
``<path>/<domain_id>/visibility/<workflow_id>.<run_id>.json``. Writes
are atomic (tmp + rename) and idempotent (archival retries overwrite
with identical content).

A copy of the reference package's ``archival/filestore.py``.
"""

from __future__ import annotations

import copy
import json
import os
import tempfile
from typing import List, Tuple
from urllib.parse import quote

from ..core.events import HistoryEvent
from ..runtime.persistence.records import VisibilityRecord
from ..visibility.query import compile_query

from .interfaces import (
    ArchiveHistoryRequest,
    ArchiveVisibilityRequest,
    HistoryArchiver,
    VisibilityArchiver,
)
from .uri import URI, InvalidURIError


def _safe(component: str) -> str:
    """Workflow/run ids are caller-controlled; percent-encode every path
    separator AND '.' (quote leaves dots alone) so ids like '../../x'
    cannot escape the archive root and dotted ids cannot collide in
    the '{wid}.{rid}.json' naming scheme."""
    return quote(component, safe="").replace(".", "%2E") or "_"


def _atomic_write(path: str, data: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class FilestoreHistoryArchiver(HistoryArchiver):
    def validate_uri(self, uri: URI) -> None:
        if uri.scheme != "file" or not uri.path:
            raise InvalidURIError(f"filestore needs file://<dir>, got {uri}")

    def _path(self, uri: URI, domain_id, workflow_id, run_id) -> str:
        return os.path.join(
            uri.path, _safe(domain_id), _safe(workflow_id), _safe(run_id),
            "history.json",
        )

    def archive(
        self, uri: URI, request: ArchiveHistoryRequest,
        batches: List[List[HistoryEvent]],
    ) -> None:
        self.validate_uri(uri)
        payload = {
            "domain_id": request.domain_id,
            "domain_name": request.domain_name,
            "workflow_id": request.workflow_id,
            "run_id": request.run_id,
            "close_failover_version": request.close_failover_version,
            "batches": [[e.to_dict() for e in b] for b in batches],
        }
        _atomic_write(
            self._path(uri, request.domain_id, request.workflow_id,
                       request.run_id),
            json.dumps(payload),
        )

    def get(
        self, uri: URI, domain_id: str, workflow_id: str, run_id: str,
        page_size: int = 0, next_token: int = 0,
    ) -> Tuple[List[List[HistoryEvent]], int]:
        self.validate_uri(uri)
        path = self._path(uri, domain_id, workflow_id, run_id)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no archived history for {workflow_id}/{run_id}"
            )
        with open(path) as f:
            payload = json.load(f)
        batches = [
            [HistoryEvent.from_dict(d) for d in b]
            for b in payload["batches"]
        ]
        if page_size > 0:  # a negative size would return an empty page
            # with an unchanged token — the infinite-pagination bug
            # class fixed in the visibility paginators
            page = batches[next_token : next_token + page_size]
            token = next_token + len(page)
            return page, (token if token < len(batches) else 0)
        # unpaged read still honors a resume token — a client may page
        # the first call and fetch the remainder with page_size=0
        return batches[next_token:], 0


class FilestoreVisibilityArchiver(VisibilityArchiver):
    # parsed-payload cache bound (files, across all domain dirs): the
    # cache exists to kill O(N^2) re-parsing in paged scans, not to
    # mirror an unbounded archive in memory
    MAX_CACHED_FILES = 4096

    def validate_uri(self, uri: URI) -> None:
        if uri.scheme != "file" or not uri.path:
            raise InvalidURIError(f"filestore needs file://<dir>, got {uri}")

    def _dir(self, uri: URI, domain_id: str) -> str:
        return os.path.join(uri.path, _safe(domain_id), "visibility")

    def archive(self, uri: URI, request: ArchiveVisibilityRequest) -> None:
        self.validate_uri(uri)
        payload = {
            "domain_id": request.domain_id,
            "workflow_id": request.workflow_id,
            "run_id": request.run_id,
            "workflow_type": request.workflow_type,
            "start_time": request.start_time,
            "execution_time": request.execution_time,
            "close_time": request.close_time,
            "close_status": request.close_status,
            "history_length": request.history_length,
            "search_attributes": {
                k: v for k, v in request.search_attributes.items()
                if isinstance(v, (str, int, float, bool))
            },
        }
        _atomic_write(
            os.path.join(
                self._dir(uri, request.domain_id),
                f"{_safe(request.workflow_id)}.{_safe(request.run_id)}.json",
            ),
            json.dumps(payload),
        )

    def query(
        self, uri: URI, domain_id: str, query: str = "",
        page_size: int = 100, next_token: int = 0,
    ) -> Tuple[List[VisibilityRecord], int]:
        self.validate_uri(uri)
        d = self._dir(uri, domain_id)
        # archived visibility files are immutable (one atomic write per
        # closed run), so parse each file ONCE per archiver instance —
        # without this a paged scan re-reads every file per page
        # (O(N^2) opens across a listing). Only the parsed JSON dict is
        # cached; a fresh VisibilityRecord is constructed per call so a
        # caller mutating a returned record (store layers decorate
        # records in place) cannot poison every later query. Bounded by
        # capping INSERTION at MAX_CACHED_FILES — eviction (FIFO or
        # LRU) under a sorted sequential scan degrades to a 0% hit
        # rate once the archive outgrows the bound; keeping the head
        # hot and re-parsing only the tail preserves most of the win.
        cache = getattr(self, "_parsed", None)
        if cache is None:
            cache = self._parsed = {}
        records: List[VisibilityRecord] = []
        if os.path.isdir(d):
            for name in sorted(os.listdir(d)):
                if not name.endswith(".json"):
                    continue
                key = (d, name)
                p = cache.get(key)
                if p is None:
                    with open(os.path.join(d, name)) as f:
                        p = json.load(f)
                    if len(cache) < self.MAX_CACHED_FILES:
                        cache[key] = p
                records.append(VisibilityRecord(
                    domain_id=p["domain_id"],
                    workflow_id=p["workflow_id"],
                    run_id=p["run_id"],
                    workflow_type=p.get("workflow_type", ""),
                    start_time=p.get("start_time", 0),
                    execution_time=p.get("execution_time", 0),
                    close_time=p.get("close_time", 0),
                    close_status=p.get("close_status", 0),
                    history_length=p.get("history_length", 0),
                    # deep copy: archives written HERE hold only scalar
                    # values, but any *.json in the dir is read — a
                    # nested list/dict must not alias the cached payload
                    search_attributes=copy.deepcopy(
                        p.get("search_attributes", {})
                    ),
                ))
        if page_size <= 0:
            page_size = 100  # see AdvancedVisibilityStore: a zero page
            # would return the same token forever
        matched = compile_query(query).apply(records)
        page = matched[next_token : next_token + page_size]
        token = next_token + len(page)
        return page, (token if token < len(matched) else 0)
