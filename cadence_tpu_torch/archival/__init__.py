"""Archival: history + visibility archivers behind a URI scheme.

Reference: common/archiver/ — interface.go:73,119 (HistoryArchiver /
VisibilityArchiver), provider/provider.go (scheme registry),
filestore/historyArchiver.go (file-backed implementation),
historyIterator.go (paginated reads sized into upload blobs).

A copy of the reference package's ``archival/__init__.py``.
"""

from .uri import URI, InvalidURIError
from .interfaces import (
    ArchiveHistoryRequest,
    ArchiveVisibilityRequest,
    HistoryArchiver,
    VisibilityArchiver,
)
from .provider import ArchiverProvider
from .filestore import FilestoreHistoryArchiver, FilestoreVisibilityArchiver
from .history_iterator import HistoryIterator

__all__ = [
    "URI",
    "InvalidURIError",
    "ArchiveHistoryRequest",
    "ArchiveVisibilityRequest",
    "HistoryArchiver",
    "VisibilityArchiver",
    "ArchiverProvider",
    "FilestoreHistoryArchiver",
    "FilestoreVisibilityArchiver",
    "HistoryIterator",
]
