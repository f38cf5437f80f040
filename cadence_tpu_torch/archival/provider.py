"""Archiver provider: scheme → implementation registry.

Reference: common/archiver/provider/provider.go — services resolve the
archiver for a domain's archival URI by scheme; unknown schemes error.

A copy of the reference package's ``archival/provider.py``.
"""

from __future__ import annotations

from typing import Callable, Dict

from .interfaces import HistoryArchiver, VisibilityArchiver
from .uri import URI


class ArchiverProvider:
    def __init__(self) -> None:
        self._history: Dict[str, Callable[[], HistoryArchiver]] = {}
        self._visibility: Dict[str, Callable[[], VisibilityArchiver]] = {}

    def register_history_archiver(
        self, scheme: str, factory: Callable[[], HistoryArchiver]
    ) -> None:
        self._history[scheme] = factory

    def register_visibility_archiver(
        self, scheme: str, factory: Callable[[], VisibilityArchiver]
    ) -> None:
        self._visibility[scheme] = factory

    def get_history_archiver(self, scheme_or_uri: str) -> HistoryArchiver:
        scheme = (
            URI.parse(scheme_or_uri).scheme
            if "://" in scheme_or_uri
            else scheme_or_uri
        )
        try:
            return self._history[scheme]()
        except KeyError:
            raise ValueError(f"no history archiver for scheme {scheme!r}")

    def get_visibility_archiver(self, scheme_or_uri: str) -> VisibilityArchiver:
        scheme = (
            URI.parse(scheme_or_uri).scheme
            if "://" in scheme_or_uri
            else scheme_or_uri
        )
        try:
            return self._visibility[scheme]()
        except KeyError:
            raise ValueError(f"no visibility archiver for scheme {scheme!r}")

    @classmethod
    def default(cls) -> "ArchiverProvider":
        from .filestore import (
            FilestoreHistoryArchiver,
            FilestoreVisibilityArchiver,
        )

        p = cls()
        p.register_history_archiver("file", FilestoreHistoryArchiver)
        p.register_visibility_archiver("file", FilestoreVisibilityArchiver)
        return p
