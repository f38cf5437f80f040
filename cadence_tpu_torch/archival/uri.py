"""Archival URI: scheme://path.

Reference: common/archiver/URI.go — archival destinations are opaque
URIs whose scheme selects the archiver implementation.

A copy of the reference package's ``archival/uri.py``.
"""

from __future__ import annotations

import dataclasses


class InvalidURIError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class URI:
    scheme: str
    path: str

    @classmethod
    def parse(cls, raw: str) -> "URI":
        if "://" not in raw:
            raise InvalidURIError(f"URI {raw!r} missing scheme://")
        scheme, _, path = raw.partition("://")
        if not scheme:
            raise InvalidURIError(f"URI {raw!r} has an empty scheme")
        return cls(scheme=scheme, path=path)

    def __str__(self) -> str:
        return f"{self.scheme}://{self.path}"
