"""NDC version histories: (event_id, version) item chains + LCA.

Model of the reference's version-history types
(Cadence common/persistence/versionHistory.go:32-317 — items,
AddOrUpdateItem, FindLCAItem, IsLCAAppendable) used for multi-master
conflict resolution: each branch of a workflow's history tree carries the
list of ``(last event_id, failover version)`` runs that produced it; the
lowest common ancestor of two version histories decides where branches
diverged.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class VersionHistoryError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class VersionHistoryItem:
    event_id: int
    version: int


class VersionHistory:
    """One branch's version history: items with increasing event_id AND
    increasing version (reference: versionHistory.go)."""

    def __init__(
        self,
        branch_token: bytes = b"",
        items: Optional[List[VersionHistoryItem]] = None,
    ) -> None:
        self.branch_token = branch_token
        self.items: List[VersionHistoryItem] = list(items or [])

    def duplicate(self) -> "VersionHistory":
        return VersionHistory(self.branch_token, list(self.items))

    def add_or_update_item(self, event_id: int, version: int) -> None:
        # reference: versionHistory.go AddOrUpdateItem
        if not self.items:
            self.items.append(VersionHistoryItem(event_id, version))
            return
        last = self.items[-1]
        if version < last.version:
            raise VersionHistoryError(
                f"version {version} < last version {last.version}"
            )
        if event_id <= last.event_id:
            raise VersionHistoryError(
                f"event id {event_id} <= last event id {last.event_id}"
            )
        if version == last.version:
            self.items[-1] = VersionHistoryItem(event_id, version)
        else:
            self.items.append(VersionHistoryItem(event_id, version))

    def last_item(self) -> VersionHistoryItem:
        if not self.items:
            raise VersionHistoryError("empty version history")
        return self.items[-1]

    def get_event_version(self, event_id: int) -> int:
        """Version that produced ``event_id`` (reference: GetEventVersion)."""
        prev_event_id = 0
        for item in self.items:
            if prev_event_id < event_id <= item.event_id:
                return item.version
            prev_event_id = item.event_id
        raise VersionHistoryError(f"event id {event_id} not in version history")

    def find_lca_item(self, other: "VersionHistory") -> VersionHistoryItem:
        """Lowest common ancestor item (reference: versionHistory.go FindLCAItem)."""
        i = len(self.items) - 1
        j = len(other.items) - 1
        while i >= 0 and j >= 0:
            a, b = self.items[i], other.items[j]
            if a.version == b.version:
                return VersionHistoryItem(min(a.event_id, b.event_id), a.version)
            if a.version > b.version:
                i -= 1
            else:
                j -= 1
        raise VersionHistoryError("version histories have no common ancestor")

    def is_lca_appendable(self, item: VersionHistoryItem) -> bool:
        # reference: IsLCAVersionHistoryItemAppendable
        return bool(self.items) and self.items[-1] == item

    def contains_item(self, item: VersionHistoryItem) -> bool:
        prev_event_id = 0
        for it in self.items:
            if prev_event_id < item.event_id <= it.event_id and item.version == it.version:
                return True
            prev_event_id = it.event_id
        return False

    def to_dict(self) -> dict:
        return {
            "branch_token": self.branch_token.decode("latin-1"),
            "items": [[it.event_id, it.version] for it in self.items],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "VersionHistory":
        return cls(
            d.get("branch_token", "").encode("latin-1"),
            [VersionHistoryItem(e, v) for e, v in d.get("items", [])],
        )


class VersionHistories:
    """All branches + the current one (reference: versionHistory.go
    VersionHistories, GetCurrentVersionHistory / FindLCAVersionHistoryIndexAndItem)."""

    def __init__(self, histories: Optional[List[VersionHistory]] = None,
                 current_index: int = 0) -> None:
        self.histories: List[VersionHistory] = histories or [VersionHistory()]
        self.current_index = current_index

    @classmethod
    def new_empty(cls) -> "VersionHistories":
        return cls()

    def get_current_version_history(self) -> VersionHistory:
        return self.histories[self.current_index]

    def get_version_history(self, index: int) -> VersionHistory:
        return self.histories[index]

    def add_version_history(self, vh: VersionHistory) -> Tuple[bool, int]:
        """Add a branch; returns (current_changed, new_index).

        The current branch switches iff the new branch's last write version
        is the highest (reference: AddVersionHistory)."""
        self.histories.append(vh)
        new_index = len(self.histories) - 1
        current = self.get_current_version_history()
        changed = False
        if vh.last_item().version > current.last_item().version:
            self.current_index = new_index
            changed = True
        return changed, new_index

    def find_lca_index_and_item(
        self, incoming: VersionHistory
    ) -> Tuple[int, VersionHistoryItem]:
        """Branch with the deepest LCA against ``incoming``."""
        best_index = -1
        best_item: Optional[VersionHistoryItem] = None
        for idx, vh in enumerate(self.histories):
            try:
                item = vh.find_lca_item(incoming)
            except VersionHistoryError:
                continue
            if best_item is None or item.event_id > best_item.event_id:
                best_index, best_item = idx, item
        if best_item is None:
            raise VersionHistoryError("no LCA across any branch")
        return best_index, best_item

    def find_first_matching_index(self, item: VersionHistoryItem) -> int:
        for idx, vh in enumerate(self.histories):
            if vh.contains_item(item):
                return idx
        raise VersionHistoryError(f"no branch contains item {item}")

    def to_dict(self) -> dict:
        return {
            "current_index": self.current_index,
            "histories": [h.to_dict() for h in self.histories],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "VersionHistories":
        return cls(
            [VersionHistory.from_dict(h) for h in d.get("histories", [])],
            d.get("current_index", 0),
        )
