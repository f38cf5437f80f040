"""History iterator: page a branch into bounded upload blobs.

Reference: common/archiver/historyIterator.go — archival uploads read
the history tree in pages and emit blobs capped by event count/size so
giant histories stream instead of loading whole.

A copy of the reference package's ``archival/history_iterator.py``.
"""

from __future__ import annotations

from typing import Iterator, List

from ..core.events import HistoryEvent
from ..runtime.persistence.records import BranchToken


class HistoryIterator:
    def __init__(
        self,
        history_manager,
        branch_token: bytes,
        next_event_id: int = 1 << 60,
        events_per_blob: int = 256,
    ) -> None:
        self.history = history_manager
        self.branch = BranchToken.from_json(branch_token.decode())
        self.next_event_id = next_event_id
        self.events_per_blob = events_per_blob

    def __iter__(self) -> Iterator[List[List[HistoryEvent]]]:
        token = 0
        blob: List[List[HistoryEvent]] = []
        count = 0
        while True:
            batches, token = self.history.read_history_branch(
                self.branch, 1, self.next_event_id,
                page_size=16, next_token=token,
            )
            for batch in batches:
                blob.append(batch)
                count += len(batch)
                if count >= self.events_per_blob:
                    yield blob
                    blob, count = [], 0
            if not token:
                break
        if blob:
            yield blob

    def all_batches(self) -> List[List[HistoryEvent]]:
        out: List[List[HistoryEvent]] = []
        for blob in self:
            out.extend(blob)
        return out
