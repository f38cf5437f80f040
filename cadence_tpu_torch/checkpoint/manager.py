"""Checkpoint lookup / write policy / retention.

The manager is the only thing the rebuild path talks to. Its contract:

* ``lookup`` returns the newest VALID checkpoint a rebuild may resume
  from, with a status ("hit" / "miss" / "invalidated") the rebuilder
  turns into the ``checkpoint_*`` counters. Validation is layered —
  fingerprint (kernel/schema changes), capacities (row shape),
  ``max_event_id`` (never resume past the rebuild target), and the NDC
  guard: the LCA of the checkpoint's version history and the target
  branch's must not fall before the snapshot, so a conflicting branch
  never resumes past its fork point. Same-branch candidates win over
  cross-branch (fork-point) ones.
* ``maybe_record`` persists a fresh snapshot from a replay result,
  honoring the write policy (every N events past the newest stored
  snapshot) and retention (keep last K per run tree).
* every store interaction is exception-isolated: a failing or corrupted
  checkpoint plane yields misses and skipped writes (full replay — the
  chaos fallback), never an error on the rebuild path.

A copy of the reference package's manager. Because ``maybe_record``
swallows every exception, a write that always fails (a device tensor
where the row copy needs numpy, say) would leave every rebuild correct
and every later one cold: the rebuilder hands it numpy state only, and
the tests and the smoke run count the hits of a warm pass. The serving
plane's eviction ``flush`` waits for the serving engine's port.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Sequence, Tuple

from ..core.version_history import (
    VersionHistory,
    VersionHistoryError,
    VersionHistoryItem,
)
from ..ops import schema as S
from ..ops.pack import ResumeState, WorkflowSideTable
from ..ops.unpack import state_row_to_mutable_state
from ..runtime.persistence.records import BranchToken

from .fingerprint import transition_fingerprint
from .record import ReplayCheckpoint
from .store import CheckpointStore

HIT = "hit"
MISS = "miss"
INVALIDATED = "invalidated"


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Write/retention policy.

    ``every_events``: a fresh snapshot is written only when the run tip
    advanced at least this many events past the newest stored snapshot
    of its branch (1 = snapshot every rebuild).
    ``keep_last``: retention per run tree — oldest beyond K are pruned
    after every write.
    ``on_close``: also snapshot when the rebuilt workflow is closed
    regardless of the every_events distance (closed runs are the ones
    archival/visibility rebuilds keep coming back to).
    """

    every_events: int = 256
    keep_last: int = 2
    on_close: bool = True

    def validate(self) -> None:
        if self.every_events < 1:
            raise ValueError("checkpoint policy: every_events must be >= 1")
        if self.keep_last < 1:
            raise ValueError("checkpoint policy: keep_last must be >= 1")


def _branch_key(branch_token) -> str:
    if isinstance(branch_token, bytes):
        return branch_token.decode()
    return str(branch_token)


def _tree_id(branch_key: str) -> str:
    return BranchToken.from_json(branch_key).tree_id


class CheckpointManager:
    def __init__(
        self,
        store: CheckpointStore,
        policy: Optional[CheckpointPolicy] = None,
        fingerprint: Optional[str] = None,
        clock=time.time,
    ) -> None:
        self.store = store
        self.policy = policy or CheckpointPolicy()
        self.policy.validate()
        # overridable for tests (stale-fingerprint scenarios)
        self.fingerprint = fingerprint or transition_fingerprint()
        self._clock = clock
        self._log = logging.getLogger("cadence_tpu_torch.checkpoint")

    # -- lookup --------------------------------------------------------

    def lookup(
        self,
        branch_token,
        caps: Optional[S.Capacities] = None,
        version_history_items: Optional[Sequence[Tuple[int, int]]] = None,
        max_event_id: Optional[int] = None,
    ) -> Tuple[Optional[ReplayCheckpoint], str]:
        """Newest resumable checkpoint for a rebuild of ``branch_token``.

        Returns ``(checkpoint, status)`` — status is ``hit`` (use it),
        ``miss`` (nothing stored / store failed), or ``invalidated``
        (candidates existed but every one failed validation: stale
        fingerprint, capacity mismatch, beyond ``max_event_id``, or NDC
        divergence before the snapshot).

        ``version_history_items``: the TARGET branch's (event_id,
        version) items. Required for cross-branch (fork-point) resume;
        for same-branch candidates it is the divergence guard — without
        it only exact-branch candidates are considered.
        """
        key = _branch_key(branch_token)
        try:
            # same-branch candidates first (deeper usable snapshots,
            # newest first); the common case resolves here without
            # decoding any sibling branch's records
            candidates: List[ReplayCheckpoint] = (
                self.store.list_checkpoints(key)
            )
            for ckpt in candidates:
                if self._valid(ckpt, caps, version_history_items,
                               max_event_id, cross_branch=False):
                    return ckpt, HIT
            if version_history_items:
                # fork-point resume: a sibling branch's snapshot below
                # the LCA covers this branch's prefix too — fetched
                # lazily, only once same-branch candidates are exhausted
                tree = [
                    c for c in self.store.list_tree_checkpoints(
                        _tree_id(key)
                    )
                    if c.branch_key != key
                ]
            else:
                tree = []
        except Exception as e:
            self._log.warning(f"checkpoint lookup failed ({e}); full replay")
            return None, MISS
        for ckpt in tree:
            if self._valid(ckpt, caps, version_history_items,
                           max_event_id, cross_branch=True):
                return ckpt, HIT
        if not candidates and not tree:
            return None, MISS
        return None, INVALIDATED

    def _valid(
        self,
        ckpt: ReplayCheckpoint,
        caps: Optional[S.Capacities],
        target_items: Optional[Sequence[Tuple[int, int]]],
        max_event_id: Optional[int],
        cross_branch: bool,
    ) -> bool:
        if ckpt.fingerprint != self.fingerprint:
            return False
        if caps is not None and ckpt.caps != caps:
            return False
        if max_event_id is not None and ckpt.event_id > max_event_id:
            return False
        if ckpt.resume is None or ckpt.event_id < 1:
            return False
        if target_items:
            # NDC divergence guard: every event the snapshot covers must
            # lie on the target branch — i.e. the LCA of the snapshot's
            # version history and the target's is at/after the snapshot
            try:
                lca = VersionHistory(
                    items=[VersionHistoryItem(e, v)
                           for e, v in ckpt.vh_items]
                ).find_lca_item(VersionHistory(
                    items=[VersionHistoryItem(int(e), int(v))
                           for e, v in target_items]
                ))
            except VersionHistoryError:
                return False
            if lca.event_id < ckpt.event_id:
                return False
        elif cross_branch:
            # without the target's items there is no divergence proof;
            # never resume a branch from another branch's snapshot
            return False
        return True

    # -- write ---------------------------------------------------------

    def maybe_record(
        self,
        branch_token,
        state: S.StateTensors,
        row: int,
        side: WorkflowSideTable,
        epoch_s: int,
        caps: S.Capacities,
        domain_id: str = "",
        workflow_id: str = "",
        run_id: str = "",
    ) -> bool:
        """Snapshot one replay-result row if the write policy says so.
        Never raises — a failed write logs and returns False (the
        rebuild result is already correct; only future resumes lose)."""
        try:
            if side.resume is None:
                return False
            key = _branch_key(branch_token)
            state_row = S.state_row(state, row)
            ex = state_row["exec_info"]
            event_id = int(ex[S.X_NEXT_EVENT_ID]) - 1
            if event_id < 1:
                return False
            newest = self.store.newest_event_id(key)
            closed = int(ex[S.X_CLOSE_STATUS]) != 0
            due = (
                newest == 0
                or event_id - newest >= self.policy.every_events
                or (self.policy.on_close and closed and event_id > newest)
            )
            if not due:
                return False
            n = int(state_row["vh_len"])
            vh_items = [
                (int(e), int(v))
                for e, v in state_row["vh_items"][:n]
            ]
            ckpt = ReplayCheckpoint(
                branch_key=key,
                tree_id=_tree_id(key),
                event_id=event_id,
                fingerprint=self.fingerprint,
                epoch_s=epoch_s,
                caps=caps,
                vh_items=vh_items,
                state_row=state_row,
                resume=side.resume,
                side=side,
                domain_id=domain_id,
                workflow_id=workflow_id,
                run_id=run_id,
                created_at=self._clock(),
            )
            self.store.put_checkpoint(ckpt)
            self.store.prune_tree(ckpt.tree_id, self.policy.keep_last)
            return True
        except Exception as e:
            self._log.warning(f"checkpoint write failed ({e}); skipped")
            return False

    # -- conversions ---------------------------------------------------

    def resume_state(self, ckpt: ReplayCheckpoint) -> ResumeState:
        return ckpt.resume_state()

    def rehydrate(self, ckpt: ReplayCheckpoint, domain_id: str = ""):
        """Full MutableState straight from the snapshot (the zero-suffix
        fast path: a checkpoint at the branch tip needs no replay)."""
        return state_row_to_mutable_state(
            ckpt.state_tensors(), 0, ckpt.side,
            domain_id=domain_id or ckpt.domain_id,
            epoch_s=ckpt.epoch_s,
        )


def checkpoint_from_replay(
    branch_token,
    state: S.StateTensors,
    row: int,
    side: WorkflowSideTable,
    epoch_s: int,
    caps: S.Capacities,
    domain_id: str = "",
    workflow_id: str = "",
    run_id: str = "",
    fingerprint: Optional[str] = None,
) -> ReplayCheckpoint:
    """Build a checkpoint record from any replay result row — the
    policy-free constructor tests, tools, and prefix-seeded benches use
    (``maybe_record`` is the production write path)."""
    key = _branch_key(branch_token)
    state_row = S.state_row(state, row)
    ex = state_row["exec_info"]
    n = int(state_row["vh_len"])
    return ReplayCheckpoint(
        branch_key=key,
        tree_id=_tree_id(key),
        event_id=int(ex[S.X_NEXT_EVENT_ID]) - 1,
        fingerprint=fingerprint or transition_fingerprint(),
        epoch_s=epoch_s,
        caps=caps,
        vh_items=[(int(e), int(v)) for e, v in state_row["vh_items"][:n]],
        state_row=state_row,
        resume=side.resume,
        side=side,
        domain_id=domain_id,
        workflow_id=workflow_id,
        run_id=run_id,
        created_at=time.time(),
    )
