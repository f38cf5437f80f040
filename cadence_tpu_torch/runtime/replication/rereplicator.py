"""History re-replication: fill event gaps from the remote cluster.

Reference: common/xdc/historyRereplicator.go:113-420 — when the passive
side raises a retry error (missing earlier events), read the missing
range [start_event_id+1, end_event_id) from the remote cluster's raw
history API and apply it batch-by-batch through the same replicator,
then let the caller retry the original task.

Bandwidth-adaptive twist (transport.py): with an ``AdaptiveTransport``
attached, every gap first consults the mode controller. A deep gap on a
constrained link recovers by **snapshot shipping** — fetch the source's
delta-compressed ``ReplayCheckpoint``, install it through the suffix-only
resume path (``NDCHistoryReplicator.apply_state_snapshot``), and owe a
history backfill for the covered range — instead of re-shipping and
re-replaying the whole event backlog. Any snapshot-path failure (torn
transfer, stale fingerprint, divergent local branch) falls back to the
event path below, which remains the correctness baseline.

A copy of the reference package's ``runtime/replication/rereplicator.py``.
Deviation: the snapshot path falls back to event shipping only on what a
torn or refused transfer raises (a link or store error, a malformed
blob), caught around the fetch and decode alone, and on a store error of
the install; a fault of the device replay, on either side, raises.
"""

from __future__ import annotations

import time
from typing import List, Optional

from ...core.events import HistoryEvent
from ...utils import tracing
from ...utils.log import get_logger
from ...utils.metrics import NOOP

from ..persistence.errors import PersistenceError
from .messages import HistoryTaskV2, RetryTaskV2Error
from .transport import MODE_SNAPSHOT, CheckpointWireError

logger = get_logger("cadence_tpu_torch.replication")

# what a torn, partitioned or refused snapshot transfer raises: the event
# path heals the gap instead (OSError covers ConnectionError and
# TimeoutError)
_SNAPSHOT_TRANSFER_ERRORS = (OSError, CheckpointWireError, PersistenceError)


class _SnapshotTorn(Exception):
    """A snapshot recovery that a torn transfer or a store error cut
    short: the event path heals the gap instead."""


class HistoryRereplicator:
    def __init__(self, remote_client, replicator, transport=None,
                 metrics=None) -> None:
        """``remote_client`` must expose get_workflow_history_raw(...)
        → (batches, version_history_items); ``replicator`` is the local
        NDCHistoryReplicator. ``transport`` (AdaptiveTransport) enables
        the snapshot recovery mode; None keeps pure event shipping."""
        self.remote = remote_client
        self.replicator = replicator
        self.transport = transport
        self._metrics = (metrics or NOOP).tagged(layer="replication")
        # the consumer's deferred-backfill hook: when set, a snapshot
        # recovery enqueues its history backfill there (state catches
        # up now, bytes follow); unset, the backfill runs inline so a
        # standalone rereplicator still converges byte-identical
        self.backfill_sink = None

    def rereplicate(self, err: RetryTaskV2Error) -> int:
        """Fetch + apply the missing range; returns batches applied
        (0 when a snapshot recovery covered the gap instead)."""
        gap = max(0, (err.end_event_id or 0) - (err.start_event_id or 0))
        if (
            self.transport is not None
            and self.transport.controller.decide(gap) == MODE_SNAPSHOT
        ):
            recovered = None
            try:
                recovered = self._snapshot_recover(err)
            except _SnapshotTorn:
                # torn snapshot transfer / partitioned link mid-blob:
                # the event path below re-fetches through the same
                # (possibly still degraded) link and stays correct
                self._metrics.inc("replication_snapshot_fallbacks")
                tracing.annotate(
                    f"snapshot_fallback wf={err.workflow_id} (torn)"
                )
                logger.exception(
                    "snapshot recovery failed; falling back to event "
                    "shipping",
                    workflow=err.workflow_id, run=err.run_id,
                )
            else:
                if recovered is None:
                    self._metrics.inc("replication_snapshot_fallbacks")
                    tracing.annotate(
                        f"snapshot_fallback wf={err.workflow_id}"
                    )
            if recovered is not None:
                # the chain-successor heal runs OUTSIDE the fallback
                # guard above: a failure here must propagate so the
                # caller holds its cursor and retries — falling back to
                # the event path for the PREDECESSOR run would read as
                # healed while the successor's first batch stays lost
                if recovered.get("continued_as_new"):
                    self._heal_chain_successor(
                        err.domain_id, err.workflow_id, err.run_id,
                        tip_event_id=recovered["covered_through"],
                    )
                return 0
        start = err.start_event_id + 1 if err.start_event_id else 1
        end = err.end_event_id or (1 << 60)
        if self.transport is not None:
            batches, items = self.transport.fetch_raw_history(
                err.domain_id, err.workflow_id, err.run_id, start, end
            )
        else:
            batches, items = self.remote.get_workflow_history_raw(
                err.domain_id, err.workflow_id, err.run_id, start, end
            )
        applied = apply_raw_history(
            self.replicator, err.domain_id, err.workflow_id, err.run_id,
            batches, items,
        )
        # the raw event heal has the same chain blind spot as snapshot
        # shipping: synthetic tasks carry no new_run_events, so a
        # healed run that closed ContinuedAsNew leaves its successor's
        # first batch unapplied — walk the chain explicitly
        succ = _chain_successor_of(batches)
        if succ:
            self._heal_chain_successor(
                err.domain_id, err.workflow_id, err.run_id,
                successor_run_id=succ,
            )
        return applied

    # -- snapshot recovery --------------------------------------------

    def _snapshot_recover(self, err: RetryTaskV2Error):
        """Returns apply_state_snapshot's result record on success, or
        None when the gap must heal through the event path. Raises
        ``_SnapshotTorn`` where the fetch and decode, the backfill's
        transfer or the install's store fail; a fault of the device
        replay, on the serving or the installing side, raises as is."""
        try:
            got = self.transport.fetch_snapshot(
                err.domain_id, err.workflow_id, err.run_id
            )
        except _SNAPSHOT_TRANSFER_ERRORS as e:
            raise _SnapshotTorn(str(e)) from e
        if got is None:
            return None
        ckpt, nbytes = got
        t0 = time.monotonic()
        try:
            res = self.replicator.apply_state_snapshot(
                err.domain_id, err.workflow_id, err.run_id, ckpt
            )
        except PersistenceError as e:
            raise _SnapshotTorn(str(e)) from e
        if res is None:
            return None
        self.transport.estimator.observe_snapshot(
            nbytes, time.monotonic() - t0
        )
        self._metrics.inc("replication_snapshots_shipped")
        sink = self.backfill_sink or self.backfill
        try:
            sink(
                err.domain_id, err.workflow_id, err.run_id,
                res["backfill_from"], res["covered_through"],
            )
        except _SNAPSHOT_TRANSFER_ERRORS as e:
            raise _SnapshotTorn(str(e)) from e
        return res

    # -- continue-as-new chain walk -----------------------------------

    _CHAIN_HEAL_MAX = 16

    def _fetch_raw(self, domain_id: str, workflow_id: str, run_id: str,
                   start: int, end: int):
        if self.transport is not None:
            return self.transport.fetch_raw_history(
                domain_id, workflow_id, run_id, start, end
            )
        return self.remote.get_workflow_history_raw(
            domain_id, workflow_id, run_id, start, end
        )

    def _fetch_tip_event(self, domain_id: str, workflow_id: str,
                         run_id: str, tip: int):
        """The run's final event via node-aligned raw reads: history
        nodes key on their batch's FIRST event id, so a [tip, tip+1)
        read misses a tail that sits inside a wider batch — widen the
        window geometrically until the tip lands (bounded by the full
        history)."""
        lo = tip
        while True:
            batches, _ = self._fetch_raw(
                domain_id, workflow_id, run_id, lo, tip + 1
            )
            for b in batches:
                for e in b:
                    if e.event_id == tip:
                        return e
            if lo <= 1:
                return None
            lo = max(1, lo - 16 * max(1, tip + 1 - lo))

    def _heal_chain_successor(
        self, domain_id: str, workflow_id: str, run_id: str,
        tip_event_id: int = 0, successor_run_id: str = "",
    ) -> int:
        """Walk a continue-as-new chain forward from a healed run and
        materialize every successor the fast-forward bypassed.

        A chain run's FIRST batch rides its predecessor's replication
        task as ``new_run_events`` — a catch-up that heals the
        predecessor by snapshot (or raw-history fetch) and fast-forwards
        the cursor past those tasks loses the successor entirely: it has
        no replication tasks of its own until a second batch exists, so
        no later cycle will ever surface it. When the successor id is
        unknown (snapshot path: the covered events are backfill debt,
        not yet local) the predecessor's tip event is fetched remotely
        — one event — to read ``new_execution_run_id``. Each successor
        heals snapshot-first when the transport prefers it, else by raw
        history from event 1; the walk continues while the healed run
        itself continued-as-new (bounded, loudly, at 16 hops). Failures
        raise: the caller must hold its cursor and retry rather than
        mark the span healed with a chain run missing."""
        healed = 0
        cur_run, cur_tip, next_run = run_id, tip_event_id, successor_run_id
        seen = {run_id}
        for _ in range(self._CHAIN_HEAL_MAX):
            if not next_run:
                # read the predecessor's final event for the successor id
                tail = self._fetch_tip_event(
                    domain_id, workflow_id, cur_run, cur_tip
                )
                if tail is None:
                    break
                next_run = tail.attributes.get(
                    "new_execution_run_id", ""
                )
            if not next_run or next_run in seen:
                break
            seen.add(next_run)
            res = None
            if self.transport is not None:
                # unknown gap for a run we may not have at all: let the
                # controller's current mode decide, exactly like the
                # predecessor's heal did
                try:
                    res = self._snapshot_recover(RetryTaskV2Error(
                        "chain successor heal",
                        domain_id=domain_id, workflow_id=workflow_id,
                        run_id=next_run, start_event_id=0, end_event_id=0,
                    )) if self.transport.controller.mode == MODE_SNAPSHOT \
                        else None
                except _SnapshotTorn:
                    res = None  # raw-history heal below stays correct
            if res is not None:
                healed += 1
                self._metrics.inc("replication_chain_heals")
                cur_run, cur_tip = next_run, res["covered_through"]
                next_run = ""
                if res.get("continued_as_new"):
                    continue
                break
            batches, items = self._fetch_raw(
                domain_id, workflow_id, next_run, 1, 1 << 60
            )
            applied = apply_raw_history(
                self.replicator, domain_id, workflow_id, next_run,
                batches, items,
            )
            if applied == 0 and not any(batches):
                break  # source knows no such run: chain ends here
            healed += 1
            self._metrics.inc("replication_chain_heals")
            succ = _chain_successor_of(batches)
            if not succ:
                break
            cur_run, next_run = next_run, succ
        else:
            # raising (not warning) keeps the caller's cursor held, so
            # a chain deeper than the hop bound converges through the
            # regular event stream instead — the held cursor re-fetches
            # the original tasks, whose new_run_events create each
            # successor page by page. Silent truncation here would lose
            # every run past the bound forever (they have no
            # replication tasks of their own to ever surface again).
            raise RuntimeError(
                f"continue-as-new chain for {workflow_id!r} exceeds "
                f"{self._CHAIN_HEAL_MAX} hops; holding the cursor so "
                "the event stream heals the remainder"
            )
        return healed

    def backfill(self, domain_id: str, workflow_id: str, run_id: str,
                 from_event_id: int, through_event_id: int) -> int:
        """Fetch + append the raw history range a snapshot covered —
        the byte-identity half of snapshot shipping. Returns events
        appended."""
        if from_event_id > through_event_id:
            return 0
        if self.transport is not None:
            batches, _ = self.transport.fetch_raw_history(
                domain_id, workflow_id, run_id,
                from_event_id, through_event_id + 1,
            )
        else:
            batches, _ = self.remote.get_workflow_history_raw(
                domain_id, workflow_id, run_id,
                from_event_id, through_event_id + 1,
            )
        applied = self.replicator.backfill_history(
            domain_id, workflow_id, run_id, batches
        )
        if applied:
            self._metrics.inc("replication_backfill_events", applied)
        return applied


def _chain_successor_of(batches) -> str:
    """The continue-as-new successor run id a healed history names in
    its final event, or "" when the run didn't continue."""
    from ...core.enums import EventType

    tail = None
    for b in batches:
        if b:
            tail = b[-1]
    if tail is None:
        return ""
    if tail.event_type != EventType.WorkflowExecutionContinuedAsNew:
        return ""
    return tail.attributes.get("new_execution_run_id", "")


def apply_raw_history(
    replicator, domain_id: str, workflow_id: str, run_id: str,
    batches, items: Optional[List[dict]],
) -> int:
    """Apply raw remote batches through the NDC replicator, one
    synthetic HistoryTaskV2 per batch — the event-shipping heal shared
    by the rereplicator and the adaptive catch-up cycle."""
    applied = 0
    for batch in batches:
        if not batch:
            continue
        task = HistoryTaskV2(
            task_id=0,
            domain_id=domain_id,
            workflow_id=workflow_id,
            run_id=run_id,
            version_history_items=_items_up_to(items or [], batch),
            events=list(batch),
        )
        replicator.apply_events(task)
        applied += 1
    return applied


def _items_up_to(
    items: List[dict], batch: List[HistoryEvent]
) -> List[dict]:
    """Trim the remote's version-history items to this batch's end —
    each re-replicated batch must present the history as it was at that
    point, or LCA math would see "future" items."""
    end_id = batch[-1].event_id
    end_version = batch[-1].version
    out: List[dict] = []
    for it in items:
        if it["event_id"] < end_id:
            out.append(dict(it))
        else:
            break
    out.append({"event_id": end_id, "version": end_version})
    # drop any stale prefix item with the same version as the boundary
    dedup: List[dict] = []
    for it in out:
        if dedup and dedup[-1]["version"] == it["version"]:
            dedup[-1] = it
        else:
            dedup.append(it)
    return dedup
