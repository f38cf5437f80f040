"""Replicator queue: hydrate persisted replication tasks into messages.

Reference: service/history/replicatorQueueProcessor.go — reads the
shard's replication task queue, loads the event batch each task covers
from its history branch (getHistoryTaskV2 → ReadHistoryBranchByBatch),
attaches the version-history items, and serves them to remote pollers
via GetReplicationMessages (pull model). Acking completes tasks up to
the remote's last-processed ID.

A copy of the reference package's ``runtime/replication/replicator_queue.py``.
Deviations: ``device`` (default ``"cuda"``) is the snapshot server's
rebuild device, and a fault of the device replay while serving a
snapshot raises instead of answering ``b""`` (only a packer refusal,
``PackError``, still answers "no snapshot"). A fault rule fires at the
reference's hook points (``replication.replicator_queue``) before any
ack or read.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ...core.events import HistoryEvent
from ...core.tasks import ReplicationTask

from ..persistence.errors import EntityNotExistsError
from ..persistence.records import BranchToken
from ..shard import ShardContext
from .messages import HistoryTaskV2, ReplicationMessages


class ReplicatorQueueProcessor:
    """Per-shard emit side of replication."""

    def __init__(
        self,
        shard: ShardContext,
        batch_size: int = 100,
        remote_clusters: Optional[List[str]] = None,
        metrics=None,
        faults=None,
        checkpoints=None,
        device="cuda",
    ) -> None:
        from ...utils.metrics import NOOP

        self.shard = shard
        self.batch_size = batch_size
        # chaos hook: fired per remote fetch BEFORE the ack/read, so an
        # injected fault leaves the cluster ack level untouched and the
        # remote's next poll simply retries (pull model is stateless)
        from ..queues.base import make_fault_hook

        self._fault_hook = make_fault_hook(
            faults, "replication.replicator_queue", shard_id=shard.shard_id
        )
        # the snapshot server's rebuild device
        self.device = device
        self._lock = threading.Lock()
        # last task id each remote cluster has confirmed processing —
        # pre-seeded with every configured remote so one cluster's ack
        # can't delete tasks another has yet to fetch
        self._cluster_ack: Dict[str, int] = {
            c: 0 for c in (remote_clusters or [])
        }
        self._metrics = (metrics or NOOP).tagged(
            service="history_replication", shard=str(shard.shard_id)
        )
        self._max_served = 0
        self._completed_through = 0  # highest min-ack already swept
        # snapshot-shipping serving plane: the engine-wired checkpoint
        # store when present (shipped rows persist and double as warm
        # rebuild seeds), else a lazily built transient store
        self._checkpoints = checkpoints
        self._snapshot_server = None

    # -- hydration ----------------------------------------------------

    def _read_batch(
        self, branch_token: bytes, first_event_id: int, next_event_id: int
    ) -> List[HistoryEvent]:
        if not branch_token:
            return []
        branch = BranchToken.from_json(branch_token.decode())
        batches, _ = self.shard.persistence.history.read_history_branch(
            branch, first_event_id, next_event_id
        )
        return [e for batch in batches for e in batch]

    def _version_history_items(
        self, task: ReplicationTask, events: List[HistoryEvent]
    ) -> List[Dict[str, int]]:
        """The version-history item list the passive side needs for LCA
        computation. Derived from the run's stored mutable state when
        available; falls back to the batch's own end item."""
        end_id = events[-1].event_id
        end_version = events[-1].version
        try:
            resp = self.shard.persistence.execution.get_workflow_execution(
                self.shard.shard_id, task.domain_id, task.workflow_id,
                task.run_id,
            )
            vh = (resp.snapshot or {}).get("version_histories")
            # VersionHistory.to_dict stores items as [event_id, version]
            # pairs (core/version_history.py to_dict).
            # Prefer the history whose branch_token matches the TASK's
            # branch — after a resolved conflict the workflow carries
            # several histories and picking by mere end-id coverage can
            # ship another branch's items, making the passive side see
            # "no common ancestor" and force a full resync
            want_branch = (
                task.branch_token.decode("latin-1")
                if isinstance(task.branch_token, bytes)
                else (task.branch_token or "")
            )
            histories = (vh or {}).get("histories", [])
            ranked = sorted(
                histories,
                key=lambda h: h.get("branch_token", "") != want_branch,
            ) if want_branch else histories
            for h in ranked:
                items = [
                    {"event_id": e, "version": v}
                    for e, v in h.get("items", [])
                ]
                if items and items[-1]["event_id"] >= end_id:
                    trimmed = [
                        dict(j) for j in items if j["event_id"] < end_id
                    ]
                    trimmed.append(
                        {"event_id": end_id, "version": end_version}
                    )
                    return trimmed
        except EntityNotExistsError:
            pass
        return [{"event_id": end_id, "version": end_version}]

    def hydrate(self, task: ReplicationTask) -> Optional[HistoryTaskV2]:
        events = self._read_batch(
            task.branch_token, task.first_event_id, task.next_event_id
        )
        if not events:
            return None
        new_run_events: List[HistoryEvent] = []
        new_run_id = ""
        if task.new_run_branch_token:
            # the continued run's FULL first transaction batch (Started +
            # DecisionTaskScheduled — active_transaction new-run close)
            branch = BranchToken.from_json(
                task.new_run_branch_token.decode()
            )
            # page_size=1 bounds the read to the first batch node — the
            # continued run may have grown arbitrarily since
            batches, _ = self.shard.persistence.history.read_history_branch(
                branch, 1, 1 << 60, page_size=1
            )
            new_run_events = list(batches[0]) if batches else []
            if new_run_events:
                new_run_id = new_run_events[0].attributes.get("run_id", "")
                if not new_run_id:
                    nb = BranchToken.from_json(
                        task.new_run_branch_token.decode()
                    )
                    new_run_id = nb.tree_id
        return HistoryTaskV2(
            task_id=task.task_id,
            domain_id=task.domain_id,
            workflow_id=task.workflow_id,
            run_id=task.run_id,
            version_history_items=self._version_history_items(task, events),
            events=events,
            new_run_events=new_run_events,
            new_run_id=new_run_id,
        )

    # -- pull API ------------------------------------------------------

    def get_replication_messages(
        self, cluster: str, last_retrieved_id: int,
        max_tasks: Optional[int] = None,
    ) -> ReplicationMessages:
        """Serve tasks after ``last_retrieved_id``; completing everything
        the remote has already confirmed (replicatorQueueProcessor.go
        getTasks: ack then read). ``max_tasks`` lets a bandwidth-aware
        consumer shrink the page below the static ``batch_size`` — a
        throttled link pulls pages its budget can afford instead of
        timing out on one giant hydrated transfer."""
        if self._fault_hook is not None:
            self._fault_hook("get_replication_messages", self.shard.shard_id)
        self.ack(cluster, last_retrieved_id)
        page = self.batch_size
        if max_tasks is not None:
            page = max(1, min(page, int(max_tasks)))
        tasks = self.shard.persistence.execution.get_replication_tasks(
            self.shard.shard_id, last_retrieved_id, page + 1
        )
        has_more = len(tasks) > page
        tasks = tasks[:page]
        out: List[HistoryTaskV2] = []
        last_id = last_retrieved_id
        for t in tasks:
            msg = self.hydrate(t)
            if msg is not None:
                out.append(msg)
            last_id = max(last_id, t.task_id)
        with self._lock:
            self._max_served = max(self._max_served, last_id)
            # how far this consumer trails the newest task this queue
            # has served (reference defs.go replication lag gauges)
            lag = self._max_served - self._cluster_ack.get(cluster, 0)
        self._metrics.tagged(cluster=cluster).gauge(
            "replication_ack_lag", max(0, lag)
        )
        return ReplicationMessages(
            tasks=out, last_retrieved_id=last_id, has_more=has_more,
            source_time_ns=self.shard.now(),
        )

    def get_replication_backlog(self, last_retrieved_id: int) -> dict:
        """Per-run backlog spans past the cursor WITHOUT event payloads
        — the adaptive consumer's cheap "how far behind am I" probe
        (transport.py). A few hundred bytes describe a backlog whose
        hydrated events could be megabytes, which is the whole point on
        a constrained link."""
        if self._fault_hook is not None:
            self._fault_hook("get_replication_backlog", self.shard.shard_id)
        runs: Dict[tuple, dict] = {}
        read_from = last_retrieved_id
        max_id = last_retrieved_id
        while True:
            tasks = self.shard.persistence.execution.get_replication_tasks(
                self.shard.shard_id, read_from, self.batch_size
            )
            if not tasks:
                break
            for t in tasks:
                max_id = max(max_id, t.task_id)
                key = (t.domain_id, t.workflow_id, t.run_id)
                rec = runs.get(key)
                if rec is None:
                    runs[key] = rec = {
                        "domain_id": t.domain_id,
                        "workflow_id": t.workflow_id,
                        "run_id": t.run_id,
                        "first_event_id": t.first_event_id,
                        "next_event_id": t.next_event_id,
                        "tasks": 0,
                    }
                rec["first_event_id"] = min(
                    rec["first_event_id"], t.first_event_id
                )
                rec["next_event_id"] = max(
                    rec["next_event_id"], t.next_event_id
                )
                rec["tasks"] += 1
            read_from = tasks[-1].task_id
        return {
            "runs": list(runs.values()),
            "max_task_id": max_id,
            "source_time_ns": self.shard.now(),
        }

    # -- snapshot shipping (bandwidth-adaptive state transfer) ---------

    def _snapshot_serving(self):
        """(StateRebuilder, CheckpointManager) used to SERVE snapshot
        requests. ``every_events=1`` so a serve-time rebuild always
        leaves a branch-tip snapshot in the store (the wired policy's
        cadence is a write-amplification knob for the rebuild path, not
        a serving constraint)."""
        if self._snapshot_server is None:
            from ...checkpoint import (
                CheckpointManager,
                CheckpointPolicy,
                MemoryCheckpointStore,
            )

            from .rebuilder import StateRebuilder

            store = (
                self._checkpoints.store
                if self._checkpoints is not None
                else MemoryCheckpointStore()
            )
            mgr = CheckpointManager(
                store, CheckpointPolicy(every_events=1, keep_last=2)
            )
            self._snapshot_server = (
                StateRebuilder(
                    self.shard.persistence.history,
                    checkpoints=mgr,
                    device=self.device,
                ),
                mgr,
            )
        return self._snapshot_server

    def get_replication_checkpoint(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> bytes:
        """The run's branch-tip ``ReplayCheckpoint``, delta-compressed
        for the wire (transport.encode_checkpoint_wire), or ``b""``
        when no shippable snapshot exists (unknown run, capacity
        overflow) — the consumer then falls back to event shipping. A
        fault of the device replay raises: it is not "no snapshot"."""
        from ...ops.pack import PackError
        from ..persistence.records import current_version_history
        from .rebuilder import RebuildRequest
        from .transport import encode_checkpoint_wire

        if self._fault_hook is not None:
            self._fault_hook(
                "get_replication_checkpoint", self.shard.shard_id
            )
        try:
            resp = self.shard.persistence.execution.get_workflow_execution(
                self.shard.shard_id, domain_id, workflow_id, run_id
            )
        except EntityNotExistsError:
            return b""
        token, items = current_version_history(resp.snapshot)
        if not token or not items:
            return b""
        tip = items[-1][0]
        rb, mgr = self._snapshot_serving()
        ckpt, _ = mgr.lookup(token, version_history_items=items)
        if ckpt is None or ckpt.event_id < tip:
            # no tip snapshot on file: rebuild once (suffix-only when an
            # older snapshot exists) and pick up the row it wrote
            try:
                rb.rebuild_many([RebuildRequest(
                    domain_id=domain_id, workflow_id=workflow_id,
                    run_id=run_id, branch_token=token.encode(),
                    version_history_items=items,
                )])
            except PackError:
                return b""
            ckpt, _ = mgr.lookup(token, version_history_items=items)
            if ckpt is None or ckpt.event_id < tip:
                return b""
        try:
            return encode_checkpoint_wire(ckpt)
        except Exception:
            return b""

    def ack(self, cluster: str, level: int) -> None:
        """Complete tasks every remote cluster has retrieved."""
        with self._lock:
            prev = self._cluster_ack.get(cluster, 0)
            if level <= prev and prev != 0:
                return
            self._cluster_ack[cluster] = level
            min_ack = min(self._cluster_ack.values())
            # skip the store scan when the MIN cursor hasn't moved —
            # every fetch calls ack(), and an unconditional scan from 0
            # is a wasted queue read per poll per cluster per shard
            if min_ack <= self._completed_through:
                return
            self._completed_through = min_ack
        if min_ack <= 0:
            return
        # scan the whole completed prefix, not just one batch
        read_from = 0
        while True:
            done = self.shard.persistence.execution.get_replication_tasks(
                self.shard.shard_id, read_from, self.batch_size
            )
            if not done:
                return
            for t in done:
                if t.task_id <= min_ack:
                    self.shard.persistence.execution.complete_replication_task(
                        self.shard.shard_id, t.task_id
                    )
            read_from = done[-1].task_id
            if read_from > min_ack:
                return
