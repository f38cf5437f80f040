"""NDC multi-master history replication: apply remote event batches.

Reference: service/history/nDCHistoryReplicator.go:158 (ApplyEvents) and
its satellites — nDCBranchMgr.go (LCA branch selection / fork),
nDCConflictResolver.go:65 (rebuild-at-branch-point via state rebuilder),
nDCTransactionMgr*.go (create/update as current vs zombie),
nDCEventsReapplier.go (reapply signals from stale branches).

The control flow is host-side Python; the replay inside creation,
continuation, and rebuild all goes through the shared StateBuilder whose
semantics are differential-tested against the device kernel — so a
replication storm can be drained through ``StateRebuilder.rebuild_many``
(one device scan for the whole backlog) without changing this module's
contract.

A copy of the reference package's ``runtime/replication/ndc.py``.
Deviations: ``device`` (default ``"cuda"``) is handed to every
``StateRebuilder`` this replicator builds (the conflict rebuilder and the
snapshot installer's), so a batched drain's conflict rebuilds replay on
the card through the FSM kernel; a fault of that replay raises out of
``apply_events_batch`` and ``apply_state_snapshot`` instead of degrading
to the host route (a packer refusal, ``PackError``, still makes
``apply_state_snapshot`` answer None). A fault rule fires at the
reference's two hook points (``replication.ndc``: ``apply_events`` and
``apply_state_snapshot``), before any state moves. The batched drain
pins each deferred workflow's context until its rebuild completes (see
``apply_events``): in the reference a cycle with more conflicts than the
history cache holds finishes the evicted ones on the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ...core.events import HistoryEvent
from ...core.enums import EventType, WorkflowState
from ...core.mutable_state import MutableState
from ...core.state_builder import StateBuilder
from ...core.version_history import (
    VersionHistories,
    VersionHistory,
    VersionHistoryError,
    VersionHistoryItem,
)

from ..persistence.errors import EntityNotExistsError
from ..persistence.records import (
    BranchToken,
    CreateWorkflowMode,
    WorkflowSnapshot,
)
from ...ops.pack import PackError
from ..shard import ShardContext
from .messages import HistoryTaskV2, RetryTaskV2Error
from .rebuilder import RebuildRequest, StateRebuilder


def _incoming_history(task: HistoryTaskV2) -> VersionHistory:
    return VersionHistory(
        items=[
            VersionHistoryItem(it["event_id"], it["version"])
            for it in task.version_history_items
        ]
    )


class NDCHistoryReplicator:
    """Applies HistoryTaskV2 batches to the local shard."""

    def __init__(
        self,
        shard: ShardContext,
        domains,
        cache,
        rebuilder: Optional[StateRebuilder] = None,
        is_active_locally=None,
        task_notifier=lambda: None,
        timer_notifier=lambda: None,
        rebuild_chunk_size=0,
        faults=None,
        checkpoints=None,
        metrics=None,
        serving=None,
        device="cuda",
    ) -> None:
        self.shard = shard
        self.domains = domains
        self.cache = cache
        # chaos hook: fired per applied task BEFORE any mutation, so an
        # injected fault exercises the fetcher's re-fetch/re-apply path
        # (at-least-once), never a half-applied batch
        from ..queues.base import make_fault_hook

        self._fault_hook = make_fault_hook(
            faults, "replication.ndc", shard_id=shard.shard_id
        )
        # where every rebuilder this replicator builds replays
        self.device = device
        self.rebuilder = rebuilder or StateRebuilder(
            shard.persistence.history,
            domain_resolver=self._resolve_domain,
            chunk_size=rebuild_chunk_size,
            checkpoints=checkpoints,
            metrics=metrics,
            serving=serving,
            device=device,
        )
        # whether this cluster is currently active for a domain (drives
        # signal reapplication; standby clusters never mint events)
        self._is_active_locally = is_active_locally or (lambda domain_id: False)
        self._task_notifier = task_notifier
        self._timer_notifier = timer_notifier
        # raw metrics handle for the snapshot-shipping install plane (the
        # transient rebuilder it builds must emit events_replayed_saved
        # into the same registry as the engine-wired one)
        self._raw_metrics = metrics
        from ...utils.metrics import NOOP

        # conflict-resolution observability: the failover drill reports
        # (replication/failover.py) read these counters as "how many
        # divergent-branch storms did the heal actually resolve"
        self._metrics = (metrics or NOOP).tagged(layer="replication")
        self._transient_snapshots = None

    def _resolve_domain(self, name: str) -> str:
        if not name:
            return ""
        try:
            return self.domains.resolve(name).info.id
        except Exception:
            return name

    # -- entry point ---------------------------------------------------

    def apply_events(
        self, task: HistoryTaskV2, _defer_rebuild: bool = False,
    ) -> Optional[dict]:
        """Apply one replication task.

        With ``_defer_rebuild`` (the batched drain), a task whose apply
        requires a conflict rebuild is NOT rebuilt inline; a plan record
        is returned instead so the caller can rebuild many workflows in
        one device scan (``apply_events_batch``)."""
        if not task.events:
            raise ValueError("replication task has no events")
        if self._fault_hook is not None:
            self._fault_hook("apply_events", self.shard.shard_id)
        # replication apply runs on the pull-pump thread; the same
        # workflow-keyed binding the queue pumps use joins this apply to
        # the workflow's sampled trace, if one exists (utils/tracing.py)
        from ...runtime.queues.base import task_span
        from ...runtime.queues.effects import task_effect_scope

        with task_span("replication-apply", task), \
                task_effect_scope("replication", "HistoryReplication"):
            ctx = self.cache.get_or_create(
                task.domain_id, task.workflow_id, task.run_id
            )
            with ctx.lock:
                try:
                    ms = ctx.load()
                except EntityNotExistsError:
                    self._apply_for_new_workflow(ctx, task)
                    return None
                rec = self._apply_for_existing(
                    ctx, ms, task, _defer_rebuild=_defer_rebuild
                )
                if rec is not None:
                    # pin the context until the deferred rebuild
                    # completes: the plan-time fork lives only in its
                    # cached mutable state, and a context the cache's
                    # LRU drops (more conflicts in one cycle than the
                    # cache holds) would otherwise be collected and
                    # reloaded without it, sending the completion down
                    # the inline host rebuild
                    rec["ctx"] = ctx
                return rec

    def apply_events_batch(self, tasks) -> None:
        """Batched drain: apply a fetched cycle's tasks, routing every
        conflict rebuild through ONE ``rebuild_many`` device scan.

        Matches the reference's per-task semantics
        (replicationTaskProcessor.go:85-434 feeding
        nDCConflictResolver.go:65) — a replication storm that forces N
        workflows to rebuild at a branch point replays all N histories
        as one batched scan instead of N sequential host replays. Once a
        workflow defers, ALL its later tasks in the cycle — any run of
        the same workflow_id, matching the reference's per-workflow
        sequential ordering (common/task/sequentialTaskProcessor.go) —
        queue behind the rebuild and apply, in order, after it
        completes."""
        deferred: dict = {}
        order: list = []
        barrier: dict = {}   # (domain, wf) -> deferred key
        for task in tasks:
            wf_key = (task.domain_id, task.workflow_id)
            if wf_key in barrier:
                deferred[barrier[wf_key]]["followups"].append(task)
                continue
            rec = self.apply_events(task, _defer_rebuild=True)
            if rec is not None:
                key = (task.domain_id, task.workflow_id, task.run_id)
                deferred[key] = rec
                order.append(key)
                barrier[wf_key] = key
        if not deferred:
            return
        from ...runtime.queues.effects import task_effect_scope

        # the batched conflict rebuilds happen outside apply_events;
        # they are still HistoryReplication work for the effect witness
        with task_effect_scope("replication", "HistoryReplication"):
            self._drain_deferred(deferred, order)

    def _drain_deferred(self, deferred: dict, order: list) -> None:
        reqs = [
            RebuildRequest(
                domain_id=deferred[k]["task"].domain_id,
                workflow_id=deferred[k]["task"].workflow_id,
                run_id=deferred[k]["task"].run_id,
                branch_token=deferred[k]["branch_token"],
                next_event_id=deferred[k]["next_event_id"],
                # the target branch's items: the checkpoint manager's
                # NDC divergence guard — a conflicting branch must not
                # resume past its fork point
                version_history_items=deferred[k]["vh_items"],
            )
            for k in order
        ]
        rebuilt = self.rebuilder.rebuild_many(reqs, use_device=True)
        for k, (ms, _, _) in zip(order, rebuilt):
            rec = deferred[k]
            self._finish_deferred_rebuild(rec, ms)
            for t in rec["followups"]:
                self.apply_events(t)

    def _finish_deferred_rebuild(self, rec: dict, rebuilt) -> None:
        task, bi = rec["task"], rec["branch_index"]
        # re-fetch the context: the plan-time handle may have been
        # evicted from the cache between planning and completion (e.g.
        # a SUPPRESS_CURRENT create zombifying this run) and would then
        # serve a stale cached mutable state
        ctx = self.cache.get_or_create(
            task.domain_id, task.workflow_id, task.run_id
        )
        with ctx.lock:
            ms = ctx.load()
            local = ms.version_histories
            # re-validate the plan under the lock (the replication pump
            # is the shard's single writer, but anything may have moved
            # between planning and completion); on any drift fall back
            # to the inline path
            plan_holds = (
                local is not None
                and bi < len(local.histories)
                and local.current_index != bi
                and local.get_version_history(bi).branch_token
                == rec["branch_token"]
                and local.get_version_history(bi).last_item().event_id + 1
                == rec["next_event_id"]
                and task.version
                > local.get_current_version_history().last_item().version
            )
            if not plan_holds:
                # the fallback may re-fork at the same LCA, leaving the
                # plan-time fork as an orphan branch (the same window
                # exists on any inline retry after _fork_branch); the
                # history scavenger owns orphan-branch cleanup
                self._apply_for_existing(ctx, ms, task)
                return
            target_vh = local.get_version_history(bi)
            rebuilt.version_histories = local
            local.current_index = bi
            rebuilt.execution_info.run_id = task.run_id
            rebuilt.execution_info.workflow_id = task.workflow_id
            self._apply_to_current(ctx, rebuilt, task, target_vh)
            self._metrics.inc("replication_conflicts_resolved")

    # -- creation path (nDCTransactionMgrForNewWorkflow) ---------------

    def _apply_for_new_workflow(self, ctx, task: HistoryTaskV2) -> None:
        if task.first_event_id != 1:
            raise RetryTaskV2Error(
                "workflow missing locally; need history from the start",
                domain_id=task.domain_id,
                workflow_id=task.workflow_id,
                run_id=task.run_id,
                start_event_id=0,
                end_event_id=task.first_event_id,
                end_event_version=task.version,
            )
        history = self.shard.persistence.history
        branch = history.new_history_branch(tree_id=task.run_id)
        history.append_history_nodes(
            branch, task.events, transaction_id=self.shard.next_task_id()
        )

        ms = MutableState(domain_id=task.domain_id)
        ms.version_histories = VersionHistories.new_empty()
        sb = StateBuilder(ms, domain_resolver=self._resolve_domain)
        sb.apply_events(
            task.domain_id, "replication", task.workflow_id, task.run_id,
            list(task.events),
            list(task.new_run_events) or None,
        )
        ms.execution_info.branch_token = branch.to_json().encode()
        ms.version_histories.get_current_version_history().branch_token = (
            ms.execution_info.branch_token
        )

        mode, prev_run_id = self._create_mode(
            task.domain_id, task.workflow_id, task.version
        )
        snapshot = self._snapshot(
            ms, sb.transfer_tasks, sb.timer_tasks, zombie=(
                mode == CreateWorkflowMode.ZOMBIE
            ),
        )
        self.shard.persistence.execution.create_workflow_execution(
            self.shard.shard_id, self.shard.range_id, mode, snapshot,
            prev_run_id=prev_run_id,
        )
        if mode == CreateWorkflowMode.SUPPRESS_CURRENT:
            # the store zombified the stale run's persisted record; evict
            # its cached context so a late replication task for that run
            # reloads the zombie state instead of resurrecting the cached
            # Running mutable state on its next write
            self.cache.evict(task.domain_id, task.workflow_id, prev_run_id)
        ctx._ms = ms
        ctx._condition = ms.next_event_id
        self._notify(sb)

    def _create_mode(
        self, domain_id: str, workflow_id: str, version: int
    ) -> Tuple[int, str]:
        """current-vs-zombie decision for a replication-created run
        (shared by the event path and snapshot shipping — both create
        runs the local cluster has never seen)."""
        try:
            cur = self.shard.persistence.execution.get_current_execution(
                self.shard.shard_id, domain_id, workflow_id
            )
        except EntityNotExistsError:
            return CreateWorkflowMode.BRAND_NEW, ""
        if version >= cur.last_write_version and cur.state == int(
            WorkflowState.Completed
        ):
            return CreateWorkflowMode.WORKFLOW_ID_REUSE, cur.run_id
        if version > cur.last_write_version:
            # incoming run was written by a NEWER failover version than
            # the still-running current run: after a failover the new
            # active cluster's run must take primacy — suppress the
            # stale run and create the incoming one as current (ref
            # nDCTransactionMgrForNewWorkflow.go
            # SuppressCurrentAndCreateAsCurrent); a plain ZOMBIE create
            # would leave workflow_id lookups resolving to the stale
            # run forever
            return CreateWorkflowMode.SUPPRESS_CURRENT, cur.run_id
        # a running current run with a version >= ours keeps primacy
        return CreateWorkflowMode.ZOMBIE, ""

    # -- existing-workflow path ----------------------------------------

    def _apply_for_existing(
        self, ctx, ms: MutableState, task: HistoryTaskV2,
        _defer_rebuild: bool = False,
    ) -> Optional[dict]:
        local = ms.version_histories
        if local is None:
            raise ValueError(
                "replication target has no version histories (local domain?)"
            )
        incoming = _incoming_history(task)
        try:
            branch_index, lca_item = local.find_lca_index_and_item(incoming)
        except VersionHistoryError:
            raise RetryTaskV2Error(
                "no common ancestor; resync from start",
                domain_id=task.domain_id,
                workflow_id=task.workflow_id,
                run_id=task.run_id,
                start_event_id=0,
                end_event_id=task.first_event_id,
                end_event_version=task.version,
            )

        branch_vh = local.get_version_history(branch_index)
        last_local = branch_vh.last_item()

        if branch_vh.is_lca_appendable(lca_item):
            # incoming continues this branch
            if task.next_event_id <= last_local.event_id + 1 and (
                branch_vh.contains_item(
                    VersionHistoryItem(task.next_event_id - 1, task.version)
                )
            ):
                return None  # duplicate batch — already applied
            if task.first_event_id > last_local.event_id + 1:
                raise RetryTaskV2Error(
                    "missing intermediate events",
                    domain_id=task.domain_id,
                    workflow_id=task.workflow_id,
                    run_id=task.run_id,
                    start_event_id=last_local.event_id,
                    start_event_version=last_local.version,
                    end_event_id=task.first_event_id,
                    end_event_version=task.version,
                )
        else:
            # divergence: fork a new branch at the LCA
            branch_index = self._fork_branch(
                local, branch_index, lca_item, task
            )
            branch_vh = local.get_version_history(branch_index)
            if task.first_event_id > lca_item.event_id + 1:
                raise RetryTaskV2Error(
                    "fork point behind incoming batch",
                    domain_id=task.domain_id,
                    workflow_id=task.workflow_id,
                    run_id=task.run_id,
                    start_event_id=lca_item.event_id,
                    start_event_version=lca_item.version,
                    end_event_id=task.first_event_id,
                    end_event_version=task.version,
                )

        # conflict resolution: which branch becomes/stays current
        if branch_index == local.current_index:
            self._apply_to_current(ctx, ms, task, branch_vh)
            return None

        current_vh = local.get_current_version_history()
        if task.version > current_vh.last_item().version:
            # incoming wins: rebuild state from the target branch tip,
            # then continue applying on it as the new current
            target_vh = local.get_version_history(branch_index)
            if _defer_rebuild:
                return {
                    "task": task,
                    "branch_index": branch_index,
                    "branch_token": target_vh.branch_token,
                    "next_event_id": target_vh.last_item().event_id + 1,
                    "vh_items": [
                        (it.event_id, it.version)
                        for it in target_vh.items
                    ],
                    "followups": [],
                }
            self._rebuild_and_apply(ctx, ms, task, branch_index)
        else:
            self._backfill_branch(ctx, ms, task, branch_index)
        return None

    # -- branch manager ------------------------------------------------

    def _fork_branch(
        self,
        local: VersionHistories,
        base_index: int,
        lca_item: VersionHistoryItem,
        task: HistoryTaskV2,
    ) -> int:
        base_vh = local.get_version_history(base_index)
        base_branch = BranchToken.from_json(base_vh.branch_token.decode())
        forked = self.shard.persistence.history.fork_history_branch(
            base_branch, lca_item.event_id + 1
        )
        # items up to the LCA, with the BOUNDARY item appended when the
        # LCA falls mid-item (base [(2,v0),(10,v1)], LCA (5,v1): the
        # fork holds events 1-5, so its items must end at (5,v1) — not
        # (2,v0), which would make the rebuild replay only events 1-2
        # and silently lose 3-5. Reference
        # CopyVersionHistoryUntilLCAVersionHistoryItem.
        items = [
            it for it in base_vh.items
            if it.event_id <= lca_item.event_id
        ]
        if not items or items[-1].event_id < lca_item.event_id:
            items.append(
                VersionHistoryItem(lca_item.event_id, lca_item.version)
            )
        new_vh = VersionHistory(
            branch_token=forked.to_json().encode(), items=items
        )
        self._metrics.inc("replication_branches_forked")
        prior_current = local.current_index
        changed, new_index = local.add_version_history(new_vh)
        if changed:
            # add_version_history flips current when the fork's last
            # version is the max; the CONFLICT RESOLVER owns that
            # decision — without this restore, _apply_for_existing
            # would see branch_index == current_index and apply the
            # incoming batch onto the old branch's un-rebuilt state
            # (append-at-end keeps prior indices stable)
            local.current_index = prior_current
        return new_index

    # -- apply variants ------------------------------------------------

    def _apply_to_current(
        self, ctx, ms: MutableState, task: HistoryTaskV2,
        branch_vh: VersionHistory,
    ) -> None:
        branch = BranchToken.from_json(
            (branch_vh.branch_token or ms.execution_info.branch_token).decode()
        )
        self.shard.persistence.history.append_history_nodes(
            branch, task.events, transaction_id=self.shard.next_task_id()
        )
        sb = StateBuilder(ms, domain_resolver=self._resolve_domain)
        _, _, new_run_ms = sb.apply_events(
            task.domain_id, "replication", task.workflow_id, task.run_id,
            list(task.events),
            list(task.new_run_events) or None,
        )
        if branch_vh.branch_token:
            ms.execution_info.branch_token = branch_vh.branch_token

        new_snapshot = None
        if new_run_ms is not None and task.new_run_events:
            new_snapshot = self._stage_new_run(new_run_ms, task)

        snapshot = self._snapshot(ms, sb.transfer_tasks, sb.timer_tasks)
        self.shard.persistence.execution.update_workflow_execution(
            self.shard.shard_id, self.shard.range_id, ctx.condition,
            snapshot, new_snapshot=new_snapshot,
        )
        ctx._ms = ms
        ctx._condition = ms.next_event_id
        self._notify(sb)

    def _rebuild_and_apply(
        self, ctx, ms: MutableState, task: HistoryTaskV2, branch_index: int
    ) -> None:
        """Reference nDCConflictResolver: the incoming version beats the
        current branch → rebuild mutable state from the target branch,
        flip current, then apply the batch on top."""
        local = ms.version_histories
        target_vh = local.get_version_history(branch_index)
        req = RebuildRequest(
            domain_id=task.domain_id,
            workflow_id=task.workflow_id,
            run_id=task.run_id,
            branch_token=target_vh.branch_token,
            next_event_id=target_vh.last_item().event_id + 1,
            version_history_items=[
                (it.event_id, it.version) for it in target_vh.items
            ],
        )
        rebuilt, _, _ = self.rebuilder.rebuild(req)
        # carry over the full set of branches; flip current
        rebuilt.version_histories = local
        local.current_index = branch_index
        rebuilt.execution_info.run_id = task.run_id
        rebuilt.execution_info.workflow_id = task.workflow_id
        self._apply_to_current(ctx, rebuilt, task, target_vh)
        self._metrics.inc("replication_conflicts_resolved")

    def _backfill_branch(
        self, ctx, ms: MutableState, task: HistoryTaskV2, branch_index: int
    ) -> None:
        """Events belong to a stale branch: persist them + the version-
        history bookkeeping without touching workflow state."""
        local = ms.version_histories
        vh = local.get_version_history(branch_index)
        if all(
            vh.contains_item(VersionHistoryItem(e.event_id, e.version))
            for e in task.events
        ):
            # at-least-once re-fetch of an already-archived batch: the
            # bookkeeping would reject the replayed item ids, and a
            # second signal reapplication would mint divergent bytes —
            # the duplicate is dropped whole, like the current-branch
            # dedup above
            return
        branch = BranchToken.from_json(vh.branch_token.decode())
        self.shard.persistence.history.append_history_nodes(
            branch, task.events, transaction_id=self.shard.next_task_id()
        )
        for e in task.events:
            vh.add_or_update_item(e.event_id, e.version)
        snapshot = self._snapshot(ms, [], [])
        self.shard.persistence.execution.update_workflow_execution(
            self.shard.shard_id, self.shard.range_id, ctx.condition, snapshot,
        )
        ctx._ms = ms
        ctx._condition = ms.next_event_id
        # the losing side of a version conflict is resolved here: its
        # events are archived on the stale branch, the winner keeps
        # current — count it like the rebuild-win path does
        self._metrics.inc("replication_conflicts_resolved")
        # signals on the stale branch still matter to the live run
        if self._is_active_locally(task.domain_id):
            self._reapply_signals(ctx, ms, task.events)

    # -- snapshot shipping (bandwidth-adaptive state transfer) ---------

    def _snapshot_rebuilder(self):
        """(StateRebuilder, CheckpointManager) pair for installing
        snapshot-shipped checkpoints. The engine-wired checkpoint plane
        is reused when present (shipped rows land in the durable store
        and seed future rebuilds); otherwise a transient in-memory
        store, cached on this replicator, carries the install — the
        optimization works either way, only its persistence differs."""
        if self.rebuilder.checkpoints is not None:
            return self.rebuilder, self.rebuilder.checkpoints
        if self._transient_snapshots is None:
            from ...checkpoint import (
                CheckpointManager,
                CheckpointPolicy,
                MemoryCheckpointStore,
            )

            mgr = CheckpointManager(
                MemoryCheckpointStore(),
                CheckpointPolicy(every_events=1 << 30, keep_last=1),
            )
            self._transient_snapshots = (
                StateRebuilder(
                    self.shard.persistence.history,
                    domain_resolver=self._resolve_domain,
                    checkpoints=mgr,
                    metrics=self._raw_metrics,
                    device=self.device,
                ),
                mgr,
            )
        return self._transient_snapshots

    def apply_state_snapshot(
        self, domain_id: str, workflow_id: str, run_id: str, ckpt,
    ) -> Optional[dict]:
        """Install a snapshot-shipped ``ReplayCheckpoint`` as the run's
        local state via the existing suffix-only resume path: the row
        is keyed to the LOCAL branch, put into the checkpoint store,
        and the standard rebuilder consults it — a tip hit rehydrates
        without replaying the covered prefix (``events_replayed_saved``
        counts it), exactly like a warm rebuild.

        Returns ``{"covered_through", "backfill_from"}`` on success —
        the caller owes a history backfill of that range (state is
        current; the history bytes arrive behind it) — or None when the
        snapshot cannot be applied (stale vs local state, divergent
        local branch, stale fingerprint/caps): the caller falls back to
        event shipping, the correctness baseline."""
        import dataclasses as _dc

        if not ckpt.vh_items or ckpt.event_id < 1:
            return None
        if self._fault_hook is not None:
            self._fault_hook("apply_state_snapshot", self.shard.shard_id)
        snap_tip = int(ckpt.event_id)
        snap_version = int(ckpt.vh_items[-1][1])
        from ...runtime.queues.effects import task_effect_scope

        witness = task_effect_scope("replication", "SnapshotReplication")
        ctx = self.cache.get_or_create(domain_id, workflow_id, run_id)
        with witness, ctx.lock:
            try:
                ms = ctx.load()
            except EntityNotExistsError:
                ms = None
            if ms is not None:
                local = ms.version_histories
                if local is None:
                    return None
                cur_vh = local.get_current_version_history()
                last = cur_vh.last_item()
                if last.event_id >= snap_tip:
                    return None  # local already at/past the snapshot
                incoming = VersionHistory(items=[
                    VersionHistoryItem(int(e), int(v))
                    for e, v in ckpt.vh_items
                ])
                try:
                    _, lca = local.find_lca_index_and_item(incoming)
                except VersionHistoryError:
                    return None
                if lca.event_id < last.event_id:
                    # local tip is off the snapshot's branch: that is a
                    # version conflict the event path must resolve
                    # (rebuild-at-LCA); fast-forwarding over it would
                    # orphan local events
                    return None
                branch_token = (
                    cur_vh.branch_token or ms.execution_info.branch_token
                )
                backfill_from = last.event_id + 1
            else:
                branch = self.shard.persistence.history.new_history_branch(
                    tree_id=run_id
                )
                branch_token = branch.to_json().encode()
                backfill_from = 1
            if isinstance(branch_token, str):
                branch_token = branch_token.encode()

            rb, mgr = self._snapshot_rebuilder()
            key = branch_token.decode()
            local_ckpt = _dc.replace(
                ckpt,
                branch_key=key,
                tree_id=BranchToken.from_json(key).tree_id,
                domain_id=domain_id,
                workflow_id=workflow_id,
                run_id=run_id,
            )
            try:
                mgr.store.put_checkpoint(local_ckpt)
            except Exception:
                return None  # degraded store: event shipping takes over
            try:
                rebuilt, transfer, timer = rb.rebuild_many([RebuildRequest(
                    domain_id=domain_id,
                    workflow_id=workflow_id,
                    run_id=run_id,
                    branch_token=branch_token,
                    version_history_items=[
                        (int(e), int(v)) for e, v in ckpt.vh_items
                    ],
                )])[0]
            except PackError:
                # the packer refused the resume: event shipping takes
                # over. A fault of the device replay raises.
                return None
            if rebuilt is None or rebuilt.next_event_id - 1 < snap_tip:
                # the resume didn't stick (stale fingerprint, capacity
                # mismatch, degraded store): event shipping takes over
                return None
            rebuilt.execution_info.workflow_id = workflow_id
            rebuilt.execution_info.run_id = run_id
            rebuilt.execution_info.branch_token = branch_token
            if rebuilt.version_histories is not None:
                rebuilt.version_histories.get_current_version_history(
                ).branch_token = branch_token

            if ms is not None:
                snapshot = self._snapshot(rebuilt, transfer, timer)
                self.shard.persistence.execution.\
                    conflict_resolve_workflow_execution(
                        self.shard.shard_id, self.shard.range_id,
                        ctx.condition, snapshot,
                    )
            else:
                mode, prev_run_id = self._create_mode(
                    domain_id, workflow_id, snap_version
                )
                snapshot = self._snapshot(
                    rebuilt, transfer, timer,
                    zombie=(mode == CreateWorkflowMode.ZOMBIE),
                )
                self.shard.persistence.execution.create_workflow_execution(
                    self.shard.shard_id, self.shard.range_id, mode,
                    snapshot, prev_run_id=prev_run_id,
                )
                if mode == CreateWorkflowMode.SUPPRESS_CURRENT:
                    self.cache.evict(domain_id, workflow_id, prev_run_id)
            ctx._ms = rebuilt
            ctx._condition = rebuilt.next_event_id
        if snapshot.transfer_tasks:
            self._task_notifier()
        if snapshot.timer_tasks:
            self._timer_notifier()
        from ...core.enums import CloseStatus

        return {
            "covered_through": snap_tip,
            "backfill_from": backfill_from,
            # a snapshot-covered run that closed ContinuedAsNew has a
            # chain successor whose first batch rode the predecessor's
            # replication task — which this fast-forward bypassed. The
            # caller (rereplicator) must heal the successor explicitly
            # or the chain's new run never materializes locally.
            "continued_as_new": (
                rebuilt.execution_info.close_status
                == CloseStatus.ContinuedAsNew
            ),
        }

    def backfill_history(
        self, domain_id: str, workflow_id: str, run_id: str, batches,
    ) -> int:
        """Append raw remote event batches to the run's local branch
        WITHOUT touching workflow state — the history half of a
        snapshot-shipped catch-up (state jumped ahead via the snapshot;
        the covered prefix's bytes arrive behind it so the standby
        stays byte-identical). Idempotent: a node-id collision rewrites
        identical bytes under a fresh transaction id."""
        batches = [b for b in batches if b]
        if not batches:
            return 0
        from ...runtime.queues.effects import task_effect_scope

        witness = task_effect_scope("replication", "HistoryBackfill")
        ctx = self.cache.get_or_create(domain_id, workflow_id, run_id)
        with witness, ctx.lock:
            ms = ctx.load()
            branch = BranchToken.from_json(
                ms.execution_info.branch_token.decode()
            )
            applied = 0
            for b in batches:
                self.shard.persistence.history.append_history_nodes(
                    branch, list(b),
                    transaction_id=self.shard.next_task_id(),
                )
                applied += len(b)
            return applied

    # -- events reapplier (nDCEventsReapplier.go) ----------------------

    def _reapply_signals(
        self, ctx, ms: MutableState, events: List[HistoryEvent]
    ) -> None:
        signals = [
            e for e in events
            if e.event_type == EventType.WorkflowExecutionSignaled
        ]
        if not signals or not ms.is_workflow_execution_running():
            return
        from ...core.active_transaction import ActiveTransaction

        txn = ActiveTransaction(
            ms, ms.execution_info.domain_id, ms.execution_info.workflow_id,
            ms.execution_info.run_id, ms.current_version,
        )
        now = self.shard.now()
        for e in signals:
            a = e.attributes
            txn.add_workflow_execution_signaled(
                a.get("signal_name", ""), a.get("input", b""),
                a.get("identity", ""), now,
            )
        result = txn.close()
        repl = []
        if result.events:
            branch = BranchToken.from_json(
                ms.execution_info.branch_token.decode()
            )
            self.shard.persistence.history.append_history_nodes(
                branch, result.events,
                transaction_id=self.shard.next_task_id(),
            )
            # reapplication is an ACTIVE-side mint (this cluster owns
            # the domain): the reapplied events must ship to the peers
            # like any engine transaction, or the recovered region
            # completes the workflow without them and the clusters
            # diverge (the failover drill caught exactly this)
            if ms.version_histories is not None:
                from ...core.tasks import ReplicationTask

                repl = [ReplicationTask(
                    first_event_id=result.events[0].event_id,
                    next_event_id=result.events[-1].event_id + 1,
                    version=result.events[0].version,
                    branch_token=ms.execution_info.branch_token,
                )]
        # with a decision in flight the signals land in buffered_events;
        # they reach history when the decision completes
        snapshot = self._snapshot(
            ms, result.transfer_tasks, result.timer_tasks,
            replication=repl,
        )
        self.shard.persistence.execution.update_workflow_execution(
            self.shard.shard_id, self.shard.range_id, ctx.condition, snapshot,
        )
        ctx._condition = ms.next_event_id

    # -- persistence helpers -------------------------------------------

    def _snapshot(
        self, ms: MutableState, transfer, timer, zombie: bool = False,
        replication=(),
    ) -> WorkflowSnapshot:
        if zombie:
            # a ZOMBIE run is deliberately not current: enqueueing live
            # transfer/timer tasks for it would mint decisions/timers
            # for a suppressed run (reference nDCTransactionMgr zombie
            # writes carry no task generation)
            transfer, timer = [], []
        ei = ms.execution_info
        replication = list(replication)
        for t in list(transfer) + list(timer) + replication:
            if not t.domain_id:
                t.domain_id = ei.domain_id
            if not t.workflow_id:
                t.workflow_id = ei.workflow_id
            if not t.run_id:
                t.run_id = ei.run_id
        self.shard.assign_task_ids(transfer, timer, replication)
        return WorkflowSnapshot(
            domain_id=ei.domain_id,
            workflow_id=ei.workflow_id,
            run_id=ei.run_id,
            snapshot=ms.snapshot(),
            next_event_id=ms.next_event_id,
            last_write_version=ms.current_version,
            transfer_tasks=list(transfer),
            timer_tasks=list(timer),
            replication_tasks=replication,
        )

    def _stage_new_run(
        self, new_run_ms: MutableState, task: HistoryTaskV2
    ) -> WorkflowSnapshot:
        new_run_id = task.new_run_id or task.events[-1].attributes.get(
            "new_execution_run_id", ""
        )
        new_run_ms.execution_info.run_id = new_run_id
        history = self.shard.persistence.history
        branch = history.new_history_branch(tree_id=new_run_id)
        new_run_ms.execution_info.branch_token = branch.to_json().encode()
        if new_run_ms.version_histories is not None:
            new_run_ms.version_histories.get_current_version_history(
            ).branch_token = new_run_ms.execution_info.branch_token
        history.append_history_nodes(
            branch, task.new_run_events,
            transaction_id=self.shard.next_task_id(),
        )
        from ...core.task_refresher import refresh_tasks

        transfer, timer = refresh_tasks(new_run_ms)
        return self._snapshot(new_run_ms, transfer, timer)

    def _notify(self, sb: StateBuilder) -> None:
        if sb.transfer_tasks:
            self._task_notifier()
        if sb.timer_tasks:
            self._timer_notifier()
