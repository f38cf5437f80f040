"""Scanner: scavengers running as system workflows.

Reference: service/worker/scanner/ — scanner.go:101-171 launches
scavenger workflows on the system domain; tasklist/scavenger.go deletes
expired/orphan task lists, history/scavenger.go deletes history
branches whose workflow is gone. Scavenger passes run as activities;
the workflow loops pass → sleep → continue-as-new (a cron shape).

A copy of the reference package's ``worker/scanner.py``.
"""

from __future__ import annotations

import json
import time
from typing import List, Optional

from ..runtime.persistence.errors import EntityNotExistsError

from .sdk import ActivityError, Worker
from .archiver import SYSTEM_DOMAIN

SCANNER_WORKFLOW_TYPE = "cadence-sys-scanner-workflow"
SCANNER_WORKFLOW_ID = "cadence-scanner"
SCANNER_TASK_LIST = "cadence-scanner-tl"


_SCAVENGE_RETRY = {
    "initial_interval_seconds": 2,
    "backoff_coefficient": 2.0,
    "maximum_interval_seconds": 60,
    "maximum_attempts": 5,
}


def scanner_workflow(ctx, input: bytes):
    """One pass of every scavenger, then sleep and continue-as-new.

    A pass that still fails after its retry budget is LOGGED-AND-SKIPPED
    (the next cron pass retries): one bad pass must not close the cron
    loop Failed and silently stop scavenging until a process restart."""
    for activity in ("scavenge_task_lists", "scavenge_history"):
        try:
            yield ctx.schedule_activity(
                activity, b"", start_to_close_timeout_seconds=300,
                retry_policy=_SCAVENGE_RETRY,
            )
        except ActivityError:
            pass  # this pass is lost; the loop survives
    interval = int(input or b"60")
    yield ctx.start_timer(interval)
    yield ctx.continue_as_new(input)


class ScannerActivities:
    def __init__(
        self,
        task_manager,
        history_manager=None,
        execution_manager=None,
        num_shards: int = 0,
        idle_task_list_age_s: float = 3600.0,
        now=time.time,
        matching=None,
        shard_ids=None,
    ) -> None:
        self.tasks = task_manager
        self.history = history_manager
        self.execution = execution_manager
        # optional: consulted for live pollers before deleting a list
        self.matching = matching
        self.num_shards = num_shards
        # live shard-id provider (elastic resharding: a split mints ids
        # beyond the boot-time count, and a run moved to the new shard
        # MUST be in the live set or the history scavenger would
        # classify its tree orphaned and destroy it). None = the static
        # range(num_shards) of a never-resharded cluster.
        self._shard_ids = shard_ids
        self.idle_age = idle_task_list_age_s
        self.now = now
        # trees seen orphaned on the previous scavenge pass
        self._orphan_candidates: set = set()

    # -- tasklist scavenger (tasklist/scavenger.go) --------------------

    def scavenge_task_lists(self, _input: bytes = b"") -> bytes:
        """Delete task lists with an expired lease, no backlog and no
        recent pollers."""
        deleted = 0
        scanned = 0
        for info in self.tasks.list_task_lists():
            scanned += 1
            backlog = self.tasks.get_tasks(
                info.domain_id, info.name, info.task_type,
                0, 1 << 62, 1,
            )
            if backlog:
                continue
            if not info.last_updated:
                continue  # age unknown: never delete on a guess
            age = self.now() - info.last_updated / 1e9
            if age < self.idle_age:
                continue
            if self._has_recent_pollers(info):
                continue
            try:
                self.tasks.delete_task_list(
                    info.domain_id, info.name, info.task_type,
                    info.range_id,
                )
                deleted += 1
            except Exception:
                continue  # raced with a new lease: leave it
        return json.dumps({"scanned": scanned, "deleted": deleted}).encode()

    def _has_recent_pollers(self, info) -> bool:
        """Live long-pollers don't bump last_updated; ask matching
        (reference: scavenger consults DescribeTaskList pollers)."""
        if self.matching is None:
            return False
        try:
            desc = self.matching.describe_task_list(
                info.domain_id, info.name, info.task_type
            )
        except Exception:
            return True  # can't tell: keep the list
        pollers = (
            desc.get("pollers", []) if isinstance(desc, dict)
            else getattr(desc, "pollers", [])
        )
        return bool(pollers)

    # -- history scavenger (history/scavenger.go) ----------------------

    def scavenge_history(self, _input: bytes = b"") -> bytes:
        """Delete history trees whose workflow execution is gone.

        Two-phase: a tree is deleted only when it was ALSO orphaned on
        the previous pass — closing the race with workflow creation,
        where the branch is written before the execution record
        (context.create_workflow). The reference uses an age threshold;
        two sightings across the scan interval bounds the same risk."""
        if self.history is None or self.execution is None:
            return json.dumps({"skipped": True}).encode()
        list_trees = getattr(self.history, "list_history_trees", None)
        if list_trees is None:
            return json.dumps({"skipped": True}).encode()
        live = self._live_run_ids()
        deleted = 0
        scanned = 0
        orphans = set()
        for tree_id, branches in list_trees():
            scanned += 1
            if tree_id in live:
                continue
            orphans.add(tree_id)
            if tree_id not in self._orphan_candidates:
                continue  # first sighting: candidate only
            for branch in branches:
                try:
                    self.history.delete_history_branch(branch)
                    deleted += 1
                except Exception:
                    pass
        self._orphan_candidates = orphans
        return json.dumps({"scanned": scanned, "deleted": deleted}).encode()

    def _live_run_ids(self) -> set:
        """Run ids AND history-tree ids of every concrete execution.

        Trees are keyed by the run that CREATED them — a reset forks
        the new run's branch inside the ORIGINAL run's tree, so once
        retention deletes the original execution, the reset run's life
        depends on its branch token's tree_id being counted here; run
        ids alone would let the scavenger destroy a live workflow's
        history."""
        from ..runtime.persistence.records import BranchToken

        live = set()
        shard_ids = (
            self._shard_ids() if self._shard_ids is not None
            else range(self.num_shards)
        )
        for shard_id in shard_ids:
            # fail-SAFE: any read error aborts this scavenge pass. An
            # incomplete live set is indistinguishable from "orphan" —
            # e.g. a reset run whose tree id we failed to read would be
            # classified orphan on two passes and its live history
            # destroyed. The next cron pass retries.
            rows = self.execution.list_concrete_executions(shard_id)
            for domain_id, wf_id, rid in rows:
                live.add(rid)
                try:
                    resp = self.execution.get_workflow_execution(
                        shard_id, domain_id, wf_id, rid
                    )
                except EntityNotExistsError:
                    continue  # deleted between list and read
                token = (resp.snapshot or {}).get(
                    "execution_info", {}
                ).get("branch_token") or b""
                if isinstance(token, bytes):
                    token = token.decode()
                if token:
                    live.add(BranchToken.from_json(token).tree_id)
        return live


def build_scanner_worker(
    frontend, task_manager, history_manager=None, execution_manager=None,
    num_shards: int = 0, shard_ids=None, **kwargs,
) -> Worker:
    acts = ScannerActivities(
        task_manager, history_manager, execution_manager,
        num_shards=num_shards, shard_ids=shard_ids, **kwargs,
    )
    w = Worker(frontend, SYSTEM_DOMAIN, SCANNER_TASK_LIST,
               identity="scanner")
    w.register_workflow(SCANNER_WORKFLOW_TYPE, scanner_workflow)
    w.register_activity("scavenge_task_lists", acts.scavenge_task_lists)
    w.register_activity("scavenge_history", acts.scavenge_history)
    return w
