"""Replication traffic for conflict storms: what a standby cluster pulls
when a failover leaves many workflows with a divergent tail.

``history_tasks`` turns one stored history into the replication stream
its active side would emit, one ``HistoryTaskV2`` per transaction batch
at the history's own version. ``divergent_tail`` re-mints a history's
last batch at a higher failover version with the same event ids: the
batch a promoted cluster wrote while the old active's copy of it was
still in flight. Applied to a standby that holds the old batch, its
version-history items put the lowest common ancestor just before that
batch, so the standby forks there and, the incoming version being
higher, rebuilds the workflow's state from the fork (every earlier
event) before it applies the batch. ``decision_storm`` is the
three-task storm of the reference's replication-storm test (a decision
started at two versions). ``BacklogClient`` serves a fixed backlog to a
``ReplicationTaskFetcher`` a page at a time.

The deep storm of ``chip_smoke.py`` and ``tests/test_torch_replication.py``
builds its traffic here.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..core import history_factory as F
from ..core.events import HistoryEvent
from ..runtime.replication.messages import HistoryTaskV2, ReplicationMessages

Batches = List[List[HistoryEvent]]
SECOND = 1_000_000_000


def history_tasks(domain_id: str, workflow_id: str, run_id: str,
                  batches: Batches, first_task_id: int) -> List[HistoryTaskV2]:
    """One task per batch, each carrying the version-history items of the
    history up to its last event (one item: the history has one
    version)."""
    out = []
    for k, batch in enumerate(batches):
        last = batch[-1]
        out.append(HistoryTaskV2(
            task_id=first_task_id + k, domain_id=domain_id,
            workflow_id=workflow_id, run_id=run_id,
            version_history_items=[{"event_id": last.event_id,
                                    "version": last.version}],
            events=list(batch),
        ))
    return out


def divergent_tail(domain_id: str, workflow_id: str, run_id: str,
                   batches: Batches, version: int,
                   task_id: int) -> HistoryTaskV2:
    """The history's last batch re-minted at ``version`` (same event ids
    and payloads), with the items of a branch that forked just before
    it. Needs at least two batches."""
    if len(batches) < 2:
        raise ValueError("a divergent tail needs a history of two batches")
    tail = batches[-1]
    lca = batches[-2][-1]
    if version <= tail[0].version:
        raise ValueError("the divergent tail must carry a higher version")
    return HistoryTaskV2(
        task_id=task_id, domain_id=domain_id, workflow_id=workflow_id,
        run_id=run_id,
        version_history_items=[
            {"event_id": lca.event_id, "version": lca.version},
            {"event_id": tail[-1].event_id, "version": version},
        ],
        events=[dataclasses.replace(e, version=version,
                                    attributes=dict(e.attributes))
                for e in tail],
    )


def conflict_storm(domain_id: str,
                   histories: Sequence[Tuple[str, str, Batches]],
                   version: int) -> Tuple[List[HistoryTaskV2],
                                          List[HistoryTaskV2]]:
    """(seed tasks, storm tasks) for ``histories``: every history's
    batches in order, workflow after workflow, then one divergent tail
    each. Task ids rise through both lists."""
    seed: List[HistoryTaskV2] = []
    for wf, run, batches in histories:
        seed += history_tasks(domain_id, wf, run, batches, len(seed) + 1)
    storm = [divergent_tail(domain_id, wf, run, batches, version,
                            len(seed) + 1 + i)
             for i, (wf, run, batches) in enumerate(histories)]
    return seed, storm


def decision_storm(domain_id: str, n_workflows: int, version: int = 1,
                   divergent_version: int = 12,
                   t0_ns: int = 1_700_000_000 * SECOND):
    """The 3-task storm of the reference's replication-storm test: per
    workflow a creation batch (started, decision scheduled) and a
    continuation (decision started) at ``version``, then a divergent
    decision-started batch at ``divergent_version`` that forces a
    conflict rebuild. Returns (tasks, [(workflow_id, run_id)])."""
    tasks: List[HistoryTaskV2] = []
    wfs = []
    for i in range(n_workflows):
        wf, run = f"wf-storm-{i}", f"run-storm-{i}"
        wfs.append((wf, run))
        b1 = [
            F.workflow_execution_started(
                1, version, t0_ns, task_list="tl", workflow_type="wt",
                execution_start_to_close_timeout_seconds=300,
                task_start_to_close_timeout_seconds=10,
            ),
            F.decision_task_scheduled(2, version, t0_ns),
        ]
        b2 = [F.decision_task_started(3, version, t0_ns + SECOND,
                                      scheduled_event_id=2)]
        divergent = [F.decision_task_started(
            3, divergent_version, t0_ns + 2 * SECOND, scheduled_event_id=2)]
        for items, events in (
            ([{"event_id": 2, "version": version}], b1),
            ([{"event_id": 3, "version": version}], b2),
            ([{"event_id": 2, "version": version},
              {"event_id": 3, "version": divergent_version}], divergent),
        ):
            tasks.append(HistoryTaskV2(
                task_id=len(tasks) + 1, domain_id=domain_id, workflow_id=wf,
                run_id=run, version_history_items=items, events=events,
            ))
    return tasks, wfs


class BacklogClient:
    """A remote cluster's replication verb over a fixed backlog (task ids
    rising): the tasks past the cursor, ``page`` at a time (None: all of
    them), with ``has_more`` set while more remain."""

    def __init__(self, tasks: Sequence[HistoryTaskV2],
                 page: Optional[int] = None) -> None:
        self.tasks: List[HistoryTaskV2] = []
        self._ids: List[int] = []
        self.page = page
        self.extend(tasks)

    def extend(self, tasks: Sequence[HistoryTaskV2]) -> None:
        for t in tasks:
            if self._ids and t.task_id <= self._ids[-1]:
                raise ValueError("backlog task ids must rise")
            self.tasks.append(t)
            self._ids.append(t.task_id)

    def get_replication_messages(self, shard_id: int,
                                 last_retrieved_id: int,
                                 max_tasks: Optional[int] = None):
        lo = bisect.bisect_right(self._ids, last_retrieved_id)
        n = len(self.tasks) - lo
        for cap in (self.page, max_tasks):
            if cap is not None:
                n = min(n, cap)
        served = self.tasks[lo:lo + n]
        last = served[-1].task_id if served else last_retrieved_id
        return ReplicationMessages(
            tasks=served, last_retrieved_id=last,
            has_more=lo + n < len(self.tasks))
