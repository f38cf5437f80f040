"""Elastic resharding: online shard split/merge under live traffic.

Following "Reconfigurable State Machine Replication from
Non-Reconfigurable Building Blocks" (PAPERS.md), reconfiguration is
layered ON TOP of the static shard substrate instead of baked into it:
each reconfiguration epoch is a write-ahead ``ReshardPlan`` executed by
a coordinator against building blocks that individually know nothing
about elasticity — range-fenced shard leases, drainable queue pumps,
and the checkpoint store.

The routing function is an epoch-versioned :class:`ShardMap`: a
partition of the 32-bit workflow-hash space into residue classes
``hash % modulus == residue``, each owned by one shard id. The initial
map (``residue i mod N -> shard i``) routes byte-identically to the
legacy ``shard_for_workflow(wid, N)``; a **split** halves one shard's
classes (doubling their modulus), a **merge** repoints a shard's
classes at a sibling — both change only the affected shards' keyspace,
never the whole cluster's (no global rehash).

Handoff protocol per epoch (the coordinator, one reconfiguration at a
time):

1. persist the plan (``persistence.shard.set_reshard_state`` — the
   write-ahead record; it rides ``wrap_bundle(faults=...)`` so chaos
   rules can kill any step);
2. pause + drain the affected shards' queue pumps to a recorded ack
   watermark (``fence_drain``), then fence the shard contexts (lease
   bump + write refusal: a fenced shard can never mint regressing task
   IDs) and flush ``ReplayCheckpoint`` snapshots for every open
   workflow on a source shard;
3. move the affected workflows' execution/current rows and the queue
   tasks past the watermark to their target shards (checkpoints — not
   event histories — are what the new owner warms from; suffix-only
   replay rides the existing resume path);
4. commit the new map under an epoch LWT, flip every host's resolver
   (brief dual-read window), let controllers re-acquire, warm the new
   owners from the shipped checkpoints, and retire the old map.

A failure at any step rolls back: moved rows return to their source
shards, the plan is marked ABORTED (same epoch LWT), and controllers
re-acquire under the old map — the old epoch's fences were lease
bumps, so rollback never regresses a range_id.

A copy of the reference package's ``runtime/resharding.py``. The
coordinator takes ``device`` (default ``"cuda"``): the checkpoint flush
and the new owners' warm replay the moving workflows through the port's
``StateRebuilder.rebuild_many`` there, which raises on a device fault
and falls back to the host only for a history the packer refuses
(``PackError``). Deviation: the reference logs a failed post-commit warm
and returns; the port finishes the commit's bookkeeping and then raises
``ReshardError``, so a device fault in the warm is never hidden.
``last_rebuild_scopes`` keeps the flush's and the warm's rebuilder
metrics (``history_read``, ``dispatch_wait``, ``rehydrate``) of the last
plan.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.hashing import fnv1a32
from ..utils.locks import make_lock
from ..utils.log import get_logger
from ..utils.metrics import NOOP, Scope

from .persistence.errors import ConditionFailedError, EntityNotExistsError
from .shard import ShardContext


class ReshardError(RuntimeError):
    """A reconfiguration step failed; the coordinator rolled back."""


# --------------------------------------------------------------------------
# ShardMap — epoch-versioned routing
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """A partition of the workflow-hash space into residue classes.

    ``entries``: tuples ``(residue, modulus, shard_id)`` — workflow w
    routes to the entry with ``fnv1a32(w) % modulus == residue``.
    Entries always partition the space (``validate``), so lookup is
    total and unambiguous.
    """

    epoch: int
    entries: Tuple[Tuple[int, int, int], ...]

    @classmethod
    def initial(cls, num_shards: int) -> "ShardMap":
        """Epoch-0 map routing identically to the legacy
        ``shard_for_workflow(wid, num_shards)``."""
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        return cls(
            epoch=0,
            entries=tuple((i, num_shards, i) for i in range(num_shards)),
        )

    # -- lookup --------------------------------------------------------

    def shard_for(self, workflow_id: str) -> int:
        return self.shard_for_hash(fnv1a32(workflow_id))

    def shard_for_hash(self, h: int) -> int:
        for residue, modulus, shard_id in self.entries:
            if h % modulus == residue:
                return shard_id
        raise RuntimeError(f"shard map does not cover hash {h}")  # validate()d away

    def shard_ids(self) -> List[int]:
        return sorted({s for _, _, s in self.entries})

    @property
    def num_shards(self) -> int:
        return len({s for _, _, s in self.entries})

    # -- reconfiguration -----------------------------------------------

    def split(self, shard_id: int,
              new_id: Optional[int] = None) -> Tuple["ShardMap", int]:
        """Halve ``shard_id``'s keyspace into (itself, a fresh shard id).
        Returns ``(new_map, new_shard_id)``. ``new_id`` lets the
        coordinator mint ids that were never used before (even by an
        aborted plan), so stale rows from a failed cleanup can never be
        resurrected by id reuse."""
        owned = [e for e in self.entries if e[2] == shard_id]
        if not owned:
            raise ValueError(f"shard {shard_id} not in map")
        if new_id is None:
            new_id = max(self.shard_ids()) + 1
        elif new_id in self.shard_ids():
            raise ValueError(f"shard id {new_id} already in map")
        entries = [e for e in self.entries if e[2] != shard_id]
        for residue, modulus, _ in owned:
            entries.append((residue, 2 * modulus, shard_id))
            entries.append((residue + modulus, 2 * modulus, new_id))
        m = ShardMap(epoch=self.epoch + 1, entries=tuple(sorted(entries)))
        m.validate()
        return m, new_id

    def merge(self, source_id: int, target_id: int) -> "ShardMap":
        """Repoint every class of ``source_id`` at ``target_id``; the
        source shard id leaves the map."""
        if source_id == target_id:
            raise ValueError("merge source == target")
        if not any(e[2] == source_id for e in self.entries):
            raise ValueError(f"shard {source_id} not in map")
        if not any(e[2] == target_id for e in self.entries):
            raise ValueError(f"shard {target_id} not in map")
        entries = tuple(sorted(
            (r, m, target_id if s == source_id else s)
            for r, m, s in self.entries
        ))
        m = ShardMap(epoch=self.epoch + 1, entries=entries)
        m.validate()
        return m

    def validate(self) -> None:
        """The entries must partition the hash space: total coverage
        (measures sum to 1) and pairwise disjoint residue classes."""
        if not self.entries:
            raise ValueError("empty shard map")
        total = sum(Fraction(1, m) for _, m, _ in self.entries)
        if total != 1:
            raise ValueError(f"shard map covers {total} of the hash space")
        import math

        es = self.entries
        for i in range(len(es)):
            r1, m1, _ = es[i]
            if not 0 <= r1 < m1:
                raise ValueError(f"residue {r1} out of range for mod {m1}")
            for j in range(i + 1, len(es)):
                r2, m2, _ = es[j]
                if (r1 - r2) % math.gcd(m1, m2) == 0:
                    raise ValueError(
                        f"overlapping classes ({r1},{m1}) and ({r2},{m2})"
                    )

    # -- serde ---------------------------------------------------------

    def to_dict(self) -> dict:
        return {"epoch": self.epoch,
                "entries": [list(e) for e in self.entries]}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardMap":
        return cls(
            epoch=int(d["epoch"]),
            entries=tuple(tuple(int(x) for x in e) for e in d["entries"]),
        )


# --------------------------------------------------------------------------
# ReshardPlan — the write-ahead record
# --------------------------------------------------------------------------

PLAN_PREPARED = "PREPARED"
PLAN_FENCED = "FENCED"
PLAN_COMMITTED = "COMMITTED"
PLAN_ABORTED = "ABORTED"


@dataclasses.dataclass
class ReshardPlan:
    """One reconfiguration epoch's durable record (old map -> new map).

    Persisted through ``ShardManager.set_reshard_state`` before any
    state moves; every later step updates ``state`` in place under the
    same epoch LWT, so a crashed coordinator's successor (``recover``)
    knows exactly how far the handoff got — and anything short of
    COMMITTED rolls back to ``epoch_from``.
    """

    kind: str                      # "split" | "merge"
    epoch_from: int
    epoch_to: int
    map_from: dict                 # ShardMap.to_dict()
    map_to: dict
    sources: List[int]             # shards losing workflows
    targets: List[int]             # shards gaining workflows
    state: str = PLAN_PREPARED
    watermarks: Dict[str, dict] = dataclasses.field(default_factory=dict)
    moved_workflows: int = 0
    moved_tasks: int = 0
    checkpoints_shipped: int = 0
    suffix_events_replayed: int = 0
    handoff_ms: float = 0.0
    # the write-unavailability window: fence-drain start → engines
    # re-acquired under the new epoch (handoff_ms minus the pre-fence
    # checkpoint flush, which runs under live traffic)
    pause_ms: float = 0.0
    error: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ReshardPlan":
        return cls(**d)


def _state_blob(shard_map: ShardMap, plan: Optional[ReshardPlan],
                max_shard_id: int = 0) -> str:
    return json.dumps({
        "map": shard_map.to_dict(),
        "plan": plan.to_dict() if plan is not None else None,
        # monotone high-water mark over every shard id EVER minted —
        # including by aborted plans whose target cleanup failed; ids
        # are never reused, so stale rows can never be resurrected
        "max_shard_id": max_shard_id,
    }, sort_keys=True)


def load_reshard_state(shard_manager):
    """(ShardMap, in-flight ReshardPlan) from the store, or (None, None)
    when no reconfiguration was ever committed. Never raises — a broken
    store reads as 'no state' (the epoch-0 default map)."""
    try:
        row = shard_manager.get_reshard_state()
    except Exception:
        return None, None
    if row is None:
        return None, None
    epoch, blob = row
    try:
        d = json.loads(blob)
        shard_map = ShardMap.from_dict(d["map"])
        plan = (
            ReshardPlan.from_dict(d["plan"])
            if d.get("plan") is not None else None
        )
        return shard_map, plan
    except Exception:
        return None, None


# --------------------------------------------------------------------------
# Coordinator
# --------------------------------------------------------------------------


class ReshardCoordinator:
    """Executes shard split/merge + host rebalancing across the given
    in-process controllers (one per history host). One reconfiguration
    at a time; the plan row is the write-ahead record.

    ``controllers``: every host's ShardController. The coordinator
    pauses/drains the affected shards wherever they live, moves the
    rows, flips each host's resolver, and triggers re-acquisition.
    Cross-process deployments drive the same steps through each host's
    admin endpoint (see README "Elastic resharding").
    """

    def __init__(
        self,
        persistence,
        controllers: Sequence,
        metrics=None,
        drain_timeout_s: float = 10.0,
        checkpoint_flush: bool = True,
        time_source=None,
        on_step=None,
        device="cuda",
    ) -> None:
        self.persistence = persistence
        # where the flush and the warm replay the moving workflows
        self.device = device
        # the flush's and the warm's rebuilder metrics of the last plan
        self.last_rebuild_scopes: Dict[str, Scope] = {}
        self.controllers = list(controllers)
        self.drain_timeout_s = drain_timeout_s
        self.checkpoint_flush = checkpoint_flush
        self._time = time_source
        # chaos hook: called with the protocol step name just completed
        # ("prepared" / "flushed" / "fenced" / "moved" / "committed") —
        # the reshard chaos family kills hosts between exact steps
        self._on_step = on_step or (lambda step: None)
        self.metrics = (metrics if metrics is not None else NOOP).tagged(
            layer="resharding"
        )
        self._lock = make_lock("ReshardCoordinator._lock")
        # in-process cache of the durable shard-id high-water mark
        self._max_shard_id = 0
        self._log = get_logger("cadence_tpu_torch.resharding")

    # -- public API ----------------------------------------------------

    def current_map(self) -> ShardMap:
        stored, _ = load_reshard_state(self.persistence.shard)
        if stored is not None:
            return stored
        return self._resolver_map()

    def split(self, shard_id: int) -> ReshardPlan:
        """Split ``shard_id`` 1→2 online; returns the committed plan."""
        with self._lock:
            old_map = self.current_map()
            new_map, new_id = old_map.split(
                shard_id, new_id=self._fresh_shard_id(old_map)
            )
            plan = ReshardPlan(
                kind="split",
                epoch_from=old_map.epoch, epoch_to=new_map.epoch,
                map_from=old_map.to_dict(), map_to=new_map.to_dict(),
                sources=[shard_id], targets=[new_id],
            )
            return self._execute(old_map, new_map, plan)

    def merge(self, source_id: int, target_id: int) -> ReshardPlan:
        """Merge ``source_id`` into ``target_id`` 2→1 online."""
        with self._lock:
            old_map = self.current_map()
            new_map = old_map.merge(source_id, target_id)
            plan = ReshardPlan(
                kind="merge",
                epoch_from=old_map.epoch, epoch_to=new_map.epoch,
                map_from=old_map.to_dict(), map_to=new_map.to_dict(),
                sources=[source_id], targets=[target_id],
            )
            return self._execute(old_map, new_map, plan)

    def _fresh_shard_id(self, shard_map: ShardMap) -> int:
        """A shard id never used before — by the current map OR by any
        plan ever recorded (including an ABORTED one whose target-side
        cleanup may have failed, leaving stale rows under the old id;
        reusing it could resurrect them over live state). The durable
        ``max_shard_id`` high-water mark makes this monotone across
        plans and restarts."""
        used = set(shard_map.shard_ids())
        _, plan = load_reshard_state(self.persistence.shard)
        if plan is not None:
            used.update(plan.sources)
            used.update(plan.targets)
            used.update(ShardMap.from_dict(plan.map_to).shard_ids())
        return max(max(used), self._stored_max_shard_id()) + 1

    def _stored_max_shard_id(self) -> int:
        best = self._max_shard_id
        try:
            row = self.persistence.shard.get_reshard_state()
            if row is not None:
                best = max(
                    best, int(json.loads(row[1]).get("max_shard_id", 0))
                )
        except Exception:
            pass
        self._max_shard_id = best
        return best

    def rebalance(self) -> None:
        """Host add/remove: re-evaluate ring ownership everywhere (the
        ring listeners normally do this; explicit for orchestrators)."""
        for c in self.controllers:
            c.acquire_shards()

    def recover(self) -> Optional[ReshardPlan]:
        """Roll back an in-flight plan left by a crashed coordinator
        (the write-ahead contract: anything short of COMMITTED aborts).
        Returns the aborted plan, or None when the store is clean."""
        with self._lock:
            stored_map, plan = load_reshard_state(self.persistence.shard)
            if plan is None or plan.state in (PLAN_COMMITTED, PLAN_ABORTED):
                return None
            old_map = ShardMap.from_dict(plan.map_from)
            new_map = ShardMap.from_dict(plan.map_to)
            self._rollback_moves(old_map, new_map, plan)
            plan.state = PLAN_ABORTED
            plan.error = plan.error or "coordinator crashed mid-handoff"
            self._persist(old_map, plan)
            for c in self.controllers:
                self._set_resolver_map(c, old_map, previous=None)
                c.acquire_shards()
            self.metrics.inc("reshard_rollbacks")
            return plan

    def status(self) -> dict:
        shard_map = self.current_map()
        _, plan = load_reshard_state(self.persistence.shard)
        return {
            "epoch": shard_map.epoch,
            "shard_ids": shard_map.shard_ids(),
            "entries": shard_map.to_dict()["entries"],
            "last_plan": plan.to_dict() if plan is not None else None,
        }

    # -- resolver plumbing ---------------------------------------------

    def _resolver_map(self) -> ShardMap:
        for c in self.controllers:
            m = c.shard_map
            if m is not None:
                return m
        raise ReshardError("no controllers with a shard map")

    @staticmethod
    def _set_resolver_map(controller, shard_map, previous) -> None:
        controller._resolver.set_shard_map(shard_map, previous=previous)

    # -- protocol steps ------------------------------------------------

    def _persist(self, shard_map: ShardMap, plan: Optional[ReshardPlan],
                 previous_epoch: Optional[int] = None) -> None:
        """Write the plan/map row, surviving torn writes: a write whose
        ack was lost LANDED — re-reading the row and finding exactly
        our payload is success (including the ConditionFailed a retry
        of a landed epoch bump produces)."""
        epoch = shard_map.epoch
        self._max_shard_id = max(
            [self._max_shard_id] + shard_map.shard_ids()
            + (plan.sources + plan.targets if plan is not None else [])
        )
        blob = _state_blob(shard_map, plan, self._max_shard_id)
        prev = epoch if previous_epoch is None else previous_epoch
        last_exc = None
        for _ in range(3):
            try:
                self.persistence.shard.set_reshard_state(
                    epoch, blob, previous_epoch=prev
                )
                return
            except Exception as e:
                last_exc = e
                try:
                    if self.persistence.shard.get_reshard_state() == (
                        epoch, blob
                    ):
                        return  # our torn write landed
                except Exception:
                    pass
                if isinstance(e, ConditionFailedError):
                    raise  # a competing coordinator really won
        raise last_exc

    def _owning_controller(self, shard_id: int):
        for c in self.controllers:
            if shard_id in c.owned_shards():
                return c
        return None

    def _affected_handles(self, plan: ReshardPlan):
        """(controller, handle) per affected live shard. A shard nobody
        owns (its host died) has nothing to pause — the fence at move
        time still protects it via the lease bump."""
        out = []
        for shard_id in sorted(set(plan.sources + plan.targets)):
            c = self._owning_controller(shard_id)
            if c is None:
                continue
            with c._lock:
                handle = c._handles.get(shard_id)
            if handle is not None:
                out.append((c, shard_id, handle))
        return out

    def _drain_and_fence(self, plan: ReshardPlan, handles) -> None:
        deadline = time.monotonic() + self.drain_timeout_s
        for _, shard_id, handle in handles:
            marks = {}
            for p in handle.processors:
                if not hasattr(p, "fence_drain"):
                    continue
                mark = p.fence_drain(deadline)
                marks[getattr(p, "name", type(p).__name__)] = (
                    list(mark) if isinstance(mark, tuple) else mark
                )
            plan.watermarks[str(shard_id)] = marks
        for _, _, handle in handles:
            handle.shard.fence()

    # -- checkpoint shipping -------------------------------------------

    def _checkpoint_manager(self):
        store = getattr(self.persistence, "checkpoint", None)
        if store is None or not self.checkpoint_flush:
            return None
        from ..checkpoint import CheckpointManager, CheckpointPolicy

        # every_events=1: the handoff must snapshot every workflow at
        # its tip, whatever the serving-path cadence is
        return CheckpointManager(
            store, CheckpointPolicy(every_events=1, keep_last=2)
        )

    @staticmethod
    def _is_open(snap: dict) -> bool:
        ex = snap.get("execution_info") or snap.get("exec") or {}
        return int(ex.get("state", 0)) != 2  # WorkflowState.Completed

    def _rebuild_requests(self, shard_id: int, workflow_ids) -> list:
        """RebuildRequests for the current run of every OPEN workflow
        given, on ``shard_id`` (branch token + version-history items
        straight from the execution snapshot). Closed runs are skipped:
        they move with the shard but nobody replays them on the hot
        path, so flushing/warming them would stretch the handoff for
        nothing."""
        from .replication.rebuilder import RebuildRequest

        execution = self.persistence.execution
        reqs = []
        for domain_id, wf_id, run_id in workflow_ids:
            try:
                resp = execution.get_workflow_execution(
                    shard_id, domain_id, wf_id, run_id
                )
            except EntityNotExistsError:
                continue
            snap = resp.snapshot or {}
            if not self._is_open(snap):
                continue
            raw = snap.get("execution_info", {}).get("branch_token", "")
            if isinstance(raw, str):
                raw = raw.encode()
            if not raw:
                continue
            vh = snap.get("version_histories") or {}
            histories = vh.get("histories", [])
            items = None
            if histories:
                cur = histories[vh.get("current_index", 0)]
                items = [tuple(i) for i in cur.get("items", [])]
            reqs.append(RebuildRequest(
                domain_id=domain_id, workflow_id=wf_id, run_id=run_id,
                branch_token=raw, version_history_items=items,
            ))
        return reqs

    def _flush_checkpoints(self, plan: ReshardPlan, moved) -> None:
        """Snapshot every moving workflow at its tip so the new owner
        rehydrates from checkpoints, never from full event streams."""
        mgr = self._checkpoint_manager()
        if mgr is None:
            return
        from .replication.rebuilder import StateRebuilder

        scope = self.last_rebuild_scopes["flush"] = Scope()
        rb = StateRebuilder(
            self.persistence.history, checkpoints=mgr, metrics=scope,
            device=self.device,
        )
        for shard_id, rows in moved.items():
            reqs = self._rebuild_requests(shard_id, rows)
            if not reqs:
                continue
            rb.rebuild_many(reqs)
            plan.checkpoints_shipped += len(reqs)
        self.metrics.inc("checkpoints_shipped", plan.checkpoints_shipped)

    def _warm_new_owners(self, plan: ReshardPlan, moved_by_target) -> None:
        """Rehydrate moved workflows on their target shards from the
        shipped checkpoints + suffix-only replay; counts the events the
        checkpoints saved vs the suffix events actually replayed."""
        mgr = self._checkpoint_manager()
        if mgr is None:
            return
        from .replication.rebuilder import StateRebuilder

        warm_scope = self.last_rebuild_scopes["warm"] = Scope()
        rb = StateRebuilder(
            self.persistence.history, checkpoints=mgr, metrics=warm_scope,
            device=self.device,
        )
        total_events = 0
        for target, rows in sorted(moved_by_target.items()):
            reqs = self._rebuild_requests(target, rows)
            if not reqs:
                continue
            for ms, _, _ in rb.rebuild_many(reqs):
                total_events += max(0, int(ms.next_event_id) - 1)
        saved = int(
            warm_scope.registry.counter_value("events_replayed_saved") or 0
        )
        # everything a shipped checkpoint covered was NOT re-read; the
        # remainder is the suffix the resume path actually replayed —
        # the "no full-history shipping" proof the chaos suite asserts
        plan.suffix_events_replayed = max(0, total_events - saved)
        self.metrics.inc("suffix_events_replayed", plan.suffix_events_replayed)
        self.metrics.inc("events_replayed_saved", saved)

    # -- row movement --------------------------------------------------

    def _moving_rows(self, old_map: ShardMap, new_map: ShardMap,
                     source: int):
        """(domain, wf, run) rows leaving ``source``, grouped by their
        target shard under ``new_map``."""
        by_target: Dict[int, list] = {}
        for domain_id, wf_id, run_id in (
            self.persistence.execution.list_concrete_executions(source)
        ):
            target = new_map.shard_for(wf_id)
            if target != source:
                by_target.setdefault(target, []).append(
                    (domain_id, wf_id, run_id)
                )
        return by_target

    def _temp_context(self, shard_id: int) -> ShardContext:
        """Coordinator-owned lease on a target shard (creates the shard
        row for a brand-new split target; the bump fences any stale
        writer until the real owner re-acquires)."""
        return ShardContext(
            shard_id, self.persistence, owner="reshard-coordinator",
            time_source=self._time,
        )

    def _move(self, old_map: ShardMap, new_map: ShardMap,
              plan: ReshardPlan, journal: list) -> Dict[int, list]:
        """Move every affected row (copy → install → purge: the source
        keeps its rows until the target copy durably landed, so a crash
        in ANY window leaves a recoverable state — at worst a duplicate
        copy the rollback sweep deletes). Returns target -> moved rows;
        appends ``[source, target, extracted, purged]`` journal entries
        so a failure can undo exactly what moved."""
        execution = self.persistence.execution
        moved_by_target: Dict[int, list] = {}
        for source in plan.sources:
            marks = plan.watermarks.get(str(source), {})
            transfer_mark, timer_mark = _queue_watermarks(source, marks)
            for target, rows in sorted(
                self._moving_rows(old_map, new_map, source).items()
            ):
                ctx = self._temp_context(target)
                wids = sorted({w for _, w, _ in rows})
                extracted = execution.reshard_extract(
                    source, wids,
                    transfer_watermark=transfer_mark,
                    timer_watermark=timer_mark,
                )
                entry = [source, target, extracted, False]
                journal.append(entry)
                execution.reshard_install(
                    target, ctx.range_id, extracted, ctx.next_task_id
                )
                execution.reshard_purge(source, extracted)
                entry[3] = True
                self._rewind_target_acks(ctx, extracted)
                plan.moved_workflows += len(extracted["executions"])
                plan.moved_tasks += (
                    len(extracted["transfer"]) + len(extracted["timers"])
                    + len(extracted["replication"])
                )
                moved_by_target.setdefault(target, []).extend(rows)
        return moved_by_target

    @staticmethod
    def _rewind_target_acks(ctx: ShardContext, extracted) -> None:
        """Moved timers keep their firing time: the target's timer
        cursors must sit at/below the earliest moved deadline or the
        pump would never read it."""
        timers = extracted.get("timers") or []
        if not timers:
            return
        min_ts = min(t.visibility_timestamp for t in timers)
        if ctx.get_timer_ack_level() > min_ts:
            ctx.update_timer_ack_level(min_ts)
        for cluster in list(ctx._info.cluster_timer_ack_level):
            if ctx.get_cluster_timer_ack_level(cluster) > min_ts:
                ctx.update_cluster_timer_ack_level(cluster, min_ts)

    def _rollback_moves(self, old_map: ShardMap, new_map: ShardMap,
                        plan: ReshardPlan, journal=None) -> None:
        """Undo the copy-then-purge moves. With a journal (in-process
        failure): delete the target copies, and reinstall on the source
        only the entries whose purge already ran (otherwise the source
        never lost its rows — reinstalling would duplicate queue
        tasks). Without one (crash recovery): sweep the new map's
        targets for rows that belong elsewhere under the OLD map,
        delete duplicates, move back orphans."""
        execution = self.persistence.execution
        if journal:
            for source, target, extracted, purged in reversed(journal):
                wids = sorted({
                    s["workflow_id"] for s in extracted["executions"]
                })
                back = {"executions": []}
                for attempt in range(2):
                    try:
                        # remove whatever landed on the target (empty
                        # when the install never happened — idempotent)
                        back = execution.reshard_extract(
                            target, wids,
                            transfer_watermark=0, timer_watermark=(0, 0),
                            delete=True,
                        )
                        break
                    except Exception:
                        if attempt:
                            # stale copies may remain on the target;
                            # harmless while its id stays out of the
                            # map, and _fresh_shard_id never re-mints
                            # it (resurrection-proof)
                            self._log.exception(
                                f"rollback cleanup of shard {target} "
                                "failed; stale copies may remain"
                            )
                if purged:
                    ctx = self._temp_context(source)
                    restore = back if back["executions"] else extracted
                    execution.reshard_install(
                        source, ctx.range_id, restore, ctx.next_task_id
                    )
            return
        # crash recovery: no journal — sweep targets for misplaced rows
        for target in set(ShardMap.from_dict(plan.map_to).shard_ids()):
            rows = []
            try:
                rows = execution.list_concrete_executions(target)
            except Exception:
                continue
            misplaced: Dict[int, list] = {}
            for domain_id, wf_id, run_id in rows:
                want = old_map.shard_for(wf_id)
                if want != target:
                    misplaced.setdefault(want, []).append(
                        (domain_id, wf_id, run_id)
                    )
            for source, rows3 in sorted(misplaced.items()):
                ctx = self._temp_context(source)
                extracted = execution.reshard_extract(
                    target, sorted({w for _, w, _ in rows3}),
                    transfer_watermark=0, timer_watermark=(0, 0),
                    delete=True,
                )
                # a crash between install and purge leaves the row on
                # BOTH shards: the source copy wins, the target copy
                # (just deleted) is discarded; orphans move back
                orphans = {
                    k: list(v) if isinstance(v, list) else v
                    for k, v in extracted.items()
                }
                keep = []
                for e in extracted["executions"]:
                    try:
                        execution.get_workflow_execution(
                            source, e["domain_id"], e["workflow_id"],
                            e["run_id"],
                        )
                    except EntityNotExistsError:
                        keep.append(e)
                if not keep:
                    continue
                kept_wids = {e["workflow_id"] for e in keep}
                orphans["executions"] = keep
                orphans["currents"] = [
                    c for c in extracted["currents"]
                    if c["workflow_id"] in kept_wids
                ]
                for q in ("transfer", "timers", "replication"):
                    orphans[q] = [
                        t for t in extracted[q]
                        if t.workflow_id in kept_wids
                    ]
                execution.reshard_install(
                    source, ctx.range_id, orphans, ctx.next_task_id
                )

    # -- the protocol --------------------------------------------------

    def _execute(self, old_map: ShardMap, new_map: ShardMap,
                 plan: ReshardPlan) -> ReshardPlan:
        t0 = time.perf_counter()
        self.last_rebuild_scopes = {}
        journal: list = []
        handles = []
        moved_by_target: Dict[int, list] = {}
        try:
            # 1. write-ahead plan row (LWT on the OLD epoch)
            self._persist(old_map, plan, previous_epoch=old_map.epoch)
            self._on_step("prepared")

            # 2a. snapshot moving workflows while traffic still flows —
            #     suffix-only replay covers anything written after the
            #     snapshot, so flushing pre-fence keeps the JIT/compile
            #     cost OUT of the write-unavailability window
            moving = {
                s: [r for rows in
                    self._moving_rows(old_map, new_map, s).values()
                    for r in rows]
                for s in plan.sources
            }
            self._flush_checkpoints(plan, moving)
            self._on_step("flushed")

            # 2b. quiesce: pause intake, drain in-flight work to the
            #     ack watermark, fence the leases (the pause starts HERE)
            t_fence = time.perf_counter()
            handles = self._affected_handles(plan)
            self._drain_and_fence(plan, handles)
            plan.state = PLAN_FENCED
            self._persist(old_map, plan, previous_epoch=old_map.epoch)
            self._on_step("fenced")

            # 3. stop the affected shards' engines, move the rows
            for c, shard_id, _ in handles:
                c.release_shard(shard_id)
            moved_by_target = self._move(old_map, new_map, plan, journal)
            self._on_step("moved")

            # 4. commit: epoch LWT flips the durable routing truth
            plan.state = PLAN_COMMITTED
            plan.handoff_ms = (time.perf_counter() - t0) * 1e3
            self._persist(new_map, plan, previous_epoch=old_map.epoch)
            self._on_step("committed")
        except Exception as e:
            self._log.exception(
                f"reshard {plan.kind} epoch {plan.epoch_to} failed; "
                "rolling back"
            )
            plan.state = PLAN_ABORTED
            plan.error = f"{type(e).__name__}: {e}"
            try:
                self._rollback_moves(old_map, new_map, plan, journal)
            finally:
                # a fence is permanent on its context (the flag never
                # clears), so every affected handle must be RELEASED —
                # re-acquisition below builds fresh, unfenced contexts
                # under new leases; merely unpausing a fenced handle
                # would brick its shard until host restart
                for c, shard_id, _ in handles:
                    try:
                        c.release_shard(shard_id)
                    except Exception:
                        self._log.exception(
                            f"release of shard {shard_id} failed in "
                            "rollback"
                        )
                for c in self.controllers:
                    self._set_resolver_map(c, old_map, previous=None)
                    c.acquire_shards()
            try:
                self._persist(old_map, plan, previous_epoch=old_map.epoch)
            except Exception:
                self._log.exception("reshard abort record write failed")
            self.metrics.inc("reshard_rollbacks")
            raise ReshardError(plan.error) from e

        # 5. flip every host's resolver (brief dual-read window), let
        #    controllers re-acquire under the new epoch, warm the new
        #    owners from the shipped checkpoints, retire the old map
        for c in self.controllers:
            self._set_resolver_map(c, new_map, previous=old_map)
        for c in self.controllers:
            c.acquire_shards()
        plan.pause_ms = (time.perf_counter() - t_fence) * 1e3
        warm_error = None
        try:
            # warm is an optimization: a failing checkpoint plane must
            # not wedge a COMMITTED reconfiguration (cold reads work) —
            # but the failure is raised once the commit is bookkept
            self._warm_new_owners(plan, moved_by_target)
        except Exception as e:
            self._log.exception("post-commit checkpoint warm failed")
            warm_error = e
            plan.error = f"warm: {type(e).__name__}: {e}"
        for c in self.controllers:
            c._resolver.retire_previous_shard_map()
        plan.handoff_ms = (time.perf_counter() - t0) * 1e3
        try:
            self._persist(new_map, plan, previous_epoch=new_map.epoch)
        except Exception:
            pass  # commit already durable; the update is bookkeeping
        self.metrics.gauge("reshard_epoch", new_map.epoch)
        self.metrics.record("handoff_ms", plan.handoff_ms)
        self.metrics.record("reshard_pause_ms", plan.pause_ms)
        self.metrics.inc("reshard_commits")
        self._log.info(
            f"reshard {plan.kind} committed: epoch "
            f"{plan.epoch_from}->{plan.epoch_to}, "
            f"{plan.moved_workflows} workflows / {plan.moved_tasks} tasks "
            f"moved in {plan.handoff_ms:.1f}ms"
        )
        if warm_error is not None:
            raise ReshardError(
                f"reshard {plan.kind} epoch {plan.epoch_to} committed; "
                f"the new owners' warm failed: {plan.error}"
            ) from warm_error
        return plan


def _queue_watermarks(source: int, marks: dict):
    """(transfer watermark, timer watermark) for one drained source
    shard; missing pumps (unowned shard) read as 'move everything'.
    The MINIMUM across active + standby pumps wins: a standby cursor
    behind the active one means those tasks are not yet standby-
    verified — they move with the shard and re-verify on the target
    (idempotent handlers), rather than being stranded behind a
    watermark only the active plane crossed."""
    transfer_marks = [
        mark for name, mark in marks.items()
        if name.startswith("transfer-") and isinstance(mark, int)
    ]
    timer_marks = [
        tuple(mark) for name, mark in marks.items()
        if name.startswith("timer-") and isinstance(mark, (list, tuple))
    ]
    return (
        min(transfer_marks) if transfer_marks else 0,
        min(timer_marks) if timer_marks else (0, 0),
    )
