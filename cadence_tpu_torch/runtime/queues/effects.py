"""Queue-task effect footprints + the task-type commutativity matrix.

The dependency-aware parallel queue (ROADMAP) needs a machine-checked
answer to "which queue-task pairs commute?" — the same commutativity
argument "Rethinking State-Machine Replication for Parallelism" uses to
run non-conflicting SMR commands in parallel. This module is the single
source of truth both sides of that proof share:

* **declared footprints** (``TASK_FOOTPRINTS``) — per (plane, task
  type), which persistence *surfaces* the handler reads/writes and
  which cross-workflow effects it fans out. Analysis Pass 5 (the
  reference package's ``analysis/queue_effects.py``) AST-extracts the
  real handlers and fails the gate when a handler touches persistence
  outside its declaration (``QUEUE-CONFLICT-UNDECLARED``) or fans out
  across workflows without declaring it (``QUEUE-CROSS-WF``);
* **the runtime witness hook** (``task_effect_scope`` +
  ``record_persistence_call``) — the chaos suites install an effect
  recorder (testing/effect_witness.py rides ``wrap_bundle`` like the
  fault client) and every persistence call made while a queue task is
  executing is attributed to that task's (plane, type). The witness
  checker then asserts recorded ⊆ static — the dynamic half of the
  bidirectional proof, run under the ≥10% write-fault storm;
* **the conflict matrix** (``build_conflict_matrix``) — pairwise
  commute/conflict verdicts derived from the footprints, emitted as a
  versioned JSON artifact by ``analysis --emit-conflict-matrix``. The
  future parallel-queue executor gates on this artifact exactly like
  the replay kernel gates on ``--emit-matrix``.

Surface model. Effects are keyed by *surface*, each with a scope that
decides how same-surface touches compose:

* ``workflow`` — rows keyed by (domain, workflow, run): two tasks
  touching the surface conflict only when they target the same
  workflow;
* ``read_shared`` — read-only shared state (domain records): reads
  always commute;
* ``counter`` — commuting read-modify-write (the shard task-id
  sequencer): increments commute with each other, the canonical
  "disjoint up to commuting operations" carve-out.

Cross-workflow effects (``xwf.*``) break per-workflow conflict keying:
a CloseExecution's parent-close-policy fan-out may terminate ANY child
workflow, so it conflicts with every task that touches workflow-scoped
state on a distinct workflow — which is why the matrix carries separate
same-workflow and distinct-workflow verdicts.

A copy of the reference package's ``runtime/queues/effects.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from typing import Dict, FrozenSet, Iterable, Optional, Tuple

from ...core.enums import TimerTaskType, TransferTaskType

# surface name → scope (see module docstring)
SURFACES: Dict[str, str] = {
    "execution": "workflow",     # mutable-state rows (update/delete/create)
    "current_run": "workflow",   # current-run pointer rows
    "history": "workflow",       # history branch nodes
    "queue_tasks": "workflow",   # transfer/timer/replication task rows
    "task_store": "workflow",    # matching task-list rows (per-wf appends)
    "visibility": "workflow",    # per-workflow visibility records
    "checkpoint": "workflow",    # replay checkpoints
    "archival": "workflow",      # archival fan-out records
    "metadata": "read_shared",   # domain records (handlers only read)
    "shard_seq": "counter",      # shard sequencer / lease row (id minting)
}

# cross-workflow effect vocabulary (the xwf.* names Pass 5 extracts)
XWF_EFFECTS = frozenset({
    "xwf.record_child_close",  # notify parent of a child close
    "xwf.terminate",           # parent-close-policy terminate
    "xwf.request_cancel",      # parent-close-policy / external cancel
    "xwf.signal",              # external signal delivery
    "xwf.start_child",         # start a child workflow
})


@dataclasses.dataclass(frozen=True)
class Footprint:
    """One task type's declared effect footprint."""

    reads: FrozenSet[str] = frozenset()
    writes: FrozenSet[str] = frozenset()
    cross_workflow: FrozenSet[str] = frozenset()

    def validate(self) -> None:
        for s in self.reads | self.writes:
            if s not in SURFACES:
                raise ValueError(f"footprint: unknown surface {s!r}")
        for x in self.cross_workflow:
            if x not in XWF_EFFECTS:
                raise ValueError(f"footprint: unknown xwf effect {x!r}")


def _fp(reads: Iterable[str] = (), writes: Iterable[str] = (),
        cross: Iterable[str] = ()) -> Footprint:
    return Footprint(frozenset(reads), frozenset(writes), frozenset(cross))


# effects every queue task pays before its handler runs (domain-owner
# classification via the allocator/domain cache) — merged into the
# declared footprint by effective_footprint(), NOT part of the per-type
# declaration the static extractor diffs handler bodies against
PLANE_COMMON_READS = frozenset({"metadata"})

# the active-side event-mint footprint: an engine transaction close
# persists the execution row + minted task rows with ids from the shard
# sequencer, and appends the minted events to the history branch
_MINT_W = ("execution", "history", "queue_tasks", "shard_seq")

# retention-driven deletion (shared by the active + standby timer planes)
_RETENTION = _fp(
    reads=("execution",),
    writes=("execution", "current_run", "visibility", "history"),
)

# verification-only standby handler: reads replicated state, no writes
_VERIFY = _fp(reads=("execution",))

_NOOP = _fp()

# (plane, task type name) → declared footprint. Planes mirror the
# processor families: "transfer"/"timer" are the active pipelines,
# "*-standby" the per-cluster verification twins, "replication" the
# NDC apply path (pseudo task types — it is not task-type dispatched).
TASK_FOOTPRINTS: Dict[Tuple[str, str], Footprint] = {
    # -- transfer (active) ---------------------------------------------
    ("transfer", "DecisionTask"): _fp(
        reads=("execution",), writes=("task_store",)),
    ("transfer", "ActivityTask"): _fp(
        reads=("execution",), writes=("task_store",)),
    ("transfer", "CloseExecution"): _fp(
        # reads its own close batch; visibility+archival on itself; the
        # parent notify + parent-close-policy fan-out mint events on
        # OTHER workflows (the implied _MINT_W surfaces ride in writes
        # so the witness can attribute the fan-out's persistence calls)
        reads=("execution", "history"),
        writes=("visibility", "archival") + _MINT_W,
        cross=("xwf.record_child_close", "xwf.terminate",
               "xwf.request_cancel")),
    ("transfer", "CancelExecution"): _fp(
        reads=("execution",), writes=_MINT_W,
        cross=("xwf.request_cancel",)),
    ("transfer", "SignalExecution"): _fp(
        reads=("execution",), writes=_MINT_W,
        cross=("xwf.signal",)),
    ("transfer", "StartChildExecution"): _fp(
        # reads the initiated event; the child start creates execution +
        # current rows (on the child); started/failed recorded on self
        reads=("execution", "history"),
        writes=("current_run", "task_store", "visibility") + _MINT_W,
        cross=("xwf.start_child",)),
    ("transfer", "RecordWorkflowStarted"): _fp(
        reads=("execution",), writes=("visibility",)),
    ("transfer", "UpsertWorkflowSearchAttributes"): _fp(
        reads=("execution",), writes=("visibility",)),
    ("transfer", "ResetWorkflow"): _NOOP,
    # -- timer (active) ------------------------------------------------
    ("timer", "UserTimer"): _fp(reads=("execution",), writes=_MINT_W),
    ("timer", "ActivityTimeout"): _fp(
        reads=("execution",), writes=_MINT_W),
    ("timer", "DecisionTimeout"): _fp(
        reads=("execution",), writes=_MINT_W),
    ("timer", "WorkflowTimeout"): _fp(
        # cron/retry restart reads the first event for the relaunch
        reads=("execution", "history"), writes=_MINT_W),
    ("timer", "ActivityRetryTimer"): _fp(
        reads=("execution",), writes=("task_store",)),
    ("timer", "WorkflowBackoffTimer"): _fp(
        reads=("execution",), writes=_MINT_W),
    ("timer", "DeleteHistoryEvent"): _RETENTION,
    # -- transfer standby (verify-and-discharge) -----------------------
    ("transfer-standby", "DecisionTask"): _VERIFY,
    ("transfer-standby", "ActivityTask"): _VERIFY,
    ("transfer-standby", "CloseExecution"): _fp(
        reads=("execution",), writes=("visibility",)),
    ("transfer-standby", "CancelExecution"): _VERIFY,
    ("transfer-standby", "SignalExecution"): _VERIFY,
    ("transfer-standby", "StartChildExecution"): _VERIFY,
    ("transfer-standby", "RecordWorkflowStarted"): _fp(
        reads=("execution",), writes=("visibility",)),
    ("transfer-standby", "UpsertWorkflowSearchAttributes"): _fp(
        reads=("execution",), writes=("visibility",)),
    ("transfer-standby", "ResetWorkflow"): _NOOP,
    # -- timer standby -------------------------------------------------
    ("timer-standby", "UserTimer"): _VERIFY,
    ("timer-standby", "ActivityTimeout"): _VERIFY,
    ("timer-standby", "DecisionTimeout"): _VERIFY,
    ("timer-standby", "WorkflowTimeout"): _VERIFY,
    ("timer-standby", "ActivityRetryTimer"): _NOOP,   # active-only
    ("timer-standby", "WorkflowBackoffTimer"): _VERIFY,
    ("timer-standby", "DeleteHistoryEvent"): _RETENTION,
    # -- replication (NDC apply path; pseudo task types) ---------------
    ("replication", "HistoryReplication"): _fp(
        reads=("execution", "history", "current_run", "checkpoint"),
        writes=("execution", "current_run", "history", "queue_tasks",
                "shard_seq", "checkpoint")),
    ("replication", "SnapshotReplication"): _fp(
        reads=("execution", "history", "current_run", "checkpoint"),
        writes=("execution", "current_run", "history", "queue_tasks",
                "shard_seq", "checkpoint")),
    ("replication", "HistoryBackfill"): _fp(
        reads=("execution",), writes=("history", "shard_seq")),
}

for _f in TASK_FOOTPRINTS.values():
    _f.validate()

PLANES = ("transfer", "timer", "transfer-standby", "timer-standby",
          "replication")


def effective_footprint(plane: str, task_type: str) -> Optional[Footprint]:
    """Declared footprint + the plane-common prelude (domain-owner
    classification) — what the runtime witness checks recorded effects
    against; None for an undeclared (plane, type)."""
    base = TASK_FOOTPRINTS.get((plane, task_type))
    if base is None:
        return None
    return Footprint(
        base.reads | PLANE_COMMON_READS, base.writes, base.cross_workflow
    )


# --------------------------------------------------------------------------
# persistence-verb → surface mapping (shared by the witness and Pass 5)
# --------------------------------------------------------------------------

_READ_PREFIXES = ("get_", "list_", "read_", "count_", "describe_")


def verb_effects(manager: str, method: str) -> Tuple[Tuple[str, str], ...]:
    """((surface, "r"|"w"), ...) for one persistence-manager call —
    the canonical name of what a wrapped-bundle invocation touches.
    Unknown managers map to themselves so a new manager surfaces as an
    undeclared effect instead of vanishing."""
    kind = "r" if method.startswith(_READ_PREFIXES) else "w"
    if manager == "metadata":
        return (("metadata", kind),)
    if manager == "visibility":
        return (("visibility", kind),)
    if manager == "task":
        return (("task_store", kind),)
    if manager == "shard":
        return (("shard_seq", kind),)
    if manager == "checkpoint":
        return (("checkpoint", kind),)
    if manager == "history":
        return (("history", kind),)
    if manager == "execution":
        if "current" in method:
            return (("current_run", kind),)
        if ("transfer_task" in method or "timer_task" in method
                or "replication_task" in method or "cross_cluster" in method):
            return (("queue_tasks", kind),)
        if method == "create_workflow_execution":
            # a create writes the state row AND the current-run pointer,
            # plus any minted task rows riding the snapshot
            return (("execution", "w"), ("current_run", "w"),
                    ("queue_tasks", "w"))
        if method in ("update_workflow_execution",
                      "conflict_resolve_workflow_execution"):
            return (("execution", "w"), ("queue_tasks", "w"))
        if method.startswith("reshard_"):
            return (("execution", kind), ("queue_tasks", kind))
        return (("execution", kind),)
    return ((manager, kind),)


# --------------------------------------------------------------------------
# runtime witness hook: task attribution for recorded persistence calls
# --------------------------------------------------------------------------

_SCOPE = threading.local()
_recorder = None  # callable(plane, task_type, manager, method) | None


def set_recorder(cb) -> None:
    """Install (or clear, with None) the process-wide effect recorder.
    Testing-only plumbing: with no recorder, task_effect_scope and
    record_persistence_call are a single module-global check."""
    global _recorder
    _recorder = cb


def plane_of(queue_name: str) -> Optional[str]:
    """Map a processor name ("transfer-standby-west-3", "timer-0",
    "replication") to its footprint plane; None for non-queue scopes."""
    for plane in ("transfer-standby", "timer-standby", "transfer",
                  "timer", "replication"):
        if queue_name == plane or queue_name.startswith(plane + "-"):
            return plane
    return None


def task_type_name(plane: str, task_type) -> str:
    """Footprint key for a task's type: enum member name for the
    transfer/timer planes, the pseudo-type string for replication."""
    try:
        if plane in ("transfer", "transfer-standby"):
            return TransferTaskType(int(task_type)).name
        if plane in ("timer", "timer-standby"):
            return TimerTaskType(int(task_type)).name
    except (ValueError, TypeError):
        pass
    return str(task_type)


class _NoopScope:
    """Shared disabled scope: entering/exiting touches nothing — the
    per-task-attempt cost with no recorder installed is one module
    global check and no allocation (the queue hot path runs this for
    every task in the system)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP_SCOPE = _NoopScope()


class _TaskScope:
    __slots__ = ("_queue_name", "_task_type", "_prev")

    def __init__(self, queue_name: str, task_type) -> None:
        self._queue_name = queue_name
        self._task_type = task_type

    def __enter__(self):
        self._prev = getattr(_SCOPE, "cur", None)
        _SCOPE.cur = (self._queue_name, self._task_type)
        return None

    def __exit__(self, *exc):
        _SCOPE.cur = self._prev
        return False


def task_effect_scope(queue_name: str, task_type):
    """Attribute persistence calls on this thread to one queue task.

    Entered around every queue-task attempt (runtime/queues/base.py
    ``run_task_attempts``) and the NDC apply entry points. Returns the
    shared no-op scope when no recorder is installed (the
    overwhelmingly common case)."""
    if _recorder is None:
        return _NOOP_SCOPE
    return _TaskScope(queue_name, task_type)


def record_persistence_call(manager: str, method: str) -> None:
    """Called by the effect-witness persistence decorator per call;
    drops calls made outside any task scope (pump machinery, ack
    checkpoints, test setup)."""
    cb = _recorder
    if cb is None:
        return
    cur = getattr(_SCOPE, "cur", None)
    if cur is None:
        return
    plane = plane_of(cur[0])
    if plane is None:
        return
    cb(plane, task_type_name(plane, cur[1]), manager, method)


# --------------------------------------------------------------------------
# commutativity matrix
# --------------------------------------------------------------------------

CONFLICT_MATRIX_SCHEMA = "queue_conflict_matrix"


def footprints_fingerprint() -> str:
    """Stable digest of the declared footprint table + surface scopes.

    Embedded in the emitted conflict matrix and re-derived by the
    parallel-queue executor at construction: a matrix artifact whose
    fingerprint does not match the LIVE table was built against a
    different footprint declaration and must not drive scheduling
    (the executor degrades to sequential and counts
    ``parqueue_matrix_stale``)."""
    doc = {
        "surfaces": dict(sorted(SURFACES.items())),
        "footprints": {
            f"{p}:{t}": {
                "reads": sorted(f.reads),
                "writes": sorted(f.writes),
                "cross_workflow": sorted(f.cross_workflow),
            }
            for (p, t), f in sorted(TASK_FOOTPRINTS.items())
        },
    }
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def _conflicting_overlap(a: FrozenSet[str], b: FrozenSet[str]):
    """Shared surfaces whose scope does NOT make same-surface touches
    commute (counter increments and shared reads do)."""
    return sorted(
        s for s in a & b
        if SURFACES.get(s) not in ("counter", "read_shared")
    )


def _touches_workflow_state(f: Footprint) -> bool:
    return any(
        SURFACES.get(s) == "workflow" for s in f.reads | f.writes
    ) or bool(f.cross_workflow)


def pair_verdict(a: Footprint, b: Footprint) -> Dict[str, object]:
    """Commute/conflict verdicts for one task-type pair.

    ``same_workflow``: both tasks target the same workflow — they
    commute iff neither's writes intersect the other's reads∪writes on
    a non-commuting surface. ``distinct_workflows``: workflow-scoped
    surfaces are disjoint rows, so the pair commutes unless either side
    fans out across workflows (the fan-out may target the other task's
    workflow, defeating per-workflow conflict keying)."""
    reasons = []
    ww = _conflicting_overlap(a.writes, b.writes)
    rw = sorted(set(_conflicting_overlap(a.reads, b.writes))
                | set(_conflicting_overlap(b.reads, a.writes)))
    if ww:
        reasons.append(f"write/write overlap: {','.join(ww)}")
    if rw:
        reasons.append(f"read/write overlap: {','.join(rw)}")
    same = "conflict" if reasons else "commute"

    distinct_reasons = []
    if a.cross_workflow and _touches_workflow_state(b):
        distinct_reasons.append(
            f"a fans out cross-workflow ({','.join(sorted(a.cross_workflow))})"
        )
    if b.cross_workflow and _touches_workflow_state(a):
        distinct_reasons.append(
            f"b fans out cross-workflow ({','.join(sorted(b.cross_workflow))})"
        )
    distinct = "conflict" if distinct_reasons else "commute"
    return {
        "same_workflow": same,
        "distinct_workflows": distinct,
        "reasons": reasons + distinct_reasons,
    }


def build_conflict_matrix() -> Dict[str, object]:
    """The full task-type × task-type commutativity matrix as a
    JSON-ready document (wrapped with schema_version by the analysis
    artifact writer). Pairs are unordered; each appears once with
    a <= b in key order."""
    keys = sorted(TASK_FOOTPRINTS)
    labels = [f"{p}:{t}" for p, t in keys]
    fps = {
        f"{p}:{t}": {
            "reads": sorted(effective_footprint(p, t).reads),
            "writes": sorted(f.writes),
            "cross_workflow": sorted(f.cross_workflow),
        }
        for (p, t), f in TASK_FOOTPRINTS.items()
    }
    pairs = []
    for i, ka in enumerate(keys):
        for kb in keys[i:]:
            v = pair_verdict(TASK_FOOTPRINTS[ka], TASK_FOOTPRINTS[kb])
            pairs.append({
                "a": f"{ka[0]}:{ka[1]}",
                "b": f"{kb[0]}:{kb[1]}",
                **v,
            })
    return {
        "surfaces": dict(SURFACES),
        "task_types": labels,
        "footprints": fps,
        "pairs": pairs,
        "fingerprint": footprints_fingerprint(),
    }
