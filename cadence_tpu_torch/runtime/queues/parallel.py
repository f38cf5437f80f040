"""Dependency-aware parallel queue executor.

"Rethinking State-Machine Replication for Parallelism" (PAPERS.md)
executes non-conflicting SMR commands concurrently because they
commute; the queue planes earn the same right from the proven per-task
effect footprints (``effects.TASK_FOOTPRINTS``, gated bidirectionally
by the analysis gate's queue-effect pass and the effect witness). This
module is that executor — a shared wave scheduler replacing the
one-task-at-a-time drain of ``QueueProcessorBase`` behind the
reference's ``queues.parallelism`` config gate (the Onebox's
``queue_parallel`` here; sequential stays the default):

* **matrix gate** — the executor consumes the versioned commutativity
  matrix artifact (``ensure_conflict_matrix`` → ``PORT_MATRIX_PATH``,
  ``build/torch_queue_conflict_matrix.json``) through
  ``analysis/artifact.load_artifact``, and validates the embedded
  footprint fingerprint against the live declaration at construction.
  A missing/stale/mismatched artifact degrades LOUDLY to sequential
  scheduling: ``parqueue_matrix_stale`` counts it, a warning names the
  regeneration command, and the ``parqueue_degraded`` gauge pins at 1
  so the state can't go unnoticed forever.
* **conflict-keyed waves** — each cycle gathers one generation-stamped
  batch from every registered queue (across shards: one executor
  drains all of a host's transfer/timer pipelines in a shared
  schedule), keys every task by its workflow conflict key(s), and
  union-finds conflict groups: two tasks that share a key conflict per
  the matrix's ``same_workflow`` verdict; disjoint-key tasks conflict
  only when one side declares an *untargeted* cross-workflow fan-out
  (``xwf.*`` whose victim is not named on the task row — a
  CloseExecution's parent-close-policy sweep). Targeted ``xwf``
  types (cancel/signal/start-child) take multi-workflow keys
  {self, target} instead of serializing the whole batch.
* **ordered groups, concurrent waves** — each conflict group runs its
  tasks in read order; distinct groups run concurrently on a bounded
  worker pool. Per-task execution is the exact sequential attempt
  loop (``run_task_attempts``): effect-scope attribution, fault-
  injection hooks, defer/park and retry semantics are shared, not
  forked.
* **generation fencing** — batches are collected under the ack
  manager's read generation; a rewind (failover handover, reshard
  fence) between collect and execution rejects the stale portion of a
  wave WHOLE (``parqueue_stale_skipped``), the same discipline the
  sequential pump applies per batch.

A copy of the reference package's ``runtime/queues/parallel.py``. The
port writes its matrix artifact at ``PORT_MATRIX_PATH`` (under the
checkout's ``build/``, beside and never over the reference package's
``build/queue_conflict_matrix.json``) and regenerates it with
``ensure_conflict_matrix``; the port's analysis gate writes the same
document plus its AST-extracted ``ms_columns`` (``python -m
cadence_tpu_torch.analysis --emit-conflict-matrix``).
"""

from __future__ import annotations

import os
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, List, Optional, Tuple

from ...utils.locks import make_guarded, make_lock
from ...utils.log import get_logger
from ...utils.metrics import NOOP

from .effects import (
    CONFLICT_MATRIX_SCHEMA,
    build_conflict_matrix,
    footprints_fingerprint,
    plane_of,
    task_type_name,
)

# xwf effects whose victim workflow is NAMED on the task row (the
# transfer task carries target_domain_id/target_workflow_id): the
# scheduler keys the task by {self, target} instead of serializing it
# against the whole batch. Every other xwf effect (parent-close-policy
# terminate/cancel sweeps, child-close notification) targets workflows
# the task row does not name — those stay sequential against anything
# that touches workflow state.
_TARGETED_XWF = frozenset({
    "xwf.request_cancel", "xwf.signal", "xwf.start_child",
})

# the port's conflict-matrix artifact: under the checkout's build/, at a
# name of its own (the reference package's lint gate owns
# build/queue_conflict_matrix.json)
PORT_MATRIX_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "build", "torch_queue_conflict_matrix.json",
)


def ensure_conflict_matrix(path: str) -> str:
    """(Re)generate the conflict-matrix artifact at ``path`` when it is
    missing, unreadable, or fingerprint-stale against the live footprint
    table — consumers (the topology cells, the smoke run) call this so
    they never gate on an artifact an older checkout left behind.
    Returns ``path``. It writes the runtime-derived document; the
    analysis gate's ``--emit-conflict-matrix`` writes the same document
    plus an AST-extracted ``ms_columns`` annotation."""
    from ...analysis import artifact

    try:
        doc = artifact.load_artifact(path, kind=CONFLICT_MATRIX_SCHEMA)
        if doc.get("fingerprint") == footprints_fingerprint():
            return path
    except Exception:
        pass
    artifact.write_artifact(path, CONFLICT_MATRIX_SCHEMA,
                            build_conflict_matrix())
    return path


class ConflictMatrix:
    """Pairwise commute/conflict verdicts, validated against the live
    footprint table. Construct via :meth:`load` (artifact path) or
    :meth:`live` (in-process, trivially fresh)."""

    def __init__(self, doc: Dict) -> None:
        fp = doc.get("fingerprint")
        live = footprints_fingerprint()
        if fp != live:
            raise ValueError(
                f"conflict matrix fingerprint {fp!r} does not match the "
                f"live footprint table ({live!r}) — regenerate with "
                "runtime.queues.parallel.ensure_conflict_matrix"
            )
        surfaces: Dict[str, str] = doc["surfaces"]
        # label → (touches workflow state, has untargeted xwf,
        #          has targeted xwf)
        self._types: Dict[str, Tuple[bool, bool, bool]] = {}
        for label, f in doc["footprints"].items():
            xwf = set(f["cross_workflow"])
            touches = bool(xwf) or any(
                surfaces.get(s) == "workflow"
                for s in set(f["reads"]) | set(f["writes"])
            )
            self._types[label] = (
                touches,
                bool(xwf - _TARGETED_XWF),
                bool(xwf & _TARGETED_XWF),
            )
        # unordered pair → same-workflow verdict is "conflict"
        self._same_conflict: Dict[Tuple[str, str], bool] = {}
        for p in doc["pairs"]:
            key = (p["a"], p["b"]) if p["a"] <= p["b"] else (p["b"], p["a"])
            self._same_conflict[key] = p["same_workflow"] == "conflict"

    @classmethod
    def load(cls, path: str) -> "ConflictMatrix":
        from ...analysis import artifact

        return cls(artifact.load_artifact(path, kind=CONFLICT_MATRIX_SCHEMA))

    @classmethod
    def live(cls) -> "ConflictMatrix":
        return cls(build_conflict_matrix())

    def known(self, label: str) -> bool:
        return label in self._types

    def touches_workflow_state(self, label: str) -> bool:
        info = self._types.get(label)
        return True if info is None else info[0]

    def untargeted_xwf(self, label: str) -> bool:
        """Whether ``label`` fans out to workflows its task row does not
        name (unknown types count: they must serialize)."""
        info = self._types.get(label)
        return True if info is None else info[1]

    def targeted_xwf(self, label: str) -> bool:
        info = self._types.get(label)
        return False if info is None else info[2]

    def same_workflow_conflict(self, a: str, b: str) -> bool:
        """Conflict verdict for two tasks sharing a workflow conflict
        key; unknown pairs conflict (safe default)."""
        key = (a, b) if a <= b else (b, a)
        return self._same_conflict.get(key, True)


class _SchedTask:
    """One collected task with its scheduling attributes."""

    __slots__ = ("slot", "task", "key", "gen", "order", "label", "keys",
                 "untargeted", "touches")

    def __init__(self, slot, task, key, gen, order, matrix: ConflictMatrix):
        self.slot = slot
        self.task = task
        self.key = key
        self.gen = gen
        self.order = order  # (queue index, read position): group order
        plane = slot.plane
        label = f"{plane}:{task_type_name(plane, getattr(task, 'task_type', ''))}" \
            if plane is not None else f"?:{getattr(task, 'task_type', '')}"
        self.label = label
        self.untargeted = matrix.untargeted_xwf(label)
        self.touches = matrix.touches_workflow_state(label)
        wf = (getattr(task, "domain_id", None),
              getattr(task, "workflow_id", None))
        keys = {wf}
        if matrix.targeted_xwf(label):
            target_wf = getattr(task, "target_workflow_id", "")
            if target_wf:
                keys.add((
                    getattr(task, "target_domain_id", "") or wf[0],
                    target_wf,
                ))
            else:
                # a targeted xwf type whose row names no victim: fall
                # back to serializing (the fan-out could land anywhere)
                self.untargeted = True
        self.keys = keys


class _Slot:
    """One registered queue processor."""

    __slots__ = ("proc", "plane")

    def __init__(self, proc) -> None:
        self.proc = proc
        self.plane = plane_of(proc.name)


class ParallelQueueExecutor:
    """Shared conflict-keyed wave scheduler over many queue pumps.

    Queues register at ``start()`` (``QueueProcessorBase`` /
    ``TimerQueueProcessor`` with ``executor=`` set); one pump thread
    then drains every registered queue in shared cycles. Sequential
    semantics are preserved group-by-group: a conflict group's tasks
    run in read order, only provably-commuting groups overlap.
    """

    def __init__(
        self,
        parallelism: int = 4,
        batch_size: int = 64,
        poll_interval_s: float = 0.05,
        matrix_path: Optional[str] = None,
        matrix: Optional[ConflictMatrix] = None,
        metrics=None,
    ) -> None:
        self._log = get_logger("cadence_tpu_torch.queue.parallel")
        self._metrics = (metrics or NOOP).tagged(
            service="history_queue", queue="parallel"
        )
        self._parallelism = max(1, int(parallelism))
        self._batch_size = batch_size
        self._poll_interval = poll_interval_s
        self._lock = make_lock("ParallelQueueExecutor._lock")
        self._slots: List[_Slot] = make_guarded(
            [], "ParallelQueueExecutor._slots", self._lock
        )
        self._notify = threading.Event()
        self._stopped = threading.Event()
        self._started = False
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pump_thread: Optional[threading.Thread] = None
        # local counters mirrored to metrics (bench/tests read these
        # without a registry round-trip)
        self.cycles = 0
        self.tasks = 0
        self.waves = 0
        self.stale_skipped = 0

        self.matrix: Optional[ConflictMatrix] = None
        self.degraded_reason: Optional[str] = None
        try:
            if matrix is not None:
                self.matrix = matrix
            elif matrix_path is not None:
                self.matrix = ConflictMatrix.load(matrix_path)
            else:
                self.matrix = ConflictMatrix.live()
        except Exception as e:
            # LOUD degrade, not silent-forever: counted, gauged, and
            # logged with the regeneration command. Scheduling falls
            # back to one sequential group per cycle.
            self.degraded_reason = f"{type(e).__name__}: {e}"
            self._metrics.inc("parqueue_matrix_stale")
            self._log.warn(
                f"conflict matrix unusable ({self.degraded_reason}) — "
                "parallel queue executor DEGRADED to sequential "
                "scheduling; regenerate the artifact with "
                "ensure_conflict_matrix"
            )
        self._metrics.gauge(
            "parqueue_degraded", 1 if self.degraded else 0
        )

    @property
    def degraded(self) -> bool:
        return self.matrix is None

    # -- registration --------------------------------------------------

    def register(self, proc) -> None:
        with self._lock:
            if all(s.proc is not proc for s in self._slots):
                self._slots.append(_Slot(proc))
            n = len(self._slots)
        self._metrics.gauge("parqueue_queues", n)
        self._notify.set()

    def unregister(self, proc) -> None:
        with self._lock:
            # guarded containers track mutations, not identity filters:
            # rebuild in place
            keep = [s for s in self._slots if s.proc is not proc]
            del self._slots[:]
            self._slots.extend(keep)
            n = len(self._slots)
        self._metrics.gauge("parqueue_queues", n)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ParallelQueueExecutor":
        if self._started:
            return self
        self._started = True
        self._pool = ThreadPoolExecutor(
            max_workers=self._parallelism,
            thread_name_prefix="parqueue-worker",
        )
        self._pump_thread = threading.Thread(
            target=self._pump, name="parqueue-pump", daemon=True
        )
        self._pump_thread.start()
        return self

    def notify(self) -> None:
        self._notify.set()

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        self._notify.set()
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    # -- pump ----------------------------------------------------------

    def _pump(self) -> None:
        while not self._stopped.is_set():
            try:
                worked = self._cycle()
            except Exception:
                self._log.exception("parallel queue cycle failed")
                worked = False
            if self._stopped.is_set():
                return
            if not worked:
                self._notify.wait(timeout=self._poll_interval)
                self._notify.clear()

    def _cycle(self) -> bool:
        """One shared wave cycle over every registered queue. Returns
        True when any task was collected (the pump loops immediately:
        full batches mean more work is waiting)."""
        with self._lock:
            slots = list(self._slots)
        if not slots:
            return False
        t0 = _time.perf_counter()
        collected_from = []
        try:
            return self._collect_and_run(slots, collected_from, t0)
        finally:
            # every queue that handed over a batch learns it ran: its
            # reshard fence waits for this (QueueProcessorBase.drain)
            for slot in collected_from:
                done = getattr(slot.proc, "parallel_done", None)
                if done is not None:
                    done()

    def _collect_and_run(self, slots, collected_from, t0) -> bool:
        matrix = self.matrix
        sched: List[_SchedTask] = []
        for qi, slot in enumerate(slots):
            try:
                batch, gen = slot.proc.parallel_collect(self._batch_size)
            except Exception:
                self._log.exception(
                    f"queue {slot.proc.name} collect failed"
                )
                continue
            if not batch:
                continue
            collected_from.append(slot)
            if matrix is None:
                for pos, (task, key) in enumerate(batch):
                    sched.append(_DegradedTask(slot, task, key, gen,
                                               (qi, pos)))
            else:
                for pos, (task, key) in enumerate(batch):
                    sched.append(_SchedTask(slot, task, key, gen,
                                            (qi, pos), matrix))
        if not sched:
            return False

        groups = self._plan(sched) if matrix is not None else [sched]
        self._execute(groups)

        self.cycles += 1
        self.tasks += len(sched)
        self.waves += len(groups)
        self._metrics.inc("parqueue_cycles")
        self._metrics.inc("parqueue_tasks", len(sched))
        self._metrics.inc("parqueue_waves", len(groups))
        self._metrics.record("parqueue_wave_width", len(groups))
        self._metrics.record(
            "parqueue_conflict_frac",
            1.0 - (len(groups) / len(sched)) if sched else 0.0,
        )
        self._metrics.record(
            "parqueue_cycle_latency", _time.perf_counter() - t0
        )
        for slot in collected_from:
            proc = slot.proc
            from .base import sweep_ack

            sweep_ack(proc.ack, self._log, proc.name)
            scope = getattr(proc, "_metrics", None)
            if scope is not None:
                scope.gauge("task_outstanding", proc.ack.outstanding())
                scope.gauge("task_held", proc.ack.held())
        return True

    # -- scheduling ----------------------------------------------------

    def _plan(self, sched: List[_SchedTask]) -> List[List[_SchedTask]]:
        """Partition one cycle's tasks into conflict groups (union-find
        over the pairwise conflict relation). Group-internal order is
        read order; distinct groups provably commute."""
        n = len(sched)
        parent = list(range(n))

        def find(i: int) -> int:
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        def union(i: int, j: int) -> None:
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[rj] = ri

        matrix = self.matrix
        # (1) shared conflict keys: full pairwise check inside each key
        # bucket — buckets are per-workflow, so they stay small; a
        # union-with-last shortcut can miss an edge when a commuting
        # predecessor pair both conflict a newcomer
        buckets: Dict[object, List[int]] = {}
        for i, t in enumerate(sched):
            for k in t.keys:
                buckets.setdefault(k, []).append(i)
        for members in buckets.values():
            for ai in range(len(members)):
                for bi in range(ai + 1, len(members)):
                    a, b = sched[members[ai]], sched[members[bi]]
                    if find(members[ai]) == find(members[bi]):
                        continue
                    if matrix.same_workflow_conflict(a.label, b.label):
                        union(members[ai], members[bi])
        # (2) untargeted cross-workflow fan-out serializes against every
        # task touching workflow state, keys notwithstanding
        fanout = [i for i, t in enumerate(sched) if t.untargeted]
        if fanout:
            for i in fanout:
                for j, t in enumerate(sched):
                    if i != j and (t.touches or t.untargeted):
                        union(i, j)
        groups: Dict[int, List[_SchedTask]] = {}
        for i, t in enumerate(sched):
            groups.setdefault(find(i), []).append(t)
        out = list(groups.values())
        for g in out:
            g.sort(key=lambda t: t.order)
        out.sort(key=lambda g: g[0].order)
        return out

    # -- execution -----------------------------------------------------

    def _execute(self, groups: List[List[_SchedTask]]) -> None:
        if len(groups) == 1 or self._pool is None:
            for g in groups:
                self._run_group(g)
            return
        futures = [
            self._pool.submit(self._run_group, g) for g in groups[1:]
        ]
        self._run_group(groups[0])
        wait(futures)

    def _run_group(self, group: List[_SchedTask]) -> None:
        """One conflict group, in read order. A queue whose ack
        generation moved since collect (rewind: failover handover,
        reshard fence) has this wave's rewound tasks rejected —
        executing them would race the span's re-read on the new cursor.
        A task the rewind kept (at or below its level: ``ack.holds``)
        still runs; skipped, it would stay in flight for good."""
        stale = {}
        for t in group:
            if self._stopped.is_set():
                return
            proc = t.slot.proc
            fresh = stale.get(id(proc))
            if fresh is None:
                fresh = proc.ack.generation() == t.gen
                stale[id(proc)] = fresh
            if not fresh and not proc.ack.holds(t.key, t.gen):
                self.stale_skipped += 1
                self._metrics.inc("parqueue_stale_skipped")
                continue
            try:
                proc.parallel_run(t.task, t.key)
            except Exception:
                self._log.exception(
                    f"queue {proc.name} task {t.key} wave execution failed"
                )


class _DegradedTask:
    """Schedule entry for degraded (matrix-less) cycles: no conflict
    attributes, everything rides one sequential group."""

    __slots__ = ("slot", "task", "key", "gen", "order")

    def __init__(self, slot, task, key, gen, order) -> None:
        self.slot = slot
        self.task = task
        self.key = key
        self.gen = gen
        self.order = order
