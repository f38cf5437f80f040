"""Runtime concurrency sanitizer: lock-order + guarded-state race
witness, cross-validated against the static Pass 3 lock graph.

Pass 3 (``cadence_tpu_torch/analysis/lock_order.py``) proves lock discipline
by AST reading — and carries a baseline of intentional findings whose
justifications nobody had ever re-verified under execution. This module
is the dynamic half, mirroring the effect-witness pattern
(static footprint table + chaos-time recorder):

* ``RaceWitness`` — the tracker installed by
  ``utils/locks.wrap_locks``. Every tracked-lock acquisition feeds a
  **runtime lock-order graph** (with acquiring site + thread), every
  release a **held-duration** record, every guarded-container access a
  **lockset observation**, and every blocking operation performed
  while a tracked lock is held a **blocking observation**. Blocking
  ops reach the witness three ways: the ``SanitizerProbeClient``
  persistence decorator (``wrap_bundle(sanitize=True)``), and the
  patched ``time.sleep`` / ``queue.Queue.get``/``put`` /
  ``threading.Thread.join`` entry points installed by
  ``install()`` (all restored by ``uninstall()``; nothing is patched
  outside sanitizer mode).

Runtime rules (all reported as the same ``Finding`` objects the static
gate uses, so waivers ride the identical fnmatch machinery):

* **RUNTIME-LOCK-INVERSION** — the observed acquisition graph contains
  both A→B and B→A; reported with both threads' acquisition sites.
* **RUNTIME-LOCK-BLOCKING** — store I/O / sleep / join / a blocking
  queue op executed while a tracked lock was held. Anchored
  ``module:Class.method:lockattr:op`` — the same shape as Pass 3's
  LOCK-BLOCKING anchors, so a baselined static entry
  (``analysis/lock_baseline.json``) waives its runtime twin AND is
  thereby annotated *observed* in the ``--emit-lock-graph`` artifact.
* **GUARDED-FIELD-RACE** — an access to a declared guarded field
  (``utils/locks.make_guarded``) without the guarding lock held, from
  a second thread (or from the first thread after the field went
  shared). Eraser's lockset discipline specialized to a declared
  guard.
* **RUNTIME-EDGE-UNKNOWN** — cross-validation: a runtime-observed lock
  edge with no counterpart in the static Pass 3 graph means the static
  scan has a coverage hole (dynamic dispatch, callback indirection);
  either the static pass grows the edge or the hole is waived with a
  written justification in ``analysis/sanitizer_waivers.json``.

``check_race_witness`` is the gate: findings minus waivers (sanitizer
waiver file + the static lock baseline for blocking twins) must be
empty — enforced by the tier-1 sanitized Onebox test and the
``CHAOS_SANITIZE=1`` chaos sweep.

A copy of the reference package's ``testing/race_witness.py``: lock and
field names carry the port's module paths, the gate reads the port's own
waiver and baseline files (``DEFAULT_WAIVERS``, ``DEFAULT_BASELINE``) and
cross-validates against the port's static graph.
"""

from __future__ import annotations

import fnmatch
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..analysis.findings import Baseline, Finding, dedupe
from ..runtime.persistence.decorators import _Wrapped
from ..utils import locks

# the declared guarded-field table: short field name → guard short
# name, per owning class. Documentation + machine check: the sanitized
# Onebox test asserts every field here was actually REGISTERED (its
# make_guarded construction site ran) so the table can't silently rot.
GUARDED_FIELDS: Dict[str, str] = {
    "ShardContext._remote_cluster_time": "ShardContext._lock",
    "ShardContext._remote_time_listeners": "ShardContext._lock",
    "QueueAckManager._outstanding": "QueueAckManager._lock",
    "DomainCache._by_id": "DomainCache._lock",
    "DomainCache._by_name": "DomainCache._lock",
    "DomainCache._active_cluster": "DomainCache._lock",
    "MemoryCheckpointStore._rows": "MemoryCheckpointStore._lock",
    "MemoryCheckpointStore._tree": "MemoryCheckpointStore._lock",
    "MemoryShardManager._shards": "MemoryShardManager._lock",
    "MatchingEngine._managers": "MatchingEngine._lock",
    "MatchingEngine._creating": "MatchingEngine._lock",
    "MatchingEngine._pending_queries": "MatchingEngine._query_lock",
    "TaskWriter._queue": "TaskWriter._lock",
    "Registry._counters": "Registry._lock",
    "Registry._gauges": "Registry._lock",
    "Registry._timers": "Registry._lock",
    # continuous-batching serving engine (cadence_tpu_torch/serving/): the
    # lane table, key index, and the fair-admission parked table all
    # ride ONE lock (the engine's — FairAdmissionQueue never acquires,
    # its callers hold the guard); packing/device steps/flushes never
    # run while it is held
    "ResidentEngine._slots": "ResidentEngine._lock",
    "ResidentEngine._by_key": "ResidentEngine._lock",
    "FairAdmissionQueue._parked": "ResidentEngine._lock",
    # capacity autopilot (runtime/autopilot.py): the rate setpoints and
    # the per-actuator cooldown table are written by the epoch thread
    # and read by the admin status/pause verbs
    "CapacityController._rates": "CapacityController._lock",
    "CapacityController._cooldowns": "CapacityController._lock",
    # parallel queue executor (runtime/queues/parallel.py): the slot
    # table is written by register/unregister (service threads) and
    # snapshotted by the pump; the lock is NEVER held across queue
    # collect/run calls, so the executor adds no lock-graph edges
    "ParallelQueueExecutor._slots": "ParallelQueueExecutor._lock",
}


class _EdgeObs:
    __slots__ = ("count", "thread", "holder_site", "acquire_site")

    def __init__(self, thread, holder_site, acquire_site):
        self.count = 1
        self.thread = thread
        self.holder_site = holder_site
        self.acquire_site = acquire_site


class _BlockObs:
    __slots__ = ("count", "kind", "detail")

    def __init__(self, kind, detail):
        self.count = 1
        self.kind = kind
        self.detail = detail


class _GuardObs:
    __slots__ = ("guard", "first_thread", "threads", "unheld")

    def __init__(self, guard):
        self.guard = guard
        self.first_thread = None
        self.threads: Set[int] = set()
        # anchor → (writing, thread, shared_at_access)
        self.unheld: Dict[str, Tuple[bool, int, bool]] = {}


def _short(lock_name: str) -> str:
    """"cadence_tpu_torch/runtime/shard.py:ShardContext._lock" → "_lock"."""
    return lock_name.rsplit(":", 1)[-1].rsplit(".", 1)[-1]


class RaceWitness:
    """The runtime tracker. Install with ``install()`` (or use as a
    context manager); everything constructed through the
    ``utils/locks`` factory afterwards reports here."""

    def __init__(self) -> None:
        # a RAW threading.Lock on purpose: the witness must never
        # trace itself
        self._mu = threading.Lock()
        self._edges: Dict[Tuple[str, str], _EdgeObs] = {}
        self._acquire_sites: Dict[str, Set[str]] = {}
        self._holds: Dict[str, Tuple[int, float]] = {}  # count, max_s
        self._blocking: Dict[str, _BlockObs] = {}       # anchor → obs
        self._guards: Dict[str, _GuardObs] = {}         # field → obs
        self._registered_guards: Dict[str, str] = {}
        self._patched = False
        self._orig: Dict[str, object] = {}

    # -- tracker callbacks (from utils/locks) --------------------------

    def on_acquire(self, lock, entry, prior) -> None:
        anchor = locks.site_anchor(entry.site)
        tid = threading.get_ident()
        with self._mu:
            self._acquire_sites.setdefault(lock.name, set()).add(anchor)
            if prior is not None and prior.lock.name != lock.name:
                key = (prior.lock.name, lock.name)
                obs = self._edges.get(key)
                if obs is None:
                    self._edges[key] = _EdgeObs(
                        tid,
                        locks.site_anchor(prior.site),
                        anchor,
                    )
                else:
                    obs.count += 1

    def on_release(self, lock, entry, held_s: float) -> None:
        with self._mu:
            count, mx = self._holds.get(lock.name, (0, 0.0))
            self._holds[lock.name] = (count + 1, max(mx, held_s))

    def on_blocking(self, entry, kind: str, detail: str) -> None:
        op = detail.rsplit(".", 1)[-1]
        anchor = (
            f"{locks.site_anchor(entry.site)}:"
            f"{_short(entry.lock.name)}:{op}"
        )
        with self._mu:
            obs = self._blocking.get(anchor)
            if obs is None:
                self._blocking[anchor] = _BlockObs(kind, detail)
            else:
                obs.count += 1

    def on_guard_registered(self, field: str, guard_name: str) -> None:
        with self._mu:
            self._registered_guards[field] = guard_name
            if field not in self._guards:
                self._guards[field] = _GuardObs(guard_name)

    def on_guarded_access(self, field: str, held: bool, writing: bool,
                          site) -> None:
        tid = threading.get_ident()
        with self._mu:
            obs = self._guards.get(field)
            if obs is None:
                obs = self._guards[field] = _GuardObs("")
            if obs.first_thread is None:
                obs.first_thread = tid
            obs.threads.add(tid)
            if not held and site is not None:
                anchor = locks.site_anchor(site)
                new = (writing, tid, len(obs.threads) > 1)
                cur = obs.unheld.get(anchor)

                def _exempt(t):
                    # matches the findings() exemption: owner thread,
                    # before the field ever went shared
                    return t[1] == obs.first_thread and not t[2]

                # keep the WORST observation per site: an exempt
                # init-time record must not mask a later genuine race
                # at the same anchor (second thread, or post-sharing)
                if cur is None or (_exempt(cur) and not _exempt(new)):
                    obs.unheld[anchor] = new

    # -- install / uninstall -------------------------------------------

    def install(self) -> "RaceWitness":
        locks.wrap_locks(self)
        if not self._patched:
            self._orig = {
                "sleep": time.sleep,
                "qget": queue.Queue.get,
                "qput": queue.Queue.put,
                "join": threading.Thread.join,
            }
            orig_sleep = self._orig["sleep"]
            orig_qget = self._orig["qget"]
            orig_qput = self._orig["qput"]
            orig_join = self._orig["join"]

            def _sleep(seconds):
                locks.note_blocking("sleep", "time.sleep")
                return orig_sleep(seconds)

            def _qget(q, block=True, timeout=None):
                if block and timeout != 0:
                    locks.note_blocking("queue", "Queue.get")
                return orig_qget(q, block, timeout)

            def _qput(q, item, block=True, timeout=None):
                if block and timeout != 0:
                    locks.note_blocking("queue", "Queue.put")
                return orig_qput(q, item, block, timeout)

            def _join(thread, timeout=None):
                locks.note_blocking("join", "Thread.join")
                return orig_join(thread, timeout)

            time.sleep = _sleep
            queue.Queue.get = _qget
            queue.Queue.put = _qput
            threading.Thread.join = _join
            self._patched = True
        return self

    def uninstall(self) -> None:
        locks.unwrap_locks()
        if self._patched:
            time.sleep = self._orig["sleep"]
            queue.Queue.get = self._orig["qget"]
            queue.Queue.put = self._orig["qput"]
            threading.Thread.join = self._orig["join"]
            self._patched = False

    def __enter__(self) -> "RaceWitness":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- report / findings ---------------------------------------------

    def observed_edges(self) -> List[Tuple[str, str]]:
        with self._mu:
            return sorted(self._edges)

    def registered_guard_fields(self) -> Dict[str, str]:
        """{full field name → guard name} for every make_guarded site
        that actually constructed a proxy under this witness."""
        with self._mu:
            return dict(self._registered_guards)

    def findings(self) -> List[Finding]:
        """The three runtime rules over everything observed so far
        (cross-validation against the static graph is separate — see
        ``cross_validate``)."""
        out: List[Finding] = []
        with self._mu:
            edges = dict(self._edges)
            blocking = dict(self._blocking)
            guards = dict(self._guards)
        reported: Set[Tuple[str, str]] = set()
        for (a, b), obs in sorted(edges.items()):
            rev = edges.get((b, a))
            if rev is None or (b, a) in reported:
                continue
            reported.add((a, b))
            out.append(Finding(
                "RUNTIME-LOCK-INVERSION",
                f"runtime-inversion:{min(a, b)}<->{max(a, b)}",
                f"observed {a} -> {b} (thread {obs.thread}: held at "
                f"{obs.holder_site}, acquired at {obs.acquire_site}) "
                f"AND {b} -> {a} (thread {rev.thread}: held at "
                f"{rev.holder_site}, acquired at {rev.acquire_site}) "
                "— deadlock-capable at runtime",
            ))
        for anchor, obs in sorted(blocking.items()):
            out.append(Finding(
                "RUNTIME-LOCK-BLOCKING",
                anchor,
                f"{obs.kind} op {obs.detail} executed {obs.count}x "
                "while the anchored lock was held",
            ))
        for field, obs in sorted(guards.items()):
            if len(obs.threads) < 2 or not obs.unheld:
                continue
            for anchor, (writing, tid, shared) in sorted(
                obs.unheld.items()
            ):
                if tid == obs.first_thread and not shared:
                    # single-owner initialization before the field
                    # ever went shared: exempt (Eraser's exclusive
                    # state)
                    continue
                out.append(Finding(
                    "GUARDED-FIELD-RACE",
                    f"guarded:{field}:{anchor}",
                    f"{'write' if writing else 'read'} of {field} at "
                    f"{anchor} without holding {obs.guard or 'its guard'}"
                    f" (field accessed by {len(obs.threads)} threads)",
                ))
        return dedupe(out)

    def report(self) -> Dict:
        """JSON-ready witness document (wrapped with the artifact
        envelope by ``save``)."""
        with self._mu:
            edges = [
                {
                    "a": a, "b": b, "count": o.count,
                    "holder_site": o.holder_site,
                    "acquire_site": o.acquire_site,
                }
                for (a, b), o in sorted(self._edges.items())
            ]
            acquires = {
                name: sorted(sites)
                for name, sites in sorted(self._acquire_sites.items())
            }
            holds = {
                name: {"count": c, "max_held_s": round(mx, 6)}
                for name, (c, mx) in sorted(self._holds.items())
            }
            blocking = [
                {
                    "anchor": anchor, "kind": o.kind,
                    "detail": o.detail, "count": o.count,
                }
                for anchor, o in sorted(self._blocking.items())
            ]
            guarded = {
                field: {
                    "guard": o.guard,
                    "threads": len(o.threads),
                    "unheld": [
                        {
                            "site": anchor, "writing": w,
                            "shared": shared,
                        }
                        for anchor, (w, _t, shared) in sorted(
                            o.unheld.items()
                        )
                    ],
                }
                for field, o in sorted(self._guards.items())
            }
        return {
            "edges": edges,
            "acquire_sites": acquires,
            "holds": holds,
            "blocking": blocking,
            "guarded": guarded,
            "findings": [
                {"rule": f.rule, "anchor": f.anchor, "message": f.message}
                for f in self.findings()
            ],
        }

    def save(self, path: str) -> None:
        """Persist the witness as the versioned ``lock_witness``
        artifact ``--emit-lock-graph`` consumes for its
        observed/never-observed annotations."""
        from ..analysis import artifact

        artifact.write_artifact(path, "lock_witness", self.report())


# --------------------------------------------------------------------------
# persistence probe (wrap_bundle(sanitize=True))
# --------------------------------------------------------------------------


class SanitizerProbeClient(_Wrapped):
    """Persistence decorator reporting store I/O performed while a
    tracked lock is held. Installed OUTERMOST by
    ``wrap_bundle(sanitize=True)`` so every attempted store call is
    seen — an injected fault that blocks the caller under a lock is
    as real a stall as a slow backend."""

    def __init__(self, base, manager: str = "") -> None:
        super().__init__(base)
        self._manager = manager or type(base).__name__

    def _invoke(self, name, method, args, kwargs):
        locks.note_blocking("store", f"{self._manager}.{name}")
        return method(*args, **kwargs)


# --------------------------------------------------------------------------
# cross-validation against the static Pass 3 graph
# --------------------------------------------------------------------------


def cross_validate(
    witness: "RaceWitness", repo_root: str, graph=None
) -> List[Finding]:
    """RUNTIME-EDGE-UNKNOWN for every observed acquisition-order edge
    absent from the static lock graph: the runtime saw an ordering the
    AST scan cannot — a static coverage hole to fix or waive.

    ``graph`` takes a prebuilt ``lock_order.LockGraph`` so a gate that
    also emits the artifact parses the tree once, not three times."""
    from ..analysis import lock_order

    if graph is None:
        graph = lock_order.build_graph(repo_root)
    static_edges = list(graph.edges)
    out: List[Finding] = []
    with witness._mu:
        observed = {
            k: (o.holder_site, o.acquire_site)
            for k, o in witness._edges.items()
        }
    for (a, b), (hsite, asite) in sorted(observed.items()):
        if lock_order.edge_in_static((a, b), static_edges):
            continue
        out.append(Finding(
            "RUNTIME-EDGE-UNKNOWN",
            f"runtime-edge:{a}->{b}",
            f"runtime-observed lock edge {a} -> {b} (held at {hsite}, "
            f"acquired at {asite}) has no counterpart in the static "
            "Pass 3 graph — static coverage hole",
        ))
    return out


# --------------------------------------------------------------------------
# the gate
# --------------------------------------------------------------------------

DEFAULT_WAIVERS = "cadence_tpu_torch/analysis/sanitizer_waivers.json"
DEFAULT_BASELINE = "cadence_tpu_torch/analysis/lock_baseline.json"

# static rules whose baselined entries waive a runtime blocking twin
_STATIC_BLOCKING_RULES = ("LOCK-BLOCKING", "LOCK-CROSS-BLOCKING")


def check_race_witness(
    witness: "RaceWitness",
    repo_root: str,
    waivers_path: Optional[str] = None,
    baseline_path: Optional[str] = None,
    graph=None,
) -> List[Finding]:
    """Unwaived runtime findings (empty = the sanitizer holds).

    A finding is waived by (a) a matching entry in the sanitizer
    waiver file (same rule, fnmatch anchor), or (b) for
    RUNTIME-LOCK-BLOCKING only, a baselined static LOCK-BLOCKING /
    LOCK-CROSS-BLOCKING entry matching the anchor — the runtime
    observation then serves as evidence FOR the baseline's prose
    justification instead of a new alarm (and flips that entry to
    *observed* in the lock-graph artifact)."""
    findings = witness.findings() + cross_validate(
        witness, repo_root, graph=graph
    )

    waivers = Baseline()
    wpath = waivers_path or os.path.join(repo_root, DEFAULT_WAIVERS)
    if os.path.isfile(wpath):
        waivers = Baseline.load(wpath)
    static_entries = []
    bpath = baseline_path or os.path.join(repo_root, DEFAULT_BASELINE)
    if os.path.isfile(bpath):
        static_entries = [
            e for e in Baseline.load(bpath).entries
            if e.rule in _STATIC_BLOCKING_RULES
        ]

    out: List[Finding] = []
    for f in findings:
        if any(e.matches(f) for e in waivers.entries):
            continue
        if f.rule == "RUNTIME-LOCK-BLOCKING" and any(
            fnmatch.fnmatchcase(f.anchor, e.anchor)
            for e in static_entries
        ):
            continue
        out.append(f)
    return out
