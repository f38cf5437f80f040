"""Pack workflow histories into dense event tensors for device replay.

A copy of the reference package's packer, so the port builds tensors
equal to the reference's byte for byte; its dense layouts come from the
port's C++ sidecar (``native/``) where the reference uses its own, and
from the same numpy paths without a compiler. The packer is the
host half of the replay-kernel contract (ops/replay_cuda.py). Like a
tokenizer, it precomputes everything
that is string- or hash-keyed so the device never chases pointers:

  * **slot assignment**: every pending-map entry (activity / timer / child /
    external cancel / external signal) gets a fixed slot index for its
    lifetime; events that touch an entry carry the slot in ``EV_SLOT``.
    Slot allocation is deterministic (lowest free slot) so replays are
    reproducible. This mirrors the reference's map keys
    (pendingActivityInfoIDs by schedule ID, pendingTimerInfoIDs by timer
    ID, … mutableStateBuilder.go:68-133) without on-device hashing.
  * **batch boundaries**: ``EV_BATCH_FIRST`` carries the first event ID of
    each transaction batch (the reference applies history batch-at-a-time,
    nDCStateRebuilder.go:103-137; batch structure drives
    scheduled_event_batch_id / completion_event_batch_id / transient
    decision schedule IDs).
  * **validation**: malformed histories (orphan completions, double fires,
    slot overflow) are rejected here with the same strictness as the host
    oracle, so the kernel can assume well-formed input.

Histories whose pending sets exceed `Capacities` raise
``PackOverflowError`` — callers route those to the host replay path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.enums import EventType, TimeoutType
from ..core.events import HistoryEvent
from ..core.ids import EMPTY_EVENT_ID
from ..core.mutable_state import MutableState
from ..utils.hashing import hash31

from .. import native
from . import schema as S

SECONDS = 1_000_000_000  # ns per second
_INT32_MAX = 2**31 - 1

from .grid import round_scan_len  # noqa: E402,F401


class PackError(Exception):
    """History cannot be packed (malformed event stream)."""


class PackOverflowError(PackError):
    """History exceeds slot-table capacities — route to host replay."""


@dataclasses.dataclass
class PackResume:
    """Packer continuation state at a history cut point.

    Everything ``pack_workflow`` tracks host-side while walking a
    history — slot assignments, the live decision, version bookkeeping —
    captured so packing can continue from an event suffix exactly as if
    the whole history had been packed in one call. Stored alongside the
    device state row by the checkpoint plane
    (``checkpoint/``); attached to every
    :class:`WorkflowSideTable` as ``side.resume`` after packing.
    """

    next_event_id: int = 0
    last_version: Optional[int] = None
    version_changes: int = 0
    pending_dec: Optional[int] = None
    # the epoch the matching state row's timestamps are relative to
    epoch_s: int = 0
    activity_slots: Dict[int, int] = dataclasses.field(default_factory=dict)
    acts_by_name: Dict[str, int] = dataclasses.field(default_factory=dict)
    timer_slots: Dict[str, int] = dataclasses.field(default_factory=dict)
    child_slots: Dict[int, int] = dataclasses.field(default_factory=dict)
    cancel_slots: Dict[int, int] = dataclasses.field(default_factory=dict)
    signal_slots: Dict[int, int] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe form: int-keyed maps become [key, slot] pair lists
        (JSON object keys are strings; round-tripping through str keys
        would silently break slot seeding)."""
        d = {
            "next_event_id": self.next_event_id,
            "last_version": self.last_version,
            "version_changes": self.version_changes,
            "pending_dec": self.pending_dec,
            "epoch_s": self.epoch_s,
        }
        for f in ("activity_slots", "acts_by_name", "timer_slots",
                  "child_slots", "cancel_slots", "signal_slots"):
            d[f] = [[k, v] for k, v in getattr(self, f).items()]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PackResume":
        out = cls(
            next_event_id=int(d["next_event_id"]),
            last_version=(
                None if d.get("last_version") is None
                else int(d["last_version"])
            ),
            version_changes=int(d.get("version_changes", 0)),
            pending_dec=(
                None if d.get("pending_dec") is None
                else int(d["pending_dec"])
            ),
            epoch_s=int(d.get("epoch_s", 0)),
        )
        for f in ("activity_slots", "timer_slots", "child_slots",
                  "cancel_slots", "signal_slots", "acts_by_name"):
            setattr(out, f, {k: int(v) for k, v in d.get(f, [])})
        return out


@dataclasses.dataclass
class WorkflowSideTable:
    """Host-side strings for one workflow, keyed by slot — merged back into
    snapshots by ops/unpack.py. Strings never influence transitions."""

    workflow_id: str = ""
    run_id: str = ""
    request_id: str = ""
    task_list: str = ""
    workflow_type: str = ""
    cron_schedule: str = ""
    parent_domain: str = ""
    parent_workflow_id: str = ""
    parent_run_id: str = ""
    memo: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    search_attributes: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    continued_execution_run_id: str = ""
    # auto reset points (first completed decision per worker binary) —
    # derived here at pack time so device rebuilds agree with the host
    # oracle's replicate path (mutable_state MAX_RESET_POINTS cap)
    auto_reset_points: List[Dict] = dataclasses.field(default_factory=list)
    # first-decision backoff deadline (ns) for cron/retry continued runs
    first_decision_backoff_deadline: int = 0
    # slot → (domain, workflow_id, run_id, child_only) for pending
    # external cancels/signals: the task refresher needs full targets
    cancel_targets: Dict[int, tuple] = dataclasses.field(default_factory=dict)
    signal_targets: Dict[int, tuple] = dataclasses.field(default_factory=dict)
    # slot → strings
    activity_ids: Dict[int, str] = dataclasses.field(default_factory=dict)
    activity_task_lists: Dict[int, str] = dataclasses.field(default_factory=dict)
    timer_ids: Dict[int, str] = dataclasses.field(default_factory=dict)
    child_domains: Dict[int, str] = dataclasses.field(default_factory=dict)
    child_workflow_ids: Dict[int, str] = dataclasses.field(default_factory=dict)
    child_run_ids: Dict[int, str] = dataclasses.field(default_factory=dict)
    child_types: Dict[int, str] = dataclasses.field(default_factory=dict)
    # packer continuation state at the end of this history — what a
    # checkpoint needs to resume packing from here (set by pack_workflow)
    resume: Optional["PackResume"] = None

    _SLOT_DICT_FIELDS = (
        "cancel_targets", "signal_targets", "activity_ids",
        "activity_task_lists", "timer_ids", "child_domains",
        "child_workflow_ids", "child_run_ids", "child_types",
    )

    def duplicate(self) -> "WorkflowSideTable":
        """Independent copy — resuming a pack must not mutate the stored
        checkpoint's side table. Generic over the dataclass fields so a
        future field cannot be silently dropped from resumed packs."""
        out = WorkflowSideTable()
        for f in dataclasses.fields(self):
            if f.name == "resume":
                continue  # the copy is about to be re-packed
            v = getattr(self, f.name)
            if isinstance(v, dict):
                v = dict(v)
            elif isinstance(v, list):
                v = [dict(p) if isinstance(p, dict) else p for p in v]
            setattr(out, f.name, v)
        return out

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe form (slot-keyed maps as pair lists, target tuples
        as lists) — the checkpoint record's side-table encoding."""
        d = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in self._SLOT_DICT_FIELDS
            and f.name not in ("resume", "memo", "search_attributes",
                               "auto_reset_points")
        }
        d["memo"] = dict(self.memo)
        d["search_attributes"] = dict(self.search_attributes)
        d["auto_reset_points"] = [dict(p) for p in self.auto_reset_points]
        for f in self._SLOT_DICT_FIELDS:
            d[f] = [[k, list(v) if isinstance(v, tuple) else v]
                    for k, v in getattr(self, f).items()]
        d["resume"] = self.resume.to_dict() if self.resume else None
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkflowSideTable":
        out = cls(
            workflow_id=d.get("workflow_id", ""),
            run_id=d.get("run_id", ""),
            request_id=d.get("request_id", ""),
            task_list=d.get("task_list", ""),
            workflow_type=d.get("workflow_type", ""),
            cron_schedule=d.get("cron_schedule", ""),
            parent_domain=d.get("parent_domain", ""),
            parent_workflow_id=d.get("parent_workflow_id", ""),
            parent_run_id=d.get("parent_run_id", ""),
            memo=dict(d.get("memo") or {}),
            search_attributes=dict(d.get("search_attributes") or {}),
            continued_execution_run_id=d.get(
                "continued_execution_run_id", ""),
            auto_reset_points=[dict(p) for p in
                               d.get("auto_reset_points") or []],
            first_decision_backoff_deadline=int(
                d.get("first_decision_backoff_deadline", 0)),
        )
        for f in ("cancel_targets", "signal_targets"):
            setattr(out, f, {
                int(k): (v[0], v[1], v[2], bool(v[3]))
                for k, v in d.get(f, [])
            })
        for f in ("activity_ids", "activity_task_lists", "timer_ids",
                  "child_domains", "child_workflow_ids", "child_run_ids",
                  "child_types"):
            setattr(out, f, {int(k): v for k, v in d.get(f, [])})
        if d.get("resume") is not None:
            out.resume = PackResume.from_dict(d["resume"])
        return out


@dataclasses.dataclass
class ResumeState:
    """Everything needed to pack + replay a history from a cut point:
    the packer continuation (``pack``), the side table accumulated over
    the prefix (``side``), and the device state row at the cut
    (``state_row``, schema.state_row form, timestamps relative to
    ``pack.epoch_s``). Built from checkpoint records."""

    pack: PackResume
    side: WorkflowSideTable
    state_row: Dict[str, Any]


@dataclasses.dataclass
class PackedHistories:
    """Batched event tensors + host side tables.

    All on-device timestamps are seconds relative to ``epoch_s`` with a +1
    offset (0 stays the "unset" sentinel): abs_s = rel + epoch_s - 1. The
    rebasing keeps every `ts + timeout` sum far from int32 overflow.
    """

    events: np.ndarray        # [B, T, EV_N] int32
    lengths: np.ndarray       # [B] int32 — valid event count per row
    side: List[WorkflowSideTable]
    caps: S.Capacities
    epoch_s: int = 0
    # concatenated valid rows ([sum(lengths), EV_N]); None when
    # constructed externally
    rows_concat: Optional[np.ndarray] = None
    # [B] StateTensors of initial carries (checkpoint resume): row i
    # seeds history i's replay instead of empty_state; None = all empty
    initial: Optional[Any] = None
    _teb: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def batch(self) -> int:
        return self.events.shape[0]

    def time_major(self) -> np.ndarray:
        """[T, B, EV_N] time-major layout. Uses the C++ sidecar's fused
        scatter when the packed rows are available."""
        if self.rows_concat is not None:
            return native.scatter_time_major(
                self.rows_concat, self.lengths, self.caps.max_events)
        return np.ascontiguousarray(np.transpose(self.events, (1, 0, 2)))

    def teb(self) -> np.ndarray:
        """[T, EV_N, B] field-major — the replay kernel's operand layout
        (ops/replay_cuda.py), scattered from the packed rows by the C++
        sidecar when they are available, else transposed. Computed once:
        the event tensor is frozen."""
        if self._teb is None:
            if self.rows_concat is not None:
                self._teb = native.scatter_teb(
                    self.rows_concat, self.lengths, self.caps.max_events)
            else:
                self._teb = np.ascontiguousarray(
                    np.transpose(self.events, (1, 2, 0)))
            self._teb.flags.writeable = False
        return self._teb


# Bounds guaranteeing every on-device `rel_ts + timeout` sum fits int32:
# relative timestamps span < 2^28 s (~8.5 years of history) and individual
# timeout fields < 2^30 s (~34 years).
MAX_REL_TS = 2**28
MAX_TIMEOUT_S = 2**30


class _SlotTable:
    """Deterministic lowest-free-slot allocator keyed by an id.

    ``seed`` (a key → slot map from :class:`PackResume`) restores the
    allocator to a mid-history state so a resumed pack assigns the same
    slots a full pack would have."""

    def __init__(self, capacity: int, kind: str,
                 seed: Optional[Dict[Any, int]] = None) -> None:
        self.capacity = capacity
        self.kind = kind
        self.by_key: Dict[Any, int] = {}
        self.free: List[int] = list(range(capacity))  # kept sorted
        if seed:
            slots = list(seed.values())
            if len(set(slots)) != len(slots):
                raise PackError(f"resume {kind} slots collide: {seed}")
            for slot in slots:
                if not 0 <= slot < capacity:
                    raise PackOverflowError(
                        f"resume {kind} slot {slot} exceeds capacity "
                        f"{capacity}"
                    )
            self.by_key = dict(seed)
            used = set(slots)
            self.free = [s for s in range(capacity) if s not in used]

    def alloc(self, key: Any) -> int:
        if not self.free:
            raise PackOverflowError(
                f"pending {self.kind} capacity {self.capacity} exceeded"
            )
        slot = self.free.pop(0)
        self.by_key[key] = slot
        return slot

    def get(self, key: Any) -> Optional[int]:
        return self.by_key.get(key)

    def release(self, key: Any) -> int:
        if key not in self.by_key:
            raise PackError(f"unknown {self.kind} key {key!r}")
        slot = self.by_key.pop(key)
        # insert keeping order (capacities are small)
        i = 0
        while i < len(self.free) and self.free[i] < slot:
            i += 1
        self.free.insert(i, slot)
        return slot


def _timeout(a: Dict[str, Any], key: str) -> int:
    v = a.get(key, 0) or 0
    if not (0 <= v < MAX_TIMEOUT_S):
        raise PackError(f"timeout {key}={v} out of range")
    return int(v)


def pack_workflow(
    batches: Sequence[Sequence[HistoryEvent]],
    caps: S.Capacities,
    workflow_id: str = "",
    run_id: str = "",
    request_id: str = "",
    epoch_s: Optional[int] = None,
    domain_resolver=None,
    resume: Optional[ResumeState] = None,
) -> Tuple[np.ndarray, WorkflowSideTable]:
    """Pack one workflow's history (a sequence of transaction batches) into
    an [n_events, EV_N] int32 array + its side table.

    ``epoch_s``: shared batch epoch (defaults to this workflow's first
    event); all timestamps become rel = abs_s - epoch_s + 1.

    ``domain_resolver``: name -> domain id, applied to child/cancel/
    signal TARGET domains captured into the side table — the host
    oracle (StateBuilder) stores RESOLVED ids, and the transfer-task
    consumers look targets up by id; storing raw names here would make
    device rebuilds emit tasks whose cross-domain target can't be
    found.

    ``resume``: continue packing from a checkpoint — ``batches`` is then
    the event SUFFIX (first event id must equal the resume point's
    next_event_id); slot tables, the side table, and version/decision
    bookkeeping seed from the snapshot so slot assignment and
    validation behave exactly as a full pack. The returned side's
    ``resume`` field always carries the END state, so checkpoints
    compose across successive resumes."""

    if resume is not None:
        side = resume.side.duplicate()
        side.workflow_id = workflow_id or side.workflow_id
        side.run_id = run_id or side.run_id
        if request_id:
            side.request_id = request_id
    else:
        side = WorkflowSideTable(
            workflow_id=workflow_id, run_id=run_id, request_id=request_id
        )
    side.resume = None
    resolve_domain = domain_resolver or (lambda name: name)
    if epoch_s is None:
        first = next((b[0] for b in batches if b), None)
        if first is not None:
            epoch_s = first.timestamp // SECONDS
        elif resume is not None:
            epoch_s = resume.pack.epoch_s
        else:
            epoch_s = 0

    def rel_ts(ns: int) -> int:
        s = ns // SECONDS - epoch_s + 1
        if not (1 <= s < MAX_REL_TS):
            # a representability limit, not malformed input: the host
            # oracle replays such histories fine, so route them there
            raise PackOverflowError(
                f"timestamp {ns} out of packable window (epoch {epoch_s})"
            )
        return int(s)
    rp = resume.pack if resume is not None else PackResume()
    acts = _SlotTable(caps.max_activities, "activity",
                      seed=rp.activity_slots)
    acts_by_name: Dict[str, int] = dict(rp.acts_by_name)
    timers = _SlotTable(caps.max_timers, "timer", seed=rp.timer_slots)
    children = _SlotTable(caps.max_children, "child", seed=rp.child_slots)
    cancels = _SlotTable(caps.max_request_cancels, "request-cancel",
                         seed=rp.cancel_slots)
    signals = _SlotTable(caps.max_signals_ext, "external-signal",
                         seed=rp.signal_slots)

    rows: List[List[int]] = []
    n_events = sum(len(b) for b in batches)
    if n_events > caps.max_events:
        raise PackOverflowError(
            f"history length {n_events} exceeds max_events {caps.max_events}"
        )

    version_changes = rp.version_changes
    last_version: Optional[int] = rp.last_version
    next_event_id: Optional[int] = (
        rp.next_event_id if resume is not None else None
    )
    # decision schedule id currently pending
    pending_dec: Optional[int] = rp.pending_dec

    for batch in batches:
        if not batch:
            raise PackError("empty event batch")
        batch_first = batch[0].event_id
        for i, ev in enumerate(batch):
            et = ev.event_type
            a = ev.attributes
            slot = -1
            attrs = [0] * 8

            if next_event_id is not None and ev.event_id != next_event_id:
                raise PackError(
                    f"event id {ev.event_id} breaks contiguity "
                    f"(expected {next_event_id})"
                )
            next_event_id = ev.event_id + 1

            if last_version is None or ev.version != last_version:
                if last_version is not None and ev.version < last_version:
                    # same strictness as VersionHistory.add_or_update_item
                    raise PackError(
                        f"event version {ev.version} < last version {last_version}"
                    )
                version_changes += 1
                last_version = ev.version
            if version_changes > caps.max_version_items:
                raise PackOverflowError(
                    f"version-history items exceed {caps.max_version_items}"
                )

            if et == EventType.WorkflowExecutionStarted:
                side.task_list = a.get("task_list", "")
                side.workflow_type = a.get("workflow_type", "")
                side.cron_schedule = a.get("cron_schedule", "")
                backoff_s = a.get(
                    "first_decision_task_backoff_seconds", 0) or 0
                side.first_decision_backoff_deadline = (
                    ev.timestamp + backoff_s * SECONDS if backoff_s else 0
                )
                side.parent_domain = a.get("parent_workflow_domain") or ""
                side.parent_workflow_id = a.get("parent_workflow_id") or ""
                side.parent_run_id = a.get("parent_run_id") or ""
                side.continued_execution_run_id = a.get("continued_execution_run_id", "")
                side.memo = dict(a.get("memo") or {})
                side.search_attributes = dict(a.get("search_attributes") or {})
                rp = a.get("retry_policy")
                attrs[0] = _timeout(a, "execution_start_to_close_timeout_seconds")
                attrs[1] = _timeout(a, "task_start_to_close_timeout_seconds")
                attrs[2] = a.get("attempt", 0)
                attrs[3] = 1 if rp is not None else 0
                exp = a.get("expiration_timestamp", 0)
                attrs[4] = rel_ts(exp) if exp else 0
                attrs[5] = _timeout(a, "first_decision_task_backoff_seconds")
                attrs[6] = a.get("initiator", 0)
                attrs[7] = a.get("parent_initiated_event_id", EMPTY_EVENT_ID)

            elif et == EventType.DecisionTaskScheduled:
                attrs[0] = _timeout(a, "start_to_close_timeout_seconds")
                attrs[1] = a.get("attempt", 0)
                pending_dec = ev.event_id

            elif et == EventType.DecisionTaskStarted:
                sched = a.get("scheduled_event_id", EMPTY_EVENT_ID)
                # same strictness as replicate_decision_task_started_event
                if pending_dec is None or sched != pending_dec:
                    raise PackError(
                        f"decision started references schedule {sched}, "
                        f"pending is {pending_dec}"
                    )
                attrs[0] = sched

            elif et == EventType.DecisionTaskCompleted:
                attrs[0] = a.get("started_event_id", EMPTY_EVENT_ID)
                pending_dec = None
                MutableState.record_reset_point(
                    side.auto_reset_points,
                    a.get("binary_checksum", "") or "",
                    side.run_id, ev.event_id, ev.timestamp,
                )

            elif et == EventType.DecisionTaskTimedOut:
                attrs[0] = a.get("timeout_type", 0)
                # sticky timeouts drop the decision; others leave a
                # transient decision pending (schedule id = batch first)
                if attrs[0] == int(TimeoutType.ScheduleToStart):
                    pending_dec = None
                else:
                    pending_dec = batch_first

            elif et == EventType.DecisionTaskFailed:
                pending_dec = batch_first  # transient decision

            elif et == EventType.ActivityTaskScheduled:
                activity_id = a.get("activity_id", "")
                slot = acts.alloc(ev.event_id)
                acts_by_name[activity_id] = slot
                side.activity_ids[slot] = activity_id
                side.activity_task_lists[slot] = a.get("task_list", "")
                rp = a.get("retry_policy")
                attrs[0] = hash31(activity_id)
                attrs[1] = _timeout(a, "schedule_to_start_timeout_seconds")
                attrs[2] = _timeout(a, "schedule_to_close_timeout_seconds")
                attrs[3] = _timeout(a, "start_to_close_timeout_seconds")
                attrs[4] = _timeout(a, "heartbeat_timeout_seconds")
                attrs[5] = 1 if rp is not None else 0
                attrs[6] = _timeout(rp or {}, "expiration_interval_seconds")

            elif et == EventType.ActivityTaskStarted:
                sched = a.get("scheduled_event_id", EMPTY_EVENT_ID)
                slot = acts.get(sched)
                if slot is None:
                    raise PackError(f"activity started for unknown schedule {sched}")
                attrs[0] = sched
                attrs[1] = a.get("attempt", 0)

            elif et in (
                EventType.ActivityTaskCompleted,
                EventType.ActivityTaskFailed,
                EventType.ActivityTaskTimedOut,
                EventType.ActivityTaskCanceled,
            ):
                sched = a.get("scheduled_event_id", EMPTY_EVENT_ID)
                slot = acts.release(sched)
                name = side.activity_ids.get(slot, "")
                if acts_by_name.get(name) == slot:
                    acts_by_name.pop(name, None)
                attrs[0] = sched
                if et == EventType.ActivityTaskTimedOut:
                    attrs[1] = a.get("timeout_type", 0)

            elif et == EventType.ActivityTaskCancelRequested:
                activity_id = a.get("activity_id", "")
                slot = acts_by_name.get(activity_id)
                if slot is None:
                    raise PackError(
                        f"cancel requested for unknown activity {activity_id!r}"
                    )
                attrs[0] = hash31(activity_id)

            elif et == EventType.RequestCancelActivityTaskFailed:
                pass

            elif et == EventType.TimerStarted:
                timer_id = a.get("timer_id", "")
                if timers.get(timer_id) is not None:
                    raise PackError(f"duplicate timer id {timer_id!r}")
                slot = timers.alloc(timer_id)
                side.timer_ids[slot] = timer_id
                attrs[0] = hash31(timer_id)
                attrs[1] = _timeout(a, "start_to_fire_timeout_seconds")

            elif et in (EventType.TimerFired, EventType.TimerCanceled):
                timer_id = a.get("timer_id", "")
                slot = timers.release(timer_id)
                attrs[0] = a.get("started_event_id", EMPTY_EVENT_ID)
                attrs[1] = hash31(timer_id)

            elif et == EventType.CancelTimerFailed:
                pass

            elif et == EventType.StartChildWorkflowExecutionInitiated:
                slot = children.alloc(ev.event_id)
                # slot reuse: a prior occupant's started run id must not
                # leak into this (not-yet-started) child's rehydration
                side.child_run_ids.pop(slot, None)
                side.child_domains[slot] = resolve_domain(
                    a.get("domain", "")
                )
                side.child_workflow_ids[slot] = a.get("workflow_id", "")
                side.child_types[slot] = a.get("workflow_type", "")
                attrs[0] = hash31(a.get("workflow_id", ""))
                attrs[1] = a.get("parent_close_policy", 0)

            elif et == EventType.ChildWorkflowExecutionStarted:
                init = a.get("initiated_event_id", EMPTY_EVENT_ID)
                slot = children.get(init)
                if slot is None:
                    raise PackError(f"child started for unknown initiated {init}")
                child_run_id = a.get("run_id", "")
                side.child_run_ids[slot] = child_run_id
                attrs[0] = init
                attrs[1] = hash31(child_run_id) if child_run_id else 0

            elif et in (
                EventType.StartChildWorkflowExecutionFailed,
                EventType.ChildWorkflowExecutionCompleted,
                EventType.ChildWorkflowExecutionFailed,
                EventType.ChildWorkflowExecutionCanceled,
                EventType.ChildWorkflowExecutionTimedOut,
                EventType.ChildWorkflowExecutionTerminated,
            ):
                init = a.get("initiated_event_id", EMPTY_EVENT_ID)
                slot = children.release(init)
                attrs[0] = init

            elif et == EventType.RequestCancelExternalWorkflowExecutionInitiated:
                slot = cancels.alloc(ev.event_id)
                side.cancel_targets[slot] = (
                    resolve_domain(a.get("domain", "")),
                    a.get("workflow_id", ""),
                    a.get("run_id", ""),
                    bool(a.get("child_workflow_only", False)),
                )

            elif et in (
                EventType.RequestCancelExternalWorkflowExecutionFailed,
                EventType.ExternalWorkflowExecutionCancelRequested,
            ):
                init = a.get("initiated_event_id", EMPTY_EVENT_ID)
                slot = cancels.release(init)
                attrs[0] = init

            elif et == EventType.SignalExternalWorkflowExecutionInitiated:
                slot = signals.alloc(ev.event_id)
                side.signal_targets[slot] = (
                    resolve_domain(a.get("domain", "")),
                    a.get("workflow_id", ""),
                    a.get("run_id", ""),
                    bool(a.get("child_workflow_only", False)),
                )

            elif et in (
                EventType.SignalExternalWorkflowExecutionFailed,
                EventType.ExternalWorkflowExecutionSignaled,
            ):
                init = a.get("initiated_event_id", EMPTY_EVENT_ID)
                slot = signals.release(init)
                attrs[0] = init

            elif et == EventType.UpsertWorkflowSearchAttributes:
                side.search_attributes.update(a.get("search_attributes", {}))

            elif et in (
                EventType.MarkerRecorded,
                EventType.WorkflowExecutionSignaled,
                EventType.WorkflowExecutionCancelRequested,
                EventType.WorkflowExecutionCompleted,
                EventType.WorkflowExecutionFailed,
                EventType.WorkflowExecutionTimedOut,
                EventType.WorkflowExecutionCanceled,
                EventType.WorkflowExecutionTerminated,
                EventType.WorkflowExecutionContinuedAsNew,
            ):
                pass

            else:
                raise PackError(f"unknown event type {et}")

            rows.append([
                int(et),
                ev.event_id,
                ev.version,
                ev.task_id,
                rel_ts(ev.timestamp),
                batch_first,
                1 if i == len(batch) - 1 else 0,
                slot,
                *attrs,
            ])

    arr = np.asarray(rows, dtype=np.int64).reshape(-1, S.EV_N)
    if arr.size and (arr.max() > _INT32_MAX or arr.min() < -(2**31)):
        raise PackError("event field does not fit int32")
    side.resume = PackResume(
        next_event_id=(next_event_id if next_event_id is not None
                       else rp.next_event_id),
        last_version=last_version,
        version_changes=version_changes,
        pending_dec=pending_dec,
        epoch_s=epoch_s,
        activity_slots=dict(acts.by_key),
        acts_by_name=dict(acts_by_name),
        timer_slots=dict(timers.by_key),
        child_slots=dict(children.by_key),
        cancel_slots=dict(cancels.by_key),
        signal_slots=dict(signals.by_key),
    )
    return arr.astype(np.int32), side


def _resume_epoch(first_ts: List[int],
                  resume: List[Optional[ResumeState]]) -> int:
    """Shared batch epoch covering both suffix events and resumed state
    rows: the minimum over first-event epochs and resume epochs, so
    every rebased row timestamp stays >= 1 (rows only shift forward)."""
    cands = [ts // SECONDS for ts in first_ts]
    cands += [r.pack.epoch_s for r in resume if r is not None]
    return min(cands) if cands else 0


def _build_initial(
    resume: List[Optional[ResumeState]], caps: S.Capacities,
    epoch_s: int, n_rows: int,
) -> Optional[S.StateTensors]:
    """[n_rows] StateTensors with resumed histories' (rebased) snapshot
    rows; None when nothing resumes."""
    if not any(r is not None for r in resume):
        return None
    initial = S.empty_state(n_rows, caps)
    for idx, r in enumerate(resume):
        if r is None:
            continue
        delta = r.pack.epoch_s - epoch_s
        row = S.rebase_state_row(r.state_row, delta)
        for field, cols in S.ROW_TS_COLS.items():
            arr = row[field]
            for c in cols:
                if (arr[..., c] >= MAX_REL_TS).any():
                    raise PackOverflowError(
                        "resumed state row timestamp out of packable "
                        f"window after rebase (delta {delta}s)"
                    )
        try:
            S.set_state_row(initial, idx, row)
        except ValueError as e:  # shape mismatch = caps mismatch
            raise PackOverflowError(
                f"resume state row does not fit capacities {caps}: {e}"
            )
    return initial


def pack_histories(
    histories: Sequence[Tuple[str, str, Sequence[Sequence[HistoryEvent]]]],
    caps: Optional[S.Capacities] = None,
    pad_batch_to: Optional[int] = None,
    domain_resolver=None,
    resume: Optional[Sequence[Optional[ResumeState]]] = None,
) -> PackedHistories:
    """Pack many workflows into one padded [B, T, EV_N] tensor.

    ``histories``: sequence of (workflow_id, run_id, batches).
    ``pad_batch_to``: round the batch dim up (e.g. to a multiple of the
    device-mesh size for even sharding).
    ``resume``: optional per-history checkpoint resume states — a
    resumed history's batches are its event SUFFIX and its row of the
    result's ``initial`` StateTensors carries the snapshot state.
    """
    caps = caps or S.Capacities()
    b = len(histories)
    bp = max(pad_batch_to or b, b)
    resume = list(resume) if resume is not None else [None] * b
    if len(resume) != b:
        raise ValueError("resume list must align with histories")
    lengths = np.zeros((bp,), dtype=np.int32)
    side: List[WorkflowSideTable] = []
    first_ts = [
        batches[0][0].timestamp
        for _, _, batches in histories
        if batches and batches[0]
    ]
    epoch_s = _resume_epoch(first_ts, resume)
    per_wf: List[np.ndarray] = []
    for idx, (wf_id, run_id, batches) in enumerate(histories):
        arr, st = pack_workflow(
            batches, caps, workflow_id=wf_id, run_id=run_id,
            epoch_s=epoch_s, domain_resolver=domain_resolver,
            resume=resume[idx],
        )
        lengths[idx] = arr.shape[0]
        side.append(st)
        per_wf.append(arr)
    for _ in range(bp - b):
        side.append(WorkflowSideTable())
    initial = _build_initial(resume, caps, epoch_s, bp)
    rows_concat = (
        np.concatenate(per_wf, axis=0)
        if per_wf
        else np.zeros((0, S.EV_N), dtype=np.int32)
    )
    # one fused pad+layout pass (the C++ sidecar when it builds) instead
    # of a per-workflow fill loop
    events = native.scatter_batch_major(rows_concat, lengths,
                                        caps.max_events)
    # rows_concat is the replay source of truth (time_major reads it);
    # freeze the derived tensor so divergence-by-mutation is an error,
    # not a silent mismatch
    events.flags.writeable = False
    rows_concat.flags.writeable = False
    return PackedHistories(
        events=events, lengths=lengths, side=side, caps=caps,
        epoch_s=epoch_s, rows_concat=rows_concat, initial=initial,
    )


@dataclasses.dataclass
class PackedLanes:
    """Ragged lane-packed batch: multiple whole histories back-to-back in
    each scan lane (sequence packing for the replay kernel).

    Where :class:`PackedHistories` pads every history to the deepest one
    in the batch, this layout packs segments (whole histories) end to end
    so the effective scan length per history is its own depth, not
    ``max(depth)``. Each segment's last (possibly padded) row carries a
    segment-end flag and a precomputed output snapshot row; the kernel
    scatters the lane's state there and resets the lane to
    ``empty_state`` — bit-identically to replaying the segment alone
    (tests/test_replay_differential.py::TestLanePacking).
    """

    events: np.ndarray       # [L, T, EV_N] int32 (-1 type = padding)
    seg_end: np.ndarray      # [L, T] bool — last row of each segment
    out_row: np.ndarray      # [L, T] int32 — snapshot row at seg-end rows
    lengths: np.ndarray      # [n_histories] int32 — real events per history
    side: List[WorkflowSideTable]  # indexed by output row (input order)
    caps: S.Capacities
    epoch_s: int = 0
    # per-lane segment table: (out_row, start, end_excl) with end_excl
    # including seg_align padding — how ops/unpack.py splits snapshots
    lane_segments: List[List[Tuple[int, int, int]]] = dataclasses.field(
        default_factory=list
    )
    seg_align: int = 1
    # [n_histories] StateTensors of initial segment carries (checkpoint
    # resume): row i seeds history i's segment instead of empty_state;
    # None = every segment starts empty
    initial: Optional[Any] = None

    @property
    def n_histories(self) -> int:
        return len(self.lengths)

    @property
    def lanes(self) -> int:
        return self.events.shape[0]

    @property
    def scan_len(self) -> int:
        return self.events.shape[1]

    @property
    def total_events(self) -> int:
        return int(self.lengths.sum())

    @property
    def padding_frac(self) -> float:
        """Padded steps ÷ real events — the waste the packer removes."""
        real = self.total_events
        if not real:
            return 0.0
        return (self.lanes * self.scan_len - real) / real

    @property
    def lanes_per_history(self) -> float:
        n = self.n_histories
        return self.lanes / n if n else 0.0

    @property
    def present_types(self) -> Tuple[int, ...]:
        """Sorted event types occurring in this batch — feed through
        ops.replay.type_signature to statically specialize the scan."""
        et = np.unique(self.events[:, :, S.EV_TYPE])
        return tuple(int(t) for t in et if t >= 0)

    def time_major(self):
        """(events [T, L, EV_N], seg_end [T, L], out_row [T, L]) — the
        layout replay_scan_packed consumes."""
        ev = np.ascontiguousarray(np.transpose(self.events, (1, 0, 2)))
        return ev, self.seg_end.T.copy(), self.out_row.T.copy()

    def teb(self) -> np.ndarray:
        """[T, EV_N, L] field-major for the kernel's packed route."""
        return np.ascontiguousarray(np.transpose(self.events, (1, 2, 0)))

    def reset_rows(self) -> np.ndarray:
        """[L, T] int32: at each segment-end step, the ``initial`` row
        the lane resets to — the NEXT segment's initial state. The
        sentinel ``n_histories`` indexes the kernels' appended pristine
        empty row (the default for non-resumed segments and lane ends)."""
        rr = np.full(
            (self.lanes, self.scan_len), self.n_histories, np.int32
        )
        for ln, segs in enumerate(self.lane_segments):
            for k in range(len(segs) - 1):
                rr[ln, segs[k][2] - 1] = segs[k + 1][0]
        return rr

    def lane_state0(self, initial=None) -> "S.StateTensors":
        """[lanes] initial lane carries: each lane starts from its FIRST
        segment's initial row (``initial``, default ``self.initial``),
        or empty_state."""
        initial = initial if initial is not None else self.initial
        state0 = S.empty_state(self.lanes, self.caps)
        if initial is None:
            return state0
        for ln, segs in enumerate(self.lane_segments):
            if segs:
                S.set_state_row(
                    state0, ln, S.state_row(initial, segs[0][0])
                )
        return state0


def pack_lanes(
    histories: Sequence[Tuple[str, str, Sequence[Sequence[HistoryEvent]]]],
    caps: Optional[S.Capacities] = None,
    target_lane_len: Optional[int] = None,
    seg_align: int = 1,
    pad_lanes_to: Optional[int] = None,
    round_lengths: bool = True,
    domain_resolver=None,
    resume: Optional[Sequence[Optional[ResumeState]]] = None,
) -> PackedLanes:
    """Greedy first-fit lane packing of many workflow histories.

    ``target_lane_len``: lane capacity in events; histories are packed
    back-to-back up to it (a history longer than the target still gets a
    lane — the final scan length is the longest lane, grid-rounded).
    Defaults to the longest single history, i.e. one history per lane,
    matching :func:`pack_histories` density.

    ``seg_align``: segment starts/ends are padded to this multiple — the
    packed kernel route flushes snapshots at time-block boundaries, so
    its callers pack with ``seg_align == tb``. Padding rows are no-ops
    (EV_TYPE −1), so the aligned snapshot equals the unaligned one.

    Output rows follow the input order: ``out_row`` i and ``side[i]``
    belong to ``histories[i]`` whatever lane its segment landed in.

    ``resume``: optional per-history checkpoint resume states (see
    :func:`pack_histories`) — a resumed history's batches are its event
    SUFFIX; its row of ``PackedLanes.initial`` seeds the segment carry.
    A zero-event suffix (checkpoint at the branch tip) still occupies
    one ``seg_align`` block of padding rows so its segment-end flush
    emits the (initial) state into the output row.
    """
    caps = caps or S.Capacities()
    if seg_align < 1:
        raise ValueError(f"seg_align must be >= 1, got {seg_align}")
    n = len(histories)
    resume = list(resume) if resume is not None else [None] * n
    if len(resume) != n:
        raise ValueError("resume list must align with histories")
    first_ts = [
        batches[0][0].timestamp
        for _, _, batches in histories
        if batches and batches[0]
    ]
    epoch_s = _resume_epoch(first_ts, resume)
    per_wf: List[np.ndarray] = []
    side: List[WorkflowSideTable] = []
    lengths = np.zeros((n,), dtype=np.int32)
    seg_lens: List[int] = []
    for idx, (wf_id, run_id, batches) in enumerate(histories):
        arr, st = pack_workflow(
            batches, caps, workflow_id=wf_id, run_id=run_id,
            epoch_s=epoch_s, domain_resolver=domain_resolver,
            resume=resume[idx],
        )
        per_wf.append(arr)
        side.append(st)
        lengths[idx] = arr.shape[0]
        seg_lens.append(-(-max(arr.shape[0], 1) // seg_align) * seg_align)

    max_seg = max(seg_lens, default=seg_align)
    cap_t = max(target_lane_len or 0, max_seg)

    # greedy first-fit in ascending-length order (original index breaks
    # ties) — lanes too small for the current segment can never fit a
    # later one, so they drop out of the open set and the fit stays
    # O(n + lanes) even for storm-sized batches
    order = sorted(range(n), key=lambda i: (seg_lens[i], i))
    lane_fill: List[int] = []          # events used per lane
    assign: List[List[int]] = []       # history indices per lane
    open_lanes: List[int] = []
    for i in order:
        seg = seg_lens[i]
        placed = None
        still_open: List[int] = []
        for ln in open_lanes:
            if placed is None and lane_fill[ln] + seg <= cap_t:
                placed = ln
            if lane_fill[ln] + seg <= cap_t or ln == placed:
                still_open.append(ln)
        open_lanes = still_open
        if placed is None:
            placed = len(lane_fill)
            lane_fill.append(0)
            assign.append([])
            open_lanes.append(placed)
        lane_fill[placed] += seg
        assign[placed].append(i)

    n_lanes = max(len(lane_fill), 1)
    t = max(lane_fill, default=seg_align)
    t = round_scan_len(t) if round_lengths else t
    # the packed kernel route needs scan length divisible by the block
    # (= seg_align); grid points like 12/24/48 may not be
    t = -(-t // seg_align) * seg_align
    lanes = round_scan_len(max(pad_lanes_to or 0, n_lanes)) \
        if round_lengths else max(pad_lanes_to or 0, n_lanes)

    events = np.full((lanes, t, S.EV_N), 0, dtype=np.int32)
    events[:, :, S.EV_TYPE] = -1
    seg_end = np.zeros((lanes, t), dtype=bool)
    out_row = np.zeros((lanes, t), dtype=np.int32)
    lane_segments: List[List[Tuple[int, int, int]]] = [
        [] for _ in range(lanes)
    ]
    for ln, members in enumerate(assign):
        cursor = 0
        for i in members:
            arr = per_wf[i]
            events[ln, cursor : cursor + arr.shape[0]] = arr
            end = cursor + seg_lens[i]
            seg_end[ln, end - 1] = True
            out_row[ln, end - 1] = i
            lane_segments[ln].append((i, cursor, end))
            cursor = end

    events.flags.writeable = False
    # initial's batch dim is a jit specialization key like every other
    # shape here: grid-round it so resumed storm chunks of arbitrary
    # size don't each compile a fresh executable (padding rows are
    # empty_state — the reset sentinel indexes one identically)
    n_init = round_scan_len(n) if round_lengths else n
    initial = _build_initial(resume, caps, epoch_s, n_init)
    return PackedLanes(
        events=events, seg_end=seg_end, out_row=out_row, lengths=lengths,
        side=side, caps=caps, epoch_s=epoch_s,
        lane_segments=lane_segments, seg_align=seg_align, initial=initial,
    )


