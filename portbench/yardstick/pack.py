"""Pack one workflow history into its dense event rows.

Frozen copy of the event-row half of ``pack_workflow`` in
``cadence_tpu_torch/ops/pack.py`` (the port as of the first benchmark):
the same slot assignment (lowest free slot, for the entry's lifetime),
batch boundaries, attribute columns and validation. What the port's
packer also keeps for the host (side tables of strings, resume state)
is left out: the reference needs only the rows.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import schema as S
from .enums import EventType, TimeoutType
from .events import HistoryEvent
from .hashing import hash31
from .ids import EMPTY_EVENT_ID

SECONDS = 1_000_000_000  # ns per second
MAX_REL_TS = 2**28
MAX_TIMEOUT_S = 2**30
_INT32_MAX = 2**31 - 1


class PackError(Exception):
    """History cannot be packed (malformed or over capacity)."""


class _SlotTable:
    """Deterministic lowest-free-slot allocator keyed by an id."""

    def __init__(self, capacity: int, kind: str) -> None:
        self.capacity = capacity
        self.kind = kind
        self.by_key: Dict[Any, int] = {}
        self.free: List[int] = list(range(capacity))  # kept sorted

    def alloc(self, key: Any) -> int:
        if not self.free:
            raise PackError(
                f"pending {self.kind} capacity {self.capacity} exceeded")
        slot = self.free.pop(0)
        self.by_key[key] = slot
        return slot

    def get(self, key: Any) -> Optional[int]:
        return self.by_key.get(key)

    def release(self, key: Any) -> int:
        if key not in self.by_key:
            raise PackError(f"unknown {self.kind} key {key!r}")
        slot = self.by_key.pop(key)
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


def pack_rows(batches: Sequence[Sequence[HistoryEvent]],
              caps: S.Capacities, epoch_s: int) -> np.ndarray:
    """[n_events, EV_N] int32 rows of one history; timestamps become
    ``abs_s - epoch_s + 1``."""

    def rel_ts(ns: int) -> int:
        s = ns // SECONDS - epoch_s + 1
        if not (1 <= s < MAX_REL_TS):
            raise PackError(
                f"timestamp {ns} out of packable window (epoch {epoch_s})")
        return int(s)

    acts = _SlotTable(caps.max_activities, "activity")
    acts_by_name: Dict[str, int] = {}
    activity_ids: Dict[int, str] = {}
    timers = _SlotTable(caps.max_timers, "timer")
    children = _SlotTable(caps.max_children, "child")
    cancels = _SlotTable(caps.max_request_cancels, "request-cancel")
    signals = _SlotTable(caps.max_signals_ext, "external-signal")

    n_events = sum(len(b) for b in batches)
    if n_events > caps.max_events:
        raise PackError(
            f"history length {n_events} exceeds max_events {caps.max_events}")

    rows: List[List[int]] = []
    version_changes = 0
    last_version: Optional[int] = None
    next_event_id: Optional[int] = None
    pending_dec: Optional[int] = None

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
                    f"(expected {next_event_id})")
            next_event_id = ev.event_id + 1

            if last_version is None or ev.version != last_version:
                if last_version is not None and ev.version < last_version:
                    raise PackError(
                        f"event version {ev.version} < last version "
                        f"{last_version}")
                version_changes += 1
                last_version = ev.version
            if version_changes > caps.max_version_items:
                raise PackError(
                    f"version-history items exceed {caps.max_version_items}")

            if et == EventType.WorkflowExecutionStarted:
                rp = a.get("retry_policy")
                attrs[0] = _timeout(
                    a, "execution_start_to_close_timeout_seconds")
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
                if pending_dec is None or sched != pending_dec:
                    raise PackError(
                        f"decision started references schedule {sched}, "
                        f"pending is {pending_dec}")
                attrs[0] = sched

            elif et == EventType.DecisionTaskCompleted:
                attrs[0] = a.get("started_event_id", EMPTY_EVENT_ID)
                pending_dec = None

            elif et == EventType.DecisionTaskTimedOut:
                attrs[0] = a.get("timeout_type", 0)
                if attrs[0] == int(TimeoutType.ScheduleToStart):
                    pending_dec = None
                else:
                    pending_dec = batch_first

            elif et == EventType.DecisionTaskFailed:
                pending_dec = batch_first

            elif et == EventType.ActivityTaskScheduled:
                activity_id = a.get("activity_id", "")
                slot = acts.alloc(ev.event_id)
                acts_by_name[activity_id] = slot
                activity_ids[slot] = activity_id
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
                    raise PackError(
                        f"activity started for unknown schedule {sched}")
                attrs[0] = sched
                attrs[1] = a.get("attempt", 0)

            elif et in (EventType.ActivityTaskCompleted,
                        EventType.ActivityTaskFailed,
                        EventType.ActivityTaskTimedOut,
                        EventType.ActivityTaskCanceled):
                sched = a.get("scheduled_event_id", EMPTY_EVENT_ID)
                slot = acts.release(sched)
                name = activity_ids.get(slot, "")
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
                        f"cancel requested for unknown activity "
                        f"{activity_id!r}")
                attrs[0] = hash31(activity_id)

            elif et == EventType.TimerStarted:
                timer_id = a.get("timer_id", "")
                if timers.get(timer_id) is not None:
                    raise PackError(f"duplicate timer id {timer_id!r}")
                slot = timers.alloc(timer_id)
                attrs[0] = hash31(timer_id)
                attrs[1] = _timeout(a, "start_to_fire_timeout_seconds")

            elif et in (EventType.TimerFired, EventType.TimerCanceled):
                timer_id = a.get("timer_id", "")
                slot = timers.release(timer_id)
                attrs[0] = a.get("started_event_id", EMPTY_EVENT_ID)
                attrs[1] = hash31(timer_id)

            elif et == EventType.StartChildWorkflowExecutionInitiated:
                slot = children.alloc(ev.event_id)
                attrs[0] = hash31(a.get("workflow_id", ""))
                attrs[1] = a.get("parent_close_policy", 0)

            elif et == EventType.ChildWorkflowExecutionStarted:
                init = a.get("initiated_event_id", EMPTY_EVENT_ID)
                slot = children.get(init)
                if slot is None:
                    raise PackError(
                        f"child started for unknown initiated {init}")
                child_run_id = a.get("run_id", "")
                attrs[0] = init
                attrs[1] = hash31(child_run_id) if child_run_id else 0

            elif et in (EventType.StartChildWorkflowExecutionFailed,
                        EventType.ChildWorkflowExecutionCompleted,
                        EventType.ChildWorkflowExecutionFailed,
                        EventType.ChildWorkflowExecutionCanceled,
                        EventType.ChildWorkflowExecutionTimedOut,
                        EventType.ChildWorkflowExecutionTerminated):
                init = a.get("initiated_event_id", EMPTY_EVENT_ID)
                slot = children.release(init)
                attrs[0] = init

            elif et == (
                    EventType.RequestCancelExternalWorkflowExecutionInitiated):
                slot = cancels.alloc(ev.event_id)

            elif et in (
                    EventType.RequestCancelExternalWorkflowExecutionFailed,
                    EventType.ExternalWorkflowExecutionCancelRequested):
                init = a.get("initiated_event_id", EMPTY_EVENT_ID)
                slot = cancels.release(init)
                attrs[0] = init

            elif et == EventType.SignalExternalWorkflowExecutionInitiated:
                slot = signals.alloc(ev.event_id)

            elif et in (EventType.SignalExternalWorkflowExecutionFailed,
                        EventType.ExternalWorkflowExecutionSignaled):
                init = a.get("initiated_event_id", EMPTY_EVENT_ID)
                slot = signals.release(init)
                attrs[0] = init

            elif et in (
                EventType.RequestCancelActivityTaskFailed,
                EventType.CancelTimerFailed,
                EventType.UpsertWorkflowSearchAttributes,
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
                int(et), ev.event_id, ev.version, ev.task_id,
                rel_ts(ev.timestamp), batch_first,
                1 if i == len(batch) - 1 else 0, slot, *attrs,
            ])

    arr = np.asarray(rows, dtype=np.int64).reshape(-1, S.EV_N)
    if arr.size and (arr.max() > _INT32_MAX or arr.min() < -(2**31)):
        raise PackError("event field does not fit int32")
    return arr.astype(np.int32)


def epoch_of(histories: Sequence[Sequence[Sequence[HistoryEvent]]]) -> int:
    """The batch epoch the port's ``pack_histories`` takes: the least
    first-event second over the histories."""
    firsts = [h[0][0].timestamp // SECONDS for h in histories if h and h[0]]
    return min(firsts) if firsts else 0


def teb(rows: Sequence[np.ndarray], steps: int) -> np.ndarray:
    """[steps, EV_N, B] int32 field-major events, padding rows of type
    -1 (zeros elsewhere), as the port's dense layouts pad."""
    out = np.zeros((steps, S.EV_N, len(rows)), np.int32)
    out[:, S.EV_TYPE, :] = -1
    for b, r in enumerate(rows):
        out[:r.shape[0], :, b] = r
    return out
