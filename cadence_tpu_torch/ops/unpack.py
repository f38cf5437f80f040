"""Unpack replayed state into canonical host snapshots and MutableStates.

A copy of the reference package's ``ops/unpack.py``. Two converters
produce the same canonical "replay snapshot" dict:

  * ``state_row_to_snapshot``: from kernel output (a StateTensors row),
  * ``mutable_state_to_snapshot``: from the host oracle's MutableState,

so snapshots of the two packages, and of the device and host routes,
compare with ``==``. Timestamps are second-granular (the device ABI) and
string-keyed fields are int31 hashes. ``state_row_to_snapshot`` also
takes torch state on any device (it copies the one row it reads).

``state_row_to_mutable_state`` rehydrates a full MutableState (strings
from the packer's side table): what a rebuild returns. It reads numpy
state only: on a CUDA tensor every row index would be a synchronous
device-to-host copy, dozens per history, so the rebuild path brings each
replayed batch to the host once (``schema.state_to_numpy``) and
rehydrates from there.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.enums import CloseStatus, ParentClosePolicy, WorkflowState
from ..core.mutable_state import (
    ActivityInfo,
    ChildExecutionInfo,
    MutableState,
    RequestCancelInfo,
    SignalInfo,
    TimerInfo,
)
from ..core.version_history import (
    VersionHistories,
    VersionHistory,
    VersionHistoryItem,
)
from ..utils.hashing import hash31
from . import schema as S
from .pack import SECONDS, WorkflowSideTable

# exec columns holding timestamps (epoch-relative on device)
_EXEC_TS_KEYS = {
    "start_ts", "dec_scheduled_ts", "dec_started_ts",
    "dec_original_scheduled_ts", "wf_expiration_ts",
}


def _abs_s(v: int, epoch_s: int) -> int:
    """Inverse of the packer's rel_ts: 0 stays the unset sentinel."""
    return v + epoch_s - 1 if v > 0 else v


_EXEC_FIELDS = [
    ("state", S.X_STATE),
    ("close_status", S.X_CLOSE_STATUS),
    ("next_event_id", S.X_NEXT_EVENT_ID),
    ("last_first_event_id", S.X_LAST_FIRST_EVENT_ID),
    ("last_event_task_id", S.X_LAST_EVENT_TASK_ID),
    ("last_processed_event", S.X_LAST_PROCESSED_EVENT),
    ("start_ts", S.X_START_TS),
    ("workflow_timeout", S.X_WORKFLOW_TIMEOUT),
    ("decision_timeout_value", S.X_DECISION_TIMEOUT_VALUE),
    ("dec_version", S.X_DEC_VERSION),
    ("dec_schedule_id", S.X_DEC_SCHEDULE_ID),
    ("dec_started_id", S.X_DEC_STARTED_ID),
    ("dec_timeout", S.X_DEC_TIMEOUT),
    ("dec_attempt", S.X_DEC_ATTEMPT),
    ("dec_scheduled_ts", S.X_DEC_SCHEDULED_TS),
    ("dec_started_ts", S.X_DEC_STARTED_TS),
    ("dec_original_scheduled_ts", S.X_DEC_ORIGINAL_SCHEDULED_TS),
    ("cancel_requested", S.X_CANCEL_REQUESTED),
    ("signal_count", S.X_SIGNAL_COUNT),
    ("attempt", S.X_ATTEMPT),
    ("has_retry_policy", S.X_HAS_RETRY_POLICY),
    ("completion_event_batch_id", S.X_COMPLETION_EVENT_BATCH_ID),
    ("parent_initiated_id", S.X_PARENT_INITIATED_ID),
    ("wf_expiration_ts", S.X_WF_EXPIRATION_TS),
    ("cur_version", S.X_CUR_VERSION),
]


def state_row_to_snapshot(
    state: S.StateTensors, b: int, epoch_s: int = 0
) -> Dict[str, Any]:
    """Canonical snapshot of workflow ``b`` from kernel output."""
    if isinstance(state.exec_info, torch.Tensor):
        state, b = S.state_to_numpy(state.map(lambda x: x[b : b + 1])), 0
    ex = np.asarray(state.exec_info[b])
    snap: Dict[str, Any] = {
        "exec": {
            k: (_abs_s(int(ex[c]), epoch_s) if k in _EXEC_TS_KEYS
                else int(ex[c]))
            for k, c in _EXEC_FIELDS
        }
    }

    acts = {}
    for row in np.asarray(state.activities[b]):
        if row[S.AC_OCC]:
            acts[int(row[S.AC_SCHEDULE_ID])] = {
                "version": int(row[S.AC_VERSION]),
                "scheduled_event_batch_id": int(row[S.AC_SCHEDULED_BATCH_ID]),
                "scheduled_ts": _abs_s(int(row[S.AC_SCHEDULED_TS]), epoch_s),
                "started_id": int(row[S.AC_STARTED_ID]),
                "started_ts": _abs_s(int(row[S.AC_STARTED_TS]), epoch_s),
                "id_hash": int(row[S.AC_ID_HASH]),
                "schedule_to_start": int(row[S.AC_SCH_TO_START]),
                "schedule_to_close": int(row[S.AC_SCH_TO_CLOSE]),
                "start_to_close": int(row[S.AC_START_TO_CLOSE]),
                "heartbeat": int(row[S.AC_HEARTBEAT]),
                "cancel_requested": int(row[S.AC_CANCEL_REQUESTED]),
                "cancel_request_id": int(row[S.AC_CANCEL_REQUEST_ID]),
                "attempt": int(row[S.AC_ATTEMPT]),
                "has_retry": int(row[S.AC_HAS_RETRY]),
                "expiration_ts": _abs_s(int(row[S.AC_EXPIRATION_TS]),
                                        epoch_s),
                "last_hb_ts": _abs_s(int(row[S.AC_LAST_HB_TS]), epoch_s),
            }
    snap["activities"] = acts

    timers = {}
    for row in np.asarray(state.timers[b]):
        if row[S.TI_OCC]:
            timers[int(row[S.TI_STARTED_ID])] = {
                "version": int(row[S.TI_VERSION]),
                "id_hash": int(row[S.TI_ID_HASH]),
                "expiry_ts": _abs_s(int(row[S.TI_EXPIRY_TS]), epoch_s),
            }
    snap["timers"] = timers

    children = {}
    for row in np.asarray(state.children[b]):
        if row[S.CH_OCC]:
            children[int(row[S.CH_INITIATED_ID])] = {
                "version": int(row[S.CH_VERSION]),
                "initiated_event_batch_id": int(row[S.CH_INITIATED_BATCH_ID]),
                "started_id": int(row[S.CH_STARTED_ID]),
                "wf_id_hash": int(row[S.CH_WF_ID_HASH]),
                "run_id_hash": int(row[S.CH_RUN_ID_HASH]),
                "policy": int(row[S.CH_POLICY]),
            }
    snap["children"] = children

    for name, table, occ_col, init_col, ver_col, batch_col in (
        ("cancels", state.cancels, S.RC_OCC, S.RC_INITIATED_ID,
         S.RC_VERSION, S.RC_INITIATED_BATCH_ID),
        ("signals", state.signals, S.SG_OCC, S.SG_INITIATED_ID,
         S.SG_VERSION, S.SG_INITIATED_BATCH_ID),
    ):
        entries = {}
        for row in np.asarray(table[b]):
            if row[occ_col]:
                entries[int(row[init_col])] = {
                    "version": int(row[ver_col]),
                    "initiated_event_batch_id": int(row[batch_col]),
                }
        snap[name] = entries

    n = int(state.vh_len[b])
    snap["version_history"] = [
        (int(e), int(v)) for e, v in np.asarray(state.vh_items[b][:n])
    ]
    return snap


def mutable_state_to_snapshot(ms: MutableState) -> Dict[str, Any]:
    """Same canonical form, from the host oracle."""
    ei = ms.execution_info
    s = lambda ns: ns // SECONDS
    snap: Dict[str, Any] = {
        "exec": {
            "state": int(ei.state),
            "close_status": int(ei.close_status),
            "next_event_id": ei.next_event_id,
            "last_first_event_id": ei.last_first_event_id,
            "last_event_task_id": ei.last_event_task_id,
            "last_processed_event": ei.last_processed_event,
            "start_ts": s(ei.start_timestamp),
            "workflow_timeout": ei.workflow_timeout,
            "decision_timeout_value": ei.decision_timeout_value,
            "dec_version": ei.decision_version,
            "dec_schedule_id": ei.decision_schedule_id,
            "dec_started_id": ei.decision_started_id,
            "dec_timeout": ei.decision_timeout,
            "dec_attempt": ei.decision_attempt,
            "dec_scheduled_ts": s(ei.decision_scheduled_timestamp),
            "dec_started_ts": s(ei.decision_started_timestamp),
            "dec_original_scheduled_ts": s(ei.decision_original_scheduled_timestamp),
            "cancel_requested": int(ei.cancel_requested),
            "signal_count": ei.signal_count,
            "attempt": ei.attempt,
            "has_retry_policy": int(ei.has_retry_policy),
            "completion_event_batch_id": ei.completion_event_batch_id,
            "parent_initiated_id": ei.initiated_id,
            "wf_expiration_ts": s(ei.expiration_time),
            "cur_version": ms.current_version,
        },
        "activities": {
            sid: {
                "version": ai.version,
                "scheduled_event_batch_id": ai.scheduled_event_batch_id,
                "scheduled_ts": s(ai.scheduled_time),
                "started_id": ai.started_id,
                "started_ts": s(ai.started_time),
                "id_hash": hash31(ai.activity_id),
                "schedule_to_start": ai.schedule_to_start_timeout,
                "schedule_to_close": ai.schedule_to_close_timeout,
                "start_to_close": ai.start_to_close_timeout,
                "heartbeat": ai.heartbeat_timeout,
                "cancel_requested": int(ai.cancel_requested),
                "cancel_request_id": ai.cancel_request_id,
                "attempt": ai.attempt,
                "has_retry": int(ai.has_retry_policy),
                "expiration_ts": s(ai.expiration_time),
                "last_hb_ts": s(ai.last_heartbeat_updated_time),
            }
            for sid, ai in ms.pending_activities.items()
        },
        "timers": {
            ti.started_id: {
                "version": ti.version,
                "id_hash": hash31(ti.timer_id),
                "expiry_ts": s(ti.expiry_time),
            }
            for ti in ms.pending_timers.values()
        },
        "children": {
            cid: {
                "version": ci.version,
                "initiated_event_batch_id": ci.initiated_event_batch_id,
                "started_id": ci.started_id,
                "wf_id_hash": hash31(ci.started_workflow_id),
                "run_id_hash": hash31(ci.started_run_id) if ci.started_run_id else 0,
                "policy": int(ci.parent_close_policy),
            }
            for cid, ci in ms.pending_children.items()
        },
        "cancels": {
            rid: {
                "version": rc.version,
                "initiated_event_batch_id": rc.initiated_event_batch_id,
            }
            for rid, rc in ms.pending_request_cancels.items()
        },
        "signals": {
            sid: {
                "version": si.version,
                "initiated_event_batch_id": si.initiated_event_batch_id,
            }
            for sid, si in ms.pending_signals.items()
        },
        "version_history": (
            [
                (it.event_id, it.version)
                for it in ms.version_histories.get_current_version_history().items
            ]
            if ms.version_histories is not None
            else []
        ),
    }
    return snap


def split_lane_snapshots(packed, final: S.StateTensors) -> list:
    """Split a lane-packed replay's output back into per-history
    snapshots, in the packer's input order.

    ``packed``: the :class:`~cadence_tpu_torch.ops.pack.PackedLanes` whose
    lanes were replayed; ``final``: the output state of
    ``replay_packed_lanes``/``replay_scan_packed`` (one row per history).
    Walks the per-lane segment tables rather than trusting row order, so
    a mis-scattered row surfaces as a snapshot mismatch, not silent
    misattribution."""
    final = S.state_to_numpy(final)
    n = packed.n_histories
    snaps = [None] * n
    for segs in packed.lane_segments:
        for out_row, _start, _end in segs:
            snaps[out_row] = state_row_to_snapshot(
                final, out_row, packed.epoch_s
            )
    missing = [i for i in range(n) if snaps[i] is None]
    if missing:
        raise ValueError(
            f"lane segment tables miss output rows {missing[:8]}"
        )
    return snaps


def state_row_to_mutable_state(
    state: S.StateTensors, b: int, side: WorkflowSideTable,
    domain_id: str = "",
    epoch_s: int = 0,
) -> MutableState:
    """Rehydrate a full MutableState from kernel output + side table.

    ``state`` must be numpy (``schema.state_to_numpy`` of a replay
    result): a torch tensor raises instead of paying a device copy per
    field and row."""
    if isinstance(state.exec_info, torch.Tensor):
        raise TypeError(
            "state_row_to_mutable_state reads numpy state; bring the batch "
            "to the host once with schema.state_to_numpy")

    def ns(v: int) -> int:
        return _abs_s(int(v), epoch_s) * SECONDS

    ex = np.asarray(state.exec_info[b])
    ms = MutableState(domain_id=domain_id, current_version=int(ex[S.X_CUR_VERSION]))
    ei = ms.execution_info
    ei.workflow_id = side.workflow_id
    ei.run_id = side.run_id
    ei.create_request_id = side.request_id
    ei.task_list = side.task_list
    ei.workflow_type_name = side.workflow_type
    ei.cron_schedule = side.cron_schedule
    ei.parent_domain_id = side.parent_domain
    ei.parent_workflow_id = side.parent_workflow_id
    ei.parent_run_id = side.parent_run_id
    ei.memo = dict(side.memo)
    ei.search_attributes = dict(side.search_attributes)
    ei.auto_reset_points = [dict(p) for p in side.auto_reset_points]
    ei.first_decision_backoff_deadline = (
        side.first_decision_backoff_deadline
    )
    ei.state = WorkflowState(int(ex[S.X_STATE]))
    ei.close_status = CloseStatus(int(ex[S.X_CLOSE_STATUS]))
    ei.next_event_id = int(ex[S.X_NEXT_EVENT_ID])
    ei.last_first_event_id = int(ex[S.X_LAST_FIRST_EVENT_ID])
    ei.last_event_task_id = int(ex[S.X_LAST_EVENT_TASK_ID])
    ei.last_processed_event = int(ex[S.X_LAST_PROCESSED_EVENT])
    ei.start_timestamp = ns(ex[S.X_START_TS])
    ei.workflow_timeout = int(ex[S.X_WORKFLOW_TIMEOUT])
    ei.decision_timeout_value = int(ex[S.X_DECISION_TIMEOUT_VALUE])
    ei.decision_version = int(ex[S.X_DEC_VERSION])
    ei.decision_schedule_id = int(ex[S.X_DEC_SCHEDULE_ID])
    ei.decision_started_id = int(ex[S.X_DEC_STARTED_ID])
    ei.decision_timeout = int(ex[S.X_DEC_TIMEOUT])
    ei.decision_attempt = int(ex[S.X_DEC_ATTEMPT])
    ei.decision_scheduled_timestamp = ns(ex[S.X_DEC_SCHEDULED_TS])
    ei.decision_started_timestamp = ns(ex[S.X_DEC_STARTED_TS])
    ei.decision_original_scheduled_timestamp = ns(ex[S.X_DEC_ORIGINAL_SCHEDULED_TS])
    ei.cancel_requested = bool(ex[S.X_CANCEL_REQUESTED])
    ei.signal_count = int(ex[S.X_SIGNAL_COUNT])
    ei.attempt = int(ex[S.X_ATTEMPT])
    ei.has_retry_policy = bool(ex[S.X_HAS_RETRY_POLICY])
    ei.completion_event_batch_id = int(ex[S.X_COMPLETION_EVENT_BATCH_ID])
    ei.initiated_id = int(ex[S.X_PARENT_INITIATED_ID])
    ei.expiration_time = ns(ex[S.X_WF_EXPIRATION_TS])

    for slot, row in enumerate(np.asarray(state.activities[b])):
        if not row[S.AC_OCC]:
            continue
        activity_id = side.activity_ids.get(slot, "")
        ai = ActivityInfo(
            version=int(row[S.AC_VERSION]),
            schedule_id=int(row[S.AC_SCHEDULE_ID]),
            scheduled_event_batch_id=int(row[S.AC_SCHEDULED_BATCH_ID]),
            scheduled_time=ns(row[S.AC_SCHEDULED_TS]),
            started_id=int(row[S.AC_STARTED_ID]),
            started_time=ns(row[S.AC_STARTED_TS]),
            activity_id=activity_id,
            schedule_to_start_timeout=int(row[S.AC_SCH_TO_START]),
            schedule_to_close_timeout=int(row[S.AC_SCH_TO_CLOSE]),
            start_to_close_timeout=int(row[S.AC_START_TO_CLOSE]),
            heartbeat_timeout=int(row[S.AC_HEARTBEAT]),
            cancel_requested=bool(row[S.AC_CANCEL_REQUESTED]),
            cancel_request_id=int(row[S.AC_CANCEL_REQUEST_ID]),
            attempt=int(row[S.AC_ATTEMPT]),
            has_retry_policy=bool(row[S.AC_HAS_RETRY]),
            expiration_time=ns(row[S.AC_EXPIRATION_TS]),
            last_heartbeat_updated_time=ns(row[S.AC_LAST_HB_TS]),
            task_list=side.activity_task_lists.get(slot, ""),
        )
        ms.pending_activities[ai.schedule_id] = ai
        ms.activity_by_id[ai.activity_id] = ai.schedule_id

    for slot, row in enumerate(np.asarray(state.timers[b])):
        if not row[S.TI_OCC]:
            continue
        timer_id = side.timer_ids.get(slot, "")
        ti = TimerInfo(
            version=int(row[S.TI_VERSION]),
            timer_id=timer_id,
            started_id=int(row[S.TI_STARTED_ID]),
            expiry_time=ns(row[S.TI_EXPIRY_TS]),
        )
        ms.pending_timers[timer_id] = ti
        ms.timer_by_started_id[ti.started_id] = timer_id

    for slot, row in enumerate(np.asarray(state.children[b])):
        if not row[S.CH_OCC]:
            continue
        ci = ChildExecutionInfo(
            version=int(row[S.CH_VERSION]),
            initiated_id=int(row[S.CH_INITIATED_ID]),
            initiated_event_batch_id=int(row[S.CH_INITIATED_BATCH_ID]),
            started_id=int(row[S.CH_STARTED_ID]),
            started_workflow_id=side.child_workflow_ids.get(slot, ""),
            started_run_id=side.child_run_ids.get(slot, ""),
            domain_name=side.child_domains.get(slot, ""),
            workflow_type_name=side.child_types.get(slot, ""),
            parent_close_policy=ParentClosePolicy(int(row[S.CH_POLICY])),
        )
        ms.pending_children[ci.initiated_id] = ci

    for slot, row in enumerate(np.asarray(state.cancels[b])):
        if row[S.RC_OCC]:
            tgt = side.cancel_targets.get(slot) or ("", "", "", False)
            rc = RequestCancelInfo(
                version=int(row[S.RC_VERSION]),
                initiated_id=int(row[S.RC_INITIATED_ID]),
                initiated_event_batch_id=int(row[S.RC_INITIATED_BATCH_ID]),
                target_domain_id=tgt[0],
                target_workflow_id=tgt[1],
                target_run_id=tgt[2],
                target_child_workflow_only=tgt[3],
            )
            ms.pending_request_cancels[rc.initiated_id] = rc

    for slot, row in enumerate(np.asarray(state.signals[b])):
        if row[S.SG_OCC]:
            tgt = side.signal_targets.get(slot) or ("", "", "", False)
            si = SignalInfo(
                version=int(row[S.SG_VERSION]),
                initiated_id=int(row[S.SG_INITIATED_ID]),
                initiated_event_batch_id=int(row[S.SG_INITIATED_BATCH_ID]),
                target_domain_id=tgt[0],
                target_workflow_id=tgt[1],
                target_run_id=tgt[2],
                target_child_workflow_only=tgt[3],
            )
            ms.pending_signals[si.initiated_id] = si

    n = int(state.vh_len[b])
    vh = VersionHistory(
        items=[
            VersionHistoryItem(int(e), int(v))
            for e, v in np.asarray(state.vh_items[b][:n])
        ]
    )
    ms.version_histories = VersionHistories([vh], 0)
    return ms
