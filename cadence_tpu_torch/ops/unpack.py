"""Unpack replayed state into canonical host snapshots.

A copy of the reference package's ``state_row_to_snapshot`` and
``split_lane_snapshots``: the same snapshot dict from the same state row,
so snapshots of the two packages compare with ``==``. Timestamps are
second-granular (the device ABI) and string-keyed fields are int31
hashes. State may be numpy or torch (on any device).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import schema as S

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
