"""The plain FSM step: one step of history events applied to a batch of
workflow states, as masked ``torch.where`` row updates.

Frozen copy of ``RowMap``, ``state_to_rows``, ``rows_to_state`` and
``_step_plain`` of ``cadence_tpu_torch/ops/replay_cuda.py`` (the port as
of the first benchmark), which follow the reference's
``stateBuilder.applyEvents`` step by step; ``replay`` loops it over the
int32 field-major events. The benchmark's reference runs it on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from . import schema as S
from .enums import (
    CloseStatus, EventType as E, WorkflowState,
    WORKFLOW_CLOSE_STATUS, decision_attempt_increment,
)
from .ids import EMPTY_EVENT_ID, EMPTY_VERSION

@dataclasses.dataclass(frozen=True)
class RowMap:
    """Static row offsets of each state tensor inside the [R, B] matrix."""

    caps: S.Capacities
    exec0: int = 0

    @property
    def vh0(self) -> int:  # vh_items rows: vh0 + i*2 + {0: event_id, 1: version}
        return self.exec0 + S.X_N

    @property
    def vhlen(self) -> int:
        return self.vh0 + 2 * self.caps.max_version_items

    @property
    def act0(self) -> int:
        return self.vhlen + 1

    @property
    def tim0(self) -> int:
        return self.act0 + self.caps.max_activities * S.AC_N

    @property
    def chd0(self) -> int:
        return self.tim0 + self.caps.max_timers * S.TI_N

    @property
    def rc0(self) -> int:
        return self.chd0 + self.caps.max_children * S.CH_N

    @property
    def sg0(self) -> int:
        return self.rc0 + self.caps.max_request_cancels * S.RC_N

    @property
    def rows(self) -> int:
        return self.sg0 + self.caps.max_signals_ext * S.SG_N

    @property
    def rows_padded(self) -> int:
        return ((self.rows + 7) // 8) * 8


def state_to_rows(state: S.StateTensors, rm: RowMap) -> torch.Tensor:
    """Torch StateTensors -> contiguous [R_pad, B] int32, batch minor."""
    b = state.exec_info.shape[0]
    parts = [
        state.exec_info.T,
        state.vh_items.reshape(b, -1).T,
        state.vh_len[None, :],
        state.activities.reshape(b, -1).T,
        state.timers.reshape(b, -1).T,
        state.children.reshape(b, -1).T,
        state.cancels.reshape(b, -1).T,
        state.signals.reshape(b, -1).T,
    ]
    pad = rm.rows_padded - rm.rows
    if pad:
        parts.append(state.exec_info.new_zeros((pad, b)))
    return torch.cat(parts, dim=0).to(torch.int32).contiguous()


def rows_to_state(rows: torch.Tensor, rm: RowMap) -> S.StateTensors:
    caps = rm.caps
    b = rows.shape[1]

    def take(r0, n, shape):
        return rows[r0 : r0 + n].T.reshape(shape).contiguous()

    return S.StateTensors(
        exec_info=take(rm.exec0, S.X_N, (b, S.X_N)),
        vh_items=take(rm.vh0, 2 * caps.max_version_items,
                      (b, caps.max_version_items, 2)),
        vh_len=rows[rm.vhlen].contiguous(),
        activities=take(rm.act0, caps.max_activities * S.AC_N,
                        (b, caps.max_activities, S.AC_N)),
        timers=take(rm.tim0, caps.max_timers * S.TI_N,
                    (b, caps.max_timers, S.TI_N)),
        children=take(rm.chd0, caps.max_children * S.CH_N,
                      (b, caps.max_children, S.CH_N)),
        cancels=take(rm.rc0, caps.max_request_cancels * S.RC_N,
                     (b, caps.max_request_cancels, S.RC_N)),
        signals=take(rm.sg0, caps.max_signals_ext * S.SG_N,
                     (b, caps.max_signals_ext, S.SG_N)),
    )


def _step_plain(st: torch.Tensor, f: torch.Tensor, rm: RowMap,
                ar: dict) -> None:
    """Apply one step's events ``f`` [EV_N, B] to ``st`` [R, B] in place,
    group by group in the reference kernel's order (later groups read
    earlier groups' writes of the same step)."""
    caps = rm.caps
    B = st.shape[1]
    X = rm.exec0
    et = f[S.EV_TYPE]
    valid = et >= 0
    ev_id, version, ts = f[S.EV_ID], f[S.EV_VERSION], f[S.EV_TS]
    batch_first, slot = f[S.EV_BATCH_FIRST], f[S.EV_SLOT]
    a0, a1, a2, a3 = f[S.EV_A0], f[S.EV_A1], f[S.EV_A2], f[S.EV_A3]
    a4, a5, a6, a7 = f[S.EV_A4], f[S.EV_A5], f[S.EV_A6], f[S.EV_A7]

    def wr(r, mask, val):
        st[r] = torch.where(mask, val, st[r])

    def m(*types):
        out = et == int(types[0])
        for t in types[1:]:
            out = out | (et == int(t))
        return valid & out

    # ---- preamble (stateBuilder.go:134-155)
    wr(X + S.X_LAST_EVENT_TASK_ID, valid, f[S.EV_TASK_ID])
    wr(X + S.X_CUR_VERSION, valid, version)
    wr(X + S.X_NEXT_EVENT_ID, valid, ev_id + 1)
    wr(X + S.X_LAST_FIRST_EVENT_ID, valid, batch_first)

    # ---- version-history AddOrUpdateItem: clamped read of the last
    # materialized slot; a same-version write past capacity matches no slot
    cap_v = caps.max_version_items
    vh_len = st[rm.vhlen].clone()
    last_idx = torch.clamp_min(vh_len - 1, 0)
    if cap_v:
        vh_ver = st[rm.vh0 + 1 : rm.vh0 + 2 * cap_v : 2]
        read_idx = torch.clamp_max(last_idx, cap_v - 1)
        last_ver = torch.gather(vh_ver, 0, read_idx[None].long())[0]
    else:
        last_ver = torch.zeros_like(vh_len)
    same = (vh_len > 0) & (last_ver == version)
    if cap_v:
        write_idx = torch.where(same, last_idx,
                                torch.clamp_max(vh_len, cap_v - 1))
        wmask = valid[None] & (write_idx[None] == ar[cap_v])
        ev_rows = st[rm.vh0 : rm.vh0 + 2 * cap_v : 2]
        ver_rows = st[rm.vh0 + 1 : rm.vh0 + 2 * cap_v : 2]
        ev_rows.copy_(torch.where(wmask, ev_id[None], ev_rows))
        ver_rows.copy_(torch.where(wmask, version[None], ver_rows))
    wr(rm.vhlen, valid & ~same, vh_len + 1)

    # ---- workflow lifecycle
    m_start = m(E.WorkflowExecutionStarted)
    wr(X + S.X_STATE, m_start, int(WorkflowState.Created))
    wr(X + S.X_CLOSE_STATUS, m_start, int(CloseStatus.NONE))
    wr(X + S.X_LAST_PROCESSED_EVENT, m_start, EMPTY_EVENT_ID)
    wr(X + S.X_START_TS, m_start, ts)
    wr(X + S.X_WORKFLOW_TIMEOUT, m_start, a0)
    wr(X + S.X_DECISION_TIMEOUT_VALUE, m_start, a1)
    wr(X + S.X_ATTEMPT, m_start, a2)
    wr(X + S.X_HAS_RETRY_POLICY, m_start, a3)
    wr(X + S.X_WF_EXPIRATION_TS, m_start, a4)
    wr(X + S.X_PARENT_INITIATED_ID, m_start, a7)
    wr(X + S.X_DEC_SCHEDULE_ID, m_start, EMPTY_EVENT_ID)
    wr(X + S.X_DEC_STARTED_ID, m_start, EMPTY_EVENT_ID)
    wr(X + S.X_DEC_VERSION, m_start, EMPTY_VERSION)
    for col in (S.X_DEC_TIMEOUT, S.X_DEC_ATTEMPT, S.X_DEC_SCHEDULED_TS,
                S.X_DEC_STARTED_TS, S.X_DEC_ORIGINAL_SCHEDULED_TS):
        wr(X + col, m_start, 0)

    close_status = torch.zeros_like(et)
    for t, cs in WORKFLOW_CLOSE_STATUS:
        close_status = torch.where(m(t), int(cs), close_status)
    m_close = close_status > 0
    wr(X + S.X_STATE, m_close, int(WorkflowState.Completed))
    wr(X + S.X_CLOSE_STATUS, m_close, close_status)
    wr(X + S.X_COMPLETION_EVENT_BATCH_ID, m_close, batch_first)

    wr(X + S.X_CANCEL_REQUESTED, m(E.WorkflowExecutionCancelRequested), 1)
    wr(X + S.X_SIGNAL_COUNT, m(E.WorkflowExecutionSignaled),
       st[X + S.X_SIGNAL_COUNT] + 1)

    # ---- decision sub-FSM
    m_dsch = m(E.DecisionTaskScheduled)
    wr(X + S.X_DEC_VERSION, m_dsch, version)
    wr(X + S.X_DEC_SCHEDULE_ID, m_dsch, ev_id)
    wr(X + S.X_DEC_STARTED_ID, m_dsch, EMPTY_EVENT_ID)
    wr(X + S.X_DEC_TIMEOUT, m_dsch, a0)
    wr(X + S.X_DEC_ATTEMPT, m_dsch, a1)
    wr(X + S.X_DEC_SCHEDULED_TS, m_dsch, ts)
    wr(X + S.X_DEC_ORIGINAL_SCHEDULED_TS, m_dsch, ts)
    wr(X + S.X_DEC_STARTED_TS, m_dsch, 0)

    m_dsta = m(E.DecisionTaskStarted)
    wr(X + S.X_STATE,
       m_dsta & (st[X + S.X_STATE] == int(WorkflowState.Created)),
       int(WorkflowState.Running))
    wr(X + S.X_DEC_VERSION, m_dsta, version)
    wr(X + S.X_DEC_STARTED_ID, m_dsta, ev_id)
    wr(X + S.X_DEC_ATTEMPT, m_dsta, 0)
    wr(X + S.X_DEC_STARTED_TS, m_dsta, ts)

    m_dcom = m(E.DecisionTaskCompleted)
    wr(X + S.X_DEC_VERSION, m_dcom, EMPTY_VERSION)
    wr(X + S.X_DEC_SCHEDULE_ID, m_dcom, EMPTY_EVENT_ID)
    wr(X + S.X_DEC_STARTED_ID, m_dcom, EMPTY_EVENT_ID)
    for col in (S.X_DEC_TIMEOUT, S.X_DEC_ATTEMPT, S.X_DEC_SCHEDULED_TS,
                S.X_DEC_STARTED_TS):
        wr(X + col, m_dcom, 0)
    wr(X + S.X_LAST_PROCESSED_EVENT, m_dcom, a0)

    m_dto = m(E.DecisionTaskTimedOut)
    m_dfail = m(E.DecisionTaskFailed)
    inc = decision_attempt_increment(m_dfail, m_dto, a0)
    no_inc = (m_dto | m_dfail) & ~inc
    new_attempt = st[X + S.X_DEC_ATTEMPT] + 1
    wr(X + S.X_DEC_VERSION, inc, st[X + S.X_CUR_VERSION])
    wr(X + S.X_DEC_SCHEDULE_ID, inc, batch_first)
    wr(X + S.X_DEC_STARTED_ID, inc, EMPTY_EVENT_ID)
    wr(X + S.X_DEC_TIMEOUT, inc, st[X + S.X_DECISION_TIMEOUT_VALUE])
    wr(X + S.X_DEC_ATTEMPT, inc, new_attempt)
    wr(X + S.X_DEC_SCHEDULED_TS, inc, ts)
    wr(X + S.X_DEC_STARTED_TS, inc, 0)
    wr(X + S.X_DEC_ORIGINAL_SCHEDULED_TS, inc, 0)
    wr(X + S.X_DEC_VERSION, no_inc, EMPTY_VERSION)
    wr(X + S.X_DEC_SCHEDULE_ID, no_inc, EMPTY_EVENT_ID)
    wr(X + S.X_DEC_STARTED_ID, no_inc, EMPTY_EVENT_ID)
    for col in (S.X_DEC_TIMEOUT, S.X_DEC_ATTEMPT, S.X_DEC_SCHEDULED_TS,
                S.X_DEC_STARTED_TS, S.X_DEC_ORIGINAL_SCHEDULED_TS):
        wr(X + col, no_inc, 0)

    # ---- slot tables: a [cap, ncol, B] view per table and a [cap, B]
    # one-hot of EV_SLOT (a slot of -1 or >= cap matches nothing)
    def table(r0, cap, ncol):
        return st[r0 : r0 + cap * ncol].view(cap, ncol, B)

    def onehot(cap, *types):
        return m(*types)[None] & (slot[None] == ar[cap])

    def set_cols(tbl, oh, cols_vals):
        for col, val in cols_vals:
            v = val[None] if isinstance(val, torch.Tensor) else val
            tbl[:, col] = torch.where(oh, v, tbl[:, col])

    def set_row(tbl, oh, vals):
        full = torch.stack([
            v if isinstance(v, torch.Tensor) else torch.full_like(et, v)
            for v in vals
        ])
        tbl.copy_(torch.where(oh[:, None], full[None], tbl))

    def clear(tbl, oh):
        tbl.copy_(torch.where(oh[:, None], 0, tbl))

    cap = caps.max_activities
    if cap:
        tbl = table(rm.act0, cap, S.AC_N)
        exp_interval = torch.where((a5 > 0) & (a6 > a2), a6, a2)
        vals = [0] * S.AC_N
        vals[S.AC_OCC], vals[S.AC_VERSION] = 1, version
        vals[S.AC_SCHEDULE_ID] = ev_id
        vals[S.AC_SCHEDULED_BATCH_ID] = batch_first
        vals[S.AC_SCHEDULED_TS] = ts
        vals[S.AC_STARTED_ID] = EMPTY_EVENT_ID
        vals[S.AC_ID_HASH], vals[S.AC_SCH_TO_START] = a0, a1
        vals[S.AC_SCH_TO_CLOSE], vals[S.AC_START_TO_CLOSE] = a2, a3
        vals[S.AC_HEARTBEAT] = a4
        vals[S.AC_CANCEL_REQUEST_ID] = EMPTY_EVENT_ID
        vals[S.AC_HAS_RETRY] = a5
        vals[S.AC_EXPIRATION_TS] = ts + exp_interval
        set_row(tbl, onehot(cap, E.ActivityTaskScheduled), vals)
        set_cols(tbl, onehot(cap, E.ActivityTaskStarted), (
            (S.AC_VERSION, version), (S.AC_STARTED_ID, ev_id),
            (S.AC_STARTED_TS, ts), (S.AC_LAST_HB_TS, ts),
            (S.AC_ATTEMPT, a1)))
        clear(tbl, onehot(cap, E.ActivityTaskCompleted, E.ActivityTaskFailed,
                          E.ActivityTaskTimedOut, E.ActivityTaskCanceled))
        set_cols(tbl, onehot(cap, E.ActivityTaskCancelRequested), (
            (S.AC_VERSION, version), (S.AC_CANCEL_REQUESTED, 1),
            (S.AC_CANCEL_REQUEST_ID, ev_id)))

    cap = caps.max_timers
    if cap:
        tbl = table(rm.tim0, cap, S.TI_N)
        vals = [0] * S.TI_N
        vals[S.TI_OCC], vals[S.TI_VERSION] = 1, version
        vals[S.TI_STARTED_ID], vals[S.TI_ID_HASH] = ev_id, a0
        vals[S.TI_EXPIRY_TS] = ts + a1
        set_row(tbl, onehot(cap, E.TimerStarted), vals)
        clear(tbl, onehot(cap, E.TimerFired, E.TimerCanceled))

    cap = caps.max_children
    if cap:
        tbl = table(rm.chd0, cap, S.CH_N)
        vals = [0] * S.CH_N
        vals[S.CH_OCC], vals[S.CH_VERSION] = 1, version
        vals[S.CH_INITIATED_ID] = ev_id
        vals[S.CH_INITIATED_BATCH_ID] = batch_first
        vals[S.CH_STARTED_ID] = EMPTY_EVENT_ID
        vals[S.CH_WF_ID_HASH], vals[S.CH_POLICY] = a0, a1
        set_row(tbl, onehot(cap, E.StartChildWorkflowExecutionInitiated),
                vals)
        set_cols(tbl, onehot(cap, E.ChildWorkflowExecutionStarted), (
            (S.CH_STARTED_ID, ev_id), (S.CH_RUN_ID_HASH, a1)))
        clear(tbl, onehot(cap, E.StartChildWorkflowExecutionFailed,
                          E.ChildWorkflowExecutionCompleted,
                          E.ChildWorkflowExecutionFailed,
                          E.ChildWorkflowExecutionCanceled,
                          E.ChildWorkflowExecutionTimedOut,
                          E.ChildWorkflowExecutionTerminated))

    for r0, cap, ncol, t_init, t_close in (
        (rm.rc0, caps.max_request_cancels, S.RC_N,
         E.RequestCancelExternalWorkflowExecutionInitiated,
         (E.RequestCancelExternalWorkflowExecutionFailed,
          E.ExternalWorkflowExecutionCancelRequested)),
        (rm.sg0, caps.max_signals_ext, S.SG_N,
         E.SignalExternalWorkflowExecutionInitiated,
         (E.SignalExternalWorkflowExecutionFailed,
          E.ExternalWorkflowExecutionSignaled)),
    ):
        if cap:
            tbl = table(r0, cap, ncol)
            set_row(tbl, onehot(cap, t_init),
                    [1, version, ev_id, batch_first])
            clear(tbl, onehot(cap, *t_close))


def replay(events: torch.Tensor, rows: torch.Tensor,
           caps: S.Capacities) -> torch.Tensor:
    """Replay every step of int32 ``events`` [T, EV_N, B] onto ``rows``
    [R_pad, B]; returns new rows."""
    rm = RowMap(caps)
    sizes = {caps.max_version_items, caps.max_activities, caps.max_timers,
             caps.max_children, caps.max_request_cancels,
             caps.max_signals_ext}
    ar = {n: torch.arange(n, dtype=torch.int32, device=rows.device)[:, None]
          for n in sizes}
    st = rows.to(torch.int32).clone()
    for t in range(events.shape[0]):
        _step_plain(st, events[t].to(torch.int32), rm, ar)
    return st
