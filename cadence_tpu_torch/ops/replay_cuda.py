"""Batched FSM replay on the GPU: the CUDA kernel, its plain PyTorch
version, and the scan entry points built on them.

The counterpart of the reference package's ``ops/replay_pallas.py``. All
state of a batch lives in one int32 ``[R_pad, B]`` row matrix (``RowMap``:
exec-info columns, version-history slots, then the flattened slot tables),
batch minor. Events arrive field-major, ``[T, P, B]``: int32 with P = EV_N,
or the int16 narrow stream of ``narrow_events_teb`` with P = EV_N plus one
column per wide column.

``replay_rows`` and ``replay_rows_packed`` are the kernel wrappers. On a
CUDA tensor they launch ``csrc/replay_fsm.cu`` (one thread per history
lane, its state column held on chip across the time loop, the event
tiles staged through shared memory) and count the launch in
``replay_rows.launches``; on a CPU tensor they run ``replay_rows_plain``
and ``replay_rows_packed_plain``, the transition table written as masked
``torch.where`` row updates that follow the reference kernel step by
step. ``replay_rows_packed`` is the lane-packed route in one launch: each
lane flushes its state into an output row and resets at its own segment
ends, on any step. All compute the reference's
``stateBuilder.applyEvents`` semantics bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.enums import (
    CloseStatus, EventType as E, WorkflowState,
    WORKFLOW_CLOSE_STATUS, decision_attempt_increment,
)
from ..core.ids import EMPTY_EVENT_ID, EMPTY_VERSION

from . import schema as S


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


# --------------------------------------------------------------------------
# The int16 narrow event stream (numpy copies of the reference's helpers)
# --------------------------------------------------------------------------


def _phys_map(wide_cols):
    """Logical column -> physical int16 column start; wide columns
    occupy two physical columns (lo16, hi16)."""
    phys = {}
    p = 0
    for c in range(S.EV_N):
        phys[c] = p
        p += 2 if c in wide_cols else 1
    return phys, p


def narrow_events_teb(events_teb, force_wide=()):
    """Narrow an int32 [T, EV_N, B] event tensor to an int16 stream.

    The kernel is bound by streaming the event tensor from device memory,
    so halving its bytes is the throughput lever. Each column whose value
    span fits int16 is stored affine (``ev - base[c]``, base = column
    midrange); a wide column (hash-valued attributes, raw timestamps) is
    stored EXACTLY as two int16 halves (low 16 bits, high 16 bits). The
    kernel reconstructs exact int32 values either way, so the state
    output is bit-identical to the int32 path.

    ``force_wide``: columns stored wide regardless of this tensor's span
    (a dispatcher passes its running union, so the wide set only grows).

    Returns (ev16 [T, P, B] int16, base [EV_N] int32, wide_cols tuple),
    or None when EV_TYPE/EV_SLOT would be wide — callers keep the int32
    path, correctness never depends on narrowing.
    """
    ev = np.asarray(events_teb)
    lo = ev.min(axis=(0, 2)).astype(np.int64)
    hi = ev.max(axis=(0, 2)).astype(np.int64)
    wide_cols = tuple(sorted(set(
        int(c) for c in range(S.EV_N) if hi[c] - lo[c] > 65000
    ) | set(int(c) for c in force_wide)))
    if S.EV_TYPE in wide_cols or S.EV_SLOT in wide_cols:
        return None
    base64 = ((lo + hi) // 2)
    base64[list(wide_cols)] = 0
    phys, P = _phys_map(wide_cols)
    T, _, B = ev.shape
    out = np.empty((T, P, B), np.int16)
    # the wide lo-half is exactly the two's-complement int16 truncation,
    # and the affine subtraction cannot overflow int32 (|col - base| <=
    # ~32.5k by construction)
    for c in range(S.EV_N):
        p = phys[c]
        col = ev[:, c, :]
        if c in wide_cols:
            out[:, p, :] = col.astype(np.int16)          # low 16 bits
            out[:, p + 1, :] = (col >> 16).astype(np.int16)
        else:
            out[:, p, :] = (col - np.int32(base64[c])).astype(np.int16)
    return out, base64.astype(np.int32), wide_cols


def _check_stream(events: torch.Tensor, base, wide_cols) -> None:
    if events.dtype == torch.int32:
        if events.shape[1] != S.EV_N:
            raise ValueError(
                f"int32 events have {events.shape[1]} fields, want {S.EV_N}")
    elif events.dtype == torch.int16:
        if base is None:
            raise ValueError("int16 events need their affine base vector")
        _, p = _phys_map(tuple(wide_cols))
        if events.shape[1] != p:
            raise ValueError(
                f"int16 events have {events.shape[1]} physical columns, "
                f"wide_cols={tuple(wide_cols)} gives {p}")
    else:
        raise ValueError(f"events must be int32 or int16, got {events.dtype}")


def _base_list(base) -> list:
    if base is None:
        return [0] * S.EV_N
    if isinstance(base, torch.Tensor):
        base = base.detach().cpu().numpy()
    out = [int(v) for v in np.asarray(base, dtype=np.int64).reshape(-1)]
    if len(out) != S.EV_N:
        raise ValueError(f"base has {len(out)} entries, want {S.EV_N}")
    return out


# --------------------------------------------------------------------------
# The plain PyTorch version
# --------------------------------------------------------------------------


def _fields_at(events, t, base_t, phys, wide_cols):
    """[EV_N, B] int32 fields of step ``t`` (int16 reconstructed exactly:
    widened before any arithmetic)."""
    ev = events[t].to(torch.int32)
    if events.dtype == torch.int32:
        return ev
    rows = []
    for c in range(S.EV_N):
        p = phys[c]
        if c in wide_cols:
            rows.append((ev[p] & 0xFFFF) | (ev[p + 1] << 16))
        else:
            rows.append(ev[p] + base_t[c])
    return torch.stack(rows)


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


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _check_rows(rows: torch.Tensor, rm: RowMap, b: int) -> None:
    if rows.shape != (rm.rows_padded, b):
        raise ValueError(
            f"rows {tuple(rows.shape)} != ({rm.rows_padded}, {b})")


def _plain_setup(events, rows, caps, base, wide_cols):
    """What the plain step loop needs: (rm, fields-of-step function,
    arange table, a fresh int32 copy of ``rows``)."""
    _check_stream(events, base, wide_cols)
    rm = RowMap(caps)
    _check_rows(rows, rm, events.shape[2])
    wide_cols = tuple(wide_cols)
    phys, _ = _phys_map(wide_cols)
    base_t = torch.tensor(_base_list(base), dtype=torch.int32,
                          device=events.device)
    sizes = {caps.max_version_items, caps.max_activities, caps.max_timers,
             caps.max_children, caps.max_request_cancels,
             caps.max_signals_ext}
    ar = {n: torch.arange(n, dtype=torch.int32, device=rows.device)[:, None]
          for n in sizes}

    def fields(t):
        return _fields_at(events, t, base_t, phys, wide_cols)

    return rm, fields, ar, rows.to(torch.int32).clone()


def replay_rows_plain(events: torch.Tensor, rows: torch.Tensor,
                      caps: S.Capacities, base=None,
                      wide_cols: Sequence[int] = (), t0: int = 0,
                      t1: Optional[int] = None) -> torch.Tensor:
    """Replay steps ``[t0, t1)`` of ``events`` [T, P, B] onto ``rows``
    [R_pad, B] int32 with plain PyTorch ops; returns new rows.

    ``events`` is int32 (P = EV_N) or the int16 narrow stream with its
    ``base`` [EV_N] and ``wide_cols``. The reference for the CUDA kernel:
    same inputs, same rows, bit for bit."""
    rm, fields, ar, st = _plain_setup(events, rows, caps, base, wide_cols)
    t1 = events.shape[0] if t1 is None else t1
    for t in range(t0, t1):
        _step_plain(st, fields(t), rm, ar)
    return st


def segment_list(seg_end, out_row, reset_row=None):
    """The packed route's segment ends in the kernel's compact form, from
    the [L, T] planes of a lane pack: ``ptr`` [L + 1] int32 (lane l's
    entries are ``ends[ptr[l]:ptr[l + 1]]``) and ``ends`` [n, 3] int32
    rows (end step, output column, reset column), by lane and then by
    step. Without ``reset_row`` every reset column is 0."""
    seg = _host(seg_end).astype(bool)
    lanes, steps = np.nonzero(seg)
    ptr = np.zeros(seg.shape[0] + 1, np.int32)
    ptr[1:] = np.cumsum(np.bincount(lanes, minlength=seg.shape[0]))
    reset = (np.zeros(len(lanes), np.int64) if reset_row is None
             else _host(reset_row)[lanes, steps])
    ends = np.stack([steps, _host(out_row)[lanes, steps], reset], axis=1)
    return ptr, np.ascontiguousarray(ends, dtype=np.int32)


def replay_rows_packed_plain(events: torch.Tensor, rows: torch.Tensor,
                             caps: S.Capacities, seg_ptr, seg_ends,
                             out_rows: torch.Tensor,
                             init_rows: torch.Tensor, base=None,
                             wide_cols: Sequence[int] = ()):
    """The packed route with plain PyTorch ops: replay every step of
    ``events`` [T, P, L] onto the lane rows ``rows`` [R_pad, L]; at a
    lane's segment end (``seg_ptr`` / ``seg_ends`` from
    ``segment_list``) write its column to column ``output`` of
    ``out_rows`` [R_pad, n_out], then reload it from column ``reset`` of
    ``init_rows`` [R_pad, n_init]. A column out of range writes nothing.
    Returns new (rows, out_rows): the reference for the kernel's packed
    route, bit for bit."""
    rm, fields, ar, st = _plain_setup(events, rows, caps, base, wide_cols)
    T, _, L = events.shape
    ptr = _host(seg_ptr).astype(np.int64)
    ends = _host(seg_ends).astype(np.int64).reshape(-1, 3)
    if ptr.shape != (L + 1,) or ptr[-1] != len(ends):
        raise ValueError(
            f"segment list ptr {ptr.shape} does not index {len(ends)} "
            f"ends over {L} lanes")
    for name, m in (("out_rows", out_rows), ("init_rows", init_rows)):
        if m.dim() != 2 or m.shape[0] != rm.rows_padded:
            raise ValueError(f"{name} must be [{rm.rows_padded}, n]")
    n_out, n_init = out_rows.shape[1], init_rows.shape[1]
    lane = np.repeat(np.arange(L), np.diff(ptr))
    dev = rows.device

    def idx(a):
        return torch.from_numpy(a).to(dev)

    # per end step: (flushed lanes, their columns, reset lanes, columns)
    flushes = {}
    for t in np.unique(ends[:, 0]):
        sel = ends[:, 0] == t
        ln, oc, rc = lane[sel], ends[sel, 1], ends[sel, 2]
        fo = (oc >= 0) & (oc < n_out)
        fr = (rc >= 0) & (rc < n_init)
        flushes[int(t)] = (idx(ln[fo]), idx(oc[fo]), idx(ln[fr]),
                           idx(rc[fr]))
    out = out_rows.to(torch.int32).clone()
    init = init_rows.to(torch.int32)
    for t in range(T):
        _step_plain(st, fields(t), rm, ar)
        if t in flushes:
            ln_o, oc, ln_r, rc = flushes[t]
            out[:, oc] = st[:, ln_o]
            st[:, ln_r] = init[:, rc]
    return st, out


# --------------------------------------------------------------------------
# The CUDA kernel wrapper
# --------------------------------------------------------------------------

# host parameter block of cadence_replay_fsm (csrc/replay_fsm.cu, Params)
_N_PARAMS = 22 + 2 * S.EV_N

# shared memory a block may use on Hopper (227 KB)
_SMEM_LIMIT = 232448
# stages of each warp's event ring (csrc/replay_fsm.cu, STAGES)
_RING_STAGES = 3
# blocks a launch should make where the batch allows: about two per SM of
# an H100 (132 SMs)
_MIN_BLOCKS = 256


def lanes_per_block(rows_padded: int, batch: Optional[int] = None) -> int:
    """History lanes (threads) per block: the widest of 128/64/32 whose
    block fits in shared memory with one step a ring stage (each warp's
    state tile, the rows past the exec rows and the vh_len row, which the
    kernel keeps in registers, and its event ring of at most 64 bytes a
    lane-step, int32 or int16) and, given the ``batch`` width, still
    makes ``_MIN_BLOCKS`` blocks; the narrowest that fits when none does,
    so that a narrow batch spreads over the SMs."""
    fits = [lanes for lanes in (128, 64, 32)
            if lanes * ((rows_padded - S.X_N - 1) * 4
                        + _RING_STAGES * 4 * S.EV_N) <= _SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"{rows_padded} state rows do not fit shared memory at 32 lanes")
    if batch is None:
        return fits[0]
    for lanes in fits:
        if -(-batch // lanes) >= _MIN_BLOCKS:
            return lanes
    return fits[-1]


def _kernel_params(events: torch.Tensor, rm: RowMap, t0: int, t1: int,
                   base, wide_cols) -> np.ndarray:
    caps = rm.caps
    T, P, B = events.shape
    phys, _ = _phys_map(tuple(wide_cols))
    wide_mask = 0
    for c in wide_cols:
        wide_mask |= 1 << int(c)
    hp = [
        T, P, B, rm.rows_padded, t0, t1, lanes_per_block(rm.rows_padded, B),
        rm.exec0, rm.vh0, rm.vhlen, rm.act0, rm.tim0, rm.chd0, rm.rc0,
        rm.sg0,
        caps.max_activities, caps.max_timers, caps.max_children,
        caps.max_request_cancels, caps.max_signals_ext,
        caps.max_version_items, wide_mask,
    ]
    hp += [phys[c] for c in range(S.EV_N)] + _base_list(base)
    assert len(hp) == _N_PARAMS
    return np.asarray(hp, dtype=np.int32)


def _int32_matrix(name: str, m: torch.Tensor, dev, rows: int,
                  cols: Optional[int] = None) -> None:
    if (m.dtype != torch.int32 or m.device != dev or m.dim() != 2
            or m.shape[0] != rows or cols not in (None, m.shape[1])
            or not m.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous int32 [{rows}, {cols or 'n'}] "
            f"tensor on {dev}, got {m.dtype} {tuple(m.shape)} on {m.device}")


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _launch(events, rows, out, caps, base, wide_cols, t0, t1,
            seg=None) -> None:
    """Check the operands and launch cadence_replay_fsm on the current
    stream; ``seg``: the packed route's (ptr, ends, out_rows, init_rows)
    device tensors, or None."""
    if events.device.type != "cuda" or rows.device != events.device:
        raise ValueError(
            f"events on {events.device} and rows on {rows.device}: the "
            "kernel needs both on one CUDA device")
    _check_stream(events, base, wide_cols)
    rm = RowMap(caps)
    T, _, B = events.shape
    _int32_matrix("rows", rows, events.device, rm.rows_padded, B)
    _int32_matrix("out", out, events.device, rm.rows_padded, B)
    if not (0 <= t0 <= t1 <= T):
        raise ValueError(f"step range [{t0}, {t1}) outside T={T}")
    if not events.is_contiguous():
        raise ValueError("events must be contiguous")
    seg_args = [None, None, None, 0, None, 0]
    if seg is not None:
        ptr, ends, out_rows, init_rows = seg
        for name, v, shape in (("seg_ptr", ptr, (B + 1,)),
                               ("seg_ends", ends, (ends.shape[0], 3))):
            if (v.dtype != torch.int32 or v.device != events.device
                    or tuple(v.shape) != shape or not v.is_contiguous()):
                raise ValueError(
                    f"{name} must be a contiguous int32 {shape} tensor on "
                    f"{events.device}")
        _int32_matrix("out_rows", out_rows, events.device, rm.rows_padded)
        _int32_matrix("init_rows", init_rows, events.device,
                      rm.rows_padded)
        seg_args = [ptr.data_ptr(), ends.data_ptr() or None,
                    out_rows.data_ptr() or None, out_rows.shape[1],
                    init_rows.data_ptr() or None, init_rows.shape[1]]
    if B == 0:
        return
    from . import _build

    lib = _build.load("replay_fsm")
    hp = _kernel_params(events, rm, t0, t1, base, wide_cols)
    err = lib.cadence_replay_fsm(
        events.data_ptr(), int(events.dtype == torch.int16),
        rows.data_ptr(), out.data_ptr(), *seg_args,
        hp.ctypes.data_as(ctypes.c_void_p), len(hp),
        torch.cuda.current_stream(events.device).cuda_stream,
        _device_index(events.device),
    )
    if err:
        raise RuntimeError(
            "replay_fsm kernel launch failed: "
            + lib.cadence_cuda_error_string(err).decode())
    replay_rows.launches += 1


def replay_rows(events: torch.Tensor, rows: torch.Tensor,
                caps: S.Capacities, base=None,
                wide_cols: Sequence[int] = (), t0: int = 0,
                t1: Optional[int] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Replay steps ``[t0, t1)`` of ``events`` [T, P, B] onto ``rows``
    [R_pad, B] int32; returns the new rows (in ``out`` when given, which
    may be ``rows`` itself). Any B and any window, one step or none
    included.

    CUDA tensors launch the FSM kernel on the current stream (counted in
    ``replay_rows.launches``); CPU tensors run ``replay_rows_plain``."""
    t1 = events.shape[0] if t1 is None else t1
    if events.device.type == "cpu" and rows.device.type == "cpu":
        res = replay_rows_plain(events, rows, caps, base, wide_cols, t0, t1)
        if out is None:
            return res
        out.copy_(res)
        return out
    if out is None:
        out = torch.empty_like(rows)
    _launch(events, rows, out, caps, base, wide_cols, t0, t1)
    return out


replay_rows.launches = 0


def replay_rows_packed(events: torch.Tensor, rows: torch.Tensor,
                       caps: S.Capacities, seg_ptr: torch.Tensor,
                       seg_ends: torch.Tensor, out_rows: torch.Tensor,
                       init_rows: torch.Tensor, base=None,
                       wide_cols: Sequence[int] = (),
                       out: Optional[torch.Tensor] = None):
    """The packed route in one launch: replay every step of ``events``
    [T, P, L] onto the lane rows ``rows`` [R_pad, L], flushing each lane
    into ``out_rows`` and resetting it from ``init_rows`` at its segment
    ends (``seg_ptr`` / ``seg_ends`` from ``segment_list``, on the same
    device), as ``replay_rows_packed_plain`` does. Returns (rows,
    out_rows): the final lane rows (in ``out`` when given, which may be
    ``rows``) and ``out_rows``, updated in place.

    CUDA tensors launch the FSM kernel once (counted in
    ``replay_rows.launches``); CPU tensors run the plain version."""
    if events.device.type == "cpu" and rows.device.type == "cpu":
        res, res_out = replay_rows_packed_plain(
            events, rows, caps, seg_ptr, seg_ends, out_rows, init_rows,
            base, wide_cols)
        out_rows.copy_(res_out)
        if out is None:
            return res, out_rows
        out.copy_(res)
        return out, out_rows
    if out is None:
        out = torch.empty_like(rows)
    _launch(events, rows, out, caps, base, wide_cols, 0, events.shape[0],
            seg=(seg_ptr, seg_ends, out_rows, init_rows))
    return out, out_rows


def kernel_plan(events: torch.Tensor, caps: S.Capacities, base=None,
                wide_cols: Sequence[int] = ()) -> dict:
    """The launch geometry the kernel takes for ``events`` on its CUDA
    device: lanes per block, steps per ring stage, bytes per copy
    request, shared memory per block and resident blocks per SM."""
    from . import _build

    lib = _build.load("replay_fsm")
    rm = RowMap(caps)
    hp = _kernel_params(events, rm, 0, events.shape[0], base, wide_cols)
    res = np.zeros(5, np.int32)
    err = lib.cadence_replay_fsm_plan(
        events.data_ptr(), int(events.dtype == torch.int16),
        hp.ctypes.data_as(ctypes.c_void_p), len(hp),
        _device_index(events.device), res.ctypes.data_as(ctypes.c_void_p))
    if err:
        raise RuntimeError(
            "replay_fsm plan failed: "
            + lib.cadence_cuda_error_string(err).decode())
    return dict(zip(("lanes_per_block", "steps_per_stage", "request_bytes",
                     "smem_bytes", "blocks_per_sm"), res.tolist()))


# --------------------------------------------------------------------------
# Scan entry points (twins of replay_scan_pallas_teb / _packed)
# --------------------------------------------------------------------------


def replay_scan_teb(state: S.StateTensors, events_teb: torch.Tensor,
                    caps: S.Capacities, base=None,
                    wide_cols: Sequence[int] = ()) -> S.StateTensors:
    """Replay ``events_teb`` [T, P, B] (int32, or the int16 narrow stream
    with ``base``/``wide_cols``) from the torch ``state`` on its device.
    Returns the final torch StateTensors. Any B and T: a lane past B and
    a step past T need no padding."""
    rm = RowMap(caps)
    rows = state_to_rows(state, rm)
    rows = replay_rows(events_teb, rows, caps, base, wide_cols, out=rows)
    return rows_to_state(rows, rm)


def replay_scan_packed(
    state: S.StateTensors,
    out0: S.StateTensors,
    events_teb: torch.Tensor,
    seg_end,
    out_row,
    caps: S.Capacities,
    base=None,
    wide_cols: Sequence[int] = (),
    init: Optional[S.StateTensors] = None,
    reset_row=None,
):
    """Lane-packed replay: several whole histories back to back per lane.

    One kernel launch replays every step; at a lane's segment end it
    writes the lane's state into the history's output row and resets the
    lane to the next segment's initial carry (``init`` row ``reset_row``,
    or empty). Segment ends may fall on any step: the packer's
    ``seg_align`` is free.

    ``state``: [L] torch lane carry; ``out0``: [n_out] torch empty_state
    buffer; ``events_teb``: [T, P, L] on the same device; ``seg_end`` /
    ``out_row`` / ``reset_row``: [L, T] (host arrays or tensors);
    ``reset_row`` indexes ``init`` and its sentinel ``n_init`` the
    appended empty row. Returns (final_lane_state, out)."""
    dev = events_teb.device
    rm = RowMap(caps)
    empty_col = state_to_rows(
        S.state_from_numpy(S.empty_state(1, caps), dev), rm)
    if init is None:
        init_rows = empty_col
        reset_row = None
    else:
        if reset_row is None:
            raise ValueError("init requires reset_row")
        init_rows = torch.cat([state_to_rows(init, rm), empty_col], dim=1)
    ptr, ends = segment_list(seg_end, out_row, reset_row)
    rows = state_to_rows(state, rm)
    rows, out_rows = replay_rows_packed(
        events_teb, rows, caps, torch.from_numpy(ptr).to(dev),
        torch.from_numpy(ends).to(dev), state_to_rows(out0, rm), init_rows,
        base, wide_cols, out=rows)
    return rows_to_state(rows, rm), rows_to_state(out_rows, rm)
