"""Outstanding transfer and timer tasks of every workflow in a batch of
replayed states.

Frozen copy of ``RefreshedTasks``, ``_activity_timer``, ``_user_timer``
and ``refresh_tasks_device`` of ``cadence_tpu_torch/ops/refresh.py``
(the port as of the first benchmark), the device twin of the
reference's mutableStateTaskRefresher; the benchmark's reference runs it
on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import schema as S
from .enums import WorkflowState
from .ids import EMPTY_EVENT_ID

_BIG = 2**31 - 1
_INT32_MIN = -(2**31)


@dataclasses.dataclass
class RefreshedTasks:
    """Compact task arrays, one row a workflow; -1 marks absent entries.
    torch tensors on the state's device, or numpy after
    ``refreshed_to_numpy``."""

    close_transfer: Any          # [B] bool
    workflow_timeout_ts: Any     # [B] int32 (-1 if closed)
    decision_transfer: Any       # [B] schedule_id or -1
    decision_timer: Any          # [B, 3] (vis_ts, schedule_id, attempt) or -1s
    activity_transfer: Any       # [B, A] schedule_id or -1
    activity_timer: Any          # [B, 5] (vis_ts, timeout_type, schedule_id, attempt, version) or -1s
    user_timer: Any              # [B, 3] (vis_ts, started_id, version) or -1s
    child_transfer: Any          # [B, C] initiated_id or -1
    cancel_transfer: Any         # [B, RC] initiated_id or -1
    signal_transfer: Any         # [B, SG] initiated_id or -1
    # [B] bool: running, no pending decision, first decision not yet
    # processed; hydrate applies the side table's backoff deadline to
    # re-arm the WorkflowBackoffTimer (host twin: task_refresher)
    first_decision_pending: Any = None
    # [B] relative start ts (device encoding); hydrate computes the
    # backoff extension of the timeout window from it
    start_ts: Any = None


FIELDS = tuple(f.name for f in dataclasses.fields(RefreshedTasks))


def _activity_timer(acts: torch.Tensor, running: torch.Tensor) -> torch.Tensor:
    """[B, 5] (expiry, timeout_type, schedule_id, attempt, version) of the
    earliest armed activity timeout, or -1s."""
    occ = acts[:, :, S.AC_OCC] > 0
    unstarted = occ & (acts[:, :, S.AC_STARTED_ID] == EMPTY_EVENT_ID)
    started = occ & (acts[:, :, S.AC_STARTED_ID] != EMPTY_EVENT_ID)
    sched_ts = acts[:, :, S.AC_SCHEDULED_TS]
    s2s = acts[:, :, S.AC_SCH_TO_START]
    s2c = acts[:, :, S.AC_SCH_TO_CLOSE]
    st2c = acts[:, :, S.AC_START_TO_CLOSE]
    hb = acts[:, :, S.AC_HEARTBEAT]
    # [B, A, 5]: each candidate kind's armed mask and expiry (int32 sums
    # wrap), stacked in the order (timeout type, the reference's kind
    # order): StartToClose 0, ScheduleToStart 1, ScheduleToClose 2 of an
    # unstarted and then of a started slot, Heartbeat 3. The tie rule
    # "least timeout type, then the earlier kind" is then "the earlier
    # position", and position p has timeout type p - (p >= 3).
    armed = torch.stack([
        started & (st2c > 0),
        unstarted & (s2s > 0),
        unstarted & (s2c > 0),
        started & (s2c > 0),
        started & (hb > 0),
    ], dim=-1) & running[:, None, None]
    expiry = torch.stack([
        acts[:, :, S.AC_STARTED_TS] + st2c,
        sched_ts + s2s,
        sched_ts + s2c,
        sched_ts + s2c,
        acts[:, :, S.AC_LAST_HB_TS] + hb,
    ], dim=-1)
    # per kind: least expiry, least schedule id among its ties, and the
    # max attempt and version over the winning slots
    exp_m = torch.where(armed, expiry, _BIG)
    k_exp = exp_m.amin(dim=1)                                   # [B, 5]
    sid_tie = torch.where(exp_m == k_exp[:, None],
                          acts[:, :, S.AC_SCHEDULE_ID, None], _BIG)
    k_sid = sid_tie.amin(dim=1)
    winner = sid_tie == k_sid[:, None]
    k_att = torch.where(winner, acts[:, :, S.AC_ATTEMPT, None], 0).amax(
        dim=1)
    k_ver = torch.where(winner, acts[:, :, S.AC_VERSION, None],
                        _INT32_MIN).amax(dim=1)
    # across kinds: least (expiry, schedule id), then the first position
    a_exp = k_exp.amin(dim=1, keepdim=True)
    best = k_exp == a_exp
    a_sid = torch.where(best, k_sid, _BIG).amin(dim=1, keepdim=True)
    pos = torch.arange(k_exp.shape[1], dtype=torch.int32,
                       device=acts.device)
    first = torch.where(best & (k_sid == a_sid), pos, _BIG).amin(
        dim=1, keepdim=True)
    pick = pos == first
    a_tt = first - (first >= 3).to(torch.int32)
    a_att = torch.where(pick, k_att, _INT32_MIN).amax(dim=1, keepdim=True)
    a_ver = torch.where(pick, k_ver, _INT32_MIN).amax(dim=1, keepdim=True)
    out = torch.cat([a_exp, a_tt, a_sid, a_att, a_ver], dim=1)
    return torch.where(a_exp < _BIG, out, -1)


def _user_timer(tmr: torch.Tensor, running: torch.Tensor) -> torch.Tensor:
    """[B, 3] (expiry, started_id, version) of the earliest user timer,
    or -1s."""
    occ = (tmr[:, :, S.TI_OCC] > 0) & running[:, None]
    t_exp = torch.where(occ, tmr[:, :, S.TI_EXPIRY_TS], _BIG)
    t_sid = torch.where(occ, tmr[:, :, S.TI_STARTED_ID], _BIG)
    u_exp = t_exp.amin(dim=1, keepdim=True)
    sid_tie = torch.where(t_exp == u_exp, t_sid, _BIG)
    u_sid = sid_tie.amin(dim=1, keepdim=True)
    u_ver = torch.where(sid_tie == u_sid, tmr[:, :, S.TI_VERSION],
                        _INT32_MIN).amax(dim=1, keepdim=True)
    out = torch.cat([u_exp, u_sid, u_ver], dim=1)
    return torch.where(u_exp < _BIG, out, -1)


def refresh_tasks_device(state: S.StateTensors) -> RefreshedTasks:
    """Outstanding tasks of every workflow in ``state`` (torch tensors,
    on any device), computed on that device; results stay there."""
    ex = state.exec_info
    if not isinstance(ex, torch.Tensor):
        raise TypeError(
            "refresh_tasks_device takes torch state; move numpy state to "
            "its device with schema.state_from_numpy")
    x_state = ex[:, S.X_STATE]
    running = (x_state == int(WorkflowState.Created)) | (
        x_state == int(WorkflowState.Running))
    dec_sid = ex[:, S.X_DEC_SCHEDULE_ID]

    workflow_timeout_ts = torch.where(
        running, ex[:, S.X_START_TS] + ex[:, S.X_WORKFLOW_TIMEOUT], -1)
    has_pending_dec = running & (dec_sid != EMPTY_EVENT_ID)
    decision_transfer = torch.where(has_pending_dec, dec_sid, -1)
    inflight = has_pending_dec & (ex[:, S.X_DEC_STARTED_ID] > 0)
    decision_timer = torch.where(inflight[:, None], torch.stack([
        ex[:, S.X_DEC_STARTED_TS] + ex[:, S.X_DEC_TIMEOUT],
        dec_sid,
        ex[:, S.X_DEC_ATTEMPT],
    ], dim=-1), -1)

    acts = state.activities
    a_unstarted = (acts[:, :, S.AC_OCC] > 0) & (
        acts[:, :, S.AC_STARTED_ID] == EMPTY_EVENT_ID)
    activity_transfer = torch.where(a_unstarted & running[:, None],
                                    acts[:, :, S.AC_SCHEDULE_ID], -1)

    ch = state.children
    ch_pending = (ch[:, :, S.CH_OCC] > 0) & (
        ch[:, :, S.CH_STARTED_ID] == EMPTY_EVENT_ID) & running[:, None]
    rc, sg = state.cancels, state.signals
    rc_live = (rc[:, :, S.RC_OCC] > 0) & running[:, None]
    sg_live = (sg[:, :, S.SG_OCC] > 0) & running[:, None]
    return RefreshedTasks(
        close_transfer=~running,
        workflow_timeout_ts=workflow_timeout_ts,
        decision_transfer=decision_transfer,
        decision_timer=decision_timer,
        activity_transfer=activity_transfer,
        activity_timer=_activity_timer(acts, running),
        user_timer=_user_timer(state.timers, running),
        child_transfer=torch.where(ch_pending, ch[:, :, S.CH_INITIATED_ID],
                                   -1),
        cancel_transfer=torch.where(rc_live, rc[:, :, S.RC_INITIATED_ID], -1),
        signal_transfer=torch.where(sg_live, sg[:, :, S.SG_INITIATED_ID], -1),
        first_decision_pending=running & (dec_sid == EMPTY_EVENT_ID) & (
            ex[:, S.X_LAST_PROCESSED_EVENT] < 1),
        start_ts=ex[:, S.X_START_TS].clone(),
    )
