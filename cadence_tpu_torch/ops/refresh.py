"""Device task refresh: outstanding queue tasks from replayed state.

The port's counterpart of the reference package's ``ops/refresh.py``
(itself the device twin of ``core/task_refresher.py`` and of the
reference's mutableStateTaskRefresher). ``refresh_tasks_device`` runs
after the replay on the device that holds the state, in torch ops: its
outputs are compact int32 (and bool) tensors, -1 marking an absent task,
that the host hydrates into TransferTask / TimerTask records with one
copy a batch (``refreshed_to_numpy``, then ``hydrate_tasks``).

The pass makes no host synchronisation: no ``.item()``, no copy, no
branch on a tensor's value. The activity timer, an argmin over five
candidate kinds in the reference's loop, is one stacked ``[B, A, 5]``
reduction here, with value reductions and equality masks (``amin``,
``amax``) that keep the reference's tie order bit for bit: the least
expiry, then the least schedule id among ties, then the earlier kind;
attempt and version the max over a kind's tied winners.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

from ..core import tasks as T
from ..core.enums import TimeoutType, TimerTaskType, WorkflowState
from ..core.ids import EMPTY_EVENT_ID
from ..core.mutable_state import SECOND
from . import schema as S
from .pack import PackedHistories

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


def refreshed_to_numpy(refreshed: RefreshedTasks) -> RefreshedTasks:
    """The batch's arrays on the host, with one device-to-host copy: the
    fields are laid side by side as int32 on their device first. Do this
    once before hydrating workflows in a loop."""
    fields = [getattr(refreshed, f) for f in FIELDS]
    b = fields[0].shape[0]
    widths = [int(np.prod(x.shape[1:])) for x in fields]
    flat = torch.cat([x.reshape(b, w).to(torch.int32)
                      for x, w in zip(fields, widths)], dim=1)
    host = flat.cpu().numpy()
    out, col = {}, 0
    for name, x, width in zip(FIELDS, fields, widths):
        part = host[:, col:col + width].reshape(x.shape)
        col += width
        out[name] = (part.astype(bool) if x.dtype == torch.bool
                     else np.ascontiguousarray(part))
    return RefreshedTasks(**out)


def hydrate_tasks(
    refreshed: RefreshedTasks, b: int, packed: PackedHistories,
    domain_id: str = "",
) -> Tuple[List[T.TransferTask], List[T.TimerTask]]:
    """Expand workflow ``b``'s compact arrays into task records, in the
    same order as ``core.task_refresher.refresh_tasks``."""
    r = refreshed
    if not isinstance(r.close_transfer, np.ndarray):
        r = refreshed_to_numpy(r)
    epoch_s = packed.epoch_s

    def vis_ns(rel: int) -> int:
        # inverse of the packer's epoch rebasing (pack.py rel_ts)
        return (rel + epoch_s - 1) * SECOND

    side = packed.side[b]
    transfer: List[T.TransferTask] = []
    timer: List[T.TimerTask] = []

    if r.close_transfer[b]:
        transfer.append(T.close_execution_transfer_task())
        return transfer, timer

    # a pending first-decision backoff extends the timeout window and
    # re-arms the backoff timer, as the host twin does
    # (core/task_refresher.py)
    deadline = side.first_decision_backoff_deadline
    backoff_extra = 0
    if deadline:
        backoff_extra = max(0, deadline - vis_ns(int(r.start_ts[b])))
    timer.append(T.TimerTask(
        task_type=TimerTaskType.WorkflowTimeout,
        visibility_timestamp=vis_ns(int(r.workflow_timeout_ts[b]))
        + backoff_extra,
    ))
    if deadline and r.first_decision_pending[b]:
        timer.append(T.TimerTask(
            task_type=TimerTaskType.WorkflowBackoffTimer,
            visibility_timestamp=deadline,
        ))
    if r.decision_transfer[b] != -1:
        transfer.append(T.decision_transfer_task(
            domain_id, side.task_list, int(r.decision_transfer[b])))
        if r.decision_timer[b][0] != -1:
            vis, sid, attempt = (int(x) for x in r.decision_timer[b])
            timer.append(T.TimerTask(
                task_type=TimerTaskType.DecisionTimeout,
                visibility_timestamp=vis_ns(vis),
                timeout_type=int(TimeoutType.StartToClose),
                event_id=sid,
                schedule_attempt=attempt,
            ))
    # one task a pending slot, in schedule id order; a repeated schedule
    # id takes its last slot's task list, as the reference does
    sids = sorted(int(x) for x in r.activity_transfer[b] if x != -1)
    slot_by_sid = {int(x): slot
                   for slot, x in enumerate(r.activity_transfer[b])
                   if x != -1}
    for sid in sids:
        transfer.append(T.activity_transfer_task(
            domain_id, side.activity_task_lists.get(slot_by_sid[sid], ""),
            sid))
    if r.activity_timer[b][0] != -1:
        vis, tt, sid, attempt, ver = (int(x) for x in r.activity_timer[b])
        timer.append(T.TimerTask(
            task_type=TimerTaskType.ActivityTimeout,
            visibility_timestamp=vis_ns(vis),
            timeout_type=tt,
            event_id=sid,
            schedule_attempt=attempt,
            version=ver,
        ))
    if r.user_timer[b][0] != -1:
        vis, sid, ver = (int(x) for x in r.user_timer[b])
        timer.append(T.TimerTask(
            task_type=TimerTaskType.UserTimer,
            visibility_timestamp=vis_ns(vis),
            event_id=sid,
            version=ver,
        ))

    def by_initiated(row):
        """(initiated_id, slot) pairs in initiated order."""
        return sorted((int(x), s) for s, x in enumerate(row) if x != -1)

    for init, slot in by_initiated(r.child_transfer[b]):
        transfer.append(T.start_child_transfer_task(
            side.child_domains.get(slot, ""),
            side.child_workflow_ids.get(slot, ""), init,
        ))
    for init, slot in by_initiated(r.cancel_transfer[b]):
        tgt = side.cancel_targets.get(slot) or ("", "", "", False)
        transfer.append(T.cancel_external_transfer_task(
            tgt[0] or domain_id, tgt[1], tgt[2], tgt[3], init,
        ))
    for init, slot in by_initiated(r.signal_transfer[b]):
        tgt = side.signal_targets.get(slot) or ("", "", "", False)
        transfer.append(T.signal_external_transfer_task(
            tgt[0] or domain_id, tgt[1], tgt[2], tgt[3], init,
        ))
    return transfer, timer
