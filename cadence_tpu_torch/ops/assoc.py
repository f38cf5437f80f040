"""Parallel-in-time replay: segmented associative composition of affine
transition updates.

The counterpart of the reference package's ``ops/assoc.py``, with the same
names, contracts and results, bit for bit. The sequential replay (the FSM
kernel, ``ops/replay_cuda.py``) walks the time axis one event at a time.
But for every event, the kernel's update to each state cell is an
*affine* map

    x  ->  mul * x + add          (mul, add event-local, mul in {0, 1})

— plain writes are the ``mul=0`` (last-writer-wins) case, counters are
``mul=1, add=delta`` — plus two small non-diagonal algebras:

  * ``fsm``  — X_STATE's Created->Running promotion on DecisionTaskStarted
    reads the prior state. Its update set {identity, promote, const c}
    is closed under composition (promote is idempotent), so it scans as
    a 2-int (kind, value) algebra.
  * ``rle``  — the version-history add_or_update appends on version
    *change*: a run-length encoding of the version stream, recovered
    from a segmented prefix count of change flags.

Affine maps compose associatively, so a whole history collapses without
a sequential walk. Two evaluation strategies, bit-identical to each
other and to the sequential replay:

  * ``impl="segscan"`` — the direct form: Phase A emits per-column
    ``(mul, add)`` updates for every [T, L] cell, Phase B composes them
    with the segmented affine scan, on the GPU the hand-written CUDA
    kernel ``csrc/affine_segscan.cu`` (``ops/assoc_cuda.py``). Segment
    starts absorb the carry, so lane-packed histories never leak state
    across the packer's segment ends. X_STATE's 2-leaf fsm stream is a
    doubling scan in PyTorch ops (ceil(log2 T) elementwise rounds).
  * ``impl="resolve"`` (default) — the factored form: because every mul
    is 0 or 1, the composed map over a segment factors into *write
    provenance* (the position of the last mul=0 writer, a per-lane
    ``cummax`` over write positions) plus prefix sums of the add-stream
    after it (``cumsum``). Slot-table cells resolve the same way via
    scatter-max provenance keyed by (history, slot). Pure cumulative
    primitives and gathers, in PyTorch ops; it is what the dispatcher
    serves.

Cross-column reads are resolved in dependency order: the one genuine
case (DecisionTask fail/timeout reads X_DECISION_TIMEOUT_VALUE, written
only by WorkflowExecutionStarted) is answered by the provenance of the
start write before the reading event; reads of columns written earlier
in the *same* step (X_CUR_VERSION) reduce to event-local values.

Events whose transition the classifier cannot prove affine
(``classify_types``) fall back to single sequential steps on the FSM
kernel between affine runs (``replay_assoc``'s hybrid chunker).

Checkpoint resume: a resumed history's snapshot row is the leading
segment element — ``init`` seeds per-segment base states x0, version-
history prefill, and slot-table base cells, exactly as the sequential
packed replay seeds lane carries from ``PackedLanes.initial``.

Every tensor is int32 (bool for masks); indices become int64 only where
they index. Entry points default to ``device="cuda"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.enums import (
    CloseStatus, EventType as E, WorkflowState,
    WORKFLOW_CLOSE_STATUS, decision_attempt_increment,
)
from ..core.ids import EMPTY_EVENT_ID, EMPTY_VERSION

from . import assoc_cuda
from . import schema as S
from .assoc_cuda import affine_combine  # noqa: F401  (re-exported)
from .pack import PackedLanes, round_scan_len
from .replay import type_signature
from .replay_cuda import replay_scan_teb

_CREATED = int(WorkflowState.Created)
_RUNNING = int(WorkflowState.Running)
_COMPLETED = int(WorkflowState.Completed)

IMPLS = ("resolve", "segscan")


# --------------------------------------------------------------------------
# Classifier: which event types the affine decomposition proves
# --------------------------------------------------------------------------

# Packable types with no kernel transition block: the preamble + version
# history still apply (they apply to EVERY valid event) and both are
# covered algebras, so these are affine by construction.
NOOP_TYPES = frozenset({
    int(E.MarkerRecorded),
    int(E.UpsertWorkflowSearchAttributes),
    int(E.RequestCancelActivityTaskFailed),
    int(E.CancelTimerFailed),
})


def assoc_types() -> frozenset:
    """Event types whose transitions this module proves affine: the
    types declared in ``ASSOC_COVERAGE`` (each backed by a derived
    update emission below) plus ``NOOP_TYPES``. A new transition block
    is nonaffine until its coverage is declared here, so the classifier
    routes it through the sequential/hybrid fallback."""
    out = set(NOOP_TYPES)
    for key in ASSOC_COVERAGE:
        out.update(key)
    return frozenset(out)


def classify_types(
    present, affine_types: Optional[frozenset] = None
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Split a batch's present event types into (affine, nonaffine)."""
    ok = affine_types if affine_types is not None else assoc_types()
    aff, non = [], []
    for t in sorted({int(t) for t in present}):
        (aff if t in ok else non).append(t)
    return tuple(aff), tuple(non)


# --------------------------------------------------------------------------
# Declared coverage: per transition group (keyed like
# ops.replay.TYPE_GROUPS entries), the state labels whose updates the
# emission below derives. Slot tables are covered at table granularity
# (whole-row masked writes).
# --------------------------------------------------------------------------

_DEC_COLS = (
    "exec:X_DEC_VERSION", "exec:X_DEC_SCHEDULE_ID", "exec:X_DEC_STARTED_ID",
    "exec:X_DEC_TIMEOUT", "exec:X_DEC_ATTEMPT", "exec:X_DEC_SCHEDULED_TS",
    "exec:X_DEC_STARTED_TS", "exec:X_DEC_ORIGINAL_SCHEDULED_TS",
)

# labels written for every valid event (preamble + version history)
ASSOC_COMMON = frozenset({
    "exec:X_LAST_EVENT_TASK_ID", "exec:X_CUR_VERSION",
    "exec:X_NEXT_EVENT_ID", "exec:X_LAST_FIRST_EVENT_ID",
    "vh:event_id", "vh:version", "vh:len",
})

ASSOC_COVERAGE = {
    (int(E.WorkflowExecutionStarted),): frozenset({
        "exec:X_STATE", "exec:X_CLOSE_STATUS",
        "exec:X_LAST_PROCESSED_EVENT", "exec:X_START_TS",
        "exec:X_WORKFLOW_TIMEOUT", "exec:X_DECISION_TIMEOUT_VALUE",
        "exec:X_ATTEMPT", "exec:X_HAS_RETRY_POLICY",
        "exec:X_WF_EXPIRATION_TS", "exec:X_PARENT_INITIATED_ID",
        *_DEC_COLS,
    }),
    tuple(sorted(int(t) for t, _ in WORKFLOW_CLOSE_STATUS)): frozenset({
        "exec:X_STATE", "exec:X_CLOSE_STATUS",
        "exec:X_COMPLETION_EVENT_BATCH_ID",
    }),
    (int(E.WorkflowExecutionCancelRequested),): frozenset({
        "exec:X_CANCEL_REQUESTED",
    }),
    (int(E.WorkflowExecutionSignaled),): frozenset({
        "exec:X_SIGNAL_COUNT",
    }),
    (int(E.DecisionTaskScheduled),): frozenset(_DEC_COLS),
    (int(E.DecisionTaskStarted),): frozenset({
        "exec:X_STATE", "exec:X_DEC_VERSION", "exec:X_DEC_STARTED_ID",
        "exec:X_DEC_ATTEMPT", "exec:X_DEC_STARTED_TS",
    }),
    # completion clears the decision but KEEPS original-scheduled ts
    (int(E.DecisionTaskCompleted),): frozenset({
        "exec:X_LAST_PROCESSED_EVENT", *_DEC_COLS,
    }) - {"exec:X_DEC_ORIGINAL_SCHEDULED_TS"},
    tuple(sorted((int(E.DecisionTaskTimedOut), int(E.DecisionTaskFailed)))):
        frozenset(_DEC_COLS),
    (int(E.ActivityTaskScheduled),): frozenset({"activities"}),
    (int(E.ActivityTaskStarted),): frozenset({"activities"}),
    tuple(sorted(int(t) for t in (
        E.ActivityTaskCompleted, E.ActivityTaskFailed,
        E.ActivityTaskTimedOut, E.ActivityTaskCanceled,
    ))): frozenset({"activities"}),
    (int(E.ActivityTaskCancelRequested),): frozenset({"activities"}),
    (int(E.TimerStarted),): frozenset({"timers"}),
    tuple(sorted((int(E.TimerFired), int(E.TimerCanceled)))):
        frozenset({"timers"}),
    (int(E.StartChildWorkflowExecutionInitiated),): frozenset({"children"}),
    (int(E.ChildWorkflowExecutionStarted),): frozenset({"children"}),
    tuple(sorted(int(t) for t in (
        E.StartChildWorkflowExecutionFailed,
        E.ChildWorkflowExecutionCompleted, E.ChildWorkflowExecutionFailed,
        E.ChildWorkflowExecutionCanceled, E.ChildWorkflowExecutionTimedOut,
        E.ChildWorkflowExecutionTerminated,
    ))): frozenset({"children"}),
    (int(E.RequestCancelExternalWorkflowExecutionInitiated),):
        frozenset({"cancels"}),
    tuple(sorted((
        int(E.RequestCancelExternalWorkflowExecutionFailed),
        int(E.ExternalWorkflowExecutionCancelRequested),
    ))): frozenset({"cancels"}),
    (int(E.SignalExternalWorkflowExecutionInitiated),):
        frozenset({"signals"}),
    tuple(sorted((
        int(E.SignalExternalWorkflowExecutionFailed),
        int(E.ExternalWorkflowExecutionSignaled),
    ))): frozenset({"signals"}),
}


# --------------------------------------------------------------------------
# The combines and the segmented scans over them
# --------------------------------------------------------------------------


def _where(cond, a, b):
    """``torch.where`` that stays int32 when both branches are Python
    ints (torch would promote them to int64)."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = torch.full_like(cond, a, dtype=torch.int32)
    return torch.where(cond, a, b)


def affine_segscan(mul, add, rst, axis: int = 1):
    """Inclusive segmented prefix composition of per-step affine updates.

    mul/add: [L, T, C] int32 with the time axis at ``axis`` (0 or 1);
    rst: bool or int, mul's shape without the column axis, set where the
    step begins a new segment. Returns (mul, add) prefix pairs in mul's
    layout; the state after step t of a segment with base x0 is
    ``mul[t]*x0+add[t]``. Runs the CUDA kernel on CUDA tensors and its
    plain version on CPU tensors (``ops/assoc_cuda.py``)."""
    if axis not in (0, 1) or mul.dim() != 3:
        raise ValueError("affine_segscan takes 3-D mul/add, time axis 0 or 1")
    pm, pa = assoc_cuda.affine_segscan(
        torch.movedim(mul, axis, 0).contiguous(),
        torch.movedim(add, axis, 0).contiguous(),
        torch.movedim(rst, axis, 0).contiguous(),
    )
    return torch.movedim(pm, 0, axis), torch.movedim(pa, 0, axis)


def fsm_combine(a, b):
    """Compose X_STATE updates (kind 0=identity, 1=promote, 2=const).

    promote is Created->Running, identity elsewhere — idempotent, so the
    set {identity, promote, const c} is closed under composition."""
    ka, va, ra = a
    kb, vb, rb = b
    promoted = _where(va == _CREATED, _RUNNING, va)
    k = _where(kb == 2, 2, _where(kb == 1, _where(ka == 2, 2, 1), ka))
    v = _where(kb == 2, vb, _where((kb == 1) & (ka == 2), promoted, va))
    # segment boundary: b alone survives
    k = torch.where(rb, kb, k)
    v = torch.where(rb, vb, v)
    return k, v, ra | rb


def fsm_apply(kind, val, x0):
    promoted = _where(x0 == _CREATED, _RUNNING, x0)
    return _where(kind == 2, val, _where(kind == 1, promoted, x0))


def fsm_segscan(kind, kval, rst):
    """Inclusive segmented scan of the fsm stream along axis 1 ([L, T]
    int32 kind/kval, bool rst): a doubling scan, ceil(log2 T) rounds of
    ``fsm_combine`` on elementwise ops. The combine is associative, so
    the result equals any other evaluation order exactly."""
    k, v, r = kind, kval, rst
    T = k.shape[1]
    d = 1
    while d < T:
        nk, nv, nr = fsm_combine((k[:, :-d], v[:, :-d], r[:, :-d]),
                                 (k[:, d:], v[:, d:], r[:, d:]))
        k = torch.cat([k[:, :d], nk], dim=1)
        v = torch.cat([v[:, :d], nv], dim=1)
        r = torch.cat([r[:, :d], nr], dim=1)
        d *= 2
    return k, v


# --------------------------------------------------------------------------
# Shared emission helpers.
#
# Everything on-device is batch-major: the event tensor arrives as EV_N
# contiguous [L, T] column planes (``events_fm`` [EV_N, L, T]) and every
# mask/reduction runs along the minor time axis.
# --------------------------------------------------------------------------


def _or(*masks):
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else (out | m)
    return out


def _mask_of(et, valid, type_set, *query):
    """[L, T] bool mask for the given event types, or None when every
    queried type is statically absent."""
    if type_set is not None:
        query = [t for t in query if int(t) in type_set]
        if not query:
            return None
    out = torch.zeros_like(valid)
    for t in query:
        out = out | (et == int(t))
    return valid & out


def _resolve(base, *cands):
    """Last-writer-wins resolution: each candidate is (t, val) with t the
    (-1 = never) position of that writer class's last write; the
    greatest t wins, base when none wrote. Write positions of distinct
    classes never tie — an event has exactly one type."""
    return _resolve_tv(base, *cands)[1]


def _resolve_tv(base, *cands):
    """Like _resolve but also returns the winning position (-1 = base)."""
    best_t = torch.full_like(base, -1)
    best_v = base
    for t, v in cands:
        if t is None or v is None:
            continue
        take = t > best_t
        best_v = _where(take, v, best_v)
        best_t = torch.maximum(best_t, t)
    return best_t, best_v


class _Ctx:
    """Per-call tensors shared by the emission and resolution stages.

    ``trivial`` marks the unpacked layout (lane i == history i, one
    segment spanning the whole time axis): provenance then collapses to
    plain per-lane reductions — no scatters, no cumulative scans. The
    packed layout keeps the general segmented forms (cummax prefix +
    gather at segment ends, scatter-max keyed by history)."""

    def __init__(self, events_fm, hist_bm, seg_pos, seg_lane, seg_start,
                 init, type_set, trivial=False):
        self.evf = events_fm                     # [EV_N, L, T]
        L, T = events_fm.shape[1], events_fm.shape[2]
        dev = events_fm.device
        self.T, self.L = T, L
        self.n_out = init.exec_info.shape[0]
        self.trivial = trivial
        self.hist = hist_bm                      # [L, T]
        self.seg_pos = seg_pos                   # [n_out]
        self.seg_lane = seg_lane
        self.seg_start = seg_start
        self.init = init
        self.valid_h = seg_pos >= 0              # [n_out] real history rows
        self.pos_c = torch.clamp_min(seg_pos, 0)
        self.lane_i = seg_lane.long()            # index forms
        self.pos_i = self.pos_c.long()
        self.type_set = type_set
        self.iota_t = torch.arange(
            T, dtype=torch.int32, device=dev).expand(L, T)
        self.et = events_fm[S.EV_TYPE]
        self.valid = self.et >= 0
        if trivial:
            self.sstep = None
        else:
            # per-step segment start / init gathers route through one
            # appended sentinel row (hist == n_out for padding steps)
            self.hist_i = hist_bm.long()
            seg_start_ext = torch.cat([
                seg_start,
                torch.full((1,), T, dtype=torch.int32, device=dev)])
            self.sstep = seg_start_ext[self.hist_i]      # [L, T]

    def m(self, *query):
        return _mask_of(self.et, self.valid, self.type_set, *query)

    def col(self, c):
        return self.evf[c]

    def per_step(self, vals, fill=0):
        """[n_out] per-history values -> [L, T] per step (``fill`` on
        padding steps of the packed layout; [L, 1] on the unpacked)."""
        if self.trivial:
            return vals[:, None]
        ext = torch.cat([vals, torch.full((1,), fill, dtype=vals.dtype,
                                          device=vals.device)])
        return ext[self.hist_i]

    # -- history-granularity gathers ------------------------------------

    def at_end(self, arr_bm):
        """arr[seg_lane, seg_pos] with -1 for padding rows."""
        return _where(self.valid_h, arr_bm[self.lane_i, self.pos_i], -1)

    def ev_at(self, t, c):
        """Event column ``c`` at per-history positions ``t`` (clamped;
        callers guard with t >= 0). None-safe: a statically absent
        writer class contributes no candidate."""
        if t is None:
            return None
        return self.evf[c][self.lane_i, torch.clamp_min(t, 0).long()]

    def ev_at2(self, t, c):
        """Event column ``c`` at [n_out, cap] positions (clamped)."""
        return self.evf[c][self.lane_i[:, None], torch.clamp_min(t, 0).long()]

    # -- provenance / counter primitives, layout-specialized ------------

    def _last_plus1(self, mask):
        """[L] last set position + 1 of a [L, T] mask (0 = none)."""
        return (mask * (self.iota_t + 1)).amax(dim=1)

    def _cummax_pos(self, mask):
        return torch.cummax(_where(mask, self.iota_t, -1), dim=1).values

    def last_pos(self, mask):
        """[n_out] last write position of one writer class within each
        history's segment (-1 = never)."""
        if mask is None:
            return None
        if self.trivial:
            return self._last_plus1(mask) - 1
        t = self.at_end(self._cummax_pos(mask))
        return _where(t >= self.seg_start, t, -1)

    def count_after(self, mask, t_lo):
        """[n_out] events of ``mask`` in (t_lo, seg end]; t_lo=-1 counts
        the whole segment — the composed add of a mul=1 counter run."""
        if mask is None:
            return torch.zeros_like(self.seg_pos)
        if self.trivial:
            return (mask & (self.iota_t > t_lo[:, None])).sum(
                dim=1, dtype=torch.int32)
        cum = torch.cumsum(mask, dim=1, dtype=torch.int32)
        lo = _where(t_lo >= 0, t_lo, self.seg_start - 1)
        c_lo = _where(
            lo >= 0, cum[self.lane_i, torch.clamp_min(lo, 0).long()], 0)
        c_hi = _where(self.valid_h, cum[self.lane_i, self.pos_i], 0)
        return _where(self.valid_h, c_hi - c_lo, 0)

    def count_in_seg(self, mask):
        if mask is None:
            return torch.zeros_like(self.seg_pos)
        return self.count_after(mask, torch.full_like(self.seg_pos, -1))

    def last_before(self, mask, t_at):
        """[n_out] last write of ``mask`` strictly before position
        ``t_at`` within the same segment (-1 = none) — the dependency-
        ordered answer to a cross-column read at ``t_at``."""
        if mask is None or t_at is None:
            return None
        if self.trivial:
            return self._last_plus1(mask & (self.iota_t < t_at[:, None])) - 1
        cmx = self._cummax_pos(mask)
        j = _where(t_at > 0,
                   cmx[self.lane_i, torch.clamp_min(t_at - 1, 0).long()], -1)
        return _where(j >= self.seg_start, j, -1)

    def table_last(self, mask, slot, cap):
        """[n_out, cap] last write position of one writer class per
        (history, slot) — per-slot masked reductions on the unpacked
        layout, scatter-max provenance keyed by history on the packed
        one."""
        if mask is None:
            return None
        if self.trivial:
            return torch.stack(
                [self._last_plus1(mask & (slot == k)) - 1
                 for k in range(cap)],
                dim=-1,
            )
        size = self.n_out * cap
        ok = mask & (slot >= 0) & (slot < cap) & (self.hist < self.n_out)
        flat = _where(ok, self.hist * cap + slot, size)
        key = _where(ok, self.iota_t, -1)
        # one sentinel slot past the end takes the writes that are not
        # kept (an index out of range would be a device-side assert)
        buf = torch.full((size + 1,), -1, dtype=torch.int32,
                         device=mask.device)
        buf.scatter_reduce_(0, flat.reshape(-1).long(), key.reshape(-1),
                            "amax", include_self=True)
        return buf[:size].reshape(self.n_out, cap)


# --------------------------------------------------------------------------
# Exec columns — factored evaluation (impl="resolve")
# --------------------------------------------------------------------------


def _decision_masks(cx: _Ctx):
    """(m_inc, m_noinc): decision fail/timeout steps that do and do not
    bump the attempt counter (None when neither type is present)."""
    m_dto = cx.m(E.DecisionTaskTimedOut)
    m_dfail = cx.m(E.DecisionTaskFailed)
    if m_dto is None and m_dfail is None:
        return None, None
    fill = torch.zeros_like(cx.valid)
    dto = fill if m_dto is None else m_dto
    dfail = fill if m_dfail is None else m_dfail
    m_inc = decision_attempt_increment(dfail, dto, cx.col(S.EV_A0))
    return m_inc, (dto | dfail) & ~m_inc


def _exec_resolve(cx: _Ctx):
    """Final exec_info [n_out, X_N] via write provenance + prefix sums."""
    base = cx.init.exec_info

    m_start = cx.m(E.WorkflowExecutionStarted)
    m_close = cx.m(*(t for t, _ in WORKFLOW_CLOSE_STATUS))
    m_creq = cx.m(E.WorkflowExecutionCancelRequested)
    m_sig = cx.m(E.WorkflowExecutionSignaled)
    m_dsch = cx.m(E.DecisionTaskScheduled)
    m_dsta = cx.m(E.DecisionTaskStarted)
    m_dcom = cx.m(E.DecisionTaskCompleted)
    m_inc, m_noinc = _decision_masks(cx)

    # write provenance per writer class: last position within each
    # history's segment
    t_v = cx.last_pos(cx.valid)
    t_start = cx.last_pos(m_start)
    t_close = cx.last_pos(m_close)
    t_creq = cx.last_pos(m_creq)
    t_dsch = cx.last_pos(m_dsch)
    t_dsta = cx.last_pos(m_dsta)
    t_dcom = cx.last_pos(m_dcom)
    t_inc = cx.last_pos(m_inc)
    t_noinc = cx.last_pos(m_noinc)

    ev_at = cx.ev_at
    out = [None] * S.X_N
    EMPTY = EMPTY_EVENT_ID
    EMPTY_V = EMPTY_VERSION

    def b(c):
        return base[:, c]

    # ---- preamble (every valid event)
    out[S.X_LAST_EVENT_TASK_ID] = _resolve(
        b(S.X_LAST_EVENT_TASK_ID), (t_v, ev_at(t_v, S.EV_TASK_ID)))
    out[S.X_CUR_VERSION] = _resolve(
        b(S.X_CUR_VERSION), (t_v, ev_at(t_v, S.EV_VERSION)))
    nid = ev_at(t_v, S.EV_ID)
    out[S.X_NEXT_EVENT_ID] = _resolve(
        b(S.X_NEXT_EVENT_ID), (t_v, None if nid is None else nid + 1))
    out[S.X_LAST_FIRST_EVENT_ID] = _resolve(
        b(S.X_LAST_FIRST_EVENT_ID), (t_v, ev_at(t_v, S.EV_BATCH_FIRST)))

    # ---- X_STATE (fsm): last const write, promoted iff a
    # DecisionTaskStarted landed after it (promote is idempotent)
    t_const, v_const = _resolve_tv(
        b(S.X_STATE), (t_start, _CREATED), (t_close, _COMPLETED))
    if t_dsta is not None:
        promoted = _where(v_const == _CREATED, _RUNNING, v_const)
        out[S.X_STATE] = torch.where(t_dsta > t_const, promoted, v_const)
    else:
        out[S.X_STATE] = v_const

    # ---- close status
    cs = None
    if t_close is not None:
        etc = ev_at(t_close, S.EV_TYPE)
        cs = torch.zeros_like(etc)
        for t, v in WORKFLOW_CLOSE_STATUS:
            cs = _where(etc == int(t), int(v), cs)
    out[S.X_CLOSE_STATUS] = _resolve(
        b(S.X_CLOSE_STATUS),
        (t_start, int(CloseStatus.NONE)),
        (t_close, cs),
    )
    out[S.X_COMPLETION_EVENT_BATCH_ID] = _resolve(
        b(S.X_COMPLETION_EVENT_BATCH_ID),
        (t_close, ev_at(t_close, S.EV_BATCH_FIRST)),
    )
    out[S.X_LAST_PROCESSED_EVENT] = _resolve(
        b(S.X_LAST_PROCESSED_EVENT),
        (t_start, EMPTY), (t_dcom, ev_at(t_dcom, S.EV_A0)),
    )

    # ---- start-only columns
    for c, a in (
        (S.X_START_TS, S.EV_TS), (S.X_WORKFLOW_TIMEOUT, S.EV_A0),
        (S.X_DECISION_TIMEOUT_VALUE, S.EV_A1), (S.X_ATTEMPT, S.EV_A2),
        (S.X_HAS_RETRY_POLICY, S.EV_A3), (S.X_WF_EXPIRATION_TS, S.EV_A4),
        (S.X_PARENT_INITIATED_ID, S.EV_A7),
    ):
        out[c] = _resolve(b(c), (t_start, ev_at(t_start, a)))

    out[S.X_CANCEL_REQUESTED] = _resolve(
        b(S.X_CANCEL_REQUESTED), (t_creq, 1))

    # ---- X_SIGNAL_COUNT: counter (mul=1, add=1 per signal); the
    # composed map over a segment is base + count
    out[S.X_SIGNAL_COUNT] = b(S.X_SIGNAL_COUNT) + cx.count_in_seg(m_sig)

    # ---- decision sub-FSM columns (all mul=0 writes except the
    # attempt counter under increment)
    out[S.X_DEC_VERSION] = _resolve(
        b(S.X_DEC_VERSION),
        (t_start, EMPTY_V), (t_dsch, ev_at(t_dsch, S.EV_VERSION)),
        (t_dsta, ev_at(t_dsta, S.EV_VERSION)), (t_dcom, EMPTY_V),
        # the increment branch reads exc[X_CUR_VERSION] which the
        # preamble set to this event's version earlier in the step
        (t_inc, ev_at(t_inc, S.EV_VERSION)), (t_noinc, EMPTY_V),
    )
    out[S.X_DEC_SCHEDULE_ID] = _resolve(
        b(S.X_DEC_SCHEDULE_ID),
        (t_start, EMPTY), (t_dsch, ev_at(t_dsch, S.EV_ID)),
        (t_dcom, EMPTY), (t_inc, ev_at(t_inc, S.EV_BATCH_FIRST)),
        (t_noinc, EMPTY),
    )
    out[S.X_DEC_STARTED_ID] = _resolve(
        b(S.X_DEC_STARTED_ID),
        (t_start, EMPTY), (t_dsch, EMPTY),
        (t_dsta, ev_at(t_dsta, S.EV_ID)), (t_dcom, EMPTY),
        (t_inc, EMPTY), (t_noinc, EMPTY),
    )
    # X_DEC_TIMEOUT's increment write is the one genuine cross-column
    # read: exc[X_DECISION_TIMEOUT_VALUE] *before* the reading step =
    # the start write strictly before t_inc (same segment), else base.
    dtv_prior = None
    if t_inc is not None:
        j = cx.last_before(m_start, t_inc)
        if j is None:
            # no start events in-batch: the prior is always the base row
            dtv_prior = b(S.X_DECISION_TIMEOUT_VALUE)
        else:
            dtv_prior = torch.where(
                j >= 0, cx.ev_at(j, S.EV_A1),
                b(S.X_DECISION_TIMEOUT_VALUE))
    out[S.X_DEC_TIMEOUT] = _resolve(
        b(S.X_DEC_TIMEOUT),
        (t_start, 0), (t_dsch, ev_at(t_dsch, S.EV_A0)),
        (t_dcom, 0), (t_inc, dtv_prior), (t_noinc, 0),
    )
    # X_DEC_ATTEMPT: last plain write + the increments after it
    t_set, set_val = _resolve_tv(
        b(S.X_DEC_ATTEMPT),
        (t_start, 0), (t_dsch, ev_at(t_dsch, S.EV_A1)),
        (t_dsta, 0), (t_dcom, 0), (t_noinc, 0),
    )
    out[S.X_DEC_ATTEMPT] = set_val + cx.count_after(m_inc, t_set)
    out[S.X_DEC_SCHEDULED_TS] = _resolve(
        b(S.X_DEC_SCHEDULED_TS),
        (t_start, 0), (t_dsch, ev_at(t_dsch, S.EV_TS)),
        (t_dcom, 0), (t_inc, ev_at(t_inc, S.EV_TS)), (t_noinc, 0),
    )
    out[S.X_DEC_STARTED_TS] = _resolve(
        b(S.X_DEC_STARTED_TS),
        (t_start, 0), (t_dsch, 0),
        (t_dsta, ev_at(t_dsta, S.EV_TS)), (t_dcom, 0),
        (t_inc, 0), (t_noinc, 0),
    )
    out[S.X_DEC_ORIGINAL_SCHEDULED_TS] = _resolve(
        b(S.X_DEC_ORIGINAL_SCHEDULED_TS),
        (t_start, 0), (t_dsch, ev_at(t_dsch, S.EV_TS)),
        (t_inc, 0), (t_noinc, 0),
    )

    exec_out = torch.stack(out, dim=1)
    return torch.where(cx.valid_h[:, None], exec_out, base)


# --------------------------------------------------------------------------
# Version history — rle algebra (run-length encoding of the version
# stream, recovered from a segmented prefix count of change flags)
# --------------------------------------------------------------------------


def _vh_resolve(cx: _Ctx):
    """(vh_items [n_out, V, 2], vh_len [n_out]) matching the sequential
    add_or_update semantics bit-for-bit, including the overflow write
    drop (same-version writes past capacity match no slot).

    Relies on the packer's layout contract: valid events are contiguous
    from each segment's start (padding only at segment tails), so the
    previous valid event of step t is step t-1 — a shift, not a scan.
    Every producer in the tree (pack_histories, pack_lanes, the smoke
    tilers) satisfies it; the parity tests pin the equivalence.
    """
    capv = cx.init.vh_items.shape[1]
    version = cx.col(S.EV_VERSION)
    len0 = cx.init.vh_len
    seed_idx = torch.clamp(len0 - 1, 0, capv - 1)
    seed_ver = torch.gather(
        cx.init.vh_items[:, :, 1], 1, seed_idx[:, None].long())[:, 0]
    has0 = len0 > 0

    # previous valid event's version (shift), seeded at segment starts
    # from the init row — what the kernel reads via vh_v[clip(len-1)]
    # (dropped overflow writes were same-version, so the fill still
    # matches that slot)
    ver_prev = torch.cat(
        [torch.zeros_like(version[:, :1]), version[:, :-1]], dim=1)
    valid_prev = torch.cat(
        [torch.zeros_like(cx.valid[:, :1]), cx.valid[:, :-1]], dim=1)
    at_start = (cx.iota_t == 0) if cx.trivial else (cx.iota_t == cx.sstep)
    prev_has = torch.where(at_start, cx.per_step(has0, False), valid_prev)
    prev_ver = torch.where(at_start, cx.per_step(seed_ver), ver_prev)
    change = cx.valid & (~prev_has | (prev_ver != version))

    chcum = torch.cumsum(change, dim=1, dtype=torch.int32)
    if cx.trivial:
        c_t = chcum
    else:
        chstart = _where(
            cx.sstep > 0,
            torch.gather(chcum, 1, torch.clamp_min(cx.sstep - 1, 0).long()),
            0,
        )
        c_t = chcum - chstart             # inclusive changes in segment
    widx = cx.per_step(len0) + c_t - 1
    widx = torch.where(change, torch.clamp_max(widx, capv - 1), widx)
    wr = cx.valid & (widx >= 0) & (widx < capv)

    # last writer per (history, vh slot) — widx is the slot stream
    t_vh = cx.table_last(wr, widx, capv)
    vh_e = torch.where(
        t_vh >= 0, cx.ev_at2(t_vh, S.EV_ID), cx.init.vh_items[:, :, 0])
    vh_v = torch.where(
        t_vh >= 0, cx.ev_at2(t_vh, S.EV_VERSION), cx.init.vh_items[:, :, 1])
    vh_len = len0 + cx.count_in_seg(change)
    return torch.stack([vh_e, vh_v], dim=-1), vh_len


# --------------------------------------------------------------------------
# Slot tables — pure mul=0 (last-writer-wins) cells resolved by write
# provenance per writer class, then per-column gathers at the winning
# positions.
# --------------------------------------------------------------------------


def _stack_table(base, cols):
    """cols: list over table columns of candidate lists [(t, val), ...];
    resolves each against base[:, :, c] and stacks to [n_out, cap, N]."""
    return torch.stack(
        [_resolve(base[:, :, c], *cands) for c, cands in enumerate(cols)],
        dim=-1)


def _cands(*items):
    return [i for i in items if i is not None]


def _activities_resolve(cx: _Ctx):
    cap = cx.init.activities.shape[1]
    slot = cx.col(S.EV_SLOT)
    m_sch = cx.m(E.ActivityTaskScheduled)
    m_sta = cx.m(E.ActivityTaskStarted)
    m_clr = cx.m(E.ActivityTaskCompleted, E.ActivityTaskFailed,
                 E.ActivityTaskTimedOut, E.ActivityTaskCanceled)
    m_crq = cx.m(E.ActivityTaskCancelRequested)
    t_full = cx.table_last(_or(m_sch, m_clr), slot, cap)
    t_sta = cx.table_last(m_sta, slot, cap)
    t_crq = cx.table_last(m_crq, slot, cap)
    base = cx.init.activities
    if t_full is None and t_sta is None and t_crq is None:
        return base
    EMPTY = EMPTY_EVENT_ID
    fv = None
    if t_full is not None:
        sched = cx.ev_at2(t_full, S.EV_TYPE) == int(E.ActivityTaskScheduled)
        ver_f = cx.ev_at2(t_full, S.EV_VERSION)
        id_f = cx.ev_at2(t_full, S.EV_ID)
        bf_f = cx.ev_at2(t_full, S.EV_BATCH_FIRST)
        ts_f = cx.ev_at2(t_full, S.EV_TS)
        a0_f = cx.ev_at2(t_full, S.EV_A0)
        a1_f = cx.ev_at2(t_full, S.EV_A1)
        a2_f = cx.ev_at2(t_full, S.EV_A2)
        a3_f = cx.ev_at2(t_full, S.EV_A3)
        a4_f = cx.ev_at2(t_full, S.EV_A4)
        a5_f = cx.ev_at2(t_full, S.EV_A5)
        a6_f = cx.ev_at2(t_full, S.EV_A6)
        # mutableStateBuilder.go:2012-2022 expiration interval
        exp_f = torch.where((a5_f > 0) & (a6_f > a2_f), a6_f, a2_f)

        def fv(expr):
            # scheduled writes the blend value, the close classes clear
            return _where(sched, expr, 0)

    def full(expr_fn):
        return None if t_full is None else (t_full, expr_fn())

    def sta(c):
        return None if t_sta is None else (t_sta, cx.ev_at2(t_sta, c))

    def crq_v(expr_fn):
        return None if t_crq is None else (t_crq, expr_fn())

    cols = [None] * S.AC_N
    cols[S.AC_OCC] = _cands(full(lambda: fv(1)))
    cols[S.AC_VERSION] = _cands(
        full(lambda: fv(ver_f)), sta(S.EV_VERSION),
        crq_v(lambda: cx.ev_at2(t_crq, S.EV_VERSION)),
    )
    cols[S.AC_SCHEDULE_ID] = _cands(full(lambda: fv(id_f)))
    cols[S.AC_SCHEDULED_BATCH_ID] = _cands(full(lambda: fv(bf_f)))
    cols[S.AC_SCHEDULED_TS] = _cands(full(lambda: fv(ts_f)))
    cols[S.AC_STARTED_ID] = _cands(full(lambda: fv(EMPTY)), sta(S.EV_ID))
    cols[S.AC_STARTED_TS] = _cands(full(lambda: fv(0)), sta(S.EV_TS))
    cols[S.AC_ID_HASH] = _cands(full(lambda: fv(a0_f)))
    cols[S.AC_SCH_TO_START] = _cands(full(lambda: fv(a1_f)))
    cols[S.AC_SCH_TO_CLOSE] = _cands(full(lambda: fv(a2_f)))
    cols[S.AC_START_TO_CLOSE] = _cands(full(lambda: fv(a3_f)))
    cols[S.AC_HEARTBEAT] = _cands(full(lambda: fv(a4_f)))
    cols[S.AC_CANCEL_REQUESTED] = _cands(
        full(lambda: fv(0)), crq_v(lambda: 1))
    cols[S.AC_CANCEL_REQUEST_ID] = _cands(
        full(lambda: fv(EMPTY)), crq_v(lambda: cx.ev_at2(t_crq, S.EV_ID)))
    cols[S.AC_ATTEMPT] = _cands(full(lambda: fv(0)), sta(S.EV_A1))
    cols[S.AC_HAS_RETRY] = _cands(full(lambda: fv(a5_f)))
    cols[S.AC_EXPIRATION_TS] = _cands(full(lambda: fv(ts_f + exp_f)))
    cols[S.AC_LAST_HB_TS] = _cands(full(lambda: fv(0)), sta(S.EV_TS))
    cols[S.AC_TIMER_STATUS] = _cands(full(lambda: fv(0)))
    return _stack_table(base, cols)


def _timers_resolve(cx: _Ctx):
    cap = cx.init.timers.shape[1]
    slot = cx.col(S.EV_SLOT)
    t_full = cx.table_last(
        _or(cx.m(E.TimerStarted), cx.m(E.TimerFired, E.TimerCanceled)),
        slot, cap,
    )
    base = cx.init.timers
    if t_full is None:
        return base
    started = cx.ev_at2(t_full, S.EV_TYPE) == int(E.TimerStarted)

    def fv(expr):
        return _where(started, expr, 0)

    cols = [None] * S.TI_N
    cols[S.TI_OCC] = [(t_full, fv(1))]
    cols[S.TI_VERSION] = [(t_full, fv(cx.ev_at2(t_full, S.EV_VERSION)))]
    cols[S.TI_STARTED_ID] = [(t_full, fv(cx.ev_at2(t_full, S.EV_ID)))]
    cols[S.TI_ID_HASH] = [(t_full, fv(cx.ev_at2(t_full, S.EV_A0)))]
    cols[S.TI_EXPIRY_TS] = [(t_full, fv(
        cx.ev_at2(t_full, S.EV_TS) + cx.ev_at2(t_full, S.EV_A1)))]
    cols[S.TI_STATUS] = [(t_full, fv(0))]
    return _stack_table(base, cols)


def _children_resolve(cx: _Ctx):
    cap = cx.init.children.shape[1]
    slot = cx.col(S.EV_SLOT)
    m_ini = cx.m(E.StartChildWorkflowExecutionInitiated)
    m_clr = cx.m(
        E.StartChildWorkflowExecutionFailed,
        E.ChildWorkflowExecutionCompleted, E.ChildWorkflowExecutionFailed,
        E.ChildWorkflowExecutionCanceled, E.ChildWorkflowExecutionTimedOut,
        E.ChildWorkflowExecutionTerminated,
    )
    t_full = cx.table_last(_or(m_ini, m_clr), slot, cap)
    t_sta = cx.table_last(cx.m(E.ChildWorkflowExecutionStarted), slot, cap)
    base = cx.init.children
    if t_full is None and t_sta is None:
        return base
    EMPTY = EMPTY_EVENT_ID
    fv = None
    if t_full is not None:
        ini = cx.ev_at2(t_full, S.EV_TYPE) == int(
            E.StartChildWorkflowExecutionInitiated)

        def fv(expr):
            return _where(ini, expr, 0)

    def full(expr_fn):
        return None if t_full is None else (t_full, expr_fn())

    def sta(c):
        return None if t_sta is None else (t_sta, cx.ev_at2(t_sta, c))

    cols = [None] * S.CH_N
    cols[S.CH_OCC] = _cands(full(lambda: fv(1)))
    cols[S.CH_VERSION] = _cands(
        full(lambda: fv(cx.ev_at2(t_full, S.EV_VERSION))))
    cols[S.CH_INITIATED_ID] = _cands(
        full(lambda: fv(cx.ev_at2(t_full, S.EV_ID))))
    cols[S.CH_INITIATED_BATCH_ID] = _cands(
        full(lambda: fv(cx.ev_at2(t_full, S.EV_BATCH_FIRST))))
    cols[S.CH_STARTED_ID] = _cands(full(lambda: fv(EMPTY)), sta(S.EV_ID))
    cols[S.CH_WF_ID_HASH] = _cands(
        full(lambda: fv(cx.ev_at2(t_full, S.EV_A0))))
    cols[S.CH_RUN_ID_HASH] = _cands(full(lambda: fv(0)), sta(S.EV_A1))
    cols[S.CH_POLICY] = _cands(
        full(lambda: fv(cx.ev_at2(t_full, S.EV_A1))))
    return _stack_table(base, cols)


def _initonly_resolve(cx: _Ctx, base, init_type, *clear_types):
    """Cancels/signals: 4-column tables written by one init blend and
    cleared by the close pair."""
    cap = base.shape[1]
    slot = cx.col(S.EV_SLOT)
    t_full = cx.table_last(
        _or(cx.m(init_type), cx.m(*clear_types)), slot, cap)
    if t_full is None:
        return base
    ini = cx.ev_at2(t_full, S.EV_TYPE) == int(init_type)

    def fv(expr):
        return _where(ini, expr, 0)

    cols = [
        [(t_full, fv(1))],
        [(t_full, fv(cx.ev_at2(t_full, S.EV_VERSION)))],
        [(t_full, fv(cx.ev_at2(t_full, S.EV_ID)))],
        [(t_full, fv(cx.ev_at2(t_full, S.EV_BATCH_FIRST)))],
    ]
    return _stack_table(base, cols)


# --------------------------------------------------------------------------
# Exec columns — direct segmented associative scan (impl="segscan").
# Phase A emits per-column (mul, add) for every [L, T] cell; Phase B is
# the segmented affine scan (the CUDA kernel on the card) plus the fsm
# doubling scan.
# --------------------------------------------------------------------------

AFFINE_EXEC_COLS = tuple(c for c in range(S.X_N) if c != S.X_STATE)


def _emit_affine_exec(cx: _Ctx):
    """Phase A: per-column (mul, add) affine updates for
    AFFINE_EXEC_COLS, time-major [T, L, C] as the scan kernel takes them;
    the fsm stream (kind, kval) [L, T] for X_STATE; and the per-step
    segment reset flags rst [L, T]."""
    ev_id, version = cx.col(S.EV_ID), cx.col(S.EV_VERSION)
    ts, bf = cx.col(S.EV_TS), cx.col(S.EV_BATCH_FIRST)
    a0, a1 = cx.col(S.EV_A0), cx.col(S.EV_A1)

    m_start = cx.m(E.WorkflowExecutionStarted)
    m_close = cx.m(*(t for t, _ in WORKFLOW_CLOSE_STATUS))
    m_creq = cx.m(E.WorkflowExecutionCancelRequested)
    m_sig = cx.m(E.WorkflowExecutionSignaled)
    m_dsch = cx.m(E.DecisionTaskScheduled)
    m_dsta = cx.m(E.DecisionTaskStarted)
    m_dcom = cx.m(E.DecisionTaskCompleted)
    m_inc, m_noinc = _decision_masks(cx)

    # per-step prior of X_DECISION_TIMEOUT_VALUE for the increment
    # write: the start write strictly before this step (same segment),
    # else the init row's value — the dependency-ordered resolution of
    # the one cross-column read
    dtv_base_step = cx.per_step(
        cx.init.exec_info[:, S.X_DECISION_TIMEOUT_VALUE])
    if m_inc is not None and m_start is not None:
        cmx_start = cx._cummax_pos(m_start)
        jst = torch.cat(
            [torch.full_like(cmx_start[:, :1], -1), cmx_start[:, :-1]],
            dim=1)
        if not cx.trivial:
            jst = _where(jst >= cx.sstep, jst, -1)
        dtv_prior = torch.where(
            jst >= 0,
            torch.gather(a1, 1, torch.clamp_min(jst, 0).long()),
            dtv_base_step,
        )
    else:
        dtv_prior = dtv_base_step

    L, T = cx.L, cx.T
    dev = cx.evf.device
    one = torch.ones((), dtype=torch.int32, device=dev).expand(L, T)
    zero2 = torch.zeros((), dtype=torch.int32, device=dev).expand(L, T)
    EMPTY = EMPTY_EVENT_ID
    EMPTY_V = EMPTY_VERSION

    muls, adds = {}, {}

    def w_set(c, mask, val):
        if mask is None:
            return
        m, a = muls.get(c, one), adds.get(c, zero2)
        muls[c] = _where(mask, 0, m)
        adds[c] = _where(mask, val, a)

    def w_add(c, mask, delta):
        if mask is None:
            return
        a = adds.get(c, zero2)
        adds[c] = _where(mask, delta, a)
        muls.setdefault(c, one)

    # preamble (every valid event)
    w_set(S.X_LAST_EVENT_TASK_ID, cx.valid, cx.col(S.EV_TASK_ID))
    w_set(S.X_CUR_VERSION, cx.valid, version)
    w_set(S.X_NEXT_EVENT_ID, cx.valid, ev_id + 1)
    w_set(S.X_LAST_FIRST_EVENT_ID, cx.valid, bf)

    # lifecycle
    w_set(S.X_CLOSE_STATUS, m_start, int(CloseStatus.NONE))
    w_set(S.X_LAST_PROCESSED_EVENT, m_start, EMPTY)
    w_set(S.X_START_TS, m_start, ts)
    w_set(S.X_WORKFLOW_TIMEOUT, m_start, a0)
    w_set(S.X_DECISION_TIMEOUT_VALUE, m_start, a1)
    w_set(S.X_ATTEMPT, m_start, cx.col(S.EV_A2))
    w_set(S.X_HAS_RETRY_POLICY, m_start, cx.col(S.EV_A3))
    w_set(S.X_WF_EXPIRATION_TS, m_start, cx.col(S.EV_A4))
    w_set(S.X_PARENT_INITIATED_ID, m_start, cx.col(S.EV_A7))
    for c in (S.X_DEC_SCHEDULE_ID, S.X_DEC_STARTED_ID):
        w_set(c, m_start, EMPTY)
    w_set(S.X_DEC_VERSION, m_start, EMPTY_V)
    for c in (S.X_DEC_TIMEOUT, S.X_DEC_ATTEMPT, S.X_DEC_SCHEDULED_TS,
              S.X_DEC_STARTED_TS, S.X_DEC_ORIGINAL_SCHEDULED_TS):
        w_set(c, m_start, 0)

    if m_close is not None:
        cs = torch.zeros_like(cx.et)
        for t, v in WORKFLOW_CLOSE_STATUS:
            cs = _where(cx.et == int(t), int(v), cs)
        w_set(S.X_CLOSE_STATUS, m_close, cs)
        w_set(S.X_COMPLETION_EVENT_BATCH_ID, m_close, bf)
    w_set(S.X_CANCEL_REQUESTED, m_creq, 1)
    w_add(S.X_SIGNAL_COUNT, m_sig, 1)

    # decision sub-FSM
    w_set(S.X_DEC_VERSION, m_dsch, version)
    w_set(S.X_DEC_SCHEDULE_ID, m_dsch, ev_id)
    w_set(S.X_DEC_STARTED_ID, m_dsch, EMPTY)
    w_set(S.X_DEC_TIMEOUT, m_dsch, a0)
    w_set(S.X_DEC_ATTEMPT, m_dsch, a1)
    w_set(S.X_DEC_SCHEDULED_TS, m_dsch, ts)
    w_set(S.X_DEC_ORIGINAL_SCHEDULED_TS, m_dsch, ts)
    w_set(S.X_DEC_STARTED_TS, m_dsch, 0)

    w_set(S.X_DEC_VERSION, m_dsta, version)
    w_set(S.X_DEC_STARTED_ID, m_dsta, ev_id)
    w_set(S.X_DEC_ATTEMPT, m_dsta, 0)
    w_set(S.X_DEC_STARTED_TS, m_dsta, ts)

    w_set(S.X_DEC_VERSION, m_dcom, EMPTY_V)
    w_set(S.X_DEC_SCHEDULE_ID, m_dcom, EMPTY)
    w_set(S.X_DEC_STARTED_ID, m_dcom, EMPTY)
    for c in (S.X_DEC_TIMEOUT, S.X_DEC_ATTEMPT, S.X_DEC_SCHEDULED_TS,
              S.X_DEC_STARTED_TS):
        w_set(c, m_dcom, 0)
    w_set(S.X_LAST_PROCESSED_EVENT, m_dcom, a0)

    # fail/timeout: increment re-schedules a transient decision, the
    # non-increment branch deletes the decision
    w_set(S.X_DEC_VERSION, m_inc, version)
    w_set(S.X_DEC_SCHEDULE_ID, m_inc, bf)
    w_set(S.X_DEC_STARTED_ID, m_inc, EMPTY)
    w_set(S.X_DEC_TIMEOUT, m_inc, dtv_prior)
    w_add(S.X_DEC_ATTEMPT, m_inc, 1)
    w_set(S.X_DEC_SCHEDULED_TS, m_inc, ts)
    w_set(S.X_DEC_STARTED_TS, m_inc, 0)
    w_set(S.X_DEC_ORIGINAL_SCHEDULED_TS, m_inc, 0)

    w_set(S.X_DEC_VERSION, m_noinc, EMPTY_V)
    w_set(S.X_DEC_SCHEDULE_ID, m_noinc, EMPTY)
    w_set(S.X_DEC_STARTED_ID, m_noinc, EMPTY)
    for c in (S.X_DEC_TIMEOUT, S.X_DEC_ATTEMPT, S.X_DEC_SCHEDULED_TS,
              S.X_DEC_STARTED_TS, S.X_DEC_ORIGINAL_SCHEDULED_TS):
        w_set(c, m_noinc, 0)

    # time-major planes: stacking the transposed [T, L] views writes the
    # [T, L, C] layout directly, with no extra copy
    mul = torch.stack(
        [muls.get(c, one).T for c in AFFINE_EXEC_COLS], dim=-1)
    add = torch.stack(
        [adds.get(c, zero2).T for c in AFFINE_EXEC_COLS], dim=-1)

    # fsm stream for X_STATE
    kind = zero2
    kval = zero2
    if m_start is not None:
        kind = _where(m_start, 2, kind)
        kval = _where(m_start, _CREATED, kval)
    if m_close is not None:
        kind = _where(m_close, 2, kind)
        kval = _where(m_close, _COMPLETED, kval)
    if m_dsta is not None:
        kind = _where(m_dsta, 1, kind)

    if cx.trivial:
        rst = cx.iota_t == 0
    else:
        rst = cx.iota_t == cx.sstep
    return mul, add, kind, kval, rst


def _exec_segscan(cx: _Ctx):
    """Final exec_info via the direct segmented associative scan: the
    affine stream through ``assoc_cuda.affine_segscan`` (the CUDA kernel
    on the card), the 2-leaf fsm stream through ``fsm_segscan``."""
    mul, add, kind, kval, rst = _emit_affine_exec(cx)
    pm, pa = assoc_cuda.affine_segscan(mul, add, rst.T.contiguous())
    del mul, add
    pk, pv = fsm_segscan(kind, kval, rst)
    # prefix composition at each history's segment end, applied to its
    # init row
    m_end = pm[cx.pos_i, cx.lane_i]              # [n_out, C]
    a_end = pa[cx.pos_i, cx.lane_i]
    k_end = pk[cx.lane_i, cx.pos_i]              # [n_out]
    v_end = pv[cx.lane_i, cx.pos_i]
    base = cx.init.exec_info
    out = [None] * S.X_N
    for i, c in enumerate(AFFINE_EXEC_COLS):
        out[c] = assoc_cuda.wrap_int32(
            m_end[:, i].long() * base[:, c].long() + a_end[:, i].long())
    out[S.X_STATE] = fsm_apply(k_end, v_end, base[:, S.X_STATE])
    exec_out = torch.stack(out, dim=1)
    return torch.where(cx.valid_h[:, None], exec_out, base)


# --------------------------------------------------------------------------
# Core + entry points
# --------------------------------------------------------------------------


def _make_ctx(events_fm, init, hist_bm=None, seg_pos=None, seg_lane=None,
              seg_start=None, types=None) -> _Ctx:
    """The shared per-call context over torch operands on one device;
    without segment geometry, lane i is history i over the whole time
    axis (the unpacked layout, n_out == L)."""
    if events_fm.dtype != torch.int32 or events_fm.dim() != 3:
        raise ValueError(
            f"events_fm must be int32 [EV_N, L, T], got {events_fm.dtype} "
            f"{tuple(events_fm.shape)}")
    T = events_fm.shape[2]
    dev = events_fm.device
    n_out = init.exec_info.shape[0]
    trivial = hist_bm is None
    if trivial:
        seg_pos = torch.full((n_out,), T - 1, dtype=torch.int32, device=dev)
        seg_lane = torch.arange(n_out, dtype=torch.int32, device=dev)
        seg_start = torch.zeros((n_out,), dtype=torch.int32, device=dev)
    type_set = None if types is None else frozenset(int(t) for t in types)
    return _Ctx(events_fm, hist_bm, seg_pos, seg_lane, seg_start, init,
                type_set, trivial=trivial)


def _assoc_core(events_fm, init, hist_bm=None, seg_pos=None,
                seg_lane=None, seg_start=None, *, types=None,
                impl="resolve"):
    """One parallel-in-time replay over field-major [EV_N, L, T] events.

    ``init``: [n_out] torch StateTensors on the events' device — each
    history's segment base state (checkpoint resume rows become the
    leading segment element; padding rows pass through untouched).
    Segment geometry arrives as host precomputes (``assoc_aux``), as
    int32 tensors on the same device; when omitted, lane i is history i
    over the whole time axis (the unpacked layout, n_out == L).
    Returns [n_out] torch StateTensors."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} (got {impl!r})")
    cx = _make_ctx(events_fm, init, hist_bm, seg_pos, seg_lane, seg_start,
                   types)
    if impl == "segscan":
        exec_out = _exec_segscan(cx)
    else:
        exec_out = _exec_resolve(cx)
    vh_items, vh_len = _vh_resolve(cx)
    return S.StateTensors(
        exec_info=exec_out,
        activities=_activities_resolve(cx),
        timers=_timers_resolve(cx),
        children=_children_resolve(cx),
        cancels=_initonly_resolve(
            cx, cx.init.cancels,
            E.RequestCancelExternalWorkflowExecutionInitiated,
            E.RequestCancelExternalWorkflowExecutionFailed,
            E.ExternalWorkflowExecutionCancelRequested,
        ),
        signals=_initonly_resolve(
            cx, cx.init.signals,
            E.SignalExternalWorkflowExecutionInitiated,
            E.SignalExternalWorkflowExecutionFailed,
            E.ExternalWorkflowExecutionSignaled,
        ),
        vh_items=vh_items,
        vh_len=vh_len,
    )


def events_fm_of(events_bm: np.ndarray) -> np.ndarray:
    """[B, T, EV_N] batch-major events → [EV_N, B, T] field-major
    contiguous column planes (the core's operand layout), on the host."""
    return np.ascontiguousarray(np.transpose(np.asarray(events_bm),
                                             (2, 0, 1)))


def assoc_aux(packed: PackedLanes, n_out: int):
    """Host-side segment geometry for the packed layout: per-step
    history ids [L, T] (``n_out`` = padding sentinel) plus per-history
    seg-end position, lane, and segment start (seg_pos -1 marks padding
    rows of the grid-rounded output)."""
    T, L = packed.scan_len, packed.lanes
    hist = np.full((L, T), n_out, np.int32)
    seg_pos = np.full((n_out,), -1, np.int32)
    seg_lane = np.zeros((n_out,), np.int32)
    seg_start = np.zeros((n_out,), np.int32)
    for ln, segs in enumerate(packed.lane_segments):
        for row, start, end in segs:
            hist[ln, start:end] = row
            seg_pos[row] = end - 1
            seg_lane[row] = ln
            seg_start[row] = start
    return hist, seg_pos, seg_lane, seg_start


def assoc_lanes_operands(
    packed: PackedLanes, initial: Optional[S.StateTensors] = None,
):
    """Grid-rounded initial rows + segment geometry for a lane-packed
    assoc replay: ``(init, hist_bm, seg_pos, seg_lane, seg_start)``
    where ``init`` is the [n_out] numpy state seeded from ``initial``
    (default ``packed.initial``). Shared by :func:`replay_assoc_lanes`
    and the dispatcher's lanes_assoc staging so the two can't diverge."""
    if initial is None:
        initial = packed.initial
    n_out = round_scan_len(max(packed.n_histories, 1))
    init = S.empty_state(n_out, packed.caps)
    if initial is not None:
        k = min(initial.exec_info.shape[0], n_out)
        for f in S.STATE_ROW_FIELDS:
            np.asarray(getattr(init, f))[:k] = np.asarray(
                getattr(initial, f))[:k]
    return (init,) + assoc_aux(packed, n_out)


def _tensor(x, dev) -> torch.Tensor:
    """An int32 torch tensor on ``dev`` from a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return S.host_tensor(np.asarray(x, dtype=np.int32)).to(dev)


def _state_to(state, dev) -> S.StateTensors:
    """``state`` (numpy or torch fields, either package's) as torch int32
    StateTensors on ``dev``."""
    return S.StateTensors(**{f: _tensor(getattr(state, f), dev)
                             for f in S.STATE_ROW_FIELDS})


def _caps_of(state: S.StateTensors, T: int) -> S.Capacities:
    """The Capacities a state's table shapes imply (for the FSM kernel's
    row layout)."""
    return S.Capacities(
        max_events=T,
        max_activities=state.activities.shape[1],
        max_timers=state.timers.shape[1],
        max_children=state.children.shape[1],
        max_request_cancels=state.cancels.shape[1],
        max_signals_ext=state.signals.shape[1],
        max_version_items=state.vh_items.shape[1],
    )


def replay_assoc_fm(state, events_fm, types=None, impl: str = "resolve",
                    device="cuda") -> S.StateTensors:
    """Associative replay of a field-major [EV_N, B, T] tensor whose
    present types are all provably affine. ``state`` is the [B] initial
    carry (empty or checkpoint-resume rows), numpy or torch. Returns
    torch StateTensors on ``device``."""
    dev = S.resolve_device(device)
    return _assoc_core(_tensor(events_fm, dev).contiguous(),
                       _state_to(state, dev), types=types, impl=impl)


def replay_assoc(state, events_tm=None, types=None,
                 affine_types: Optional[frozenset] = None,
                 impl: str = "resolve", *, events_fm=None,
                 device="cuda") -> S.StateTensors:
    """Chunked hybrid replay of an unpacked event tensor — time-major
    [T, B, EV_N] (``events_tm``) or the field-major [EV_N, B, T] column
    planes directly (``events_fm``), numpy or torch. Returns torch
    StateTensors on ``device``.

    Steps carrying only affine-provable types ride ``_assoc_core``; a
    step where any lane holds a nonlinear type runs as one sequential
    step of the FSM kernel (``replay_scan_teb``) between chunks. With
    the current kernel every handled type is affine, so the whole tensor
    is normally a single chunk; ``affine_types`` lets tests (and future
    nonlinear transitions) exercise the seam."""
    if (events_tm is None) == (events_fm is None):
        raise ValueError("pass exactly one of events_tm / events_fm")
    dev = S.resolve_device(device)
    if events_fm is None:
        evf = _tensor(events_tm, dev).permute(2, 1, 0).contiguous()
    else:
        evf = _tensor(events_fm, dev).contiguous()
    et = evf[S.EV_TYPE]                                  # [B, T]
    present = [t for t in torch.unique(et).tolist() if t >= 0]
    _, non = classify_types(present, affine_types)
    if types is None:
        types = type_signature(present)
    state = _state_to(state, dev)
    if not non:
        return _assoc_core(evf, state, types=types, impl=impl)
    non_t = torch.tensor(non, dtype=torch.int32, device=dev)
    nl = torch.isin(et, non_t).any(dim=0).tolist()       # [T]
    n_ev, B, T = evf.shape
    caps = _caps_of(state, T)
    t = 0
    while t < T:
        if nl[t]:
            step = evf[:, :, t:t + 1].permute(2, 0, 1).contiguous()
            state = replay_scan_teb(state, step, caps)
            t += 1
            continue
        e = t
        while e < T and not nl[e]:
            e += 1
        tc = round_scan_len(e - t)
        chunk = evf[:, :, t:e]
        if tc > e - t:
            pad = torch.zeros((n_ev, B, tc - (e - t)), dtype=torch.int32,
                              device=dev)
            pad[S.EV_TYPE] = -1
            chunk = torch.cat([chunk, pad], dim=2)
        state = _assoc_core(chunk.contiguous(), state, types=types,
                            impl=impl)
        t = e
    return state


def replay_assoc_lanes(
    packed: PackedLanes,
    initial: Optional[S.StateTensors] = None,
    types=None,
    impl: str = "resolve",
    device="cuda",
) -> S.StateTensors:
    """Associative replay of a lane-packed batch; returns numpy state
    with one row per history in input order — the drop-in parallel of
    ops.replay.replay_packed_lanes. Raises ValueError when the batch
    carries a type the classifier cannot prove affine (callers fall
    back to the sequential packed replay)."""
    _, non = classify_types(packed.present_types)
    if non:
        raise ValueError(
            f"non-affine event types {non} in lane-packed batch; "
            "use the sequential packed replay"
        )
    dev = S.resolve_device(device)
    init, hist_bm, seg_pos, seg_lane, seg_start = assoc_lanes_operands(
        packed, initial)
    if types is None:
        types = type_signature(packed.present_types)
    out = _assoc_core(
        S.host_tensor(packed.events).to(dev).permute(2, 0, 1).contiguous(),
        _state_to(init, dev),
        *(_tensor(a, dev) for a in (hist_bm, seg_pos, seg_lane, seg_start)),
        types=types, impl=impl,
    )
    return S.state_to_numpy(out.map(lambda x: x[: packed.n_histories]))
