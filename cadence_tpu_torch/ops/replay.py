"""Replay facades: a packed batch in, numpy state (one row per history) out.

The counterparts of the reference package's ``ops/replay.py``
``replay_packed`` and ``replay_packed_lanes``, with the same contracts and
return values. ``scan_mode``:

* ``"auto"`` and ``"scan"`` run the sequential FSM kernel
  (``ops/replay_cuda.py``), as the reference does on its accelerator;
* ``"assoc"`` runs the parallel-in-time replay (``ops/assoc.py``):
  ``replay_packed`` takes ``replay_assoc`` (single sequential steps
  only where a present type is not provably affine);
  ``replay_packed_lanes`` takes ``replay_assoc_lanes`` when every present
  type is affine and the sequential packed route otherwise.

All routes give the same state, bit for bit. On ``device="cuda"`` (the
default) the kernels run on the GPU; on ``device="cpu"`` their plain
PyTorch versions run instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.enums import EventType as E
from . import schema as S
from .pack import PackedLanes, round_scan_len
from .replay_cuda import narrow_events_teb, replay_scan_packed, replay_scan_teb

SCAN_MODES = ("auto", "scan", "assoc")

# The kernel's transition groups: the types of one group share one
# transition block. ``type_signature`` widens a batch's present types to
# whole groups, so a specialization key says which blocks run.
TYPE_GROUPS = (
    (E.WorkflowExecutionStarted,),
    (E.WorkflowExecutionCompleted, E.WorkflowExecutionFailed,
     E.WorkflowExecutionTimedOut, E.WorkflowExecutionCanceled,
     E.WorkflowExecutionTerminated,
     E.WorkflowExecutionContinuedAsNew),
    (E.WorkflowExecutionCancelRequested,),
    (E.WorkflowExecutionSignaled,),
    (E.DecisionTaskScheduled,),
    (E.DecisionTaskStarted,),
    (E.DecisionTaskCompleted,),
    (E.DecisionTaskTimedOut, E.DecisionTaskFailed),
    (E.ActivityTaskScheduled,),
    (E.ActivityTaskStarted,),
    (E.ActivityTaskCompleted, E.ActivityTaskFailed,
     E.ActivityTaskTimedOut, E.ActivityTaskCanceled),
    (E.ActivityTaskCancelRequested,),
    (E.TimerStarted,),
    (E.TimerFired, E.TimerCanceled),
    (E.StartChildWorkflowExecutionInitiated,),
    (E.ChildWorkflowExecutionStarted,),
    (E.StartChildWorkflowExecutionFailed,
     E.ChildWorkflowExecutionCompleted,
     E.ChildWorkflowExecutionFailed,
     E.ChildWorkflowExecutionCanceled,
     E.ChildWorkflowExecutionTimedOut,
     E.ChildWorkflowExecutionTerminated),
    (E.RequestCancelExternalWorkflowExecutionInitiated,),
    (E.RequestCancelExternalWorkflowExecutionFailed,
     E.ExternalWorkflowExecutionCancelRequested),
    (E.SignalExternalWorkflowExecutionInitiated,),
    (E.SignalExternalWorkflowExecutionFailed,
     E.ExternalWorkflowExecutionSignaled),
)


def type_signature(present) -> tuple:
    """Canonical static type set of a batch: its present event types
    expanded to whole transition groups, as a sorted tuple. The
    parallel-in-time replay skips the masks of absent groups; retained
    groups still test exact types, so the result is bit-identical to
    the unspecialized one."""
    ps = {int(t) for t in present}
    out = set()
    for g in TYPE_GROUPS:
        if any(int(t) in ps for t in g):
            out.update(int(t) for t in g)
    return tuple(sorted(out))


def check_scan_mode(scan_mode: str, allowed=SCAN_MODES) -> None:
    """Reject ``scan_mode`` strings outside ``allowed`` up front."""
    if scan_mode not in allowed:
        raise ValueError(
            f"scan_mode must be one of {'/'.join(allowed)} "
            f"(got {scan_mode!r})")


def events_to_device(teb: np.ndarray, device, narrow: bool):
    """Move a [T, EV_N, B] int32 event tensor to ``device``, as the int16
    narrow stream when ``narrow`` and the batch allows it. Returns
    (events, base, wide_cols); base is None for int32 events."""
    if narrow:
        narrowed = narrow_events_teb(teb)
        if narrowed is not None:
            ev16, base, wide = narrowed
            return torch.from_numpy(ev16).to(device), base, wide
    return S.host_tensor(teb).to(device), None, ()


def replay_packed(
    packed,
    initial: Optional[S.StateTensors] = None,
    scan_mode: str = "auto",
    device="cuda",
    narrow: bool = False,
) -> S.StateTensors:
    """Replay a packed batch; returns numpy state, one row per history.

    Accepts :class:`PackedHistories` (one history per lane) or
    :class:`PackedLanes` (ragged lane packing). ``initial``: per-history
    initial carries (checkpoint resume), default ``packed.initial``.
    ``narrow``: stream the events as the int16 narrow stream (half the
    bytes; the result is bit-identical) on the sequential route.
    ``scan_mode="assoc"``: the parallel-in-time replay (module
    docstring), on int32 events."""
    check_scan_mode(scan_mode)
    if isinstance(packed, PackedLanes):
        return replay_packed_lanes(packed, initial=initial,
                                   scan_mode=scan_mode, device=device,
                                   narrow=narrow)
    dev = S.resolve_device(device)
    if initial is None:
        initial = packed.initial
    state = initial if initial is not None else S.empty_state(
        packed.batch, packed.caps)
    if packed.batch == 0:
        return S.state_to_numpy(state)
    if scan_mode == "assoc":
        return _replay_packed_assoc(packed, state, dev)
    events, base, wide = events_to_device(packed.teb(), dev, narrow)
    final = replay_scan_teb(S.state_from_numpy(state, dev), events,
                            packed.caps, base=base, wide_cols=wide)
    return S.state_to_numpy(final)


def replay_packed_lanes(
    packed: PackedLanes,
    initial: Optional[S.StateTensors] = None,
    scan_mode: str = "auto",
    device="cuda",
    narrow: bool = False,
) -> S.StateTensors:
    """Replay a lane-packed batch; returns numpy state with one row per
    history, in input order (``packed.side`` indexes it directly).

    ``initial``: [n_histories] per-history initial carries (checkpoint
    resume), default ``packed.initial``: each history's segment then
    seeds from its row instead of ``empty_state``, bit-identically to
    replaying the full history from scratch.

    ``scan_mode="assoc"`` takes ``replay_assoc_lanes`` when every present
    type is provably affine; the lane-packed assoc path has no hybrid
    chunker, so a batch with a nonaffine type takes the sequential packed
    route below, as under ``"auto"``/``"scan"``. Either route takes any
    ``seg_align``: the sequential kernel replays the whole pack in one
    launch and flushes each segment at its own end step."""
    check_scan_mode(scan_mode)
    dev = S.resolve_device(device)
    if scan_mode == "assoc":
        from .assoc import classify_types, replay_assoc_lanes

        _, non = classify_types(packed.present_types)
        if not non:
            return replay_assoc_lanes(packed, initial=initial, device=dev)
    caps = packed.caps
    if initial is None:
        initial = packed.initial
    out0 = S.state_from_numpy(S.empty_state(packed.n_histories, caps), dev)
    kw = {}
    if initial is not None:
        kw = dict(init=S.state_from_numpy(initial, dev),
                  reset_row=packed.reset_rows())
    state0 = S.state_from_numpy(packed.lane_state0(initial), dev)
    events, base, wide = events_to_device(packed.teb(), dev, narrow)
    _, out = replay_scan_packed(
        state0, out0, events, packed.seg_end, packed.out_row, caps,
        base=base, wide_cols=wide, **kw)
    return S.state_to_numpy(out)


def _replay_packed_assoc(packed, state, dev) -> S.StateTensors:
    """``replay_packed(scan_mode="assoc")`` of a PackedHistories: the
    batch padded to the ``round_scan_len`` grid with padding lanes, then
    ``replay_assoc``, which runs single sequential steps only where a
    present type is not provably affine."""
    from .assoc import replay_assoc

    b = packed.batch
    bp = round_scan_len(b)
    # field-major column planes, transposed on the device
    evf = S.host_tensor(packed.events).to(dev).permute(2, 0, 1)
    if bp > b:
        pad = torch.zeros((S.EV_N, bp - b, evf.shape[2]), dtype=torch.int32,
                          device=dev)
        pad[S.EV_TYPE] = -1
        evf = torch.cat([evf, pad], dim=1)
        empty = S.empty_state(bp - b, packed.caps)
        state = S.StateTensors(**{
            f: np.concatenate([np.asarray(getattr(state, f), np.int32),
                               getattr(empty, f)])
            for f in S.STATE_ROW_FIELDS})
    final = replay_assoc(state, events_fm=evf, device=dev)
    return S.state_to_numpy(final.map(lambda x: x[:b]))
