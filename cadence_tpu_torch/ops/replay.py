"""Replay facades: a packed batch in, numpy state (one row per history) out.

The counterparts of the reference package's ``ops/replay.py``
``replay_packed`` and ``replay_packed_lanes``, with the same contracts and
return values. Every ``scan_mode`` runs the sequential FSM kernel
(``ops/replay_cuda.py``), as the reference does on its accelerator; the
parallel-in-time path is not ported yet.

On ``device="cuda"`` (the default) the kernel runs on the GPU; on
``device="cpu"`` its plain PyTorch version runs instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import schema as S
from .pack import PackedLanes
from .replay_cuda import narrow_events_teb, replay_scan_packed, replay_scan_teb

SCAN_MODES = ("auto", "scan", "assoc")


def check_scan_mode(scan_mode: str) -> None:
    """Reject unknown ``scan_mode`` strings up front."""
    if scan_mode not in SCAN_MODES:
        raise ValueError(
            f"scan_mode must be one of {'/'.join(SCAN_MODES)} "
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
    bytes; the result is bit-identical)."""
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

    The kernel advances one ``packed.seg_align``-step block per launch,
    and segment flushes happen between blocks, so pack with
    ``seg_align`` at the time block wanted (16 in the dispatcher)."""
    check_scan_mode(scan_mode)
    dev = S.resolve_device(device)
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
        tb=packed.seg_align, base=base, wide_cols=wide, **kw)
    return S.state_to_numpy(out)
