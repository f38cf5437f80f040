"""The least time an NVIDIA H100 could take for the FSM replay of one
batch: its bytes and its integer operations, counted from the cell's
inputs, against the card's peaks.

The arithmetic is a frozen copy of ``bound`` in ``chip_smoke.py`` (the
port's bring-up script), with the bytes counted as the replay needs
them: each valid event once, at the width of the port's lossless int16
narrow stream where the batch narrows (a column whose span over the
valid events fits 65,000 takes 2 bytes, a wide column 4) and at 4 bytes
a column where it does not (the event type or the slot column wide);
each lane's state read once and written once.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from . import schema as S
from .fsm import RowMap

# HBM bytes/s of one H100 SXM, NVIDIA's data sheet (at its 700 W limit)
PEAK_BYTES_S = 3.35e12
# assumed: int32 ALU operations/s, half the 67 TFLOP/s float32 rate (64
# INT32 lanes per SM against 128 FP32 lanes); chip_smoke.py's figure
PEAK_INT32_OPS_S = 33.5e12
# assumed: integer operations one lane-step of the FSM costs (field
# reconstruction, preamble, version history, switch and the largest
# group's writes); chip_smoke.py's figure
FSM_OPS_PER_EVENT = 64
# a column narrows when its span fits an affine int16 (the port's rule)
NARROW_SPAN = 65000


def event_bytes(rows: Sequence[np.ndarray]) -> int:
    """Bytes of the valid events ``rows`` (each [n, EV_N] int32) at the
    narrow stream's widths."""
    ev = np.concatenate([np.asarray(r) for r in rows]) if len(rows) else (
        np.zeros((0, S.EV_N), np.int32))
    if ev.shape[0] == 0:
        return 0
    span = ev.max(axis=0).astype(np.int64) - ev.min(axis=0).astype(np.int64)
    wide = span > NARROW_SPAN
    if wide[S.EV_TYPE] or wide[S.EV_SLOT]:
        per_event = 4 * S.EV_N
    else:
        per_event = int(np.where(wide, 4, 2).sum())
    return per_event * ev.shape[0]


def replay_work(unique_rows: Sequence[np.ndarray], lanes: int,
                caps: S.Capacities) -> Dict[str, float]:
    """The batch's bytes, operations and least seconds. ``unique_rows``:
    the valid event rows each unique lane streams; lane ``i`` streams
    unique ``i % U``."""
    u = len(unique_rows)
    if not u or lanes % u:
        raise ValueError(f"{lanes} lanes do not tile {u} uniques")
    reps = lanes // u
    valid = reps * sum(int(np.asarray(r).shape[0]) for r in unique_rows)
    ev_bytes = reps * event_bytes(unique_rows)
    state_bytes = 2 * 4 * RowMap(caps).rows * lanes
    nbytes = ev_bytes + state_bytes
    ops = valid * FSM_OPS_PER_EVENT
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = ops / PEAK_INT32_OPS_S
    return dict(valid_events=valid, event_bytes=ev_bytes,
                state_bytes=state_bytes, bytes=nbytes, ops=ops,
                least_s=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
