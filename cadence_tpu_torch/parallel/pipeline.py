"""Time-pipelined replay for deep histories (sequence parallelism).

The counterpart of the reference package's ``parallel/pipeline.py``. A
history replay is a sequential scan over time and its transition is not
associative, but it can be pipelined: the steps split into contiguous
chunks over the ``seq`` axis, the lanes into micro-batches, and each
micro-batch's carry passes from stage i to stage i + 1 as soon as chunk
i is done. With M micro-batches and S stages a stage is busy M of the
M + S - 1 steps of the GPipe schedule.

The reference runs every stage on every step under masks and hands the
carries on with ``ppermute``. Here the hand-offs are real point-to-point
messages: stage ``idx`` replays micro-batch j at schedule step
``j + idx``, receiving its carry from stage ``idx - 1`` and sending the
result to ``idx + 1``; the results are the same.
"""

from __future__ import annotations

import torch

from ..ops import schema as S
from ..ops.assoc import _caps_of
from ..ops.replay_cuda import RowMap, replay_rows, rows_to_state, state_to_rows
from .mesh import SEQ_AXIS, ReplayMesh, broadcast_, isend, recv


def replay_pipelined(state: S.StateTensors, events_teb_local: torch.Tensor,
                     mesh: ReplayMesh, n_micro: int = 0) -> S.StateTensors:
    """Pipelined replay: steps split over ``seq``, lanes over ``shard``.

    ``state``: this rank's [B_local] initial carry (torch, on the events'
    device); ``events_teb_local``: its [T / n_seq, P, B_local] block
    (``parallel.mesh.pipeline_spec``). ``n_micro`` defaults to the
    seq-axis size (balanced bubble) and must divide B_local. Returns the
    final [B_local] state on every rank of the seq axis.

    The carry handed on is the FSM kernel's row block, one contiguous
    [R_pad, B_local / n_micro] int32 tensor a micro-batch, replayed over
    the stage's steps by ``replay_rows``."""
    n_seq = mesh.shape[SEQ_AXIS]
    n_micro = n_micro or n_seq
    b_local = events_teb_local.shape[2]
    if b_local % n_micro != 0:
        raise ValueError(
            f"local batch {b_local} not divisible by n_micro={n_micro}")
    if state.exec_info.shape[0] != b_local:
        raise ValueError(
            f"state holds {state.exec_info.shape[0]} lanes, the events "
            f"{b_local}")
    mb = b_local // n_micro
    idx = mesh.seq_index
    dev = events_teb_local.device
    caps = _caps_of(state, events_teb_local.shape[0])
    rm = RowMap(caps)
    init = state_to_rows(state, rm)
    out = torch.empty_like(init)
    sent = []
    for j in range(n_micro):                 # schedule step j + idx
        lanes = slice(j * mb, (j + 1) * mb)
        if idx == 0:
            rows = init[:, lanes].contiguous()
        else:
            rows = recv(mesh, (rm.rows_padded, mb), torch.int32, dev,
                        idx - 1, SEQ_AXIS, tag=j)
        ev = events_teb_local[:, :, lanes].contiguous()
        replay_rows(ev, rows, caps, out=rows)
        if idx < n_seq - 1:
            sent.append(isend(mesh, rows, idx + 1, SEQ_AXIS, tag=j))
        else:
            out[:, lanes] = rows
    for s in sent:
        s.wait()
    # only the last stage holds the results; it hands them to the others
    broadcast_(mesh, out, n_seq - 1, SEQ_AXIS)
    return rows_to_state(out, rm)
