"""Mesh-sharded batched replay + NDC snapshot exchange.

The counterpart of the reference package's ``parallel/replay_sharded.py``.
Batch (shard-axis) sharding needs no collective: the replay is
elementwise over the batch, so each rank replays and refreshes its own
contiguous block on its device, the shared-nothing design of the
reference's history shards (each shard single-writer). Ranks of one
shard on the seq axis compute the same block, as ``P("shard")`` leaves
it replicated over ``seq``.

The one cross-rank step is the NDC replication storm (BASELINE config
5): after a batched rebuild every participant needs the others' rebuilt
snapshot digests, one ``all_gather`` and two ``all_reduce`` calls over
the shard axis.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import schema as S
from ..ops.assoc import _assoc_core, _caps_of, events_fm_of
from ..ops.pack import PackedHistories
from ..ops.refresh import FIELDS, RefreshedTasks, refresh_tasks_device
from ..ops.replay import check_scan_mode
from ..ops.replay_cuda import replay_scan_teb
from .mesh import (
    SHARD_AXIS, ReplayMesh, all_gather, all_reduce, events_spec, shard_spec,
)

# no "auto" here: the sharded facade is an explicit two-kernel API
SCAN_MODES = ("scan", "assoc")


def replay_sharded_fn(mesh: ReplayMesh, scan_mode: str = "scan"):
    """The per-rank replay + refresh step of ``mesh``'s batch sharding.

    Returns ``fn(state_local, events_local) -> (final_local,
    tasks_local)`` on this rank's block, torch tensors on their device;
    it runs no collective. ``scan_mode="scan"`` takes field-major
    [T, P, B_local] events through the FSM kernel (``replay_scan_teb``);
    ``"assoc"`` takes [EV_N, B_local, T] column planes through the
    parallel-in-time core (``ops/assoc._assoc_core``, its ``"resolve"``
    form, as the reference's sharded step does)."""
    check_scan_mode(scan_mode, allowed=SCAN_MODES)
    if scan_mode == "assoc":
        def step(state: S.StateTensors, events_fm: torch.Tensor):
            final = _assoc_core(events_fm, state)
            return final, refresh_tasks_device(final)
        return step

    def step(state: S.StateTensors, events_teb: torch.Tensor):
        caps = _caps_of(state, events_teb.shape[0])
        final = replay_scan_teb(state, events_teb, caps)
        return final, refresh_tasks_device(final)
    return step


def gather_shards(tensors: Sequence[torch.Tensor],
                  mesh: ReplayMesh) -> List[np.ndarray]:
    """All shards' blocks of each [B_local, ...] tensor as full [B, ...]
    numpy arrays on every rank, in shard order: one ``all_gather`` of the
    tensors laid side by side as int32 (bool fields come back bool)."""
    b = tensors[0].shape[0]
    widths = [int(np.prod(t.shape[1:])) for t in tensors]
    flat = torch.cat([t.reshape(b, w).to(torch.int32)
                      for t, w in zip(tensors, widths)], dim=1)
    host = all_gather(mesh, flat, SHARD_AXIS, to_host=True).numpy()
    out, col = [], 0
    for t, w in zip(tensors, widths):
        part = host[:, col:col + w].reshape((host.shape[0],) + t.shape[1:])
        col += w
        out.append(part.astype(bool) if t.dtype == torch.bool
                   else np.ascontiguousarray(part))
    return out


def replay_packed_sharded(
    packed: PackedHistories,
    mesh: ReplayMesh,
    initial: Optional[S.StateTensors] = None,
    scan_mode: str = "scan",
    device="cuda",
) -> Tuple[S.StateTensors, RefreshedTasks]:
    """Replay a packed batch across the mesh; returns numpy pytrees of
    the whole batch on every rank.

    The batch must be a multiple of the shard-axis size
    (``pack_histories(pad_batch_to=...)``). ``initial``: per-history
    initial carries, default ``empty_state``. The scan route takes
    ``packed.teb()``; ``scan_mode="assoc"`` rides the parallel-in-time
    core, bit-identical to the scan."""
    check_scan_mode(scan_mode, allowed=SCAN_MODES)
    n_shard = mesh.shape[SHARD_AXIS]
    if packed.batch % n_shard != 0:
        raise ValueError(
            f"batch {packed.batch} not divisible by shard axis {n_shard}; "
            "pack with pad_batch_to")
    dev = S.resolve_device(device)
    blk = shard_spec(mesh, packed.batch)
    state = (S.state_to_numpy(initial) if initial is not None
             else S.empty_state(packed.batch, packed.caps))
    state_local = S.state_from_numpy(state.map(lambda x: x[blk]), dev)
    ev_blk = events_spec(mesh, packed.batch)
    if scan_mode == "assoc":
        events = events_fm_of(packed.events[ev_blk])
    else:
        events = packed.teb()[:, :, ev_blk]
    final, tasks = replay_sharded_fn(mesh, scan_mode)(
        state_local, S.host_tensor(events).to(dev))
    names = S.STATE_ROW_FIELDS + FIELDS
    full = gather_shards([getattr(final, f) for f in S.STATE_ROW_FIELDS]
                         + [getattr(tasks, f) for f in FIELDS], mesh)
    full = dict(zip(names, full))
    return (S.StateTensors(**{f: full[f] for f in S.STATE_ROW_FIELDS}),
            RefreshedTasks(**{f: full[f] for f in FIELDS}))


# Snapshot digest columns gathered in the NDC exchange: enough for the
# receiving side's version check and conflict detection (the fields the
# reference's nDCHistoryReplicator.ApplyEvents consults before accepting
# events: last event id and version, state and close status).
_DIGEST_COLS = (
    S.X_STATE,
    S.X_CLOSE_STATUS,
    S.X_NEXT_EVENT_ID,
    S.X_LAST_EVENT_TASK_ID,
    S.X_CUR_VERSION,
    S.X_DEC_VERSION,
)


def ndc_snapshot_exchange(state_local: S.StateTensors, mesh: ReplayMesh):
    """All-gather rebuilt snapshot digests and reduce the storm counters
    over the shard axis.

    ``state_local``: this rank's [B_local] torch state. Returns, on every
    rank and on the state's device, int32 tensors (digests [B, 6],
    vh_items [B, V, 2], vh_len [B], replayed_count [], max_version []).
    Ranks of one shard on the seq axis hold copies of the same rows, so
    the reductions run over the shard axis only."""
    ex = state_local.exec_info
    b, v = ex.shape[0], state_local.vh_items.shape[1]
    digest = torch.stack([ex[:, c] for c in _DIGEST_COLS], dim=-1)
    flat = torch.cat([digest, state_local.vh_items.reshape(b, 2 * v),
                      state_local.vh_len[:, None]], dim=1).to(torch.int32)
    full = all_gather(mesh, flat, SHARD_AXIS)
    n_dig = len(_DIGEST_COLS)
    # a row is replayed iff its history started (start_ts set):
    # X_STATE >= 0 holds for zero-initialized padding rows too
    replayed = all_reduce(
        mesh, (ex[:, S.X_START_TS] > 0).sum(dtype=torch.int32).reshape(1),
        dist.ReduceOp.SUM, SHARD_AXIS)
    max_version = all_reduce(
        mesh, ex[:, S.X_CUR_VERSION].amax().reshape(1), dist.ReduceOp.MAX,
        SHARD_AXIS)
    return (full[:, :n_dig].contiguous(),
            full[:, n_dig:n_dig + 2 * v].reshape(-1, v, 2).contiguous(),
            full[:, n_dig + 2 * v].contiguous(),
            replayed.reshape(()), max_version.reshape(()))
