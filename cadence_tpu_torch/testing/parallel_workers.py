"""Rank functions for ``parallel.launch.run_ranks``.

Spawned ranks import their function by module path, so the functions
that the tests and the smoke run hand to ``run_ranks`` live here, in the
package. Each takes the rank's device first and returns numpy and plain
values.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import assoc_cuda as AC
from ..ops import replay_cuda as RC
from ..ops import schema as S
from ..ops.refresh import FIELDS, refreshed_to_numpy
from ..parallel import (
    make_mesh, ndc_snapshot_exchange, replay_packed_sharded,
    replay_pipelined, replay_sharded_fn,
)
from ..parallel.mesh import SEQ_AXIS, pipeline_spec, shard_spec
from ..parallel.replay_sharded import gather_shards


def _coords(mesh) -> dict:
    return {"shape": dict(mesh.shape), "shard_index": mesh.shard_index,
            "seq_index": mesh.seq_index, "shard_ranks": mesh.shard_ranks,
            "seq_ranks": mesh.seq_ranks}


def _numpy(tree, names) -> dict:
    return {f: np.asarray(getattr(tree, f)) for f in names}


def _value_error(fn) -> str:
    """The message of the ValueError ``fn`` raises; raises if it does
    not."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("expected a ValueError")


def differential_cases(dev: torch.device, packed) -> dict:
    """Every multi-rank case of the differential tests on one spawn of 8
    ranks: the sharded step at seq 1 and 2 in both scan modes, the
    pipelined replay at (seq, n_micro) (2, 2), (4, 2), (8, 1), the NDC
    exchange at seq 1 and 2, and the errors raised before any
    collective."""
    caps = packed.caps
    b, t = packed.batch, caps.max_events
    out = {"meshes": {}, "sharded": {}, "pipelined": {}, "exchange": {}}
    meshes = {seq: make_mesh(seq=seq) for seq in (1, 2, 4, 8)}
    for seq, mesh in meshes.items():
        out["meshes"][seq] = _coords(mesh)
    for seq in (1, 2):
        for mode in ("scan", "assoc"):
            final, tasks = replay_packed_sharded(
                packed, meshes[seq], scan_mode=mode, device=dev)
            out["sharded"][seq, mode] = (_numpy(final, S.STATE_ROW_FIELDS),
                                         _numpy(tasks, FIELDS))
    final = out["sharded"][1, "scan"][0]
    for seq, n_micro in ((2, 2), (4, 2), (8, 1)):
        mesh = meshes[seq]
        steps, lanes = pipeline_spec(mesh, t, b)
        init = S.state_from_numpy(
            S.empty_state(b, caps).map(lambda x: x[lanes]), dev)
        events = S.host_tensor(packed.teb()[steps, :, lanes]).to(dev)
        piped = replay_pipelined(init, events, mesh, n_micro=n_micro)
        out["pipelined"][seq, n_micro] = _numpy(piped, S.STATE_ROW_FIELDS)
    for seq in (1, 2):
        blk = shard_spec(meshes[seq], b)
        local = S.state_from_numpy({f: v[blk] for f, v in final.items()},
                                   dev)
        res = ndc_snapshot_exchange(local, meshes[seq])
        out["exchange"][seq] = [x.cpu().numpy() for x in res]

    mesh2 = meshes[2]
    short = type(packed)(events=packed.events[:12],
                         lengths=packed.lengths[:12], side=packed.side[:12],
                         caps=caps, epoch_s=packed.epoch_s)
    steps, lanes = pipeline_spec(mesh2, t, b)
    b_local = lanes.stop - lanes.start
    out["errors"] = {
        "auto": _value_error(lambda: replay_packed_sharded(
            packed, meshes[1], scan_mode="auto", device=dev)),
        "batch": _value_error(lambda: replay_packed_sharded(
            short, meshes[1], device=dev)),
        "steps": _value_error(lambda: pipeline_spec(mesh2, t - 1, b)),
        "n_micro": _value_error(lambda: replay_pipelined(
            S.state_from_numpy(S.empty_state(b_local, caps), dev),
            S.host_tensor(packed.teb()[steps, :, lanes]).to(dev), mesh2,
            n_micro=3)),
    }
    return out


def raise_on(dev: torch.device, bad_rank: int) -> int:
    """Rank ``bad_rank`` raises; the others wait in a barrier that it
    never joins."""
    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} refuses")
    dist.barrier()
    return dist.get_rank()


def sleep_on(dev: torch.device, slow_rank: int, seconds: float) -> int:
    """Rank ``slow_rank`` sleeps for ``seconds``; the others return."""
    if dist.get_rank() == slow_rank:
        time.sleep(seconds)
    return dist.get_rank()


# --------------------------------------------------------------------------
# chip_smoke.py's phase 10 (b): one rank of a 2 x 2 gloo mesh on one card
# --------------------------------------------------------------------------


def field_digests(arrays: dict) -> dict:
    """sha256 of each named array's dtype, shape and bytes: ranks report
    these instead of shipping their arrays, and the caller holds them
    against the same digests of its reference."""
    out = {}
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.data)
        out[name] = h.hexdigest()
    return out


def _local_digests(final, tasks=None) -> dict:
    host = S.state_to_numpy(final)
    arrays = {f: getattr(host, f) for f in S.STATE_ROW_FIELDS}
    if tasks is not None:
        t = refreshed_to_numpy(tasks)
        arrays.update({f: getattr(t, f) for f in FIELDS})
    return field_digests(arrays)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_ms(dev: torch.device, fn, reps: int) -> float:
    """Median ms of ``reps`` calls of ``fn`` after one warm-up call:
    CUDA events on a card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _mesh_step(dev: torch.device, drive):
    """``drive()`` -> (result, {part: ms}) run by every rank from one
    barrier to the next; returns (result, times), the times with the
    barrier-to-barrier wall as ``mesh_wall_ms``."""
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    res, times = drive()
    _sync(dev)
    dist.barrier()
    return res, dict(times, mesh_wall_ms=(time.perf_counter() - t0) * 1e3)


def _warm(dev: torch.device, drive, reps: int) -> dict:
    """The median of each time of ``reps`` more ``_mesh_step`` runs."""
    runs = [_mesh_step(dev, drive)[1] for _ in range(reps)]
    return {k: sorted(r[k] for r in runs)[reps // 2] for k in runs[0]}


def _timed(dev: torch.device, fn):
    """(result, ms) of ``fn`` on this rank, ending at its synchronize."""
    t0 = time.perf_counter()
    res = fn()
    _sync(dev)
    return res, (time.perf_counter() - t0) * 1e3


def smoke_mesh(dev: torch.device, uniq_teb: np.ndarray, caps_kw: dict,
               n_scan: int, n_assoc: int, micros, reps: int = 5) -> dict:
    """The sharded step in scan mode over ``n_scan`` lanes with the
    gather of the whole batch, the NDC exchange of its result,
    ``replay_pipelined`` at each of ``micros``, and the sharded step in
    assoc mode over ``n_assoc`` lanes, on one rank of a 2 x 2 mesh.

    Lane b of a batch is history b % U of ``uniq_teb`` [T, P, U], tiled
    on the device (no rank packs the batch on its host). Each part runs
    once with FSM launches counted from zero (its first, cold call:
    ``times``), then ``reps`` more times (``warm``: medians); every rank
    times at once. Results come back as ``field_digests``."""
    caps = S.Capacities(**caps_kw)
    mesh = make_mesh(seq=2)
    u = S.host_tensor(uniq_teb).to(dev)

    def tiled(lanes: slice, steps: slice = slice(None)):
        idx = torch.arange(lanes.start, lanes.stop, device=dev) % u.shape[2]
        return u[steps].index_select(2, idx).contiguous()

    def empty(lanes: slice):
        return S.state_from_numpy(
            S.empty_state(lanes.stop - lanes.start, caps), dev)

    def sharded(step, state0, events):
        def drive():
            (final, tasks), step_ms = _timed(dev, lambda: step(state0, events))
            full, gather_ms = _timed(dev, lambda: gather_shards(
                [getattr(final, f) for f in S.STATE_ROW_FIELDS]
                + [getattr(tasks, f) for f in FIELDS], mesh))
            return (final, tasks, full), {"step_ms": step_ms,
                                          "gather_ms": gather_ms}
        return drive

    def counted(drive):
        staged0 = mesh.staged_bytes
        RC.replay_rows.launches = 0
        AC.affine_segscan.launches = 0
        res, times = _mesh_step(dev, drive)
        return res, {"launches": RC.replay_rows.launches,
                     "segscan_launches": AC.affine_segscan.launches,
                     "times": times,
                     "staged_bytes": mesh.staged_bytes - staged0}

    names = S.STATE_ROW_FIELDS + FIELDS
    rec = {"rank": mesh.rank, "shard_index": mesh.shard_index,
           "seq_index": mesh.seq_index, "shape": dict(mesh.shape)}

    # the sharded step, scan mode, and the gather of the whole batch
    blk = shard_spec(mesh, n_scan)
    ev = tiled(blk)
    state0 = empty(blk)
    drive = sharded(replay_sharded_fn(mesh, "scan"), state0, ev)
    (final, tasks, full), rec["scan"] = counted(drive)
    rec["scan"].update(lanes=blk.stop - blk.start,
                       local=_local_digests(final, tasks),
                       full=field_digests(dict(zip(names, full))))
    del full
    rec["scan"]["warm"] = _warm(dev, drive, reps)
    rm = RC.RowMap(caps)
    rows0 = RC.state_to_rows(state0, rm)
    out = torch.empty_like(rows0)
    dist.barrier()
    rec["scan"]["kernel_ms"] = _median_ms(
        dev, lambda: RC.replay_rows(ev, rows0, caps, out=out), reps)
    del ev, rows0, out

    # the NDC exchange of the scan's result
    def exchange():
        res, ms = _timed(dev, lambda: ndc_snapshot_exchange(final, mesh))
        return res, {"exchange_ms": ms}
    res, rec["exchange"] = counted(exchange)
    dig, vh, vh_len, replayed, max_version = res
    rec["exchange"].update(
        replayed=int(replayed), max_version=int(max_version),
        dtypes=[str(x.dtype) for x in res],
        digests=field_digests({"digests": dig.cpu().numpy(),
                               "vh_items": vh.cpu().numpy(),
                               "vh_len": vh_len.cpu().numpy()}),
        warm=_warm(dev, exchange, reps))
    del final, tasks, res, dig, vh, vh_len

    # the pipelined replay: steps over seq, lanes over shard
    steps, lanes = pipeline_spec(mesh, caps.max_events, n_scan)
    ev = tiled(lanes, steps)
    n_seq = mesh.shape[SEQ_AXIS]
    rec["pipeline"] = {}
    for n_micro in micros:
        def pipe():
            res, ms = _timed(dev, lambda: replay_pipelined(
                state0, ev, mesh, n_micro))
            return res, {"rank_ms": ms}
        piped, r = counted(pipe)
        r.update(steps=steps.stop - steps.start,
                 lanes=lanes.stop - lanes.start,
                 bubble=n_micro / (n_micro + n_seq - 1),
                 local=_local_digests(piped), warm=_warm(dev, pipe, reps))
        rec["pipeline"][n_micro] = r
    del ev, piped, state0

    # the sharded step, assoc mode, and the gather
    blk = shard_spec(mesh, n_assoc)
    ev = tiled(blk).permute(1, 2, 0).contiguous()
    state0 = empty(blk)
    drive = sharded(replay_sharded_fn(mesh, "assoc"), state0, ev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    (final, tasks, full), rec["assoc"] = counted(drive)
    rec["assoc"].update(
        lanes=blk.stop - blk.start,
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None),
        local=_local_digests(final, tasks),
        full=field_digests(dict(zip(names, full))))
    del full
    rec["assoc"]["warm"] = _warm(dev, drive, reps)
    rec["staged_bytes"] = mesh.staged_bytes
    return rec
