#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cadence_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout, holds each against its plain
PyTorch version, drives the replay main path at the size of the
``retry_deep`` deployment (65,536 histories of about 1,000 events) and
the depth-bucketed rebuild route, and prints one JSON line per phase:

1. device: the card (``nvidia-smi`` name and power limit), kernel build;
2. kernel against plain on seeded random events (every event type,
   slots from -1 to past capacity, version changes, padding), at the
   default and the retry_deep capacities, int32 and int16 streams;
3. ``replay_packed`` on 65,536 tiled retry_deep histories, int32 and
   narrow, with kernel timing (CUDA events) against the memory bound;
4. ``replay_stream(bucket=True)`` on a 90% shallow / 10% deep mix,
   every snapshot against the plain route on the CPU;
5. the kernel list with launch counts on the main path, then the device
   line.

Any failure exits non-zero without the final line. Needs one CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the retry_deep deployment: caps, 512 x 128 histories of ~1k events
RETRY_CAPS = dict(max_events=1024, max_activities=4, max_timers=2,
                  max_children=2, max_request_cancels=2, max_signals_ext=2,
                  max_version_items=2)
N_UNIQUE = 256
N_HISTORIES = 512 * 128
DEPTH = 1000
PLAIN_CHECK_LANES = 4096
RANDOM_B, RANDOM_T = 2048, 1024
# phase 4: the mixed_depth shape
N_SHALLOW, N_DEEP = 1800, 200

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; int32 ALU ops/s is
# half the 67 TFLOP/s float32 rate (64 INT32 lanes per SM against 128
# FP32 lanes)
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 33.5e12
# integer operations one lane-step of the FSM costs, counted from the
# transition code: field reconstruction, preamble, version history,
# switch and the largest group's writes
FSM_OPS_PER_EVENT = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA
    events, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(event_bytes: int, rows_padded: int, lanes: int,
          valid_events: int):
    """Least time for the replay: each event byte read once and the
    state read and written once, against the FSM's integer work."""
    nbytes = event_bytes + 2 * rows_padded * lanes * 4
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = valid_events * FSM_OPS_PER_EVENT / PEAK_INT32_OPS_S * 1e3
    return nbytes, max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def random_events(S, E, caps, t, b, seed, pad_frac=0.1):
    """Seeded random [T, EV_N, B] int32 events over every event type,
    slots from -1 to past the largest table, frequent version changes,
    padding steps, and a hash-wide column."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ev = np.zeros((t, S.EV_N, b), np.int32)
    et = rng.integers(0, len(E), size=(t, b))
    et[rng.random((t, b)) < pad_frac] = -1
    ev[:, S.EV_TYPE] = et
    ev[:, S.EV_ID] = np.arange(1, t + 1)[:, None]
    ev[:, S.EV_VERSION] = rng.choice([-24, 1, 2, 3, 10], size=(t, b))
    ev[:, S.EV_TASK_ID] = rng.integers(-1234, 5000, size=(t, b))
    ev[:, S.EV_TS] = rng.integers(0, 30000, size=(t, b))
    ev[:, S.EV_BATCH_FIRST] = rng.integers(1, t + 1, size=(t, b))
    ev[:, S.EV_IS_BATCH_LAST] = rng.integers(0, 2, size=(t, b))
    top = max(caps.max_activities, caps.max_timers, caps.max_children,
              caps.max_request_cancels, caps.max_signals_ext)
    ev[:, S.EV_SLOT] = rng.integers(-1, top + 2, size=(t, b))
    for c in range(S.EV_A0, S.EV_N):
        ev[:, c] = rng.integers(-3, 20, size=(t, b))
    ev[:, S.EV_A0] = rng.integers(0, 2**31 - 1, size=(t, b))
    dto = et == int(E.DecisionTaskTimedOut)
    ev[:, S.EV_A0][dto] = rng.integers(0, 2, size=int(dto.sum()))
    return ev


def phase_device(torch, _build):
    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    build_s = time.perf_counter() - t0
    for name in _build.KERNELS:
        _build.load(name)
    # ptxas's register and spill lines, one per kernel instantiation
    ptxas = [ln.strip() for log in _build.build_logs.values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "ptxas": ptxas,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels_built": list(_build.KERNELS), "build_s": build_s})
    return smi


def phase_kernel_vs_plain(torch, S, E, RC):
    """The kernel against its plain version on random events."""
    b, t = RANDOM_B, RANDOM_T
    caps_set = {"default": S.Capacities(),
                "retry_deep": S.Capacities(**RETRY_CAPS)}
    cases = []
    for ci, (cname, caps) in enumerate(caps_set.items()):
        rm = RC.RowMap(caps)
        ev = random_events(S, E, caps, t, b, seed=100 + ci)
        narrowed = RC.narrow_events_teb(ev)
        check(narrowed is not None, "random events must narrow")
        rng = torch.Generator().manual_seed(ci)
        # a random (not empty) starting state exercises every row
        rows0 = torch.randint(-5, 6, (rm.rows_padded, b), generator=rng,
                              dtype=torch.int32).cuda()
        for stream in ("int32", "int16"):
            if stream == "int32":
                evd, base, wide = torch.from_numpy(ev).cuda(), None, ()
            else:
                evd = torch.from_numpy(narrowed[0]).cuda()
                base, wide = narrowed[1], narrowed[2]
            got = RC.replay_rows(evd, rows0, caps, base, wide)
            torch.cuda.synchronize()
            want = RC.replay_rows_plain(evd, rows0, caps, base, wide)
            err = int((got.long() - want.long()).abs().max())
            cases.append({"caps": cname, "stream": stream, "R_pad":
                          rm.rows_padded, "B": b, "T": t,
                          "max_abs_err": err,
                          "equal": bool(torch.equal(got, want))})
    emit({"phase": "kernel_vs_plain", "cases": cases})
    bad = [c for c in cases if not c["equal"]]
    check(not bad, f"kernel disagrees with plain: {bad}")
    return max(c["max_abs_err"] for c in cases)


def retry_uniques(W, n, depth, seed):
    rng = random.Random(seed)
    return [(f"wf-{i}", f"run-{i}", W.retry_deep_history(rng, depth=depth))
            for i in range(n)]


def tiled_pack(np, P, caps, n_hist):
    """Pack ``N_UNIQUE`` retry_deep histories and tile them to
    ``n_hist`` lanes (batch-major), as the reference bench tiles."""
    from cadence_tpu_torch.testing import workloads as W

    uniq = P.pack_histories(retry_uniques(W, N_UNIQUE, DEPTH, 42),
                            caps=caps)
    reps = -(-n_hist // N_UNIQUE)
    return P.PackedHistories(
        events=np.tile(uniq.events, (reps, 1, 1))[:n_hist],
        lengths=np.tile(uniq.lengths, reps)[:n_hist],
        side=(uniq.side * reps)[:n_hist], caps=caps, epoch_s=uniq.epoch_s,
    )


def phase_main_path(torch, np, S, P, RC, replay_packed):
    """replay_packed at full width, int32 then narrow, through the
    kernel; returns what phase 5 and the kernel record need."""
    caps = S.Capacities(**RETRY_CAPS)
    rm = RC.RowMap(caps)
    t0 = time.perf_counter()
    tiled = tiled_pack(np, P, caps, N_HISTORIES)
    teb = tiled.teb()
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    narrowed = RC.narrow_events_teb(teb)
    narrow_s = time.perf_counter() - t0
    check(narrowed is not None, "retry_deep events must narrow")
    valid = int(tiled.lengths.sum())

    finals, wall = {}, {}
    for stream in ("int32", "int16"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finals[stream] = replay_packed(tiled, device="cuda",
                                       narrow=stream == "int16")
        wall[stream] = time.perf_counter() - t0
    return dict(caps=caps, rm=rm, tiled=tiled, teb=teb,
                narrowed=narrowed, valid=valid, finals=finals, wall=wall,
                pack_s=pack_s, narrow_s=narrow_s)


def check_main_path(np, S, m, replay_packed_plain_lanes):
    """Results of phase 3: shape, tiling consistency, and the plain
    version on a slice."""
    n = m["tiled"].batch
    for stream, fin in m["finals"].items():
        check(fin.exec_info.shape == (n, S.X_N),
              f"{stream}: state shape {fin.exec_info.shape}")
        ex = fin.exec_info.reshape(-1, N_UNIQUE, S.X_N)
        check((ex == ex[:1]).all(), f"{stream}: tiled copies diverge")
        # retry_deep histories stay open: running, no close status
        check((fin.exec_info[:, S.X_STATE] == 1).all()
              and (fin.exec_info[:, S.X_CLOSE_STATUS] == 0).all(),
              f"{stream}: a retry_deep history is not running")
        check((fin.exec_info[:, S.X_NEXT_EVENT_ID]
               == m["tiled"].lengths + 1).all(),
              f"{stream}: next_event_id is not the history's length + 1")
    for f in S.STATE_ROW_FIELDS:
        check(np.array_equal(getattr(m["finals"]["int32"], f),
                             getattr(m["finals"]["int16"], f)),
              f"int16 and int32 streams differ in {f}")
    k = min(PLAIN_CHECK_LANES, n)
    plain = replay_packed_plain_lanes(k)
    for f in S.STATE_ROW_FIELDS:
        check(np.array_equal(getattr(m["finals"]["int32"], f)[:k],
                             getattr(plain, f)),
              f"kernel and plain differ in {f} on the first {k} lanes")
    return k


def time_kernel(torch, S, RC, m):
    """Kernel, plain and bound at the main path's full-width inputs."""
    caps, rm = m["caps"], m["rm"]
    n = m["tiled"].batch
    rows0 = RC.state_to_rows(
        S.state_from_numpy(S.empty_state(n, caps), "cuda"), rm)
    out = torch.empty_like(rows0)
    rec = {}
    for stream in ("int32", "int16"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if stream == "int32":
            evd = S.host_tensor(m["teb"]).cuda()
            base, wide = None, ()
        else:
            evd = torch.from_numpy(m["narrowed"][0]).cuda()
            base, wide = m["narrowed"][1], m["narrowed"][2]
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t0
        ms = cuda_ms(lambda: RC.replay_rows(evd, rows0, caps, base, wide,
                                            out=out))
        plain_ms = cuda_ms(
            lambda: RC.replay_rows_plain(evd, rows0, caps, base, wide),
            reps=1, warmup=0)
        ev_bytes = evd.numel() * evd.element_size()
        nbytes, bound_ms, bound_by = bound(ev_bytes, rm.rows_padded, n,
                                           m["valid"])
        rec[stream] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=nbytes,
                           event_bytes=ev_bytes, h2d_s=h2d_s,
                           achieved_GBps=nbytes / (ms * 1e-3) / 1e9)
        del evd
        torch.cuda.empty_cache()
    return rec


def mixed_depth(W, seed=43):
    """90% shallow (~16 events) / 10% deep (~1k) retry histories, in a
    shuffled stream."""
    rng = random.Random(seed)
    hs = [(f"wf-s{i}", f"run-s{i}", W.retry_deep_history(rng, depth=16))
          for i in range(N_SHALLOW)]
    hs += [(f"wf-d{i}", f"run-d{i}", W.retry_deep_history(rng, depth=DEPTH))
           for i in range(N_DEEP)]
    order = random.Random(seed + 1).sample(range(len(hs)), len(hs))
    return [hs[i] for i in order]


def stream_snapshots(results, n, unpack):
    snaps = [None] * n
    for idxs, packed, final in results:
        for j, i in enumerate(idxs):
            snaps[i] = unpack.state_row_to_snapshot(final, j, packed.epoch_s)
    return snaps


def phase_stream(torch, S, replay_stream, hs, **kw):
    """The dispatcher route on the card; snapshots fetched to the host.
    Unbucketed results gain their indices, as bucketed ones carry."""
    caps = S.Capacities(**RETRY_CAPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = replay_stream(hs, caps=caps, device="cuda", **kw)
    if not kw.get("bucket"):
        base, indexed = 0, []
        for packed, final in res:
            indexed.append((range(base, base + packed.batch), packed, final))
            base += packed.batch
        res = indexed
    res = [(i, p, S.state_to_numpy(f)) for i, p, f in res]
    wall = time.perf_counter() - t0
    return res, wall


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "cadence_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: the cadence_tpu_torch package is missing "
              f"beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cadence_tpu_torch.core.enums import EventType as E
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.ops import pack as P
    from cadence_tpu_torch.ops import replay_cuda as RC
    from cadence_tpu_torch.ops import schema as S
    from cadence_tpu_torch.ops import unpack
    from cadence_tpu_torch.ops.dispatch import depth_buckets, replay_stream
    from cadence_tpu_torch.ops.replay import replay_packed
    from cadence_tpu_torch.testing import workloads as W

    # 1. device and build
    smi = phase_device(torch, _build)

    # 2. kernel against plain on random events
    rand_err = phase_kernel_vs_plain(torch, S, E, RC)

    # host inputs of the main path, made before the counted window
    t0 = time.perf_counter()
    mixed = mixed_depth(W)
    gen_s = time.perf_counter() - t0

    # 3 + 4. the main path, launches counted from zero
    RC.replay_rows.launches = 0
    m = phase_main_path(torch, np, S, P, RC, replay_packed)
    stream_res, stream_wall = phase_stream(torch, S, replay_stream, mixed,
                                           bucket=True)
    hist_res, hist_wall = phase_stream(torch, S, replay_stream, mixed,
                                       batch_size=1024)
    launches = RC.replay_rows.launches

    # checks and measurements, outside the counted window
    caps = m["caps"]
    k = check_main_path(
        np, S, m,
        lambda k: replay_packed(P.PackedHistories(
            events=m["tiled"].events[:k], lengths=m["tiled"].lengths[:k],
            side=m["tiled"].side[:k], caps=caps,
            epoch_s=m["tiled"].epoch_s), device="cpu"))
    timing = time_kernel(torch, S, RC, m)
    n = m["tiled"].batch
    emit({"phase": "main_path", "config": "retry_deep", "histories": n,
          "unique_histories": N_UNIQUE, "T": caps.max_events,
          "valid_events": m["valid"], "R_pad": m["rm"].rows_padded,
          "lanes_per_block": RC.lanes_per_block(m["rm"].rows_padded),
          "pack_s": m["pack_s"], "host_narrow_s": m["narrow_s"],
          "plain_check_lanes": k,
          "replay_packed_wall_s": m["wall"],
          "e2e_histories_per_s": {s: n / w for s, w in m["wall"].items()},
          "kernel": {s: dict(r, histories_per_s=n / (r["ms"] * 1e-3))
                     for s, r in timing.items()},
          "nvidia_smi": smi})

    # 4. the bucketed stream against the plain route
    t0 = time.perf_counter()
    plain_res = replay_stream(mixed, caps=caps, bucket=True, device="cpu")
    plain_wall = time.perf_counter() - t0
    # the host's share of the stream: its packing alone
    t0 = time.perf_counter()
    for _, hs in depth_buckets(mixed):
        P.pack_lanes(hs, caps=caps, seg_align=16)
    pack_only = time.perf_counter() - t0
    want = stream_snapshots(plain_res, len(mixed), unpack)
    got = stream_snapshots(stream_res, len(mixed), unpack)
    got_hist = stream_snapshots(hist_res, len(mixed), unpack)
    mism = sum(g != w for g, w in zip(got, want))
    mism_hist = sum(g != w for g, w in zip(got_hist, want))
    emit({"phase": "stream", "route": "replay_stream(bucket=True)",
          "histories": len(mixed), "shallow": N_SHALLOW, "deep": N_DEEP,
          "batches": len(stream_res), "gen_s": gen_s,
          "wall_s": stream_wall,
          "histories_per_s": len(mixed) / stream_wall,
          "host_pack_only_s": pack_only, "plain_cpu_wall_s": plain_wall,
          "snapshot_mismatches": mism,
          "unbucketed": {"batch_size": 1024, "batches": len(hist_res),
                         "wall_s": hist_wall,
                         "snapshot_mismatches": mism_hist}})
    check(not (mism or mism_hist or None in got or None in got_hist),
          f"stream snapshots differ from plain: {mism} bucketed, "
          f"{mism_hist} unbucketed")

    # 5. kernels and device
    check(launches > 0, "the main path launched no FSM kernel")
    t32 = timing["int32"]
    kernels = [{
        "name": "replay_fsm", "route": "cuda",
        "source": "cadence_tpu_torch/ops/csrc/replay_fsm.cu",
        "replaces": "cadence_tpu/ops/replay_pallas.py:153",
        "launches": launches, "max_abs_err": rand_err,
        "ms": t32["ms"], "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
        "library_ms": None,
        "ms_int16": timing["int16"]["ms"],
        "plain_ms_int16": timing["int16"]["plain_ms"],
        "bound_ms_int16": timing["int16"]["bound_ms"],
        "shape": f"T={caps.max_events} B={n} R_pad={m['rm'].rows_padded}",
    }]
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
