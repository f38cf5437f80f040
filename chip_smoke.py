#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cadence_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout, holds each against its plain
PyTorch version, drives the replay main path at the size of the
``retry_deep`` deployment (65,536 histories of about 1,000 events) and
the depth-bucketed rebuild route, and prints one JSON line per phase:

1. device: the card (``nvidia-smi`` name and power limit), kernel build,
   and the C++ sidecar's build (``cadence_tpu_torch/native``; the run
   fails without it);
2. kernel against plain on seeded random events (every event type,
   slots from -1 to past capacity, version changes, padding), at the
   default and the retry_deep capacities, int32 and int16 streams; ragged
   batch widths (2,045 and 2,046 lanes: narrower copy requests), one-step
   and empty windows, and the fused packed route (segment ends at any
   step, permuted output columns, resets into init columns);
3. ``replay_packed`` on 65,536 tiled retry_deep histories, int32 and
   narrow, with kernel timing (CUDA events) against the memory bound,
   and the kernel's launch geometry; then the reference bench's replay
   step on the same device-resident events, ``replay_scan_teb`` and
   ``refresh_tasks_device`` (``ops/refresh.py``): the refresh's time,
   launches (torch.profiler) and bound, the step's histories/s, the
   card's refresh against the CPU's on every lane and a seeded 256
   hydrated against the host refresher; the compiled baseline
   (``native.replay_sequential`` on the first 256 histories, its state
   against the kernel's, ``baseline_cpp_per_sec`` and ``vs_baseline``
   with the host CPU's model); the sidecar's scatters at full width
   against their numpy paths, byte for byte and timed;
4. ``replay_stream(bucket=True)`` on a 90% shallow / 10% deep mix,
   every snapshot against the plain route on the CPU, its FSM launches
   (one per packed batch), its device-busy share (torch.profiler), the
   packed route's time per batch against its bound, and the refresh of
   the deepest batch's output snapshots on the card against the CPU's;
5. ``segscan_vs_plain`` (run right after phase 2, outside the counted
   windows): the segmented affine-scan kernel against its plain version
   on seeded random streams (L = 4,096, C = 24, T = 1,024 and 1,000;
   ``mul`` in {0, 1} and full-range int32);
6. ``assoc_main_path``: the parallel-in-time replay of 16,384 tiled
   retry_deep histories, ``replay_assoc`` (both impls) and
   ``replay_packed(scan_mode="assoc")`` against the FSM route field by
   field, with the scan kernel's time at the path's operands and the FSM
   kernel's time against its bound at the same lanes;
7. ``assoc_lanes``: ``replay_assoc_lanes(impl="segscan")`` and
   ``replay_stream(scan_mode="assoc")``, bucketed and unbucketed, on the
   phase-4 mix, every snapshot against the FSM route's;
8. ``rebuild``: the rebuild path, ``StateRebuilder.rebuild_many`` on the
   card with the rebuilder's default capacities (R_pad = 944): the
   reference bench's ``rebuild_warm`` cell at its chip size (256
   retry_deep histories of 1,000 events, a cold and a checkpointed warm
   pass, every rebuilt run against the host oracle ``rebuild()``), the
   p50 and p99 of one rebuild request on the card and on the host
   oracle, an ``ndc_storm`` rebuild storm (1,024 fuzzed histories, a
   seeded sample against the host oracle), and the FSM kernel's time at
   the cold pass's batch against its bound;
9. ``serving``: the serving plane, ``ResidentEngine`` on the card, every
   resident row checked against the card's cold replay of the same
   history: (a) the reference bench's ``serve_continuous`` cell at its
   chip size through the open-loop harness (decision latency p50/p99,
   sustained qps, the O(Δ) counters); (b) a 4,096-lane megabatch, one
   bulk seat and 8 ticks of one Δ a lane (each tick's wall split into
   pack, replay and commit, its FSM launches, a seeded sample against the
   CPU plain route), and the FSM kernel at one tick's pack against its
   bound and its plain version; (c) eviction through the checkpoint
   plane's ``flush`` and resumed re-admission; (d) the rebuilder's
   resident-lane consult at the exact tip and one event off, and cold
   reads of workflows without a lane;
10. ``parallel``: the process-group fabric (``cadence_tpu_torch/parallel``,
    ``cadence_tpu_torch/entry.py``): (a) the sharded step in scan mode
    and the NDC exchange through NCCL at world size 1, in this process,
    on phase 3's 65,536 lanes, bit-equal to phase 3's step; (b) a 2 x 2
    mesh of 4 gloo ranks on cuda:0: the sharded step in scan mode at
    65,536 lanes with the gather of the whole batch, the exchange, the
    pipelined replay (512 steps a stage, 2 and 4 micro-batches), the
    sharded step in assoc mode at 16,384 lanes, every result against the
    single-process FSM route; (c) ``entry(device="cuda")``'s forward
    against the CPU's, and ``dryrun_multichip(4)`` over gloo on the card.
    One card: several ranks time-slice it, so these are the code path's
    and the collectives' times, not scaling;
11. ``service``: the port's history host (``cadence_tpu_torch/runtime``,
    ``matching``, ``client``) at the size of one history host: 4 shards,
    4,096 workflows started and answered through matching (every fourth
    with an activity round trip), a 4,096-lane ``ResidentEngine`` seated
    from the store with one ``admit_many`` but for 64 workflows, 4 rounds
    of a signal and a ``HistoryService.serving_read`` on every workflow
    (every read against the port's host ``StateBuilder`` replay of the
    stored history; the 64 first reads are cold misses), then ``stop()``
    draining the engine through the checkpoint plane; host-clock p50/p99
    per verb, the seat's and each round's wall, FSM launches by route and
    one round's device-busy share (torch.profiler);
12. the refresh's line (``device_passes``: torch ops, no kernel of its
    own), the kernel list with launch counts on the main paths, then the
    device line.

Any failure exits non-zero without the final line. Needs one CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import gc
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
# phase 3, the replay + refresh step: a seeded sample of lanes hydrated
# against the host refresher; the compiled baseline replays the first
# 256 histories (bench.py's baseline=256 for retry_deep, bench.py:2383)
REFRESH_SAMPLE, REFRESH_SEED, BASELINE_N = 256, 44, 256
RANDOM_B, RANDOM_T = 2048, 1024
# phase 2: ragged widths, one-step windows and the packed route
RAGGED_BS, RAGGED_T = (2045, 2046), 256
WINDOWS = ((0, 1), (100, 101), (255, 256), (5, 5))
PACKED_L, PACKED_T, PACKED_N_INIT = 2048, 256, 64
# phase 4: the mixed_depth shape
N_SHALLOW, N_DEEP = 1800, 200
# phase 5: random affine streams for the scan kernel
SEGSCAN_L, SEGSCAN_C, SEGSCAN_TS = 4096, 24, (1024, 1000)
# phase 6: histories of the assoc main path (the segscan form's [T, L, 24]
# int32 streams at 65,536 lanes would need 25.8 GB for four of them alone)
ASSOC_HISTORIES = 16384

# phase 8, the rebuild path. bench.py's rebuild_warm cell at its chip size
# (bench.py:1063-1206, :2392): 256 retry_deep histories of depth 1,000 from
# random.Random(45), their last eighth appended after an untimed prefix
# pass writes one checkpoint per run, one warm-up and 2 timed passes
WARM_N, WARM_DEPTH, WARM_TAIL, WARM_ITERS = 256, 1000, 0.125, 2
REBUILD_LANE_LEN = 1024
# the p50 of one rebuild request: the first 200 runs of that cohort
P50_REQUESTS = 200
# the ndc_storm rebuild storm: bench.py's batch is 32,768 fuzzed histories
# (bench.py:2385-2387); cut to 1,024 to fit this run's time (4,096 and
# 1,024 drained at the same rate, PERF.md), a seeded sample of 256 held
# against the host oracle
STORM_N, STORM_DEPTH, STORM_SAMPLE, STORM_SEED = 1024, 1000, 256, 5000

# phase 9, the serving plane. (a) bench.py's serve_continuous cell at its
# chip size (bench.py:1209-1354, :2412-2413): 48 signal_history workflows
# of 60-400 events from random.Random(46), the first 40% of each one's
# batches seated, Δs of 3 batches, 64 lanes, Poisson arrivals at 300 qps
# (seed 7) through an admission TokenBucket(rps=600, burst=300)
SERVE_CAPS = dict(max_events=512, max_activities=2, max_timers=2,
                  max_children=2, max_request_cancels=2, max_signals_ext=4,
                  max_version_items=2)
SERVE_WORKFLOWS, SERVE_LANES, SERVE_QPS = 48, 64, 300.0
SERVE_SEED, SERVE_ARRIVAL_SEED = 46, 7
SERVE_MIN_EVENTS, SERVE_MAX_EVENTS = 60, 400
SERVE_PREFIX, SERVE_DELTA_BATCHES = 0.4, 3
# (b) a resident megabatch at full width: 4,096 workflows of the same
# generator from random.Random(47), one bulk seat, 8 rounds of one Δ a
# lane and one tick each; a seeded 256 also against the CPU plain route
MEGA_LANES, MEGA_ROUNDS, MEGA_SEED, SERVE_SAMPLE = 4096, 8, 47, 256
# (c) and (d): the first 256 workflows of (b); (d) cold-reads 8 more
FLUSH_LANES, SERVE_COLD_READS = 256, 8

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; int32 ALU ops/s is
# half the 67 TFLOP/s float32 rate (64 INT32 lanes per SM against 128
# FP32 lanes)
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 33.5e12
# integer operations one lane-step of the FSM costs, counted from the
# transition code: field reconstruction, preamble, version history,
# switch and the largest group's writes
FSM_OPS_PER_EVENT = 64
# integer operations one element-step of the affine scan costs: two
# multiplies and one add (the reset select is not counted)
SEGSCAN_OPS_PER_ELEMENT = 3


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


def cuda_ms_each(fn, reps: int = 21, warmup: int = 2):
    """Device milliseconds of each of ``reps`` calls of ``fn`` (one pair
    of CUDA events per call, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in ev]


def smi_clocks() -> str:
    """The card's SM and memory clocks (MHz), power draw, temperature and
    its throttle reasons, as ``nvidia-smi`` reads them now."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip() or res.stderr.strip()


def bound(event_bytes: int, rows_padded: int, lanes: int,
          valid_events: int):
    """Least time for the replay: each event byte read once and the
    state read and written once, against the FSM's integer work."""
    nbytes = event_bytes + 2 * rows_padded * lanes * 4
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = valid_events * FSM_OPS_PER_EVENT / PEAK_INT32_OPS_S * 1e3
    return nbytes, max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def packed_bound(event_bytes: int, rows_padded: int, lanes: int,
                 n_out: int, n_init: int, n_seg: int, valid_events: int):
    """Least time for the packed route: the events, the lane rows read
    and written, the output columns written and the init columns read
    once each, and the segment list, against the FSM's integer work."""
    nbytes = (event_bytes + 4 * rows_padded * (2 * lanes + n_out + n_init)
              + 4 * (lanes + 1) + 12 * n_seg)
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


def sidecar_build(native):
    """Build and load the port's C++ sidecar; fails without it (a pack
    that quietly took the numpy route would hide what phase 3 measures)."""
    compiled = not native.lib_path().exists()
    t0 = time.perf_counter()
    lib = native._load()
    build_s = time.perf_counter() - t0
    check(lib is not None,
          f"the native sidecar did not build or load: {native.load_error}")
    res = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60)
    return {"compiler": res.stdout.splitlines()[0] if res.stdout else "",
            "flags": " ".join(native.CXX_FLAGS), "compiled": compiled,
            "build_s": build_s,
            "library": str(native.lib_path().relative_to(ROOT))}


def phase_device(torch, _build, native):
    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    build_s = time.perf_counter() - t0
    sidecar = sidecar_build(native)
    for name in _build.KERNELS:
        _build.load(name)
    # ptxas's register and spill lines, one per kernel instantiation
    ptxas = [f"{name}: {ln.strip()}"
             for name, log in _build.build_logs.items()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "ptxas": ptxas,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels_built": list(_build.KERNELS), "build_s": build_s,
          "sidecar": sidecar})
    return smi


def phase_kernel_vs_plain(torch, np, S, E, RC):
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
    cases += ragged_and_window_cases(torch, S, E, RC)
    cases += packed_cases(torch, np, S, E, RC)
    emit({"phase": "kernel_vs_plain", "cases": cases})
    bad = [c for c in cases if not c["equal"]]
    check(not bad, f"kernel disagrees with plain: {bad}")
    return max(c["max_abs_err"] for c in cases)


def device_streams(torch, RC, ev):
    """The int32 and the int16 narrow stream of host events on the card:
    {name: (events, base, wide_cols)}."""
    narrowed = RC.narrow_events_teb(ev)
    check(narrowed is not None, "random events must narrow")
    return {"int32": (torch.from_numpy(ev).cuda(), None, ()),
            "int16": (torch.from_numpy(narrowed[0]).cuda(), narrowed[1],
                      narrowed[2])}


def compare(torch, got, want):
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    return err, all(torch.equal(g, w) for g, w in zip(got, want))


def ragged_and_window_cases(torch, S, E, RC):
    """The unpacked kernel at batch widths that are not a multiple of 8
    (int16 at an odd width copies 2 bytes a request, int32 4) and over
    one-step and empty windows, against plain."""
    caps = S.Capacities(**RETRY_CAPS)
    rm = RC.RowMap(caps)
    cases = []
    for bi, b in enumerate(RAGGED_BS):
        ev = random_events(S, E, caps, RAGGED_T, b, seed=300 + bi)
        rng = torch.Generator().manual_seed(300 + bi)
        rows0 = torch.randint(-5, 6, (rm.rows_padded, b), generator=rng,
                              dtype=torch.int32).cuda()
        for stream, (evd, base, wide) in device_streams(torch, RC,
                                                        ev).items():
            windows = [(0, RAGGED_T)] + (list(WINDOWS) if bi == 0 else [])
            for t0, t1 in windows:
                got = RC.replay_rows(evd, rows0, caps, base, wide, t0, t1)
                torch.cuda.synchronize()
                want = RC.replay_rows_plain(evd, rows0, caps, base, wide,
                                            t0, t1)
                err, equal = compare(torch, [got], [want])
                cases.append({"caps": "retry_deep", "stream": stream,
                              "B": b, "T": RAGGED_T, "window": [t0, t1],
                              "max_abs_err": err, "equal": equal})
    return cases


def random_segments(np, lanes, t, n_init, seed):
    """Segment ends at random steps (every lane's last at t - 1), a
    permuted output column per segment and a reset column into
    ``n_init`` init columns, the empty sentinel ``n_init`` included."""
    rng = np.random.default_rng(seed)
    seg_end = rng.random((lanes, t)) < 0.05
    seg_end[:, t - 1] = True
    n_seg = int(seg_end.sum())
    out_row = np.zeros((lanes, t), np.int32)
    out_row[seg_end] = rng.permutation(n_seg)
    reset_row = np.zeros((lanes, t), np.int32)
    reset_row[seg_end] = rng.integers(0, n_init + 1, n_seg)
    return seg_end, out_row, reset_row, n_seg


def packed_cases(torch, np, S, E, RC):
    """The fused packed route against ``replay_rows_packed_plain``."""
    caps = S.Capacities(**RETRY_CAPS)
    rm = RC.RowMap(caps)
    L, T = PACKED_L, PACKED_T
    ev = random_events(S, E, caps, T, L, seed=400)
    seg_end, out_row, reset_row, n_seg = random_segments(
        np, L, T, PACKED_N_INIT, seed=401)
    ptr, ends = RC.segment_list(seg_end, out_row, reset_row)
    ptr_d, ends_d = torch.from_numpy(ptr).cuda(), torch.from_numpy(
        ends).cuda()
    rng = torch.Generator().manual_seed(402)
    rows0 = torch.randint(-5, 6, (rm.rows_padded, L), generator=rng,
                          dtype=torch.int32).cuda()
    init_rows = torch.randint(-5, 6, (rm.rows_padded, PACKED_N_INIT + 1),
                              generator=rng, dtype=torch.int32).cuda()
    out0 = torch.randint(-5, 6, (rm.rows_padded, n_seg + 2), generator=rng,
                         dtype=torch.int32).cuda()
    cases = []
    for stream, (evd, base, wide) in device_streams(torch, RC, ev).items():
        out_rows = out0.clone()
        got = RC.replay_rows_packed(evd, rows0, caps, ptr_d, ends_d,
                                    out_rows, init_rows, base, wide)
        torch.cuda.synchronize()
        want = RC.replay_rows_packed_plain(evd, rows0, caps, ptr_d, ends_d,
                                           out0, init_rows, base, wide)
        err, equal = compare(torch, got, want)
        cases.append({"caps": "retry_deep", "stream": stream,
                      "route": "packed", "L": L, "T": T, "segments": n_seg,
                      "max_abs_err": err, "equal": equal})
    return cases


def retry_uniques(W, n, depth, seed):
    rng = random.Random(seed)
    return [(f"wf-{i}", f"run-{i}", W.retry_deep_history(rng, depth=depth))
            for i in range(n)]


def tiled_pack(np, P, caps, n_hist):
    """Pack ``N_UNIQUE`` retry_deep histories and tile them to
    ``n_hist`` lanes (batch-major), as the reference bench tiles;
    returns the uniques' pack and the tiled one."""
    from cadence_tpu_torch.testing import workloads as W

    uniq = P.pack_histories(retry_uniques(W, N_UNIQUE, DEPTH, 42),
                            caps=caps)
    reps = -(-n_hist // N_UNIQUE)
    return uniq, P.PackedHistories(
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
    uniq, tiled = tiled_pack(np, P, caps, N_HISTORIES)
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
    return dict(caps=caps, rm=rm, uniq=uniq, tiled=tiled, teb=teb,
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
                           achieved_GBps=nbytes / (ms * 1e-3) / 1e9,
                           share_of_bound=bound_ms / ms,
                           plan=RC.kernel_plan(evd, caps, base, wide))
        del evd
        torch.cuda.empty_cache()
    return rec


# -- phase 3, continued: the replay + refresh step, the compiled
# baseline and the sidecar's scatter ------------------------------------


def refresh_bound(state, refreshed):
    """Least time for the refresh: the six state tables it reads read
    once and every output written once, against its integer work (about
    20 operations a candidate of every activity slot and kind, 10 a
    timer slot, 3 a child, cancel and signal slot, 30 for the rest: a
    count from ops/refresh.py)."""
    read = sum(getattr(state, f).numel() * getattr(state, f).element_size()
               for f in ("exec_info", "activities", "timers", "children",
                         "cancels", "signals"))
    written = sum(x.numel() * x.element_size() for x in (
        getattr(refreshed, f.name) for f in dataclasses.fields(refreshed)))
    b, a = state.activities.shape[:2]
    ops = b * (20 * 5 * a + 10 * state.timers.shape[1] + 3 * (
        state.children.shape[1] + state.cancels.shape[1]
        + state.signals.shape[1]) + 30)
    t_bytes = (read + written) / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_S * 1e3
    return dict(bytes_read=read, bytes_written=written, ops=ops,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def refresh_on_card(torch, S, R, final):
    """The refresh of a device-resident ``final`` on the card: the median
    of 21 CUDA-event timings, its device launches (torch.profiler), its
    bound, and every field against the same refresh on the CPU."""
    got = R.refresh_tasks_device(final)
    torch.cuda.synchronize()
    want = R.refresh_tasks_device(final.map(lambda x: x.cpu()))
    diverged = [f for f in R.FIELDS
                if getattr(got, f).dtype != getattr(want, f).dtype
                or not torch.equal(getattr(got, f).cpu(), getattr(want, f))]
    each = sorted(cuda_ms_each(lambda: R.refresh_tasks_device(final)))
    prof = device_busy(torch, lambda: R.refresh_tasks_device(final))
    rec = dict(lanes=final.exec_info.shape[0], ms=each[len(each) // 2],
               ms_min=each[0], ms_max=each[-1],
               launches=prof["device_activities"],
               launch_names=prof["top_ms"], fields_diverged=diverged,
               dtypes={f: str(getattr(got, f).dtype).replace("torch.", "")
                       for f in R.FIELDS},
               **refresh_bound(final, got))
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    return got, rec


def phase_refresh_step(torch, np, S, RC, R, unpack, m):
    """bench.py's unpacked replay step at full width, device-resident:
    ``replay_scan_teb`` then ``refresh_tasks_device``. The card's refresh
    against the CPU's on every lane; a seeded sample hydrated against
    the host refresher on the rehydrated rows."""
    from cadence_tpu_torch.core.task_refresher import refresh_tasks

    caps, tiled = m["caps"], m["tiled"]
    n = tiled.batch
    evd = S.host_tensor(m["teb"]).cuda()
    state0 = S.state_from_numpy(S.empty_state(n, caps), "cuda")
    final = RC.replay_scan_teb(state0, evd, caps)
    torch.cuda.synchronize()
    host = S.state_to_numpy(final)
    check(all(np.array_equal(getattr(host, f),
                             getattr(m["finals"]["int32"], f))
              for f in S.STATE_ROW_FIELDS),
          "replay_scan_teb differs from replay_packed's final")
    refreshed, rec = refresh_on_card(torch, S, R, final)
    check(not rec["fields_diverged"],
          f"card refresh differs from the CPU's: {rec['fields_diverged']}")

    def step():
        return R.refresh_tasks_device(RC.replay_scan_teb(state0, evd, caps))
    step_each = sorted(cuda_ms_each(step, reps=11))
    step_ms = step_each[len(step_each) // 2]

    t0 = time.perf_counter()
    tasks = R.refreshed_to_numpy(refreshed)
    d2h_s = time.perf_counter() - t0
    sample = sorted(random.Random(REFRESH_SEED).sample(
        range(n), min(REFRESH_SAMPLE, n)))
    mism, n_tasks = 0, 0
    for b in sample:
        got = R.hydrate_tasks(tasks, b, tiled, domain_id="dom")
        ms = unpack.state_row_to_mutable_state(
            host, b, tiled.side[b], domain_id="dom", epoch_s=tiled.epoch_s)
        want = refresh_tasks(ms)
        n_tasks += len(got[0]) + len(got[1])
        mism += [task_rows(x) for x in got] != [task_rows(x) for x in want]
    del evd, state0, final
    torch.cuda.empty_cache()
    rec.update(step_ms=step_ms, step_ms_min=step_each[0],
               step_ms_max=step_each[-1],
               histories_per_sec=n / (step_ms * 1e-3),
               refreshed_to_numpy_s=d2h_s, hydrate_sample=len(sample),
               hydrate_tasks=n_tasks, hydrate_mismatches=mism)
    check(mism == 0, f"{mism} hydrated lanes differ from the host refresher")
    return rec


def cpu_model() -> dict:
    """The host CPU as ``lscpu`` and ``/proc/cpuinfo`` name it, and the
    cores this process may use."""
    import os

    res = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60)
    keys = ("Model name", "Vendor ID", "CPU(s)", "Thread(s) per core",
            "CPU max MHz")
    lscpu = {k: v.strip() for k, _, v in (
        ln.partition(":") for ln in res.stdout.splitlines())
        if k.strip() in keys}
    try:
        info = Path("/proc/cpuinfo").read_text()
        model = next((ln.split(":", 1)[1].strip()
                      for ln in info.splitlines()
                      if ln.startswith("model name")), "")
    except OSError:
        model = ""
    return {"lscpu": lscpu, "cpuinfo_model": model,
            "cores_usable": len(os.sched_getaffinity(0))}


def phase_baseline(np, S, P, native, m, step_rate):
    """The compiled sequential replayer on the first ``BASELINE_N``
    histories for at least 0.5 s (bench.py:412-438), its state against
    the kernel's rows for those lanes."""
    tiled = m["tiled"]
    nb = min(BASELINE_N, tiled.batch)
    sub = P.PackedHistories(events=tiled.events[:nb],
                            lengths=tiled.lengths[:nb],
                            side=tiled.side[:nb], caps=m["caps"],
                            epoch_s=tiled.epoch_s)
    state = native.replay_sequential(sub)
    want = m["finals"]["int32"]
    diverged = [f for f in S.STATE_ROW_FIELDS
                if not np.array_equal(getattr(state, f),
                                      getattr(want, f)[:nb])]
    check(not diverged, f"replay_sequential differs from the kernel on "
          f"the first {nb} lanes: {diverged}")
    t0 = time.perf_counter()
    reps = 0
    while time.perf_counter() - t0 < 0.5:
        native.replay_sequential(sub)
        reps += 1
    cpp_s = (time.perf_counter() - t0) / reps
    cpp_rate = nb / cpp_s
    return dict(histories=nb, reps=reps, s_per_rep=cpp_s,
                baseline_cpp_per_sec=cpp_rate,
                vs_baseline=step_rate / cpp_rate,
                host_cpu=cpu_model(), fields_diverged=diverged)


def phase_scatter(np, P, native, m):
    """The sidecar's scatters at full width from the tiled pack's rows
    (the uniques' ``rows_concat`` tiled as their events are), against
    their numpy paths, byte for byte: ``teb()`` and the batch-major
    ``events``."""
    tiled, uniq = m["tiled"], m["uniq"]
    reps = tiled.batch // uniq.batch
    check(reps * uniq.batch == tiled.batch,
          "the tiled pack is not whole copies of the uniques")
    t0 = time.perf_counter()
    rows = np.tile(uniq.rows_concat, (reps, 1))
    tile_s = time.perf_counter() - t0
    T = m["caps"].max_events
    rec = dict(histories=tiled.batch, rows=int(rows.shape[0]),
               rows_bytes=rows.nbytes, tile_rows_s=tile_s,
               library=native.HAVE_NATIVE)
    check(native.HAVE_NATIVE, "the sidecar is not loaded")
    with_rows = P.PackedHistories(
        events=tiled.events, lengths=tiled.lengths, side=tiled.side,
        caps=m["caps"], epoch_s=tiled.epoch_s, rows_concat=rows)
    t0 = time.perf_counter()
    got = with_rows.teb()
    rec["teb_native_s"] = time.perf_counter() - t0
    rec["teb_equal_main_path"] = got.tobytes() == m["teb"].tobytes()
    del with_rows
    t0 = time.perf_counter()
    want = native.scatter_teb(rows, tiled.lengths, T, force_python=True)
    rec["teb_numpy_s"] = time.perf_counter() - t0
    rec["teb_equal"] = got.tobytes() == want.tobytes()
    del got, want
    for label, fp in (("native", False), ("numpy", True)):
        t0 = time.perf_counter()
        ev = native.scatter_batch_major(rows, tiled.lengths, T,
                                        force_python=fp)
        rec[f"batch_major_{label}_s"] = time.perf_counter() - t0
        rec[f"batch_major_{label}_equal"] = (
            ev.tobytes() == tiled.events.tobytes())
        del ev
    rec["bytes_out"] = int(tiled.events.nbytes)
    check(rec["teb_equal"] and rec["teb_equal_main_path"]
          and rec["batch_major_native_equal"]
          and rec["batch_major_numpy_equal"],
          f"sidecar scatter differs from the numpy path: {rec}")
    return rec


def stream_refresh(torch, np, S, RC, R, caps, results):
    """bench.py's packed replay step (bench.py:348-356) at the stream's
    deepest batch: ``replay_scan_packed`` then ``refresh_tasks_device`` on
    its output snapshots, against the CPU and the stream's own rows."""
    _, packed, want = max(results,
                          key=lambda r: r[1].scan_len * r[1].lanes)
    evd = S.host_tensor(packed.teb()).cuda()
    state0 = S.state_from_numpy(packed.lane_state0(), "cuda")
    out0 = S.state_from_numpy(S.empty_state(packed.n_histories, caps),
                              "cuda")

    def replay():
        return RC.replay_scan_packed(state0, out0, evd, packed.seg_end,
                                     packed.out_row, caps)[1]
    out = replay()
    host = S.state_to_numpy(out)
    check(all(np.array_equal(getattr(host, f), getattr(want, f))
              for f in S.STATE_ROW_FIELDS),
          "the packed step's snapshots differ from the stream's")
    _, rec = refresh_on_card(torch, S, R, out)
    check(not rec["fields_diverged"], "card refresh differs from the "
          f"CPU's at the stream batch: {rec['fields_diverged']}")
    each = sorted(cuda_ms_each(lambda: R.refresh_tasks_device(replay()),
                               reps=11))
    rec.update(T=packed.scan_len, packed_lanes=packed.lanes,
               step_ms=each[len(each) // 2], step_ms_min=each[0],
               step_ms_max=each[-1],
               histories_per_sec=packed.n_histories / (
                   each[len(each) // 2] * 1e-3))
    del evd, state0, out0, out
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
    Unbucketed results gain their indices, as bucketed ones carry (an
    assoc batch's pack is padded to the grid; its final holds the
    histories' rows only)."""
    caps = S.Capacities(**RETRY_CAPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = replay_stream(hs, caps=caps, device="cuda", **kw)
    if not kw.get("bucket"):
        base, indexed = 0, []
        for packed, final in res:
            rows = final.exec_info.shape[0]
            indexed.append((range(base, base + rows), packed, final))
            base += rows
        res = indexed
    res = [(i, p, S.state_to_numpy(f)) for i, p, f in res]
    wall = time.perf_counter() - t0
    return res, wall


def segscan_bound(T: int, L: int, C: int, rst_bytes: int):
    """Least time of the affine scan: mul and add read, pm and pa written
    once each, rst read once, against its integer work."""
    nbytes = 4 * T * L * C * 4 + rst_bytes
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = T * L * C * SEGSCAN_OPS_PER_ELEMENT / PEAK_INT32_OPS_S * 1e3
    return nbytes, max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def phase_segscan_vs_plain(torch, np, AC):
    """The scan kernel against its plain version on random streams."""
    L, C = SEGSCAN_L, SEGSCAN_C
    cases = []
    for ti, T in enumerate(SEGSCAN_TS):
        for vi, values in enumerate(("mul01", "full_range")):
            rng = np.random.default_rng(200 + 2 * ti + vi)
            if values == "mul01":
                mul = rng.integers(0, 2, (T, L, C), dtype=np.int32)
                add = rng.integers(-1000, 1000, (T, L, C), dtype=np.int32)
            else:
                mul = rng.integers(-2**31, 2**31 - 1, (T, L, C),
                                   dtype=np.int32, endpoint=True)
                add = rng.integers(-2**31, 2**31 - 1, (T, L, C),
                                   dtype=np.int32, endpoint=True)
            rst = rng.random((T, L)) < 0.05
            rst[0] = True
            mul_d, add_d = torch.from_numpy(mul).cuda(), torch.from_numpy(
                add).cuda()
            rst_d = torch.from_numpy(rst.astype(np.int32)).cuda()
            got = AC.affine_segscan(mul_d, add_d, rst_d)
            torch.cuda.synchronize()
            want = AC.affine_segscan_plain(mul_d, add_d, rst_d)
            err = max(int((g.long() - w.long()).abs().max())
                      for g, w in zip(got, want))
            cases.append({"T": T, "L": L, "C": C, "values": values,
                          "resets": int(rst.sum()), "max_abs_err": err,
                          "equal": all(torch.equal(g, w)
                                       for g, w in zip(got, want))})
            del mul_d, add_d, rst_d, got, want
    torch.cuda.empty_cache()
    emit({"phase": "segscan_vs_plain", "cases": cases})
    bad = [c for c in cases if not c["equal"]]
    check(not bad, f"scan kernel disagrees with plain: {bad}")
    return max(c["max_abs_err"] for c in cases)


def timed_call(torch, fn):
    """(result, host wall s, peak device bytes) of one call that ends in
    a synchronize."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def device_busy(torch, fn):
    """One call of ``fn`` under torch.profiler: the count of device
    activities (kernels, copies), their summed device ms, the five
    names that took the most of it, and the profiled call's wall s.
    They run on one stream, so their sum over a wall is the device's
    busy share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name[:80]] = (by_name.get(e.name[:80], 0.0)
                                + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    # activities on several streams overlap: the busy time is the union
    busy_us, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return dict(device_activities=len(dev),
                device_ms=sum(e.time_range.elapsed_us() for e in dev) / 1e3,
                device_busy_ms=busy_us / 1e3,
                busy_share=busy_us / 1e6 / wall if wall > 0 else None,
                top_ms=dict(top), profiled_wall_s=wall)


def profile_routes(torch, S, A, RC, tiled):
    """Device busy time of one warm call of each replay route at the
    assoc path's lanes, from device-resident inputs."""
    caps = tiled.caps
    evf = S.host_tensor(tiled.events).cuda().permute(2, 0, 1).contiguous()
    teb = S.host_tensor(tiled.teb()).cuda()
    state0 = S.empty_state(tiled.batch, caps)
    state0_d = S.state_from_numpy(state0, "cuda")
    routes = {f"replay_assoc[{impl}]": (lambda impl=impl: A.replay_assoc(
        state0, events_fm=evf, impl=impl, device="cuda"))
        for impl in ("segscan", "resolve")}
    routes["replay_scan_teb"] = lambda: RC.replay_scan_teb(state0_d, teb,
                                                           caps)
    out = {}
    for name, fn in routes.items():
        fn()                                       # warm
        out[name] = device_busy(torch, fn)
    del evf, teb
    torch.cuda.empty_cache()
    return out


def phase_assoc_main_path(torch, S, A, tiled):
    """The parallel-in-time replay on the card, from device-resident
    field-major events, each impl called twice (the first call loads
    the torch kernels it uses); returns {impl: (final, [wall s, wall s],
    peak bytes)}. The caller counts launches around it."""
    evf = S.host_tensor(tiled.events).cuda().permute(2, 0, 1).contiguous()
    state0 = S.empty_state(tiled.batch, tiled.caps)
    out = {}
    for impl in ("segscan", "resolve"):
        runs = [timed_call(torch, lambda: A.replay_assoc(
            state0, events_fm=evf, impl=impl, device="cuda"))
            for _ in range(2)]
        out[impl] = (runs[-1][0], [r[1] for r in runs],
                     max(r[2] for r in runs))
    del evf
    return out


def time_segscan(torch, S, A, AC, tiled):
    """The scan kernel, its plain version and its bound at the exact
    [T, L, C] operands the segscan route gives it; the kernel's ms is the
    median of 21 launches, beside their least and most."""
    evf = S.host_tensor(tiled.events).cuda().permute(2, 0, 1).contiguous()
    cx = A._make_ctx(evf, S.state_from_numpy(
        S.empty_state(tiled.batch, tiled.caps), "cuda"))
    mul, add, _, _, rst = A._emit_affine_exec(cx)
    rst_t = rst.T.contiguous()                   # bool, as the path passes
    del cx, evf
    T, L, C = mul.shape
    got = AC.affine_segscan(mul, add, rst_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = AC.affine_segscan_plain(mul, add, rst_t)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    del got, want
    torch.cuda.empty_cache()
    # each launch timed alone, with the clocks read before and after, so
    # the spread between launches and its cause show in the record
    clocks_before = smi_clocks()
    each = sorted(cuda_ms_each(lambda: AC.affine_segscan(mul, add, rst_t)))
    clocks_after = smi_clocks()
    ms = each[len(each) // 2]
    nbytes, bound_ms, bound_by = segscan_bound(
        T, L, C, rst_t.numel() * rst_t.element_size())
    del mul, add, rst_t
    torch.cuda.empty_cache()
    return dict(shape=f"T={T} L={L} C={C}", ms=ms, ms_min=each[0],
                ms_max=each[-1], launches_timed=len(each),
                clocks_before=clocks_before, clocks_after=clocks_after,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                achieved_GBps=nbytes / (ms * 1e-3) / 1e9,
                share_of_bound=bound_ms / ms, max_abs_err=err, equal=equal)


def time_fsm_at(torch, S, RC, tiled):
    """The FSM route at the assoc path's lanes: device-resident
    ``replay_scan_teb`` wall, and the kernel's CUDA-event time against
    its bound on the int32 and the int16 stream."""
    caps = tiled.caps
    rm = RC.RowMap(caps)
    host = tiled.teb()
    teb = S.host_tensor(host).cuda()
    state0 = S.state_from_numpy(S.empty_state(tiled.batch, caps), "cuda")
    _, wall, peak = timed_call(
        torch, lambda: RC.replay_scan_teb(state0, teb, caps))
    rows0 = RC.state_to_rows(state0, rm)
    out = torch.empty_like(rows0)
    narrowed = RC.narrow_events_teb(host)
    check(narrowed is not None, "retry_deep events must narrow")
    rec = dict(replay_scan_teb_wall_s=wall, peak_bytes=peak)
    for stream in ("int32", "int16"):
        if stream == "int32":
            evd, base, wide = teb, None, ()
        else:
            evd = torch.from_numpy(narrowed[0]).cuda()
            base, wide = narrowed[1], narrowed[2]
        ms = cuda_ms(lambda: RC.replay_rows(evd, rows0, caps, base, wide,
                                            out=out))
        nbytes, bound_ms, bound_by = bound(
            evd.numel() * evd.element_size(), rm.rows_padded, tiled.batch,
            int(tiled.lengths.sum()))
        rec[stream] = dict(kernel_ms=ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=nbytes,
                           share_of_bound=bound_ms / ms,
                           plan=RC.kernel_plan(evd, caps, base, wide))
        del evd
    del teb
    torch.cuda.empty_cache()
    return rec


def time_packed(torch, np, S, RC, caps, results):
    """The packed route, one launch per batch, at each batch the bucketed
    stream packed: kernel (CUDA-event mean) and plain ms against the
    bound, int32 and int16."""
    rm = RC.RowMap(caps)
    out = []
    for _, packed, _ in results:
        ptr, ends = RC.segment_list(packed.seg_end, packed.out_row)
        ptr_d, ends_d = (torch.from_numpy(ptr).cuda(),
                         torch.from_numpy(ends).cuda())
        rows0 = RC.state_to_rows(
            S.state_from_numpy(packed.lane_state0(), "cuda"), rm)
        n_out = packed.n_histories
        out_rows = RC.state_to_rows(
            S.state_from_numpy(S.empty_state(n_out, caps), "cuda"), rm)
        init_rows = RC.state_to_rows(
            S.state_from_numpy(S.empty_state(1, caps), "cuda"), rm)
        rows_out = torch.empty_like(rows0)
        valid = int((packed.events[:, :, S.EV_TYPE] >= 0).sum())
        rec = dict(lanes=packed.lanes, T=packed.scan_len,
                   histories=n_out, segments=len(ends))
        for stream, (evd, base, wide) in device_streams(
                torch, RC, packed.teb()).items():
            def call():
                return RC.replay_rows_packed(
                    evd, rows0, caps, ptr_d, ends_d, out_rows, init_rows,
                    base, wide, out=rows_out)
            ms = cuda_ms(call)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            RC.replay_rows_packed_plain(evd, rows0, caps, ptr_d, ends_d,
                                        out_rows, init_rows, base, wide)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            nbytes, bound_ms, bound_by = packed_bound(
                evd.numel() * evd.element_size(), rm.rows_padded,
                packed.lanes, n_out, 1, len(ends), valid)
            rec[stream] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, bytes=nbytes,
                               share_of_bound=bound_ms / ms,
                               plan=RC.kernel_plan(evd, caps, base, wide))
        out.append(rec)
    torch.cuda.empty_cache()
    return out


# -- phase 8: the rebuild path ------------------------------------------


def task_rows(tasks):
    """Tasks field by field, the task type as an int."""
    return [{k: int(v) if k == "task_type" else v
             for k, v in dataclasses.asdict(t).items()} for t in tasks]


def rebuild_key(unpack, result):
    """A rebuilt run as data: its canonical snapshot, its transfer and
    timer tasks field by field, and its branch token."""
    ms, transfer, timer = result
    return (unpack.mutable_state_to_snapshot(ms), task_rows(transfer),
            task_rows(timer), ms.execution_info.branch_token)


def store_run(hist, i, batches):
    """Append run ``i``'s history to a branch of its own; returns its
    request (workflow ``wf-i``, run ``run-i``, as the reference bench
    names them)."""
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        RebuildRequest)

    branch = hist.new_history_branch(tree_id=f"run-{i}")
    for txn, b in enumerate(batches, 1):
        hist.append_history_nodes(branch, b, transaction_id=txn)
    return RebuildRequest(
        domain_id="dom", workflow_id=f"wf-{i}", run_id=f"run-{i}",
        branch_token=branch.to_json().encode())


def warm_cohort():
    """bench.py's rebuild_warm cohort: retry_deep histories cut where
    the last ``WARM_TAIL`` of their events starts (at least the start
    batch kept); the prefixes go to a memory history store, the tails
    wait to be appended after the prefix pass."""
    from cadence_tpu_torch.runtime.persistence.memory import (
        MemoryHistoryManager)
    from cadence_tpu_torch.testing import workloads as W

    rng = random.Random(45)
    full, cuts = [], []
    total = suffix = 0
    for _ in range(WARM_N):
        batches = W.retry_deep_history(rng, depth=WARM_DEPTH)
        n_events = sum(len(b) for b in batches)
        cut, seen = len(batches), 0
        for k, b in enumerate(batches):
            if seen + len(b) > int(n_events * (1.0 - WARM_TAIL)):
                cut = max(k, 1)
                break
            seen += len(b)
        full.append(batches)
        cuts.append(cut)
        total += n_events
        suffix += sum(len(b) for b in batches[cut:])
    hist = MemoryHistoryManager()
    reqs = [store_run(hist, i, b[:c])
            for i, (b, c) in enumerate(zip(full, cuts))]
    return dict(hist=hist, reqs=reqs, full=full, cuts=cuts,
                total_events=total, suffix_events=suffix)


def append_tails(c):
    from cadence_tpu_torch.runtime.persistence.records import BranchToken

    for req, batches, cut in zip(c["reqs"], c["full"], c["cuts"]):
        branch = BranchToken.from_json(req.branch_token.decode())
        for txn, b in enumerate(batches[cut:], cut + 1):
            c["hist"].append_history_nodes(branch, b, transaction_id=txn)


def storm_cohort():
    """``STORM_N`` ndc_storm histories, the fuzzer seeded per history,
    each stored as it is made."""
    from cadence_tpu_torch.runtime.persistence.memory import (
        MemoryHistoryManager)
    from cadence_tpu_torch.testing import workloads as W
    from cadence_tpu_torch.testing.event_generator import HistoryFuzzer

    hist = MemoryHistoryManager()
    reqs, events = [], 0
    for i in range(STORM_N):
        batches = W.ndc_storm_history(HistoryFuzzer(seed=STORM_SEED + i),
                                      depth=STORM_DEPTH)
        events += sum(len(b) for b in batches)
        reqs.append(store_run(hist, i, batches))
    return dict(hist=hist, reqs=reqs, events=events)


def timed_passes(rb, reqs, iters):
    """bench.py's discipline: one warm-up pass, then ``iters`` timed
    passes; returns (mean s a pass, the last pass's results)."""
    rb.rebuild_many(reqs)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = rb.rebuild_many(reqs)
    return (time.perf_counter() - t0) / iters, out


def wall_split(scope, passes):
    """The rebuilder's own timers, per pass: history read (checkpoint
    consult included), pack + device (the wait for the dispatcher), and
    rehydrate + refresh (checkpoint writes included)."""
    reg = scope.registry
    return {name: reg.timer_stats(timer).total_s / passes
            for name, timer in (("history_read_s", "history_read"),
                                ("pack_device_s", "dispatch_wait"),
                                ("rehydrate_refresh_s", "rehydrate"))}


def fsm_profiled(torch, fn):
    """(result, wall s, device ms of each FSM kernel launch) of one call
    of ``fn`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
          if e.device_type == DeviceType.CUDA and "replay_fsm" in e.name]
    return res, wall, ms


def percentiles(np, ms):
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "n": len(ms)}


def phase_rebuild(torch, np, unpack, RC):
    """Drive the rebuild path on the card; returns the phase record
    (its checks applied) and the FSM launches it made. The caller
    times the kernel at the path's batch afterwards."""
    from cadence_tpu_torch.checkpoint import (
        CheckpointManager, CheckpointPolicy, MemoryCheckpointStore)
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        StateRebuilder)
    from cadence_tpu_torch.utils.metrics import Scope

    t0 = time.perf_counter()
    c = warm_cohort()
    warm_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    storm = storm_cohort()
    storm_setup_s = time.perf_counter() - t0
    hist, reqs = c["hist"], c["reqs"]
    store = MemoryCheckpointStore()

    # the main path, launches counted from zero
    RC.replay_rows.launches = 0
    t0 = time.perf_counter()
    StateRebuilder(hist, lane_len=REBUILD_LANE_LEN,
                   checkpoints=CheckpointManager(
                       store, CheckpointPolicy(every_events=1, keep_last=1))
                   ).rebuild_many(reqs)
    prefix_pass_s = time.perf_counter() - t0
    checkpoints_written = store.count_checkpoints()
    append_tails(c)
    cold_scope, warm_scope = Scope(), Scope()
    cold_s, cold_out = timed_passes(
        StateRebuilder(hist, lane_len=REBUILD_LANE_LEN, metrics=cold_scope),
        reqs, WARM_ITERS)
    # a huge every_events keeps the warm pass read-only on the store
    warm_s, warm_out = timed_passes(
        StateRebuilder(hist, lane_len=REBUILD_LANE_LEN, metrics=warm_scope,
                       checkpoints=CheckpointManager(
                           store, CheckpointPolicy(every_events=1 << 30,
                                                   keep_last=1))),
        reqs, WARM_ITERS)
    one_scope = Scope()
    one = StateRebuilder(hist, lane_len=REBUILD_LANE_LEN, metrics=one_scope)
    one_ms, one_out = [], []
    for r in reqs[:P50_REQUESTS]:
        t0 = time.perf_counter()
        one_out += one.rebuild_many([r])
        one_ms.append((time.perf_counter() - t0) * 1e3)
    storm_scope = Scope()
    storm_out, storm_wall, storm_fsm_ms = fsm_profiled(
        torch, lambda: StateRebuilder(
            storm["hist"], lane_len=REBUILD_LANE_LEN,
            metrics=storm_scope).rebuild_many(storm["reqs"]))
    launches = RC.replay_rows.launches

    # the host oracle, outside the counted window
    oracle, host_ms = [], []
    for r in reqs:
        t0 = time.perf_counter()
        oracle.append(rebuild_key(unpack, one.rebuild(r)))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    sample = random.Random(STORM_SEED).sample(range(STORM_N), STORM_SAMPLE)
    storm_rb = StateRebuilder(storm["hist"])
    storm_mism = sum(
        rebuild_key(unpack, storm_out[i])
        != rebuild_key(unpack, storm_rb.rebuild(storm["reqs"][i]))
        for i in sample)
    mism = {name: sum(rebuild_key(unpack, g) != w
                      for g, w in zip(out, oracle))
            for name, out in (("cold", cold_out), ("warm", warm_out),
                              ("one_request", one_out))}
    mism["storm_sample"] = storm_mism

    passes = WARM_ITERS + 1
    reg = warm_scope.registry
    hits = reg.counter_value("checkpoint_hit")
    lookups = hits + reg.counter_value("checkpoint_miss") + \
        reg.counter_value("checkpoint_invalidated")
    saved = reg.counter_value("events_replayed_saved") // passes
    suffix_frac = 1.0 - saved / c["total_events"]
    configured = c["suffix_events"] / c["total_events"]
    fallbacks = {name: s.registry.counter_value("host_fallbacks")
                 for name, s in (("cold", cold_scope), ("warm", warm_scope),
                                 ("storm", storm_scope))}
    rec = {
        "phase": "rebuild",
        "rebuild_warm": {
            "histories": WARM_N, "depth": WARM_DEPTH, "tail_frac": WARM_TAIL,
            "iters": WARM_ITERS, "lane_len": REBUILD_LANE_LEN,
            "mean_depth": c["total_events"] / WARM_N,
            "setup_s": warm_setup_s, "prefix_pass_s": prefix_pass_s,
            "checkpoints_written": checkpoints_written,
            "cold_histories_per_s": WARM_N / cold_s,
            "warm_histories_per_s": WARM_N / warm_s,
            "vs_cold": cold_s / warm_s,
            "cold_batch_s": cold_s, "warm_batch_s": warm_s,
            "checkpoint_hit_rate": hits / max(lookups, 1),
            "suffix_frac": suffix_frac,
            "suffix_frac_configured": configured,
            "events_replayed_saved": saved,
            "host_fallbacks": fallbacks["cold"] + fallbacks["warm"],
            "wall_split_cold": wall_split(cold_scope, passes),
            "wall_split_warm": wall_split(warm_scope, passes),
        },
        "rebuild_one_request": {
            "card": percentiles(np, one_ms),
            "card_wall_split": wall_split(one_scope, P50_REQUESTS),
            "host_oracle": percentiles(np, host_ms[:P50_REQUESTS]),
            "host_oracle_all_256": percentiles(np, host_ms),
        },
        "ndc_storm": {
            "histories": STORM_N, "cut_from": 32768, "depth": STORM_DEPTH,
            "events": storm["events"], "setup_s": storm_setup_s,
            "wall_s": storm_wall, "histories_per_s": STORM_N / storm_wall,
            "host_fallbacks": fallbacks["storm"],
            "host_fallback_s": storm_scope.registry.timer_stats(
                "host_fallback").total_s,
            "fsm_launches": len(storm_fsm_ms),
            "fsm_ms_per_batch": storm_fsm_ms,
            "wall_split": wall_split(storm_scope, 1),
            "sample": STORM_SAMPLE, "profiled": True,
        },
        "fsm_launches": launches,
        "mismatches": mism,
    }
    emit(rec)
    check(not any(mism.values()), f"rebuilt runs differ from the host "
          f"oracle: {mism}")
    check(checkpoints_written == WARM_N,
          f"the prefix pass wrote {checkpoints_written} checkpoints")
    check(fallbacks["cold"] == fallbacks["warm"] == 0,
          f"rebuild_warm took the host route: {fallbacks}")
    check(hits == lookups == WARM_N * passes,
          f"warm checkpoint hits {hits} of {lookups} lookups")
    check(abs(suffix_frac - configured) <= 0.02,
          f"measured suffix_frac {suffix_frac} against {configured}")
    check(launches > 0, "the rebuild path launched no FSM kernel")
    return rec, launches, c


def time_rebuild_kernel(torch, np, S, P, RC, c):
    """The FSM kernel at the cold pass's batch: the cohort's histories
    packed as the dispatcher packs them, at the rebuilder's default
    capacities. There R_pad is 944 (152 at the retry_deep caps): a block
    holds 32 lanes, one warp an SM, and 256 histories fill 8 of the
    card's 132 SMs, so the launch is latency-bound."""
    from cadence_tpu_torch.ops.dispatch import depth_buckets

    caps = S.Capacities()
    hs = [(f"wf-{i}", f"run-{i}", b) for i, b in enumerate(c["full"])]
    packs = [(None, P.pack_lanes(bhs, caps=caps,
                                 target_lane_len=REBUILD_LANE_LEN,
                                 seg_align=16), None)
             for _, bhs in depth_buckets(hs)]
    rec = time_packed(torch, np, S, RC, caps, packs)
    for r in rec:
        r["R_pad"] = RC.RowMap(caps).rows_padded
        r["lanes_per_block"] = RC.lanes_per_block(r["R_pad"], r["lanes"])
    return rec


# -- phase 9: the serving plane -------------------------------------------


class ServeRoutes:
    """FSM launches of the serving engine, by route: each wrapped engine
    step adds the launches made while it ran to its route (seat, tick's
    compose, cold read) and keeps each call's count; ``capture`` also
    keeps the packs the tick's replays took."""

    ROUTES = {"_seat": "serving_seat", "_compose": "serving_tick",
              "_cold_read": "serving_cold_read"}

    def __init__(self, RC):
        self.RC = RC
        self.counts = {r: 0 for r in self.ROUTES.values()}
        self.calls = {r: [] for r in self.ROUTES.values()}
        self.packs = []

    def wrap(self, engine, capture=False):
        for attr, route in self.ROUTES.items():
            setattr(engine, attr, self._counted(getattr(engine, attr), route))
        if capture:
            replay = engine._replay

            def keep(packed, scan_mode):
                self.packs.append((scan_mode, packed))
                return replay(packed, scan_mode=scan_mode)
            engine._replay = keep
        return engine

    def _counted(self, fn, route):
        def call(*a, **k):
            start = self.RC.replay_rows.launches
            try:
                return fn(*a, **k)
            finally:
                n = self.RC.replay_rows.launches - start
                self.counts[route] += n
                self.calls[route].append(n)
        return call


def serve_cohort(W, n, seed, tag):
    """bench.py's serve_continuous cohort: ``n`` open signal-dominated
    histories from ``random.Random(seed)``, the first ``SERVE_PREFIX``
    of each history's batches seated, the rest cut into Δs of
    ``SERVE_DELTA_BATCHES`` batches. Returns (workloads, events a cold
    per-arrival rebuild would replay, events appended)."""
    from cadence_tpu_torch.serving import ServeWorkload

    rng = random.Random(seed)
    loads, cold_events, appended = [], 0, 0
    for i in range(n):
        batches = W.signal_history(rng, min_events=SERVE_MIN_EVENTS,
                                   max_events=SERVE_MAX_EVENTS)
        cut = max(1, int(len(batches) * SERVE_PREFIX))
        deltas = [batches[k : k + SERVE_DELTA_BATCHES]
                  for k in range(cut, len(batches), SERVE_DELTA_BATCHES)]
        seen = sum(len(b) for b in batches[:cut])
        for d in deltas:
            dn = sum(len(b) for b in d)
            seen += dn
            appended += dn
            cold_events += seen  # a cold read replays the whole prefix
        loads.append(ServeWorkload(
            domain_id="bench", workflow_id=f"serve-{tag}-wf-{i}",
            run_id=f"serve-{tag}-run-{i}", branch_token=b"",
            prefix=batches[:cut], deltas=deltas))
    return loads, cold_events, appended


def through(w, k):
    """A workload's history through its first ``k`` Δs."""
    return list(w.prefix) + [b for d in w.deltas[:k] for b in d]


def cold_rows(S, P, replay_packed, caps, hists, device):
    """Cold replays of full histories: [(row, epoch_s)], one history a
    lane through ``replay_packed`` (the FSM route on the card)."""
    pk = P.pack_histories(hists, caps=caps)
    final = replay_packed(pk, device=device)
    return [(S.state_row(final, i), pk.epoch_s) for i in range(len(hists))]


def row_equal(np, S, row, epoch, cold):
    """A resident row (at its lane's epoch) against a cold (row, epoch):
    rows hold epoch-relative timestamps, so the resident row moves to
    the cold replay's epoch first."""
    want, want_epoch = cold
    got = S.rebase_state_row(row, epoch - want_epoch)
    return all(np.array_equal(got[f], want[f]) for f in S.STATE_ROW_FIELDS)


def serve_counters(reg, *names):
    return {n: reg.counter_value(n) for n in names}


def phase_serve_continuous(torch, np, S, P, W, replay_packed, routes):
    """(a) bench.py's serve_continuous at its chip size through the
    open-loop harness, after an untimed warm round on its own engine;
    every resident row against the card's cold replay."""
    from cadence_tpu_torch.serving import (
        ArrivalProcess, OpenLoopHarness, ResidentEngine)
    from cadence_tpu_torch.utils.metrics import NOOP, Scope
    from cadence_tpu_torch.utils.quotas import TokenBucket

    caps = S.Capacities(**SERVE_CAPS)

    def drive(tag, scope):
        loads, cold_events, appended = serve_cohort(
            W, SERVE_WORKFLOWS, SERVE_SEED, tag)
        engine = routes.wrap(ResidentEngine(
            lanes=SERVE_LANES, caps=caps, metrics=scope, device="cuda"))
        run = OpenLoopHarness(
            engine, loads, ArrivalProcess(qps=SERVE_QPS, kind="poisson",
                                          seed=SERVE_ARRIVAL_SEED),
            metrics=scope,
            admission_bucket=TokenBucket(rps=SERVE_QPS * 2.0,
                                         burst=max(8, int(SERVE_QPS))),
        ).run()
        return loads, cold_events, appended, run, engine

    warm = drive("warm", NOOP)[4].drain()
    ticks_before = len(routes.calls["serving_tick"])
    scope = Scope()
    reg = scope.registry
    loads, cold_events, appended, run, engine = drive("run", scope)
    tick_launches = routes.calls["serving_tick"][ticks_before:]
    # every lane still resident, against the cold replay of its history
    # up to its tip (a shed last arrival leaves a lane short of the end)
    checked, resident = [], []
    for w in loads:
        got = engine.resident_row(w.workflow_id, w.run_id)
        if got is None:
            continue  # evicted idle (no checkpoint plane attached)
        tip = int(got.state_row["exec_info"][S.X_NEXT_EVENT_ID])
        hist = [b for b in through(w, len(w.deltas)) if b[-1].event_id < tip]
        checked.append((w.workflow_id, w.run_id, hist))
        resident.append(got)
    cold = cold_rows(S, P, replay_packed, caps, checked, "cuda")
    mism = sum(not row_equal(np, S, g.state_row, g.epoch_s, c)
               for g, c in zip(resident, cold))
    drained = engine.drain()
    stats = reg.timer_stats("serve_decision")
    # where a request's time goes: the engine's own timers, per request
    per_request = {
        f"{name}_ms": reg.timer_stats(timer).total_s * 1e3 / max(
            run["completed"], 1)
        for name, timer in (("tick", "serving_tick_seconds"),
                            ("tick_pack", "serving_tick_pack"),
                            ("tick_replay", "serving_tick_replay"),
                            ("tick_commit", "serving_tick_commit"),
                            ("read", "serving_read_seconds"))}
    c = serve_counters(reg, "serving_resident_hits", "serving_cold_misses",
                       "serving_appends", "serving_events_replayed",
                       "serving_ticks", "serving_admit_failures",
                       "serving_compose_failures")
    rec = {
        "part": "serve_continuous", "workflows": SERVE_WORKFLOWS,
        "lanes": SERVE_LANES, "caps": SERVE_CAPS,
        "arrival": "poisson", "qps_target": SERVE_QPS,
        "requests": run["requests"], "completed": run["completed"],
        "shed": run["shed"], "wall_s": run["wall_s"],
        "qps_sustained": run["qps_sustained"],
        "latency_p50_ms": stats.p50 * 1e3, "latency_p99_ms": stats.p99 * 1e3,
        "engine_ms_per_request": per_request,
        "resident_hit_rate": c["serving_resident_hits"] / max(
            c["serving_resident_hits"] + c["serving_cold_misses"], 1),
        "appends": c["serving_appends"], "ticks": c["serving_ticks"],
        "appends_per_tick": c["serving_appends"] / max(
            c["serving_ticks"], 1),
        "events_appended": appended,
        "events_replayed": c["serving_events_replayed"],
        "events_per_append": c["serving_events_replayed"] / max(
            c["serving_appends"], 1),
        "cold_events_equiv": cold_events,
        "suffix_frac": c["serving_events_replayed"] / max(cold_events, 1),
        "admit_failures": c["serving_admit_failures"],
        "compose_failures": c["serving_compose_failures"],
        "drain_flush_failed": drained["flush_failed"],
        "warm_drain_flush_failed": warm["flush_failed"],
        "fsm_launches_per_tick_max": max(tick_launches, default=0),
        "fsm_launches_ticks": sum(tick_launches),
        "rows_checked": len(checked), "row_mismatches": mism,
    }
    emit({"phase": "serving", **rec})
    check(mism == 0, f"serve_continuous: {mism} resident rows differ from "
          "the cold replay")
    check(len(checked) > 0, "serve_continuous: no resident row to check")
    check(c["serving_admit_failures"] == c["serving_compose_failures"] == 0,
          f"serve_continuous: failures {c}")
    check(drained["flush_failed"] == warm["flush_failed"] == 0,
          "serve_continuous: drain flush failed")
    check(max(tick_launches, default=0) <= 2,
          f"serve_continuous: a tick launched {max(tick_launches)} times")
    check(run["completed"] > 0, "serve_continuous completed nothing")
    return rec


def phase_serve_megabatch(torch, np, S, P, W, replay_packed, classify_types,
                          routes):
    """(b) 4,096 resident lanes: one bulk seat through the dispatcher,
    then ``MEGA_ROUNDS`` rounds of one Δ a lane and one tick for all;
    every row against the card's cold replay, a seeded sample against
    the CPU plain route."""
    from cadence_tpu_torch.serving import ResidentEngine
    from cadence_tpu_torch.utils.metrics import Scope

    caps = S.Capacities(**SERVE_CAPS)
    t0 = time.perf_counter()
    loads, _, _ = serve_cohort(W, MEGA_LANES, MEGA_SEED, "mega")
    setup_s = time.perf_counter() - t0
    scope = Scope()
    reg = scope.registry
    engine = routes.wrap(ResidentEngine(lanes=MEGA_LANES, caps=caps,
                                        metrics=scope, device="cuda"),
                         capture=True)
    seat_launches = routes.counts["serving_seat"]
    t0 = time.perf_counter()
    tickets = engine.admit_many([
        dict(domain_id=w.domain_id, workflow_id=w.workflow_id,
             run_id=w.run_id, batches=w.prefix) for w in loads])
    seat_s = time.perf_counter() - t0
    seat_launches = routes.counts["serving_seat"] - seat_launches
    check(None not in tickets.values(), "megabatch: a seat failed")

    def timer_totals():
        return {k: reg.timer_stats(f"serving_tick_{k}").total_s
                for k in ("pack", "replay", "commit")}

    ticks, appended = [], 0
    for r in range(MEGA_ROUNDS):
        groups, n_events = set(), 0
        for w in loads:
            if r < len(w.deltas):
                d = w.deltas[r]
                check(engine.append(tickets[(w.workflow_id, w.run_id)], d),
                      f"megabatch: append refused in round {r}")
                n_events += sum(len(b) for b in d)
                _, non = classify_types({int(e.event_type)
                                         for b in d for e in b})
                groups.add("scan" if non else "auto")
        appended += n_events
        before = timer_totals()
        n_calls = len(routes.calls["serving_tick"])
        gen2 = gc.get_stats()[2]["collections"]
        t0 = time.perf_counter()
        stats = engine.tick()
        wall = time.perf_counter() - t0
        gen2 = gc.get_stats()[2]["collections"] - gen2
        after = timer_totals()
        launches = sum(routes.calls["serving_tick"][n_calls:])
        split = {f"{k}_s": after[k] - before[k] for k in after}
        ticks.append(dict(round=r, lanes=stats["composed"],
                          events=n_events, wall_s=wall, **split,
                          other_s=wall - sum(split.values()),
                          groups=sorted(groups), fsm_launches=launches,
                          gc_full_collections=gen2))
        check(launches == len(groups) <= 2,
              f"megabatch tick {r}: {launches} launches for groups {groups}")
    replayed = reg.counter_value("serving_events_replayed")
    # every row against the card's cold replay of its history so far
    hists = [(w.workflow_id, w.run_id, through(w, MEGA_ROUNDS))
             for w in loads]
    reads = [engine.resident_row(w.workflow_id, w.run_id) for w in loads]
    check(None not in reads, "megabatch: a lane is not resident")
    t0 = time.perf_counter()
    cold = cold_rows(S, P, replay_packed, caps, hists, "cuda")
    cold_s = time.perf_counter() - t0
    mism = sum(not row_equal(np, S, g.state_row, g.epoch_s, c)
               for g, c in zip(reads, cold))
    sample = random.Random(MEGA_SEED).sample(range(MEGA_LANES), SERVE_SAMPLE)
    plain = cold_rows(S, P, replay_packed, caps, [hists[i] for i in sample],
                      "cpu")
    mism_plain = sum(not row_equal(np, S, reads[i].state_row,
                                   reads[i].epoch_s, c)
                     for i, c in zip(sample, plain))
    c = serve_counters(reg, "serving_admit_failures",
                       "serving_compose_failures")
    rec = {
        "part": "serve_megabatch", "lanes": MEGA_LANES,
        "rounds": MEGA_ROUNDS, "caps": SERVE_CAPS, "setup_s": setup_s,
        "seat_s": seat_s, "seat_events": sum(
            sum(len(b) for b in w.prefix) for w in loads),
        "seat_fsm_launches": seat_launches, "ticks": ticks,
        "events_appended": appended, "events_replayed": replayed,
        "cold_check_s": cold_s, "row_mismatches": mism,
        "plain_sample": SERVE_SAMPLE, "plain_mismatches": mism_plain,
        "admit_failures": c["serving_admit_failures"],
        "compose_failures": c["serving_compose_failures"],
    }
    emit({"phase": "serving", **rec})
    check(mism == mism_plain == 0, f"megabatch: {mism} rows differ from the "
          f"card's cold replay, {mism_plain} from the CPU plain route")
    check(replayed == appended, f"megabatch: replayed {replayed} events for "
          f"{appended} appended (O(Δ) means equal)")
    check(c["serving_admit_failures"] == c["serving_compose_failures"] == 0,
          f"megabatch: failures {c}")
    # the largest pack one tick replayed, for the kernel's timing
    biggest = max(routes.packs, key=lambda mp: mp[1].lanes * mp[1].scan_len)
    routes.packs.clear()
    return rec, loads, hists, cold, biggest[1]


def time_tick_pack(torch, np, S, RC, caps, packed):
    """The FSM kernel at one tick's pack (every segment resumed from an
    init column): CUDA-event mean against the packed bound, the plain
    version's time, and kernel against plain on the card."""
    rm = RC.RowMap(caps)
    dev = "cuda"
    init = packed.initial
    ptr, ends = RC.segment_list(packed.seg_end, packed.out_row,
                                packed.reset_rows())
    ptr_d, ends_d = torch.from_numpy(ptr).to(dev), torch.from_numpy(
        ends).to(dev)
    rows0 = RC.state_to_rows(S.state_from_numpy(packed.lane_state0(init),
                                                dev), rm)
    n_out = packed.n_histories
    out0 = RC.state_to_rows(S.state_from_numpy(S.empty_state(n_out, caps),
                                               dev), rm)
    empty = RC.state_to_rows(S.state_from_numpy(S.empty_state(1, caps), dev),
                             rm)
    init_rows = torch.cat([RC.state_to_rows(S.state_from_numpy(init, dev),
                                            rm), empty], dim=1)
    evd = torch.from_numpy(packed.teb()).to(dev)
    out_k = out0.clone()
    got = RC.replay_rows_packed(evd, rows0, caps, ptr_d, ends_d, out_k,
                                init_rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = RC.replay_rows_packed_plain(evd, rows0, caps, ptr_d, ends_d,
                                       out0.clone(), init_rows)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, equal = compare(torch, list(got), list(want))
    rows_out = torch.empty_like(rows0)
    ms = cuda_ms(lambda: RC.replay_rows_packed(
        evd, rows0, caps, ptr_d, ends_d, out_k, init_rows, out=rows_out),
        reps=20, warmup=2)
    valid = int((packed.events[:, :, S.EV_TYPE] >= 0).sum())
    nbytes, bound_ms, bound_by = packed_bound(
        evd.numel() * evd.element_size(), rm.rows_padded, packed.lanes,
        n_out, init_rows.shape[1], len(ends), valid)
    rec = dict(lanes=packed.lanes, T=packed.scan_len, histories=n_out,
               segments=len(ends), R_pad=rm.rows_padded, valid_events=valid,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, share_of_bound=bound_ms / ms,
               max_abs_err=err, equal=equal,
               plan=RC.kernel_plan(evd, caps))
    emit({"phase": "serving", "part": "tick_kernel", **rec})
    check(equal, "the tick's packed replay disagrees with plain")
    return rec


def split_type(A, deltas):
    """The proven-affine event type whose removal from the affine set
    splits these Δs most evenly into the tick's two groups: every Δ of
    ``signal_history`` is affine, so without this seam the card never
    sees a two-group tick."""
    present = [{int(e.event_type) for b in d for e in b} for d in deltas]
    best = min(A.assoc_types(), key=lambda t: abs(
        2 * sum(t in p for p in present) - len(present)))
    scan = sum(best in p for p in present)
    return best, scan, len(present) - scan


def phase_serve_flush(np, S, P, A, replay_packed, loads, cold, routes):
    """(c) a 256-lane engine with a checkpoint plane over the first 256
    workflows of (b): seated midway, one more Δ composed in a tick whose
    lanes split into both groups (one event type taken out of the
    engine's affine set, so the lanes whose Δ holds it compose in the
    ``scan`` group) and checked against the card's cold replay, drained
    (one flushed record a lane), then re-admitted with the histories of
    (b): every seat resumes from its record and every row equals (b)'s
    cold replay."""
    from cadence_tpu_torch.checkpoint import (
        CheckpointManager, CheckpointPolicy, MemoryCheckpointStore)
    from cadence_tpu_torch.serving import ResidentEngine
    from cadence_tpu_torch.utils.metrics import Scope

    caps = S.Capacities(**SERVE_CAPS)
    loads = loads[:FLUSH_LANES]
    half = MEGA_ROUNDS // 2
    deltas = [w.deltas[half] for w in loads if half < len(w.deltas)]
    dropped, n_scan, n_auto = split_type(A, deltas)
    check(n_scan and n_auto, f"flush: no event type splits the tick's Δs "
          f"({n_scan} scan, {n_auto} auto)")
    store = MemoryCheckpointStore()
    scope = Scope()
    engine = routes.wrap(ResidentEngine(
        lanes=FLUSH_LANES, caps=caps, metrics=scope, device="cuda",
        affine_types=A.assoc_types() - {dropped},
        checkpoints=CheckpointManager(store, CheckpointPolicy(
            every_events=1, keep_last=1))))
    tickets = engine.admit_many([
        dict(domain_id=w.domain_id, workflow_id=w.workflow_id,
             run_id=w.run_id, branch_token=serve_token(w),
             batches=through(w, half)) for w in loads])
    for w in loads:
        if half < len(w.deltas):
            engine.append(tickets[(w.workflow_id, w.run_id)], w.deltas[half])
    n_calls = len(routes.calls["serving_tick"])
    engine.tick()
    tick_launches = sum(routes.calls["serving_tick"][n_calls:])
    reads = [engine.resident_row(w.workflow_id, w.run_id) for w in loads]
    check(None not in reads, "flush: a lane left the engine in the tick")
    tick_cold = cold_rows(S, P, replay_packed, caps, [
        (w.workflow_id, w.run_id, through(w, half + 1)) for w in loads],
        "cuda")
    tick_mism = sum(not row_equal(np, S, g.state_row, g.epoch_s, c)
                    for g, c in zip(reads, tick_cold))
    t0 = time.perf_counter()
    drained = engine.drain()
    drain_s = time.perf_counter() - t0
    records = store.count_checkpoints()
    t0 = time.perf_counter()
    tickets = engine.admit_many([
        dict(domain_id=w.domain_id, workflow_id=w.workflow_id,
             run_id=w.run_id, branch_token=serve_token(w),
             batches=through(w, MEGA_ROUNDS)) for w in loads])
    readmit_s = time.perf_counter() - t0
    reads = [engine.resident_row(w.workflow_id, w.run_id) for w in loads]
    check(None not in reads, "flush: a re-admitted lane is not resident")
    mism = sum(not row_equal(np, S, g.state_row, g.epoch_s, c)
               for g, c in zip(reads, cold[:FLUSH_LANES]))
    reg = scope.registry
    resumed = reg.counter_value("serving_admit_resume")
    rec = {"part": "serve_flush", "lanes": FLUSH_LANES,
           "two_group_tick": {"type_out_of_affine_set": dropped,
                              "scan_lanes": n_scan, "auto_lanes": n_auto,
                              "fsm_launches": tick_launches,
                              "row_mismatches": tick_mism},
           "drain": drained, "drain_s": drain_s,
           "checkpoint_records": records, "readmit_s": readmit_s,
           "admit_resume": resumed, "row_mismatches": mism,
           "flush_failures": reg.counter_value("serving_flush_failures")}
    emit({"phase": "serving", **rec})
    check(tick_launches == 2, f"flush: the two-group tick made "
          f"{tick_launches} FSM launches")
    check(tick_mism == 0, f"flush: {tick_mism} rows of the two-group tick "
          f"differ from the card's cold replay")
    check(drained["flush_failed"] == 0 and drained["flushed"] == FLUSH_LANES,
          f"flush: drain {drained}")
    check(records == FLUSH_LANES, f"flush: {records} checkpoint records")
    check(resumed == FLUSH_LANES, f"flush: {resumed} resumed seats")
    check(mism == 0, f"flush: {mism} re-admitted rows differ")
    return rec


def serve_token(w):
    from cadence_tpu_torch.runtime.persistence.records import BranchToken

    return BranchToken(tree_id=w.run_id,
                       branch_id=f"branch-{w.run_id}").to_json().encode()


def phase_serve_consult(np, S, unpack, loads, hists, cold, routes):
    """(d) the rebuilder's resident-lane consult: the first 256 histories
    of (b) in the port's history store, seated by ``admit_from_store``;
    ``rebuild_many`` at their exact tips hits every lane and equals a
    rebuilder without ``serving=``; a tip one event short falls through
    to the cold path. ``SERVE_COLD_READS`` further stored workflows are
    read without a lane: the cold read on the card."""
    from cadence_tpu_torch.runtime.persistence.memory import (
        MemoryHistoryManager)
    from cadence_tpu_torch.runtime.persistence.records import BranchToken
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        RebuildRequest, StateRebuilder)
    from cadence_tpu_torch.serving import ResidentEngine
    from cadence_tpu_torch.utils.metrics import Scope

    caps = S.Capacities(**SERVE_CAPS)
    hist = MemoryHistoryManager()
    n = FLUSH_LANES + SERVE_COLD_READS
    for w, (_, _, batches) in zip(loads[:n], hists[:n]):
        branch = BranchToken.from_json(serve_token(w).decode())
        for txn, b in enumerate(batches, 1):
            hist.append_history_nodes(branch, b, transaction_id=txn)
    scope = Scope()
    engine = routes.wrap(ResidentEngine(
        lanes=FLUSH_LANES, caps=caps, history=hist, metrics=scope,
        device="cuda"))
    t0 = time.perf_counter()
    for w in loads[:FLUSH_LANES]:
        check(engine.admit_from_store(w.domain_id, w.workflow_id, w.run_id,
                                      serve_token(w)) is not None,
              "consult: admit_from_store failed")
    admit_s = time.perf_counter() - t0

    def reqs(off):
        return [RebuildRequest(
            domain_id=w.domain_id, workflow_id=w.workflow_id,
            run_id=w.run_id, branch_token=serve_token(w),
            next_event_id=b[-1][-1].event_id + 1 - off)
            for w, (_, _, b) in zip(loads[:FLUSH_LANES], hists)]

    out = {}
    for name, off in (("exact_tip", 0), ("tip_one_off", 1)):
        rscope = Scope()
        t0 = time.perf_counter()
        got = StateRebuilder(hist, serving=engine, metrics=rscope,
                             device="cuda").rebuild_many(reqs(off))
        wall = time.perf_counter() - t0
        want = StateRebuilder(hist, device="cuda").rebuild_many(reqs(off))
        out[name] = {
            "hits": rscope.registry.counter_value(
                "serving_resident_hits", {"layer": "serving"}),
            "wall_s": wall,
            "mismatches": sum(rebuild_key(unpack, g) != rebuild_key(unpack, x)
                              for g, x in zip(got, want))}
    # reads of stored workflows without a lane: the cold read
    reads = [engine.read(w.workflow_id, w.run_id, domain_id=w.domain_id,
                         branch_token=serve_token(w))
             for w in loads[FLUSH_LANES:n]]
    check(None not in reads and not any(r.resident for r in reads),
          "consult: a cold read did not answer from a cold replay")
    cold_mism = sum(not row_equal(np, S, r.state_row, r.epoch_s, c)
                    for r, c in zip(reads, cold[FLUSH_LANES:n]))
    rec = {"part": "serve_consult", "lanes": FLUSH_LANES,
           "admit_from_store_s": admit_s, **out,
           "cold_reads": SERVE_COLD_READS, "cold_read_mismatches": cold_mism,
           "admit_failures": scope.registry.counter_value(
               "serving_admit_failures")}
    emit({"phase": "serving", **rec})
    check(out["exact_tip"]["hits"] == FLUSH_LANES,
          f"consult: {out['exact_tip']['hits']} resident hits")
    check(out["tip_one_off"]["hits"] == 0, "consult: a tip one event off hit")
    check(not any(v["mismatches"] for v in out.values()) and not cold_mism,
          f"consult: results differ {out}, cold reads {cold_mism}")
    return rec


def phase_serving(torch, np, S, P, RC, unpack):
    """Phase 9: the serving plane on the card, parts (a) to (d). Returns
    (record, tick kernel timing, launches by route)."""
    from cadence_tpu_torch.ops import assoc as A
    from cadence_tpu_torch.ops.replay import replay_packed
    from cadence_tpu_torch.testing import workloads as W

    t_phase = time.perf_counter()
    routes = ServeRoutes(RC)
    a = phase_serve_continuous(torch, np, S, P, W, replay_packed, routes)
    b, loads, hists, cold, tick_pack = phase_serve_megabatch(
        torch, np, S, P, W, replay_packed, A.classify_types, routes)
    c = phase_serve_flush(np, S, P, A, replay_packed, loads, cold, routes)
    d = phase_serve_consult(np, S, unpack, loads, hists, cold, routes)
    launches = dict(routes.counts)
    tick_kernel = time_tick_pack(torch, np, S, RC,
                                 S.Capacities(**SERVE_CAPS), tick_pack)
    wall = time.perf_counter() - t_phase
    emit({"phase": "serving", "part": "summary", "phase_s": wall,
          "launches_by_route": launches})
    for route in ("serving_seat", "serving_tick", "serving_cold_read"):
        check(launches[route] > 0, f"the serving path made no {route} launch")
    return {"a": a, "b": b, "c": c, "d": d}, tick_kernel, launches


# -- phase 10: the process-group fabric (cadence_tpu_torch/parallel) ----

# (b): a 2 x 2 gloo mesh of 4 ranks on cuda:0, the pipeline at these
# micro-batch counts; every rank call of run_ranks within this deadline
PARALLEL_RANKS, PARALLEL_MICROS, PARALLEL_REPS = 4, (2, 4), 5
PARALLEL_TIMEOUT_S = 300


def ref_digests(S, R, PW, final, tasks, lanes):
    """field_digests of the reference's ``lanes``: ``final`` numpy state,
    ``tasks`` numpy RefreshedTasks or None."""
    arrays = {f: getattr(final, f)[lanes] for f in S.STATE_ROW_FIELDS}
    if tasks is not None:
        arrays.update({f: getattr(tasks, f)[lanes] for f in R.FIELDS})
    return PW.field_digests(arrays)


def phase_parallel_nccl(torch, np, S, RC, R, m, phase3_step):
    """(a) ``replay_sharded_fn`` in scan mode and ``ndc_snapshot_exchange``
    through NCCL at world size 1, in this process, on phase 3's 65,536
    lanes, device-resident. Returns (record, the single-process step's
    refresh as numpy, FSM launches)."""
    import torch.distributed as dist
    from cadence_tpu_torch.parallel import (
        make_mesh, ndc_snapshot_exchange, replay_sharded_fn)
    from cadence_tpu_torch.parallel.replay_sharded import _DIGEST_COLS

    caps, n = m["caps"], m["tiled"].batch
    evd = S.host_tensor(m["teb"]).cuda()
    state0 = S.state_from_numpy(S.empty_state(n, caps), "cuda")
    ref = RC.replay_scan_teb(state0, evd, caps)
    ref_tasks = R.refresh_tasks_device(ref)
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(seq=1)
        init_s = time.perf_counter() - t0
        step = replay_sharded_fn(mesh, "scan")
        RC.replay_rows.launches = 0
        final, tasks = step(state0, evd)
        torch.cuda.synchronize()
        launches = RC.replay_rows.launches
        diverged = [f for f in S.STATE_ROW_FIELDS
                    if not torch.equal(getattr(final, f), getattr(ref, f))]
        diverged += [f for f in R.FIELDS
                     if getattr(tasks, f).dtype != getattr(ref_tasks, f).dtype
                     or not torch.equal(getattr(tasks, f),
                                        getattr(ref_tasks, f))]
        host = S.state_to_numpy(final)
        vs_phase3 = [f for f in S.STATE_ROW_FIELDS
                     if not np.array_equal(getattr(host, f),
                                           getattr(m["finals"]["int32"], f))]
        # the sharded step and the single-process step in turns
        # (single, sharded, sharded, single), 11 CUDA-event timings each
        fns = {"single": lambda: R.refresh_tasks_device(
                   RC.replay_scan_teb(state0, evd, caps)),
               "sharded": lambda: step(state0, evd)}
        turns = {"single": [], "sharded": []}
        for name in ("single", "sharded", "sharded", "single"):
            turns[name] += cuda_ms_each(fns[name], reps=11)
        each, single = sorted(turns["sharded"]), sorted(turns["single"])
        dig, vh, vh_len, replayed, max_version = ex = ndc_snapshot_exchange(
            final, mesh)
        ex_ok = {
            "digests": torch.equal(dig, torch.stack(
                [final.exec_info[:, c] for c in _DIGEST_COLS], dim=-1)),
            "vh_items": torch.equal(vh, final.vh_items),
            "vh_len": torch.equal(vh_len, final.vh_len),
            "replayed": int(replayed) == n,
            "max_version": int(max_version) == int(
                final.exec_info[:, S.X_CUR_VERSION].max()),
            "dtypes": all(x.dtype == torch.int32 for x in ex)}
        ex_each = sorted(cuda_ms_each(
            lambda: ndc_snapshot_exchange(final, mesh), reps=11))
    finally:
        dist.destroy_process_group()
    tasks_np = R.refreshed_to_numpy(ref_tasks)
    del evd, state0, ref, ref_tasks, final, tasks, ex, dig, vh, vh_len
    torch.cuda.empty_cache()
    rec = {"backend": "nccl", "world": 1, "mesh": dict(mesh.shape),
           "lanes": n, "T": caps.max_events,
           "R_pad": RC.RowMap(caps).rows_padded, "init_s": init_s,
           "launches": launches, "step_ms": each[len(each) // 2],
           "step_ms_min": each[0], "step_ms_max": each[-1],
           "single_step_ms": single[len(single) // 2],
           "single_step_ms_min": single[0],
           "single_step_ms_max": single[-1],
           "phase3_step_ms": phase3_step["step_ms"],
           "fields_diverged": diverged, "vs_phase3_diverged": vs_phase3,
           "exchange_ms": ex_each[len(ex_each) // 2],
           "exchange_ms_min": ex_each[0], "exchange_ms_max": ex_each[-1],
           "exchange_checks": ex_ok, "replayed": int(replayed)}
    check(not diverged, f"sharded step differs from the single-process "
          f"step: {diverged}")
    check(not vs_phase3, f"sharded step differs from phase 3: {vs_phase3}")
    check(all(ex_ok.values()), f"NCCL exchange: {ex_ok}")
    return rec, tasks_np, launches


def phase_parallel_gloo(np, S, R, m, ref_tasks):
    """(b) the sharded step (scan, then assoc), the exchange and the
    pipeline on a 2 x 2 gloo mesh of 4 ranks, all on cuda:0; every
    rank's results held against the single-process FSM route's on the
    same lanes (phase 3's final, (a)'s refresh) by their digests."""
    from cadence_tpu_torch.parallel.launch import run_ranks
    from cadence_tpu_torch.parallel.replay_sharded import _DIGEST_COLS
    from cadence_tpu_torch.testing import parallel_workers as PW

    n, ref = m["tiled"].batch, m["finals"]["int32"]
    t0 = time.perf_counter()
    recs = run_ranks(PW.smoke_mesh, PARALLEL_RANKS, backend="gloo",
                     device="cuda", timeout_s=PARALLEL_TIMEOUT_S,
                     args=(m["uniq"].teb(), RETRY_CAPS, n, ASSOC_HISTORIES,
                           PARALLEL_MICROS, PARALLEL_REPS))
    wall = time.perf_counter() - t0
    n_shard = recs[0]["shape"]["shard"]
    full = ref_digests(S, R, PW, ref, ref_tasks, slice(None))
    full_a = ref_digests(S, R, PW, ref, ref_tasks, slice(0, ASSOC_HISTORIES))
    want_ex = PW.field_digests({
        "digests": ref.exec_info[:, list(_DIGEST_COLS)],
        "vh_items": ref.vh_items, "vh_len": ref.vh_len})
    max_version = int(ref.exec_info[:, S.X_CUR_VERSION].max())
    bad = []
    for r in recs:
        i = r["shard_index"]
        blk = slice(i * n // n_shard, (i + 1) * n // n_shard)
        blk_a = slice(i * ASSOC_HISTORIES // n_shard,
                      (i + 1) * ASSOC_HISTORIES // n_shard)
        want = ref_digests(S, R, PW, ref, ref_tasks, blk)
        want_state = ref_digests(S, R, PW, ref, None, blk)
        cases = {
            "scan_local": r["scan"]["local"] == want,
            "scan_gathered": r["scan"]["full"] == full,
            "exchange": r["exchange"]["digests"] == want_ex
            and r["exchange"]["replayed"] == n
            and r["exchange"]["max_version"] == max_version
            and set(r["exchange"]["dtypes"]) == {"torch.int32"},
            "assoc_local": r["assoc"]["local"] == ref_digests(
                S, R, PW, ref, ref_tasks, blk_a),
            "assoc_gathered": r["assoc"]["full"] == full_a,
            "assoc_launches": r["assoc"]["launches"] == 0
            and r["assoc"]["segscan_launches"] == 0}
        for k, p in r["pipeline"].items():
            cases[f"pipeline[{k}]"] = p["local"] == want_state
        bad += [f"rank {r['rank']}: {c}" for c, ok in cases.items() if not ok]
    digests = ("local", "full", "digests")
    per_rank = [{
        "rank": r["rank"], "shard": r["shard_index"], "seq": r["seq_index"],
        "staged_bytes": r["staged_bytes"],
        **{part: {k: v for k, v in r[part].items() if k not in digests}
           for part in ("scan", "exchange", "assoc")},
        "pipeline": {n_micro: {k: v for k, v in p.items()
                               if k not in digests}
                     for n_micro, p in r["pipeline"].items()}}
        for r in recs]
    launches = {
        "parallel[gloo_scan]": sum(r["scan"]["launches"] for r in recs),
        "parallel[pipeline]": sum(p["launches"] for r in recs
                                  for p in r["pipeline"].values())}
    rec = {"backend": "gloo", "world": PARALLEL_RANKS, "device": "cuda:0",
           "mesh": recs[0]["shape"], "lanes_scan": n,
           "lanes_assoc": ASSOC_HISTORIES,
           "cut": f"assoc at {ASSOC_HISTORIES} lanes in total (phase 6's "
                  "width), so four ranks share the card's memory",
           "micro_batches": list(PARALLEL_MICROS),
           "bubble": {k: k / (k + recs[0]["shape"]["seq"] - 1)
                      for k in PARALLEL_MICROS},
           "run_ranks_wall_s": wall, "per_rank": per_rank,
           "staged_bytes": sum(r["staged_bytes"] for r in recs),
           "launches": launches, "mismatches": bad}
    check(not bad, f"gloo mesh results differ from the FSM route: {bad}")
    return rec, launches


def phase_parallel_entry(torch, np, S, R, RC):
    """(c) the entry twin: ``entry(device="cuda")``'s forward against
    ``device="cpu"``, then ``dryrun_multichip(4)`` over gloo on the
    card."""
    from cadence_tpu_torch.entry import dryrun_multichip, entry

    fwd, args = entry(device="cuda")
    RC.replay_rows.launches = 0
    final, tasks = fwd(*args)
    torch.cuda.synchronize()
    launches = RC.replay_rows.launches
    fwd_c, args_c = entry(device="cpu")
    final_c, tasks_c = fwd_c(*args_c)
    diverged = [f for f in S.STATE_ROW_FIELDS
                if not torch.equal(getattr(final, f).cpu(),
                                   getattr(final_c, f))]
    diverged += [f for f in R.FIELDS
                 if getattr(tasks, f).dtype != getattr(tasks_c, f).dtype
                 or not torch.equal(getattr(tasks, f).cpu(),
                                    getattr(tasks_c, f))]
    t0 = time.perf_counter()
    recs = dryrun_multichip(PARALLEL_RANKS, device="cuda", backend="gloo",
                            timeout_s=PARALLEL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    dry_launches = sum(r["launches"] for r in recs)
    check(not diverged, f"entry forward on the card differs from the "
          f"CPU's: {diverged}")
    check(all(r["pipelined"] and r["replayed"] == r["batch"] for r in recs),
          f"dry run records: {recs}")
    rec = {"entry_workflows": int(final.exec_info.shape[0]),
           "entry_launches": launches, "entry_fields_diverged": diverged,
           "dryrun": {"ranks": PARALLEL_RANKS, "backend": "gloo",
                      "device": "cuda:0", "mesh": recs[0]["mesh"],
                      "batch": recs[0]["batch"], "wall_s": wall,
                      "launches": dry_launches,
                      "staged_bytes": sum(r["staged_bytes"] for r in recs)}}
    return rec, {"parallel[entry]": launches,
                 "parallel[dryrun]": dry_launches}


def phase_parallel(torch, np, S, RC, R, m, phase3_step, smi):
    """Phase 10: (a) NCCL at world size 1, (b) a 2 x 2 gloo mesh on the
    card, (c) the entry twin. Returns FSM launches by route."""
    t_phase = time.perf_counter()
    a, ref_tasks, nccl_launches = phase_parallel_nccl(
        torch, np, S, RC, R, m, phase3_step)
    emit({"phase": "parallel", "part": "nccl_world1", **a,
          "nvidia_smi": smi})
    b, gloo_launches = phase_parallel_gloo(np, S, R, m, ref_tasks)
    emit({"phase": "parallel", "part": "gloo_mesh", **b, "nvidia_smi": smi})
    c, entry_launches = phase_parallel_entry(torch, np, S, R, RC)
    emit({"phase": "parallel", "part": "entry", **c, "nvidia_smi": smi})
    launches = {"parallel[nccl_scan]": nccl_launches, **gloo_launches,
                **entry_launches}
    emit({"phase": "parallel", "part": "summary",
          "phase_s": time.perf_counter() - t_phase,
          "launches_by_route": launches})
    for route, k in launches.items():
        check(k > 0, f"the parallel path made no {route} launch")
    return launches


# -- phase 11: the history host (runtime/, matching/, client/) -----------

# one history host: 4 shards, 4,096 open workflows (the engine's per-shard
# history cache, runtime/engine/cache.py max_size=1024, times 4; bench.py's
# 4,096-lane serving cell) on one task list, every fourth with one activity
# round trip, answered by 16 concurrent pollers; a 4,096-lane ResidentEngine seated from the store but for 64
# workflows, whose first serving_read is a cold miss; 4 rounds of a signal
# and a serving_read on every workflow; the rounds' device-busy share is
# profiled on this round (0-based)
SVC_SHARDS, SVC_WORKFLOWS, SVC_UNSEATED, SVC_ROUNDS = 4, 4096, 64, 4
SVC_ACTIVITY_EVERY, SVC_PROFILED_ROUND, SVC_POLLERS = 4, 1, 16
SVC_TASK_LIST, SVC_DOMAIN, SVC_POLL_S = "svc-tl", "svc-domain", 60.0


class ServiceRoutes:
    """FSM launches of the history host's serving reads, by route: the
    bulk seat (``admit_many``), the Δ composition (the engine's
    ``_compose``) and the cold misses (``read_through``, which seats the
    workflow in a free lane)."""

    def __init__(self, RC):
        self.RC = RC
        self.counts = {"service_seat": 0, "service_tick": 0,
                       "service_cold_miss": 0}

    def wrap(self, engine):
        engine._compose = self._counted(engine._compose, "service_tick")
        engine.read_through = self._counted(engine.read_through,
                                            "service_cold_miss")
        return engine

    def _counted(self, fn, route):
        def call(*a, **k):
            start = self.RC.replay_rows.launches
            try:
                return fn(*a, **k)
            finally:
                self.counts[route] += self.RC.replay_rows.launches - start
        return call

    def seat(self, fn):
        start = self.RC.replay_rows.launches
        out = fn()
        self.counts["service_seat"] += self.RC.replay_rows.launches - start
        return out


def svc_wf(i):
    return f"svc-wf-{i:05d}"


def svc_host(persistence, serving, scope):
    """The history host as the reference's service-plane test box builds
    it (memory persistence, one domain, a single-host ring, the history
    service with live transfer and timer queues, matching and the
    clients), with ``serving`` handed in; the real clock."""
    from cadence_tpu_torch.client import HistoryClient, MatchingClient
    from cadence_tpu_torch.matching import MatchingEngine
    from cadence_tpu_torch.runtime.domains import DomainCache, register_domain
    from cadence_tpu_torch.runtime.membership import single_host_monitor
    from cadence_tpu_torch.runtime.service import HistoryService

    from types import SimpleNamespace

    domain_id = register_domain(persistence.metadata, SVC_DOMAIN)
    service = HistoryService(
        SVC_SHARDS, persistence, DomainCache(persistence.metadata),
        single_host_monitor("svc-host-0"), serving=serving, metrics=scope)
    client = HistoryClient(service.controller, metrics=scope)
    matching = MatchingEngine(persistence.task, client, metrics=scope)
    service.wire(MatchingClient(matching), client)
    service.start()
    return SimpleNamespace(persistence=persistence, domain_id=domain_id,
                           service=service, client=client,
                           matching=matching)


def svc_branch(host, wf, run):
    shard = host.service.controller.shard_for(wf)
    snap = host.persistence.execution.get_workflow_execution(
        shard, host.domain_id, wf, run).snapshot
    return snap["execution_info"]["branch_token"]


def svc_batches(host, token):
    from cadence_tpu_torch.runtime.persistence.records import BranchToken

    if isinstance(token, bytes):
        token = token.decode()
    batches, _ = host.persistence.history.read_history_branch(
        BranchToken.from_json(token), 1, 1 << 60)
    return batches


def svc_pollers(n, fn):
    """Run ``fn`` ``n`` times over ``SVC_POLLERS`` concurrent pollers, as a
    worker fleet polls a task list."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(SVC_POLLERS) as pool:
        for f in [pool.submit(fn) for _ in range(n)]:
            f.result()


def svc_decide(host, first, lat):
    """One decision poll through matching, answered: the first decision
    of every fourth workflow schedules one activity, every other answer
    carries no decision."""
    from cadence_tpu_torch.core.enums import DecisionType
    from cadence_tpu_torch.matching import PollRequest
    from cadence_tpu_torch.runtime.api import Decision

    t0 = time.perf_counter()
    task = host.matching.poll_for_decision_task(PollRequest(
        host.domain_id, SVC_TASK_LIST, "smoke", SVC_POLL_S))
    check(task is not None, "no decision task within the poll")
    i = int(task.workflow_id.rsplit("-", 1)[1])
    decisions = []
    if first and i % SVC_ACTIVITY_EVERY == 0:
        decisions = [Decision(DecisionType.ScheduleActivityTask, {
            "activity_id": f"a-{i}", "activity_type": "work",
            "task_list": SVC_TASK_LIST, "input": b"x",
            "schedule_to_close_timeout_seconds": 3600,
            "schedule_to_start_timeout_seconds": 3600,
            "start_to_close_timeout_seconds": 3600,
            "heartbeat_timeout_seconds": 0})]
    host.client.respond_decision_task_completed(
        task.task_token, decisions, identity="smoke")
    lat.append((time.perf_counter() - t0) * 1e3)


def svc_activity(host, lat):
    from cadence_tpu_torch.matching import PollRequest

    t0 = time.perf_counter()
    act = host.matching.poll_for_activity_task(PollRequest(
        host.domain_id, SVC_TASK_LIST, "smoke", SVC_POLL_S))
    check(act is not None, "no activity task within the poll")
    host.client.respond_activity_task_completed(
        act.task_token, result=b"done", identity="smoke")
    lat.append((time.perf_counter() - t0) * 1e3)


def svc_oracle(host, runs, wfs):
    """The port's host oracle: StateBuilder over each workflow's stored
    history, in the canonical snapshot form serving reads carry."""
    from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        RebuildRequest, StateRebuilder)

    rb = StateRebuilder(host.persistence.history, device="cpu")
    out = {}
    for wf in wfs:
        ms, _, _ = rb.rebuild(RebuildRequest(
            host.domain_id, wf, runs[wf], svc_branch(host, wf, runs[wf])))
        out[wf] = mutable_state_to_snapshot(ms)
    return out


def phase_service(torch, np, S, RC, smi):
    """Phase 11: the port's history host on the card at the size of one
    history host. Returns FSM launches by route."""
    from cadence_tpu_torch.checkpoint import (
        CheckpointManager, MemoryCheckpointStore)
    from cadence_tpu_torch.runtime.api import (
        SignalRequest, StartWorkflowRequest)
    from cadence_tpu_torch.runtime.persistence.memory import (
        create_memory_bundle)
    from cadence_tpu_torch.serving import ResidentEngine
    from cadence_tpu_torch.utils.metrics import Scope

    t_phase = time.perf_counter()
    scope = Scope()
    reg = scope.registry
    routes = ServiceRoutes(RC)
    persistence = create_memory_bundle()
    engine = routes.wrap(ResidentEngine(
        lanes=SVC_WORKFLOWS, caps=S.Capacities(**SERVE_CAPS),
        checkpoints=CheckpointManager(MemoryCheckpointStore()),
        history=persistence.history, metrics=scope, device="cuda"))
    host = svc_host(persistence, engine, scope)
    n = SVC_WORKFLOWS
    wfs = [svc_wf(i) for i in range(n)]
    lat = {"start": [], "poll_respond": [], "activity": [], "signal": [],
           "serving_read": []}
    drained = []
    try:
        # (a) starts, first decisions, activity round trips
        runs = {}
        t0 = time.perf_counter()
        for i, wf in enumerate(wfs):
            t1 = time.perf_counter()
            runs[wf] = host.client.start_workflow_execution(
                StartWorkflowRequest(
                    domain=SVC_DOMAIN, workflow_id=wf, workflow_type="svc",
                    task_list=SVC_TASK_LIST, input=b"in",
                    execution_start_to_close_timeout_seconds=36000,
                    task_start_to_close_timeout_seconds=3600,
                    request_id=f"svc-start-{i}"))
            lat["start"].append((time.perf_counter() - t1) * 1e3)
        start_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc_pollers(n, lambda: svc_decide(host, True, lat["poll_respond"]))
        n_act = len(range(0, n, SVC_ACTIVITY_EVERY))
        svc_pollers(n_act, lambda: svc_activity(host, lat["activity"]))
        svc_pollers(n_act,
                    lambda: svc_decide(host, False, lat["poll_respond"]))
        decide_s = time.perf_counter() - t0

        # (b) seat the hot set from the store, but for 64 workflows
        unseated = set(wfs[SVC_WORKFLOWS // SVC_UNSEATED - 1::
                           SVC_WORKFLOWS // SVC_UNSEATED])
        check(len(unseated) == SVC_UNSEATED, "unseated set size")
        seat_next = {}
        reqs = []
        t0 = time.perf_counter()
        for wf in wfs:
            if wf in unseated:
                continue
            token = svc_branch(host, wf, runs[wf])
            batches = svc_batches(host, token)
            seat_next[wf] = batches[-1][-1].event_id + 1
            reqs.append({"domain_id": host.domain_id, "workflow_id": wf,
                         "run_id": runs[wf], "branch_token": token,
                         "batches": batches})
        store_read_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seated = routes.seat(lambda: host.service.serving.admit_many(reqs))
        torch.cuda.synchronize()
        seat_s = time.perf_counter() - t0
        check(all(v is not None for v in seated.values())
              and len(seated) == len(reqs), "the bulk seat left lanes out")
        del reqs

        # (c) rounds: signal every workflow, then read every workflow
        rounds, busy, mismatches = [], None, 0
        for r in range(SVC_ROUNDS):
            t0 = time.perf_counter()
            for i, wf in enumerate(wfs):
                t1 = time.perf_counter()
                host.client.signal_workflow_execution(SignalRequest(
                    domain=SVC_DOMAIN, workflow_id=wf, signal_name="go",
                    input=f"s{r}".encode(), identity="smoke",
                    request_id=f"svc-sig-{r}-{i}"))
                lat["signal"].append((time.perf_counter() - t1) * 1e3)
            signal_s = time.perf_counter() - t0
            got = {}

            def read_all():
                for wf in wfs:
                    t1 = time.perf_counter()
                    res = host.service.serving_read(
                        host.domain_id, wf, runs[wf])
                    lat["serving_read"].append(
                        (time.perf_counter() - t1) * 1e3)
                    check(res is not None, f"serving_read of {wf} is None")
                    got[wf] = res
            t0 = time.perf_counter()
            if r == SVC_PROFILED_ROUND:
                busy = device_busy(torch, read_all)
                # the profiler's own trace processing is not the reads'
                read_s = busy["profiled_wall_s"]
                profiler_s = time.perf_counter() - t0 - read_s
            else:
                read_all()
                read_s = time.perf_counter() - t0
                profiler_s = 0.0
            for wf in unseated:
                seat_next.setdefault(
                    wf, got[wf].snapshot["exec"]["next_event_id"])
            t0 = time.perf_counter()
            want = svc_oracle(host, runs, wfs)
            bad = [wf for wf in wfs if got[wf].snapshot != want[wf]]
            mismatches += len(bad)
            rounds.append({"round": r, "signal_s": signal_s,
                           "read_s": read_s, "wall_s": signal_s + read_s,
                           "profiled": r == SVC_PROFILED_ROUND,
                           "profiler_processing_s": profiler_s,
                           "resident": sum(g.resident for g in got.values()),
                           "oracle_s": time.perf_counter() - t0,
                           "mismatches": len(bad)})
            check(not bad, f"round {r}: {len(bad)} serving reads differ "
                  f"from the host replay, first {bad[:3]}")
        final_next = {wf: want[wf]["exec"]["next_event_id"] for wf in wfs}
        counters = serve_counters(
            reg, "serving_resident_hits", "serving_cold_misses",
            "serving_events_replayed", "serving_ticks",
            "serving_compose_failures", "serving_cold_read_failures")

        # (d) stop: the engine drains through the checkpoint plane
        orig_drain = host.service.serving.drain
        host.service.serving.drain = (
            lambda: drained.append(orig_drain()) or drained[-1])
        t0 = time.perf_counter()
        host.service.stop()
        stop_s = time.perf_counter() - t0
        engine = host.service.serving
        occupancy = engine.occupancy()
        seated_after = engine.describe()["seated"]
    finally:
        host.matching.shutdown()
        if not drained:
            host.service.stop()
    reads = SVC_ROUNDS * n
    appended = sum(final_next[wf] - seat_next[wf] for wf in wfs)
    emit({"phase": "service", "part": "latency", "workflows": n,
          "shards": SVC_SHARDS, "rounds": SVC_ROUNDS,
          "host_ms": {k: percentiles(np, v) for k, v in lat.items()},
          "start_s": start_s, "decide_s": decide_s, "nvidia_smi": smi})
    emit({"phase": "service", "part": "seat", "lanes": SVC_WORKFLOWS,
          "seated": len(seated), "unseated": SVC_UNSEATED,
          "store_read_s": store_read_s, "seat_wall_s": seat_s,
          "fsm_launches": routes.counts["service_seat"],
          "nvidia_smi": smi})
    emit({"phase": "service", "part": "rounds", "rounds": rounds,
          "nvidia_smi": smi})
    emit({"phase": "service", "part": "device_busy",
          "round": SVC_PROFILED_ROUND, "reads": n, **busy,
          "nvidia_smi": smi})
    emit({"phase": "service", "part": "summary",
          "phase_s": time.perf_counter() - t_phase, "reads": reads,
          "counters": counters, "events_appended_after_seat": appended,
          "drain": drained, "stop_s": stop_s,
          "occupancy_after": occupancy, "seated_after": seated_after,
          "oracle_mismatches": mismatches,
          "launches_by_route": dict(routes.counts)})
    check(counters["serving_resident_hits"] >= reads - SVC_UNSEATED,
          f"resident hits {counters['serving_resident_hits']} < "
          f"{reads} reads - {SVC_UNSEATED}")
    check(counters["serving_events_replayed"] == appended,
          f"serving_events_replayed {counters['serving_events_replayed']} "
          f"!= {appended} events appended after the seat")
    check(len(drained) == 1 and drained[0]["flush_failed"] == 0,
          f"the drain at stop() failed flushes: {drained}")
    check(drained[0]["flushed"] == SVC_WORKFLOWS,
          f"stop() flushed {drained[0]['flushed']} of {SVC_WORKFLOWS} lanes")
    check(occupancy == 0 and seated_after == 0,
          "the engine is not empty after stop()")
    for route, k in routes.counts.items():
        check(k > 0, f"the history host made no {route} launch")
    return dict(routes.counts)


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
    from cadence_tpu_torch import native
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.ops import assoc as A
    from cadence_tpu_torch.ops import assoc_cuda as AC
    from cadence_tpu_torch.ops import pack as P
    from cadence_tpu_torch.ops import refresh as R
    from cadence_tpu_torch.ops import replay_cuda as RC
    from cadence_tpu_torch.ops import schema as S
    from cadence_tpu_torch.ops import unpack
    from cadence_tpu_torch.ops.dispatch import depth_buckets, replay_stream
    from cadence_tpu_torch.ops.replay import replay_packed
    from cadence_tpu_torch.testing import workloads as W

    # 1. device and build
    smi = phase_device(torch, _build, native)

    # 2. kernel against plain on random events
    rand_err = phase_kernel_vs_plain(torch, np, S, E, RC)

    # 5. the scan kernel against plain on random streams, beside phase 2
    seg_rand_err = phase_segscan_vs_plain(torch, np, AC)

    # host inputs of the main path, made before the counted window
    t0 = time.perf_counter()
    mixed = mixed_depth(W)
    gen_s = time.perf_counter() - t0

    # 3 + 4. the main path, launches counted from zero
    RC.replay_rows.launches = 0
    m = phase_main_path(torch, np, S, P, RC, replay_packed)
    launches_packed = RC.replay_rows.launches
    stream_res, stream_wall = phase_stream(torch, S, replay_stream, mixed,
                                           bucket=True)
    launches_stream = RC.replay_rows.launches - launches_packed
    hist_res, hist_wall = phase_stream(torch, S, replay_stream, mixed,
                                       batch_size=1024)
    launches = RC.replay_rows.launches
    launches_hist = launches - launches_packed - launches_stream

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
          "lanes_per_block": RC.lanes_per_block(m["rm"].rows_padded, n),
          "pack_s": m["pack_s"], "host_narrow_s": m["narrow_s"],
          "plain_check_lanes": k,
          "replay_packed_wall_s": m["wall"],
          "e2e_histories_per_s": {s: n / w for s, w in m["wall"].items()},
          "kernel": {s: dict(r, histories_per_s=n / (r["ms"] * 1e-3))
                     for s, r in timing.items()},
          "nvidia_smi": smi})

    # 3, continued, outside the counted window: the replay + refresh step
    # on the card, the compiled baseline, the sidecar's scatter
    step = phase_refresh_step(torch, np, S, RC, R, unpack, m)
    baseline = phase_baseline(np, S, P, native, m,
                              step["histories_per_sec"])
    emit({"phase": "replay_refresh_step", "config": "retry_deep",
          "histories": n, "refresh": step, "baseline": baseline,
          "nvidia_smi": smi})
    emit({"phase": "sidecar_scatter", **phase_scatter(np, P, native, m),
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
    # one more (warm) bucketed stream under the profiler, then the packed
    # route alone at each of its batches
    busy = device_busy(torch, lambda: replay_stream(
        mixed, caps=caps, bucket=True, device="cuda"))
    packed_timing = time_packed(torch, np, S, RC, caps, stream_res)
    stream_step = stream_refresh(torch, np, S, RC, R, caps, stream_res)
    emit({"phase": "stream", "route": "replay_stream(bucket=True)",
          "histories": len(mixed), "shallow": N_SHALLOW, "deep": N_DEEP,
          "batches": len(stream_res), "gen_s": gen_s,
          "wall_s": stream_wall,
          "histories_per_s": len(mixed) / stream_wall,
          "host_pack_only_s": pack_only, "plain_cpu_wall_s": plain_wall,
          "fsm_launches": launches_stream, "device_busy": busy,
          "packed_route": packed_timing, "replay_refresh_step": stream_step,
          "snapshot_mismatches": mism,
          "unbucketed": {"batch_size": 1024, "batches": len(hist_res),
                         "wall_s": hist_wall, "fsm_launches": launches_hist,
                         "snapshot_mismatches": mism_hist}})
    check(not (mism or mism_hist or None in got or None in got_hist),
          f"stream snapshots differ from plain: {mism} bucketed, "
          f"{mism_hist} unbucketed")
    check(launches_stream == len(stream_res),
          f"the bucketed stream launched the FSM kernel {launches_stream} "
          f"times for {len(stream_res)} packed batches")

    # 6. the assoc main path, launches counted from zero
    caps = m["caps"]
    tiled = m["tiled"]
    na = min(ASSOC_HISTORIES, tiled.batch)
    sub = P.PackedHistories(
        events=tiled.events[:na], lengths=tiled.lengths[:na],
        side=tiled.side[:na], caps=caps, epoch_s=tiled.epoch_s)
    # the FSM route's [T, EV_N, B] host layout, made outside the timed
    # calls as phase 3 makes it
    t0 = time.perf_counter()
    sub.teb()
    sub_teb_s = time.perf_counter() - t0
    AC.affine_segscan.launches = 0
    RC.replay_rows.launches = 0
    assoc = phase_assoc_main_path(torch, S, A, sub)
    facade, facade_wall, facade_peak = timed_call(
        torch, lambda: replay_packed(sub, scan_mode="assoc", device="cuda"))
    seg_launches = AC.affine_segscan.launches
    fsm_in_assoc = RC.replay_rows.launches

    want_sub, scan_wall, _ = timed_call(
        torch, lambda: replay_packed(sub, scan_mode="scan", device="cuda"))
    finals = {f"replay_assoc[{impl}]": S.state_to_numpy(res)
              for impl, (res, _, _) in assoc.items()}
    finals["replay_packed[assoc]"] = facade
    diverged = {name: [f for f in S.STATE_ROW_FIELDS
                       if not np.array_equal(getattr(fin, f),
                                             getattr(want_sub, f))]
                for name, fin in finals.items()}
    seg_timing = time_segscan(torch, S, A, AC, sub)
    fsm_at = time_fsm_at(torch, S, RC, sub)
    busy = profile_routes(torch, S, A, RC, sub)
    emit({"phase": "assoc_main_path", "config": "retry_deep",
          "histories": na, "T": caps.max_events,
          "host_teb_s": sub_teb_s,
          "wall_s": {f"replay_assoc[{impl}]": w
                     for impl, (_, w, _) in assoc.items()}
          | {"replay_packed[assoc]": facade_wall,
             "replay_packed[scan]": scan_wall},
          "peak_bytes": {f"replay_assoc[{impl}]": pk
                         for impl, (_, _, pk) in assoc.items()}
          | {"replay_packed[assoc]": facade_peak},
          "fsm_at_same_lanes": fsm_at, "device_busy": busy,
          "segscan_launches": seg_launches,
          "fsm_launches_on_assoc_path": fsm_in_assoc,
          "fields_diverged": diverged, "segscan_kernel": seg_timing,
          "nvidia_smi": smi})
    check(not any(diverged.values()),
          f"assoc routes differ from the FSM route: {diverged}")
    check(seg_timing["equal"], "scan kernel disagrees with plain at the "
          "path's operands")

    # 7. the assoc lanes routes on the phase-4 mix, launches counted
    AC.affine_segscan.launches = 0
    t0 = time.perf_counter()
    lanes_pk = P.pack_lanes(mixed, caps=caps)
    lanes_final = A.replay_assoc_lanes(lanes_pk, impl="segscan",
                                       device="cuda")
    lanes_wall = time.perf_counter() - t0
    stream_assoc, stream_assoc_wall = phase_stream(
        torch, S, replay_stream, mixed, bucket=True, scan_mode="assoc")
    hist_assoc, hist_assoc_wall = phase_stream(
        torch, S, replay_stream, mixed, batch_size=1024, scan_mode="assoc")
    seg_launches_lanes = AC.affine_segscan.launches
    got_lanes = [unpack.state_row_to_snapshot(lanes_final, i,
                                              lanes_pk.epoch_s)
                 for i in range(len(mixed))]
    got_sa = stream_snapshots(stream_assoc, len(mixed), unpack)
    got_ha = stream_snapshots(hist_assoc, len(mixed), unpack)
    mism_lanes = sum(g != w for g, w in zip(got_lanes, got))
    mism_sa = sum(g != w for g, w in zip(got_sa, got))
    mism_ha = sum(g != w for g, w in zip(got_ha, got))
    emit({"phase": "assoc_lanes", "histories": len(mixed),
          "lanes": lanes_pk.lanes, "scan_len": lanes_pk.scan_len,
          "replay_assoc_lanes_segscan_wall_s": lanes_wall,
          "stream_assoc_wall_s": stream_assoc_wall,
          "stream_assoc_batches": len(stream_assoc),
          "unbucketed_assoc": {"batch_size": 1024,
                               "batches": len(hist_assoc),
                               "wall_s": hist_assoc_wall},
          "segscan_launches": seg_launches_lanes,
          "snapshot_mismatches": {"replay_assoc_lanes": mism_lanes,
                                  "replay_stream[assoc]": mism_sa,
                                  "replay_stream[assoc, unbucketed]":
                                  mism_ha}})
    check(not (mism_lanes or mism_sa or mism_ha or None in got_sa
               or None in got_ha),
          f"assoc snapshots differ from the FSM route: {mism_lanes} "
          f"lanes, {mism_sa} bucketed, {mism_ha} unbucketed")

    # 8. the rebuild path, launches counted from zero inside the phase;
    # then the kernel at the path's batch, outside the counted window
    rebuild, launches_rebuild, cohort = phase_rebuild(torch, np, unpack, RC)
    rebuild_kernel = time_rebuild_kernel(torch, np, S, P, RC, cohort)
    del cohort
    emit({"phase": "rebuild_kernel", "packed_route": rebuild_kernel,
          "nvidia_smi": smi})

    # 9. the serving plane, launches counted by route inside the phase
    RC.replay_rows.launches = 0
    serving, tick_kernel, serve_launches = phase_serving(
        torch, np, S, P, RC, unpack)
    del serving

    # 10. the process-group fabric, launches counted by route inside the
    # phase
    parallel_launches = phase_parallel(torch, np, S, RC, R, m, step, smi)

    # 11. the history host, launches counted by route inside the phase
    service_launches = phase_service(torch, np, S, RC, smi)

    # 12. kernels and device
    check(launches > 0, "the main path launched no FSM kernel")
    seg_total = seg_launches + seg_launches_lanes
    check(seg_total > 0, "the assoc path launched no scan kernel")
    t32 = timing["int32"]
    deep = max(packed_timing, key=lambda r: r["T"] * r["lanes"])
    rk = max(rebuild_kernel, key=lambda r: r["T"] * r["lanes"])
    kernels = [{
        "name": "replay_fsm", "route": "cuda",
        "source": "cadence_tpu_torch/ops/csrc/replay_fsm.cu",
        "replaces": "cadence_tpu/ops/replay_pallas.py:153",
        "launches": launches + launches_rebuild + sum(
            serve_launches.values()) + sum(parallel_launches.values())
        + sum(service_launches.values()),
        "max_abs_err": max(rand_err, tick_kernel["max_abs_err"]),
        "ms": t32["ms"], "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
        "library_ms": None,
        "ms_int16": timing["int16"]["ms"],
        "plain_ms_int16": timing["int16"]["plain_ms"],
        "bound_ms_int16": timing["int16"]["bound_ms"],
        "shape": f"T={caps.max_events} B={n} R_pad={m['rm'].rows_padded}",
        "ms_16384": fsm_at["int32"]["kernel_ms"],
        "bound_ms_16384": fsm_at["int32"]["bound_ms"],
        "packed_ms": deep["int32"]["ms"],
        "packed_bound_ms": deep["int32"]["bound_ms"],
        "packed_shape": f"T={deep['T']} L={deep['lanes']}",
        "rebuild_ms": rk["int32"]["ms"],
        "rebuild_ms_int16": rk["int16"]["ms"],
        "rebuild_bound_ms": rk["int32"]["bound_ms"],
        "rebuild_bound_ms_int16": rk["int16"]["bound_ms"],
        "rebuild_shape": f"T={rk['T']} L={rk['lanes']} R_pad={rk['R_pad']}",
        "tick_ms": tick_kernel["ms"], "tick_plain_ms": tick_kernel["plain_ms"],
        "tick_bound_ms": tick_kernel["bound_ms"],
        "tick_shape": f"T={tick_kernel['T']} L={tick_kernel['lanes']} "
                      f"histories={tick_kernel['histories']} "
                      f"R_pad={tick_kernel['R_pad']}",
        "launches_by_route": {"replay_packed": launches_packed,
                              "replay_stream[bucket]": launches_stream,
                              "replay_stream[unbucketed]": launches_hist,
                              "rebuild_many": launches_rebuild,
                              **serve_launches, **parallel_launches,
                              **service_launches},
    }, {
        "name": "affine_segscan", "route": "cuda",
        "source": "cadence_tpu_torch/ops/csrc/affine_segscan.cu",
        "replaces": "cadence_tpu/ops/replay_pallas.py:1068",
        "launches": seg_total,
        "max_abs_err": max(seg_rand_err, seg_timing["max_abs_err"]),
        "ms": seg_timing["ms"], "plain_ms": seg_timing["plain_ms"],
        "bound_ms": seg_timing["bound_ms"],
        "bound_by": seg_timing["bound_by"], "library_ms": None,
        "shape": seg_timing["shape"],
    }]
    emit({"device_passes": [{
        "name": "refresh_tasks_device", "route": "torch ops",
        "source": "cadence_tpu_torch/ops/refresh.py",
        "replaces": "cadence_tpu/ops/refresh.py:79",
        **{k: step[k] for k in ("lanes", "launches", "ms", "bound_ms",
                                "bound_by", "step_ms", "histories_per_sec")},
        "stream": {k: stream_step[k] for k in (
            "lanes", "launches", "ms", "bound_ms", "bound_by", "step_ms")},
    }]})
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
