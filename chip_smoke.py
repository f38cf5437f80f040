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
   ``refresh_tasks_device`` (``ops/refresh.py``): the refresh's and the
   step's times three ways (CUDA events around the eager launches, the
   launches' summed device time under torch.profiler, a CUDA graph's
   replay), the refresh's launches and bound, the step's histories/s, the
   card's refresh against the CPU's on every lane and a seeded 256
   hydrated against the host refresher; the compiled baseline
   (``native.replay_sequential`` on the first 256 histories, its state
   against the kernel's, ``baseline_cpp_per_sec`` and ``vs_baseline``
   with the host CPU's model); the sidecar's scatters at full width
   against their numpy paths, byte for byte and timed;
4. ``replay_stream(bucket=True)`` on a 90% shallow / 10% deep mix, with
   a metrics scope wired in, every snapshot against the plain route on
   the CPU and against the same stream without a scope, its FSM launches
   (one per packed batch), its device-busy share (torch.profiler), the
   packed route's time per batch against its bound, the dispatcher's
   device-step telemetry against the batches it ran (``device_telemetry``:
   counts, widths, occupancy and padding against the packers', no kernel
   library loaded after the warm-up, each step at least its kernel's
   time), and the refresh of the deepest batch's output snapshots on the
   card against the CPU's;
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
   ``replay_stream(scan_mode="assoc")``, bucketed (with a metrics scope:
   the ``lanes_assoc`` batches' device telemetry, checked as phase 4's
   but for the kernel time) and unbucketed, on the phase-4 mix, every
   snapshot against the FSM route's;
8. ``rebuild``: the rebuild path, ``StateRebuilder.rebuild_many`` on the
   card with the rebuilder's default capacities (R_pad = 944): the
   reference bench's ``rebuild_warm`` cell at its chip size (256
   retry_deep histories of 1,000 events, a cold and a checkpointed warm
   pass, every rebuilt run against the host oracle ``rebuild()``), the
   p50 and p99 of one rebuild request on the card and on the host
   oracle, an ``ndc_storm`` rebuild storm (1,024 fuzzed histories, a
   seeded sample against the host oracle and against the card without a
   metrics scope), and the FSM kernel's time at the cold pass's batch
   against its bound; every rebuilder there has a metrics scope, so
   the dispatcher's device-step telemetry is on (each one-request rebuild
   also runs without a scope, the arms alternating); the cohort's cold pass
   once more without a scope and once with a fresh one
   (``rebuild_telemetry``: both walls, the telemetry against the batches
   and each step against the kernel's time at its batch), the storm's
   telemetry likewise;
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
    from the store with one ``admit_many`` but for 64 workflows, 2 rounds
    of a signal and a ``HistoryService.serving_read`` on every workflow
    (every read against the port's host ``StateBuilder`` replay of the
    stored history; the 64 first reads are cold misses), then ``stop()``
    draining the engine through the checkpoint plane; host-clock p50/p99
    per verb, the seat's and each round's wall, FSM launches by route and
    one round's device-busy share (torch.profiler);
12. ``frontend``: the user path (``cadence_tpu_torch/frontend``,
    ``worker``, ``testing/onebox``): the port's Onebox twin over a 4-shard
    history host with a ``ResidentEngine`` of a lane a workflow, 16 SDK
    ``Worker``s (sticky) on one task list, 1,024 workflows started through the
    frontend (every fourth with an activity, each then waiting on
    signals), an open-loop burst of 2,048 requests (300 qps, bursty), each
    a frontend signal and a ``serving_read`` (a workflow's first read a
    cold miss that seats it), every read against the host replay at its
    tip, queries the SDK answers and histories on a seeded 256, the
    visibility counts, then the workers stop and ``box.stop()`` drains the
    engine; host-clock p50/p99 per verb (start, signal, cold and resident
    read, query, the SDK's decision), sustained qps, FSM launches by route
    and the device-busy share of a 1,024-request window;
13. ``replication``: the replication planes (``cadence_tpu_torch/runtime/
    replication``, the standby queues) between two port clusters whose
    history services rebuild on the card: (a) ``xdc``, 4 shards a side,
    2,048 workflows started and signalled 4 times each on the active (no
    worker: 10,240 replication tasks), the standby, down meanwhile, comes
    up and pulls through ``enable_replication_from`` over an unthrottled
    simulated link, every state and history equal on both sides and no
    passive task dispatched; a managed handover, a signal a workflow on the
    new active, the drain back (its device-busy share), both sides equal
    again and a decision task in the new active's matching for every
    scheduled decision; (b1) ``storm_10k``: the reference's >=10k-task
    storm (3,334 workflows x 3 tasks) in one cycle on a 1-shard standby,
    one ``rebuild_many`` of 3,334 on the card, every conflict closed, a
    seeded 64 against the one-at-a-time path on a CPU box; (b2)
    ``storm_deep``: the first 64 of phase 8's retry_deep histories of
    1,000 events seeded task by task in fetch pages, then one cycle of a
    divergent tail each (one ``rebuild_many`` of 64 replaying ~1,000
    events each), every
    state against the host replay of its new branch, a seeded 16 against
    the one-at-a-time path, the cycle split into plan, rebuild and apply,
    and the FSM kernel at the storm's batch against its bound; (d)
    ``install_resume``: 64 snapshots shipped 112 signals behind their
    run's tip, installed on the standby, the history's bytes backfilled,
    and one ``rebuild_many`` on the installer's rebuilder resuming every
    run from its installed row and replaying the suffix on the card, every
    state against the host replay; (c) the reference bench's
    ``replication_lag`` (three arms) and ``failover_drill`` cells at their
    own sizes. FSM launches by route, counted on the launching thread with
    no lock around the counted calls: the batched drain's conflict
    rebuilds, the snapshot serve, the snapshot install and (d)'s resume;
14. ``topology``: the parallel queue executor, elastic resharding and
    the capacity autopilot (``cadence_tpu_torch/runtime/queues/parallel``,
    ``runtime/resharding``, ``runtime/autopilot``, ``testing/
    topology_cells``): (a) the reference bench's ``queue_drain`` cell at
    its size, the sequential pump against the shared executor over the
    same storm (final states equal, the matrix gate not degraded); (b)
    ``split_merge``: the Onebox twin on 4 shards with a 12-wide executor
    and checkpoints, 4,096 workflows started and signalled and 64 deep
    ones of ~1,000 events in the class the split moves, then
    ``admin.reshard_split(0)`` and ``reshard_merge`` back, each with 64
    workflows started and the deep ones signalled while its flush runs;
    after each plan: committed at the next epoch, every row on the shard
    its workflow routes to, every moved open workflow's state on its new
    owner and the warm's device result equal to the host replay at its
    tip, no host rebuild; then every scheduled decision in matching and,
    past the short timeout, every short timer fired; the flush's
    ``rebuild_many`` split and the FSM kernel at its batch against its
    bound; (c) the reference bench's ``reshard_live`` cell (16 s of load,
    a split mid-run); (d) its ``capacity_diurnal`` cell on the card's
    ``ResidentEngine`` (the setpoint tracks the curve both ways, no
    operator call, no freeze), then the autopilot's topology loop: a
    hotspot on one shard of a 2-shard Onebox twin until the controller
    splits it on the card, then idle until it merges. FSM launches by
    route, counted on the launching thread: the reshard flush, the warm
    and the diurnal engine;
15. ``worker_store``: the worker services (``cadence_tpu_torch/worker``)
    and the durable sqlite store (``runtime/persistence/sqlite.py``, the
    ``SqliteCheckpointStore``): (a) ``durable_rebuild``, phase 8's
    ``rebuild_warm`` cohort's first 64 runs written into a sqlite file
    one transaction a batch (commits/s), then phase 8's prefix, cold and
    warm passes with
    ``rebuild_many`` over that bundle and its checkpoint store, every run
    against the host replay over the same store and phase 8's
    memory-store result, the read/dispatch/rehydrate split beside phase
    8's, and the FSM kernel at the cold batch; (b) ``worker_services``:
    the Onebox twin over a sqlite file with the worker services on (the
    default), 4 shards, checkpoints, a resident engine and 16 SDK
    workers; 128 workflows run to completion and archived (history and
    visibility, ``file://``), 8 parents of 4 children closed under the
    parent-close policy (inline, and offloaded to its system workflow),
    64 open workflows read twice through ``serving_read`` (every read
    against the host replay) then terminated by one batch workflow
    through a visibility query, the retention delete of every closed run
    with every history then read from the archive, the indexer's
    visibility counts, 64 orphan history trees and two scavenger passes;
    close-to-archived p50/p99, the batch's and a pass's wall, commits/s,
    FSM launches by route; (c) ``push_replication``: the standby's
    ``WorkerService`` applying the active's published replication tasks
    (512 workflows, 2,560 tasks) and its domain records, every state and
    history equal on both sides;
16. ``entry_points``: the server's entry points (``cadence_tpu_torch/
    rpc``, ``client/routed.py``, ``config``, ``tools/cli.py``,
    ``canary``, ``utils/pprof.py``) over gRPC: (a) ``config_host``, a
    host booted by ``start_services`` from a config (a YAML file too),
    memory store, 4 shards, the four services on loopback ports, the
    serving section on at 512 lanes; 512 workflows started through a
    ``RemoteFrontend`` (every fourth with an activity) and answered by 8
    SDK workers over gRPC, a signal each, ``RemoteHistory.serving_read``
    of every workflow (a cold miss that seats it), a second signal each,
    a second read (resident, its tick composing the signal), every read
    against the host replay of the history fetched over the wire at its
    tip, then the canary's 20 probes over gRPC; host-clock p50/p99 per
    verb over the wire beside phase 12's in-process figures, sustained
    verbs/s, FSM launches by route, the device-busy share of 256 cold
    reads; (c) ``cli``: the operator CLI in subprocesses against (a)'s
    frontend (domain register and describe, workflow start, signal,
    observe and show, admin describe-host, queue-state and dlq read, a
    canary), each output against the in-process answer, the schema
    verbs, the CLI's Onebox server started, pinged and ended by SIGTERM,
    and a pprof device trace around one serving tick that must name the
    FSM kernel; (b) ``two_process``: the CLI's ``server --config
    --services history,matching`` in a child process on the card over a
    shared sqlite file, 16 shards, the frontend alone in the script's
    process; 256 workflows through it, a signal each, a ``serving_read``
    each over the child's history endpoint against the host replay, the
    child ended by SIGTERM with exit code 0;
17. ``chaos``: fault injection and the witnesses (``cadence_tpu_torch/
    testing/faults.py``, ``effect_witness.py``, ``race_witness.py``,
    ``utils/locks.py``, ``analysis/lock_order.py``), the reference chaos
    suite's shapes at card size: (a) ``chaos_differential``, 256
    chained-doubler workflows on a clean Onebox twin (4 shards, frozen
    clock, pinned poll nonce, serving and checkpoints) and on one under
    the suite's write-fault schedule (seed 1234) with the effect recorder
    on: every history byte-identical across the arms, every rule fired,
    a ``serving_read`` of each workflow and one ``rebuild_many`` of all
    256 on the card against the host replay, no effect outside its
    footprint; (b) ``checkpoint_serving_chaos``, 256 retry_deep runs
    rebuilt twice (a prefix pass, a warm pass after the tails) through a
    checkpoint store that errs on 15% of its calls and tears 25% of its
    writes, against a fault-free rebuilder and the host, then a
    1,024-lane ``ResidentEngine`` seated, ticked, drained and re-admitted
    with 25% of its checkpoint calls failing and then with every flush
    write failing, its reads against the fault-free engine's; (c)
    ``sanitized_onebox``, the sanitizer's acceptance drive on the card
    (64 workflows under the race witness, a cold and a resident read
    each), ``check_race_witness`` against the port's static lock graph,
    every declared guarded field built, a baselined entry observed, the
    engine lock's held-time p99. ``host_fallbacks`` stays 0 throughout;
18. ``analysis``: the static-analysis gate and the trace demo
    (``cadence_tpu_torch/analysis``, ``testing/trace_demo.py``), (a) and
    (c) in child processes started together beside (b): (a)
    ``python -m cadence_tpu_torch.analysis --strict-stale --device cuda``
    (its surface pass probes the FSM kernel on the card), exit 0,
    findings by pass, baselined and stale counts, wall;
    (b) the transition-surface probe on the card: ``replay_rows`` on
    int32 events and on the int16 narrow stream and ``replay_rows_packed``
    (one segment a lane), every group's probed matrix against the plain
    step's label for label, every probe's rows bit for bit, and
    ``diff_surface`` exactly the baselined findings; then every affine
    group through ``replay_assoc(impl="segscan")`` on the card, its
    written sets and rows against the FSM's; launches and wall of each
    arm; (c) ``python -m cadence_tpu_torch.testing.trace_demo`` on the
    card, exit 0, its span count and services;
19. the refresh's line (``device_passes``: torch ops, no kernel of its
    own), the kernel list with launch counts on the main paths, then the
    device line.

Any failure exits non-zero without the final line. Needs one CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time
import types
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


def graph_ms_each(torch, fn, reps: int = 21):
    """Device milliseconds of each of ``reps`` replays of a CUDA graph
    that captured one call of ``fn`` (one pair of CUDA events a replay):
    the device's time for the call's work without the host's launch
    overhead. ``fn`` warms up on a side stream first, as capture asks."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    each = cuda_ms_each(graph.replay, reps=reps)
    del graph
    return each


def median_split(each):
    """{"": median, "_min": least, "_max": largest} of a list of ms."""
    each = sorted(each)
    return {"": each[len(each) // 2], "_min": each[0], "_max": each[-1]}


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
    """The refresh of a device-resident ``final`` on the card, timed three
    ways: the median of 21 CUDA-event timings around its eager launches
    (``ms``: the host's launch rate shows in it), the summed device time
    of its launches under torch.profiler (``device_ms``) and the median
    of 21 replays of a CUDA graph of it (``graph_ms``); its device
    launches, its bound, and every field against the same refresh on
    the CPU."""
    got = R.refresh_tasks_device(final)
    torch.cuda.synchronize()
    want = R.refresh_tasks_device(final.map(lambda x: x.cpu()))
    diverged = [f for f in R.FIELDS
                if getattr(got, f).dtype != getattr(want, f).dtype
                or not torch.equal(getattr(got, f).cpu(), getattr(want, f))]
    each = sorted(cuda_ms_each(lambda: R.refresh_tasks_device(final)))
    prof = device_busy(torch, lambda: R.refresh_tasks_device(final))
    graph = median_split(graph_ms_each(
        torch, lambda: R.refresh_tasks_device(final)))
    rec = dict(lanes=final.exec_info.shape[0], ms=each[len(each) // 2],
               ms_min=each[0], ms_max=each[-1],
               device_ms=prof["device_ms"],
               device_busy_ms=prof["device_busy_ms"],
               **{f"graph_ms{k}": v for k, v in graph.items()},
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
    the host refresher on the rehydrated rows. The step and its refresh
    are each timed three ways (``refresh_on_card``): eager CUDA events,
    summed device time, a CUDA graph's replay; the step's device time
    and its graph must exceed its refresh's."""
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
    step_prof = device_busy(torch, step)
    step_graph = median_split(graph_ms_each(torch, step, reps=11))

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
               step_device_ms=step_prof["device_ms"],
               step_launches=step_prof["device_activities"],
               **{f"step_graph_ms{k}": v for k, v in step_graph.items()},
               histories_per_sec=n / (step_ms * 1e-3),
               refreshed_to_numpy_s=d2h_s, hydrate_sample=len(sample),
               hydrate_tasks=n_tasks, hydrate_mismatches=mism)
    check(mism == 0, f"{mism} hydrated lanes differ from the host refresher")
    check(rec["step_device_ms"] > rec["device_ms"]
          and rec["step_graph_ms"] > rec["graph_ms"],
          "the replay + refresh step took less device time than its "
          f"refresh: {rec}")
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


# -- device-step telemetry (phases 4, 7, 8) -------------------------------


def registry_log(scope):
    """Every gauge and timer sample written to ``scope``'s registry, in
    the order written: a gauge keeps only its last value, a timer only
    its histogram, and the checks below read each batch's."""
    log = []
    reg = scope.registry
    for kind in ("gauge", "record"):
        def logged(name, tags, value, write=getattr(reg, kind)):
            log.append((name, dict(tags), value))
            write(name, tags, value)
        setattr(reg, kind, logged)
    return log


def device_telemetry(np, scope, log, packs, mode, kernel_ms=None):
    """The dispatcher's device-step telemetry of one wired run against
    the batches it ran (``packs``: their packers' ``PackedLanes``, in
    submission order) and, where given, each batch's FSM kernel ms:
    ``device_batches`` and the stage and step counts equal the batches,
    the ``batch_width`` counters sum to them (one per lane count), every
    batch's ``lane_occupancy`` is above 0 and equals its packer's, its
    ``padding_frac`` equals its packer's, no kernel library was loaded
    after the warm-up (``jit_retraces`` 0), and each batch's step took at
    least its kernel's time, the step p50 at least the kernels' median.
    Returns the record; fails the run where a check does not hold."""
    reg = scope.registry

    def logged(name):
        return [v for n, t, v in log
                if n == name and t.get("layer") == "device"]
    step_s, stage_s = logged("device_step_seconds"), logged(
        "host_stage_seconds")
    occ, pad = logged("lane_occupancy"), logged("padding_frac")
    with reg._lock:
        widths = {dict(t)["width"]: v for (n, t), v in reg._counters.items()
                  if n == "batch_width"}
    from collections import Counter

    want_widths = Counter(str(p.lanes) for p in packs)
    n = len(packs)
    rec = dict(
        mode=mode, batches=n,
        device_batches=reg.counter_value("device_batches"),
        device_batches_in_mode=reg.counter_value("device_batches", {
            "layer": "device", "kernel": "cuda", "mode": mode}),
        host_stage_n=reg.timer_stats("host_stage_seconds").count,
        device_step_n=reg.timer_stats("device_step_seconds").count,
        batch_width=widths, lane_occupancy=occ,
        padding_frac=pad, packer_padding_frac=[p.padding_frac for p in packs],
        jit_cache_entries=reg.gauge_value("jit_cache_entries"),
        jit_retraces=reg.counter_value("jit_retraces"),
        host_stage_ms=[x * 1e3 for x in stage_s],
        device_step_ms=[x * 1e3 for x in step_s],
        device_step_p50_ms=reg.timer_quantile("device_step_seconds", 0.5)
        * 1e3, kernel_ms=kernel_ms)
    check(rec["device_batches"] == rec["device_batches_in_mode"] == n
          == rec["host_stage_n"] == rec["device_step_n"] == len(step_s)
          == len(stage_s), f"device telemetry counted other batches than "
          f"the {n} that ran: {rec}")
    check(widths == want_widths, f"batch_width {widths} against the "
          f"packers' lane counts {dict(want_widths)}")
    check(occ == [p.n_histories / p.lanes for p in packs]
          and all(x > 0 for x in occ),
          f"lane_occupancy {occ} against the packers'")
    check(pad == rec["packer_padding_frac"],
          f"padding_frac {pad} against the packers' "
          f"{rec['packer_padding_frac']}")
    check(rec["jit_retraces"] == 0,
          f"{rec['jit_retraces']} kernel libraries loaded after the warm-up")
    if kernel_ms is not None:
        check(len(kernel_ms) == n and all(
            s * 1e3 >= k for s, k in zip(step_s, kernel_ms))
            and rec["device_step_p50_ms"] >= float(np.median(kernel_ms)),
            f"a device step took less than its FSM kernel: {rec}")
    return rec


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


def warm_cohort(hist=None, n=None):
    """bench.py's rebuild_warm cohort: retry_deep histories cut where
    the last ``WARM_TAIL`` of their events starts (at least the start
    batch kept); the prefixes go to ``hist`` (a memory history store by
    default), the tails wait to be appended after the prefix pass.
    ``write_s`` is the prefixes' write. ``n`` (default ``WARM_N``) takes
    the cohort's first runs."""
    from cadence_tpu_torch.runtime.persistence.memory import (
        MemoryHistoryManager)
    from cadence_tpu_torch.testing import workloads as W

    rng = random.Random(45)
    full, cuts = [], []
    total = suffix = 0
    for _ in range(WARM_N if n is None else n):
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
    hist = MemoryHistoryManager() if hist is None else hist
    t0 = time.perf_counter()
    reqs = [store_run(hist, i, b[:c])
            for i, (b, c) in enumerate(zip(full, cuts))]
    return dict(hist=hist, reqs=reqs, full=full, cuts=cuts,
                total_events=total, suffix_events=suffix,
                write_s=time.perf_counter() - t0,
                prefix_batches=sum(cuts))


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
    reqs, hs, events = [], [], 0
    for i in range(STORM_N):
        batches = W.ndc_storm_history(HistoryFuzzer(seed=STORM_SEED + i),
                                      depth=STORM_DEPTH)
        events += sum(len(b) for b in batches)
        reqs.append(store_run(hist, i, batches))
        hs.append((f"wf-{i}", f"run-{i}", batches))
    return dict(hist=hist, reqs=reqs, hs=hs, events=events)


def rebuild_packs(P, hs):
    """The lane packs the rebuilder's dispatcher makes of histories
    ``hs`` on the card: one batch a depth bucket at the default
    capacities, segments aligned to its ``tb``."""
    from cadence_tpu_torch.ops.dispatch import depth_buckets
    from cadence_tpu_torch.ops.schema import Capacities

    return [P.pack_lanes(bhs, caps=Capacities(),
                         target_lane_len=REBUILD_LANE_LEN, seg_align=16)
            for _, bhs in depth_buckets(hs)]


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


def phase_rebuild(torch, np, P, unpack, RC):
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
    # device-step telemetry: the cohort's cold pass without a metrics
    # scope, then with a fresh one (cold_scope above carries it too); the
    # difference is the price of the mode's synchronise per batch
    t0 = time.perf_counter()
    bare_out = StateRebuilder(hist, lane_len=REBUILD_LANE_LEN).rebuild_many(
        reqs)
    bare_s = time.perf_counter() - t0
    tele_scope = Scope()
    tele_log = registry_log(tele_scope)
    t0 = time.perf_counter()
    tele_out = StateRebuilder(hist, lane_len=REBUILD_LANE_LEN,
                              metrics=tele_scope).rebuild_many(reqs)
    tele_s = time.perf_counter() - t0
    one_scope = Scope()
    one = StateRebuilder(hist, lane_len=REBUILD_LANE_LEN, metrics=one_scope)
    # each request also through a rebuilder without a scope, the two
    # arms alternating which goes first: telemetry's price on one request
    bare_one = StateRebuilder(hist, lane_len=REBUILD_LANE_LEN)
    one_ms, one_out, bare_ms = [], [], []
    for k, r in enumerate(reqs[:P50_REQUESTS]):
        arms = [(one, one_ms, one_out), (bare_one, bare_ms, [])]
        for rb, ms, out in arms if k % 2 == 0 else arms[::-1]:
            t0 = time.perf_counter()
            out += rb.rebuild_many([r])
            ms.append((time.perf_counter() - t0) * 1e3)
    storm_scope = Scope()
    storm_log = registry_log(storm_scope)
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
    # the storm's sample once more on the card, without a metrics scope
    storm_bare = StateRebuilder(
        storm["hist"], lane_len=REBUILD_LANE_LEN).rebuild_many(
            [storm["reqs"][i] for i in sample])
    mism = {name: sum(rebuild_key(unpack, g) != w
                      for g, w in zip(out, oracle))
            for name, out in (("cold", cold_out), ("warm", warm_out),
                              ("one_request", one_out),
                              ("cold_unwired", bare_out),
                              ("cold_wired", tele_out))}
    mism["storm_sample"] = storm_mism
    mism["storm_sample_unwired"] = sum(
        rebuild_key(unpack, storm_out[i]) != rebuild_key(unpack, b)
        for i, b in zip(sample, storm_bare))
    storm_tele = device_telemetry(np, storm_scope, storm_log,
                                  rebuild_packs(P, storm["hs"]), "lanes",
                                  storm_fsm_ms)
    c["telemetry"] = dict(scope=tele_scope, log=tele_log,
                          rehydrated=tele_scope.registry.timer_stats(
                              "rehydrate").count,
                          wired_s=tele_s, unwired_s=bare_s, storm=storm_tele)

    # phase 15 holds its durable rebuilds against these
    c["cold_keys"] = [rebuild_key(unpack, g) for g in cold_out]
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
            "card_unwired": percentiles(np, bare_ms),
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
            "device_telemetry": storm_tele,
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


def rebuild_telemetry(np, c, rebuild_kernel, smi):
    """The cohort's wired cold pass (phase 8) against the batches the
    dispatcher ran (``time_rebuild_kernel``'s packs), each step against
    the FSM kernel's CUDA-event time at that batch (int16: the
    dispatcher narrows), its wall beside the unwired pass's; emits the
    line."""
    t, packs = c["telemetry"], c["packs"]
    rec = device_telemetry(np, t["scope"], t["log"], packs, "lanes",
                           [r["int16"]["ms"] for r in rebuild_kernel])
    check(t["rehydrated"] == len(packs), f"the wired pass rehydrated "
          f"{t['rehydrated']} batches, not {len(packs)}")
    emit({"phase": "rebuild_telemetry", "histories": WARM_N,
          "cold_pass_wired_s": t["wired_s"],
          "cold_pass_unwired_s": t["unwired_s"],
          "wired_over_unwired": t["wired_s"] / t["unwired_s"],
          "rebuild_warm": rec, "ndc_storm": t["storm"], "nvidia_smi": smi})


def time_rebuild_kernel(torch, np, S, P, RC, c):
    """The FSM kernel at the cold pass's batch: the cohort's histories
    packed as the dispatcher packs them, at the rebuilder's default
    capacities. There R_pad is 944 (152 at the retry_deep caps): a block
    holds 32 lanes, one warp an SM, and 256 histories fill 8 of the
    card's 132 SMs, so the launch is latency-bound."""
    caps = S.Capacities()
    hs = [(f"wf-{i}", f"run-{i}", b) for i, b in enumerate(c["full"])]
    c["packs"] = rebuild_packs(P, hs)
    rec = time_packed(torch, np, S, RC, caps,
                      [(None, p, None) for p in c["packs"]])
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
# workflows, whose first serving_read is a cold miss; 2 rounds of a signal
# and a serving_read on every workflow (cut from 4 so that phase 12 fits
# the command's time limit); the rounds' device-busy share is profiled on
# this round (0-based)
SVC_SHARDS, SVC_WORKFLOWS, SVC_UNSEATED, SVC_ROUNDS = 4, 4096, 64, 2
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


# phase 12, the frontend and the worker SDK: the port's Onebox twin with
# the history host's resident engine (a lane a workflow, the serving
# caps) answered by 16 SDK workers on one task list, sticky on, as a
# fleet of worker processes polls it. 1,024 workflows (4,096, the history
# host's size, until phase 15 needed the run's time: a slow host took
# 145 s for them; 2,048 until phase 18 needed it: a slow host ran the
# whole script in 1,052.5 s) started through the frontend (every fourth
# runs one activity, each then loops on a "ping" signal), then
# serve_demo's open-loop burst: 2,048 requests (2 a workflow,
# round-robin) on
# ArrivalProcess(qps=300,
# kind="bursty", seed=11), each a frontend signal and a serving_read, the
# first read of a workflow a cold miss that seats it; then queries and
# histories of a seeded 256, the visibility counts, and the drain. The
# requests due at one moment form a batch (signals, then reads), whose
# first read ticks; a burst that keeps its schedule makes batches of a
# request or two, so the round-robin reads a lane about once per 1,024
# ticks. A lane stays seated while idle for fewer than FE_IDLE_TICKS
# ticks (the engine's default, 256, would evict it between its reads)
FE_SHARDS, FE_WORKFLOWS, FE_WORKERS, FE_ACTIVITY_EVERY = 4, 1024, 16, 4
FE_QPS, FE_REQUESTS, FE_ARRIVAL_SEED = 300.0, 2048, 11
FE_SAMPLE, FE_SAMPLE_SEED, FE_BUSY_REQUESTS = 256, 12, 1024
FE_IDLE_TICKS = 2 * FE_WORKFLOWS
FE_DOMAIN, FE_TASK_LIST, FE_WAIT_S = "fe-domain", "fe-tl", 600.0


class FrontendRoutes:
    """FSM launches of the frontend phase's serving reads, by route: the
    Δ composition of a tick (the engine's ``_compose``) and the cold
    misses that seat a workflow (``read_through``). A launch counts to
    the innermost route running: a cold miss that ticks a dirty lane
    counts that tick's launch as a tick. ``prefix`` names the phase."""

    def __init__(self, RC, prefix="frontend"):
        self.RC = RC
        self.tick, self.cold = f"{prefix}_tick", f"{prefix}_cold_miss"
        self.counts = {self.tick: 0, self.cold: 0}
        self._inner = [0]

    def wrap(self, engine):
        engine._compose = self._counted(engine._compose, self.tick)
        engine.read_through = self._counted(engine.read_through, self.cold)
        return engine

    def _counted(self, fn, route):
        def call(*a, **k):
            start = self.RC.replay_rows.launches
            self._inner.append(0)
            try:
                return fn(*a, **k)
            finally:
                nested = self._inner.pop()
                made = self.RC.replay_rows.launches - start
                self.counts[route] += made - nested
                self._inner[-1] += made
        return call


def fe_workflow(seen):
    """The phase's workflow type: every fourth workflow runs one
    activity, then each loops on the "ping" signal. ``seen`` maps a
    workflow's input to the signals its last decision consumed, which
    the query handler answers (a handler sees no history)."""

    def run(ctx, input):
        if int(input) % FE_ACTIVITY_EVERY == 0:
            yield ctx.schedule_activity("fe-work", input)
        n = 0
        while True:
            yield ctx.wait_signal("ping")
            n += 1
            seen[input] = n
    return run


def fe_timed(fn, lat):
    """``fn`` with the wall of each call that returned True appended."""
    def call(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if out:
            lat.append((time.perf_counter() - t0) * 1e3)
        return out
    return call


def fe_settled(box, domain_id, runs, shard_for=None):
    """Workflows with a decision or an activity still outstanding, read
    from ``box``'s store (a shard a workflow by its history controller,
    or by ``shard_for`` on a host that runs none)."""
    from cadence_tpu_torch.core.ids import EMPTY_EVENT_ID

    ex = box.persistence.execution
    shard_for = shard_for or box.history.controller.shard_for
    out = []
    for wf, run in runs.items():
        snap = ex.get_workflow_execution(
            shard_for(wf), domain_id, wf, run).snapshot
        if (snap["execution_info"]["decision_schedule_id"]
                != EMPTY_EVENT_ID or snap["pending_activities"]):
            out.append(wf)
    return out


def fe_wait_settled(box, domain_id, runs, what, shard_for=None):
    t0 = time.perf_counter()
    while True:
        left = fe_settled(box, domain_id, runs, shard_for)
        if not left:
            return time.perf_counter() - t0
        check(time.perf_counter() - t0 < FE_WAIT_S,
              f"{len(left)} workflows still have work outstanding after "
              f"{what}, first {left[:3]}")
        time.sleep(0.2)


def fe_branch(box, domain_id, wf, run):
    shard = box.history.controller.shard_for(wf)
    return box.persistence.execution.get_workflow_execution(
        shard, domain_id, wf, run).snapshot["execution_info"]["branch_token"]


def phase_frontend(torch, np, S, RC, smi, device="cuda"):
    """Phase 12: the port's frontend and SDK workers over the history
    host on the card. Returns FSM launches by route and the host-clock
    percentiles of each verb."""
    from cadence_tpu_torch.checkpoint import CheckpointManager
    from cadence_tpu_torch.core.enums import EventType
    from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot
    from cadence_tpu_torch.runtime.api import (
        SignalRequest, StartWorkflowRequest)
    from cadence_tpu_torch.runtime.persistence.memory import (
        create_memory_bundle)
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        RebuildRequest, StateRebuilder)
    from cadence_tpu_torch.serving import ArrivalProcess, ResidentEngine
    from cadence_tpu_torch.testing.onebox import Onebox
    from cadence_tpu_torch.utils.metrics import Scope
    from cadence_tpu_torch.worker import Worker

    t_phase = time.perf_counter()
    n = FE_WORKFLOWS
    routes = FrontendRoutes(RC)
    persistence = create_memory_bundle()
    checkpoints = CheckpointManager(persistence.checkpoint)
    engine_scope = Scope()
    engine = routes.wrap(ResidentEngine(
        lanes=n, caps=S.Capacities(**SERVE_CAPS), checkpoints=checkpoints,
        history=persistence.history, metrics=engine_scope,
        idle_ticks=FE_IDLE_TICKS, device=device))
    box = Onebox(num_shards=FE_SHARDS, persistence=persistence,
                 checkpoints=checkpoints, serving=engine,
                 start_worker=False, device=device).start()
    lat = {k: [] for k in ("start", "signal", "cold_read", "resident_read",
                           "request", "query", "sdk_decision")}
    seen, workers, drained = {}, [], []
    wfs = [f"fe-wf-{i:05d}" for i in range(n)]
    try:
        domain_id = box.domain_handler.register_domain(FE_DOMAIN)
        for k in range(FE_WORKERS):
            w = Worker(box.frontend, FE_DOMAIN, FE_TASK_LIST,
                       identity=f"fe-worker-{k}")
            w.register_workflow("fe-signal-sink", fe_workflow(seen))
            w.register_activity("fe-work", lambda b: b"done:" + b)
            w.register_query_handler(
                "fe-signal-sink",
                lambda qtype, args: b"%d" % seen.get(args, 0))
            w.decisions.poll_and_process_one = fe_timed(
                w.decisions.poll_and_process_one, lat["sdk_decision"])
            workers.append(w)
            w.start()

        # (a) starts through the frontend; the workers take the first
        # decisions and the activity round trips meanwhile
        runs = {}
        t0 = time.perf_counter()
        for i, wf in enumerate(wfs):
            t1 = time.perf_counter()
            runs[wf] = box.frontend.start_workflow_execution(
                StartWorkflowRequest(
                    domain=FE_DOMAIN, workflow_id=wf,
                    workflow_type="fe-signal-sink", task_list=FE_TASK_LIST,
                    input=b"%d" % i, request_id=f"fe-start-{i}",
                    execution_start_to_close_timeout_seconds=36000,
                    task_start_to_close_timeout_seconds=3600))
            lat["start"].append((time.perf_counter() - t1) * 1e3)
        start_s = time.perf_counter() - t0
        settle_s = fe_wait_settled(box, domain_id, runs,
                                   "the first decisions")
        decisions_before_burst = len(lat["sdk_decision"])

        # (b) the open-loop burst: a signal, then a serving read
        schedule = ArrivalProcess(qps=FE_QPS, kind="bursty",
                                  seed=FE_ARRIVAL_SEED).schedule(FE_REQUESTS)
        reads, req_batches = [], []
        busy_from = n + (n - FE_BUSY_REQUESTS) // 2
        window = range(busy_from, busy_from + FE_BUSY_REQUESTS)
        t_burst = time.perf_counter()

        def serve(lo, hi):
            """Requests [lo, hi) on their schedule, as the open-loop
            harness takes them: every request due by now is one batch,
            its signals first, then its reads in arrival order (the
            first read's tick composes every dirty lane)."""
            i = lo
            while i < hi:
                now = time.perf_counter() - t_burst
                if schedule[i] > now:
                    time.sleep(schedule[i] - now)
                    now = schedule[i]
                j = i + 1
                while j < hi and schedule[j] <= now:
                    j += 1
                req_batches.append(j - i)
                for k in range(i, j):
                    wf = wfs[k % n]
                    t1 = time.perf_counter()
                    box.frontend.signal_workflow_execution(SignalRequest(
                        domain=FE_DOMAIN, workflow_id=wf,
                        signal_name="ping", input=b"%d" % k,
                        identity="fe-caller", request_id=f"fe-sig-{k}"))
                    lat["signal"].append((time.perf_counter() - t1) * 1e3)
                for k in range(i, j):
                    wf = wfs[k % n]
                    t1 = time.perf_counter()
                    got = box.history.serving_read(domain_id, wf, runs[wf])
                    t2 = time.perf_counter()
                    lat["cold_read" if k < n else "resident_read"].append(
                        (t2 - t1) * 1e3)
                    lat["request"].append(
                        (t2 - t_burst - schedule[k]) * 1e3)
                    check(got is not None, f"serving_read of {wf} is None")
                    reads.append((wf, got))
                i = j

        serve(0, window.start)
        busy = device_busy(torch, lambda: serve(window.start, window.stop))
        serve(window.stop, FE_REQUESTS)
        burst_s = time.perf_counter() - t_burst
        seat_by_miss_s = sum(lat["cold_read"]) / 1e3
        counters = {
            "serving_resident_hits": box.metrics.registry.counter_value(
                "serving_resident_hits"),
            **serve_counters(engine_scope.registry, "serving_cold_misses",
                             "serving_events_replayed", "serving_ticks",
                             "serving_compose_failures",
                             "serving_cold_read_failures")}
        engine_timers = {}
        for name in ("serving_tick_seconds", "serving_tick_pack",
                     "serving_tick_replay", "serving_tick_commit",
                     "serving_read_seconds"):
            st = engine_scope.registry.timer_stats(name)
            engine_timers[name] = {
                "n": st[0], "total_ms": st[1] * 1e3,
                "p50": st.p50 * 1e3, "p99": st.p99 * 1e3}
        settle_after_s = fe_wait_settled(box, domain_id, runs,
                                         "the burst's decisions")

        # (c) queries the SDK answers, histories, visibility
        sample = sorted(random.Random(FE_SAMPLE_SEED).sample(wfs, FE_SAMPLE))
        answers = {}
        for wf in sample:
            t1 = time.perf_counter()
            answers[wf] = box.frontend.query_workflow(
                FE_DOMAIN, wf, query_type="signals",
                query_args=b"%d" % wfs.index(wf), timeout_s=60.0)
            lat["query"].append((time.perf_counter() - t1) * 1e3)
        delivered = {wf: FE_REQUESTS // n for wf in wfs}
        bad_queries = [wf for wf in sample
                       if answers[wf] != b"%d" % delivered[wf]]
        histories, bad_histories = {}, []
        t0 = time.perf_counter()
        for wf in wfs:
            histories[wf] = [e for b in svc_batches(
                box, fe_branch(box, domain_id, wf, runs[wf])) for e in b]
        for wf in sample:
            events, token = box.frontend.get_workflow_execution_history(
                FE_DOMAIN, wf, runs[wf])
            if token or [e.to_dict() for e in events] != [
                    e.to_dict() for e in histories[wf]]:
                bad_histories.append(wf)
        failed_decisions = [
            wf for wf, h in histories.items()
            if any(e.event_type == EventType.DecisionTaskFailed for e in h)]
        open_count = box.frontend.count_workflow_executions(FE_DOMAIN)
        listed, token = [], 0
        while True:
            page, token = box.frontend.list_open_workflow_executions(
                FE_DOMAIN, page_size=1000, next_token=token)
            listed.extend(page)
            if not token:
                break
        history_s = time.perf_counter() - t0

        # (d) every read against the host replay at the read's tip
        t0 = time.perf_counter()
        rb = StateRebuilder(box.persistence.history, device="cpu")
        tokens = {wf: fe_branch(box, domain_id, wf, runs[wf]) for wf in wfs}
        mismatches = []
        for k, (wf, got) in enumerate(reads):
            tip = got.snapshot["exec"]["next_event_id"]
            ms, _, _ = rb.rebuild(RebuildRequest(
                domain_id, wf, runs[wf], tokens[wf], next_event_id=tip))
            if got.snapshot != mutable_state_to_snapshot(ms):
                mismatches.append((k, wf))
        oracle_s = time.perf_counter() - t0

        # (e) the workers stop; stop() drains the engine
        t0 = time.perf_counter()
        for w in workers:
            w.stop()
        workers_stop_s = time.perf_counter() - t0
        orig_drain = engine.drain
        engine.drain = lambda: drained.append(orig_drain()) or drained[-1]
        t0 = time.perf_counter()
        box.stop()
        stop_s = time.perf_counter() - t0
        occupancy = engine.occupancy()
        seated_after = engine.describe()["seated"]
    finally:
        for w in workers:
            w.stop()
        if not drained:
            box.stop()
    host_ms = {k: percentiles(np, v) for k, v in lat.items()}
    emit({"phase": "frontend", "part": "latency", "workflows": n,
          "workers": FE_WORKERS, "shards": FE_SHARDS,
          "requests": FE_REQUESTS, "host_ms": host_ms,
          "nvidia_smi": smi})
    emit({"phase": "frontend", "part": "summary",
          "phase_s": time.perf_counter() - t_phase, "start_s": start_s,
          "settle_s": settle_s, "decisions_before_burst":
          decisions_before_burst, "burst_s": burst_s,
          "qps_target": FE_QPS, "qps_sustained": FE_REQUESTS / burst_s,
          "request_batches": len(req_batches),
          "request_batch_max": max(req_batches),
          "engine_timers_ms": engine_timers,
          "seat_by_miss_s": seat_by_miss_s,
          "settle_after_burst_s": settle_after_s,
          "history_and_visibility_s": history_s, "oracle_s": oracle_s,
          "workers_stop_s": workers_stop_s, "stop_s": stop_s,
          "counters": counters, "launches_by_route": dict(routes.counts),
          "device_busy": {"requests": [window.start, window.stop],
                          **busy},
          "queries": len(sample), "query_mismatches": len(bad_queries),
          "history_mismatches": len(bad_histories),
          "failed_decisions": len(failed_decisions),
          "open_count": open_count, "listed_open": len(listed),
          "oracle_mismatches": len(mismatches), "drain": drained,
          "occupancy_after": occupancy, "seated_after": seated_after,
          "nvidia_smi": smi})
    check(not mismatches, f"{len(mismatches)} of {len(reads)} reads differ "
          f"from the host replay at their tip, first {mismatches[:3]}")
    check(counters["serving_resident_hits"] >= FE_REQUESTS - n,
          f"resident hits {counters['serving_resident_hits']} < "
          f"{FE_REQUESTS} requests - {n} workflows")
    check(not failed_decisions, f"{len(failed_decisions)} histories hold a "
          f"DecisionTaskFailed, first {failed_decisions[:3]}")
    check(not bad_queries, f"{len(bad_queries)} query answers differ from "
          f"the signals delivered, first {bad_queries[:3]}")
    check(not bad_histories, f"{len(bad_histories)} frontend histories "
          f"differ from the store's, first {bad_histories[:3]}")
    check(open_count == n and len(listed) == n,
          f"open count {open_count}, listed {len(listed)}, want {n}")
    check(len(drained) == 1 and drained[0]["flush_failed"] == 0
          and drained[0]["flushed"] >= 1,
          f"the drain at stop() did not flush cleanly: {drained}")
    check(occupancy == 0 and seated_after == 0,
          "the engine is not empty after stop()")
    for route, k in routes.counts.items():
        check(k > 0, f"the frontend phase made no {route} launch")
    return dict(routes.counts), host_ms


# -- phase 13: the replication planes ------------------------------------

# phase 13, the replication planes. (a) xdc: two port clusters of 4
# shards each (one history host a side, as phases 11-12) sharing a global
# domain (clusters active and standby, failover version increment 10);
# 1,024 workflows (4,096 until phase 15 needed the run's time: a slow
# host took 133 s for them; 2,048 until phase 18's whole run took 1,091 s
# of the 1,200 s limit, this part 66 s of it) started on the active and
# signalled 4 times each, no worker, so every write mints one
# replication task (5,120); the
# standby, down meanwhile, then comes up and pulls through
# enable_replication_from over an unthrottled simulated link; a managed
# handover to the standby, one signal a workflow there, the drain back.
# (b1) the >=10k-task storm of the reference's replication-storm test
# (3,334 workflows x 3 tasks) on a 1-shard standby in one cycle. (b2) a
# conflict storm at 1k depth: the first 64 of phase 8's rebuild_warm
# cohort (retry_deep histories of depth 1,000 from random.Random(45); 256
# until phase 15 needed the run's time: the seeding, task by task, took
# 51 s on a fast host and 82 s for 128 on a slow one) seeded at version 1
# in fetch pages of 512 tasks, then one cycle of a divergent tail each at
# version 12. (c) the reference bench's replication_lag and failover_drill
# cells at their own sizes (bench.py:2401-2402,
# :2407-2408)
XDC_SHARDS, XDC_WORKFLOWS, XDC_SIGNALS, XDC_PAYLOAD = 4, 1024, 4, 96
REPL_DOMAIN, REPL_DOMAIN_ID, XDC_TASK_LIST = (
    "repl-domain", "repl-domain-0000", "repl-tl")
STORM10K_N, STORM10K_SAMPLE, STORM10K_SEED = 3334, 64, 13
DEEP_N, DEEP_DEPTH, DEEP_SEED, DEEP_PAGE = 64, 1000, 45, 512
DEEP_VERSION, DEEP_SAMPLE, DEEP_SAMPLE_SEED = 12, 16, 14
INSTALL_N, INSTALL_BEFORE, INSTALL_AFTER = 64, 16, 112
LAG_CELL = dict(workflows=12, signals_each=48, bytes_per_s=131072.0)
DRILL_CELL = dict(workflows=6, signals_each=24, bytes_per_s=131072.0)
REPL_DRAIN_S, REPL_DISPATCH_S = 600.0, 300.0


class ThreadRoutes:
    """FSM launches by route, counted on the launching thread. Each
    wrapped site (``sites``: route -> (class, method)) tags its thread
    with its route and runs unserialised; a ``DeviceDispatcher`` made
    under a tag hands it to its run thread, and every FSM launch
    (``replay_cuda._launch``) on a tagged thread counts to that route.
    ``extra`` names routes tagged by hand (``run``). ``calls`` counts the
    calls."""

    def __init__(self, RC, sites, extra=()):
        import threading

        from cadence_tpu_torch.ops import dispatch as D

        self.RC = RC
        self._tag = threading.local()
        # held for an increment only, never around a call
        self._lock = threading.Lock()
        self.counts = dict.fromkeys([*sites, *extra], 0)
        self.calls = dict.fromkeys(self.counts, 0)
        Disp = D.DeviceDispatcher
        self._saved = [(cls, name, getattr(cls, name))
                       for cls, name in list(sites.values())
                       + [(Disp, "__init__"), (Disp, "_run_pump")]]
        self._saved_launch = RC._launch
        for route, (cls, name) in sites.items():
            setattr(cls, name, self._tagged(getattr(cls, name), route))
        tag, init, run, launch = (self._tag, Disp.__init__, Disp._run_pump,
                                  RC._launch)

        def disp_init(d, *a, **k):
            d._route = getattr(tag, "route", None)
            init(d, *a, **k)

        def disp_run(d):
            tag.route = d._route
            return run(d)

        def counted_launch(*a, **k):
            out = launch(*a, **k)
            route = getattr(tag, "route", None)
            if route is not None:
                with self._lock:
                    self.counts[route] += 1
            return out
        Disp.__init__, Disp._run_pump = disp_init, disp_run
        RC._launch = counted_launch

    def _tagged(self, fn, route):
        tag = self._tag

        def call(*a, **k):
            prev = getattr(tag, "route", None)
            tag.route = route
            with self._lock:
                self.calls[route] += 1
            try:
                return fn(*a, **k)
            finally:
                tag.route = prev
        return call

    def run(self, route, fn):
        """``fn()`` with its thread tagged ``route``."""
        return self._tagged(fn, route)()

    def restore(self):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        self.RC._launch = self._saved_launch


def ReplicationRoutes(RC):
    """FSM launches of the replication planes, by route: the batched
    drain's conflict rebuilds (``NDCHistoryReplicator._drain_deferred``),
    the active side's snapshot serve
    (``ReplicatorQueueProcessor.get_replication_checkpoint``), the
    standby's snapshot install (``NDCHistoryReplicator.
    apply_state_snapshot``) and, tagged by hand, the install drill's
    suffix resume on the installer's rebuilder (part (d))."""
    from cadence_tpu_torch.runtime.replication.ndc import (
        NDCHistoryReplicator)
    from cadence_tpu_torch.runtime.replication.replicator_queue import (
        ReplicatorQueueProcessor)

    return ThreadRoutes(RC, {
        "replication_conflict": (NDCHistoryReplicator, "_drain_deferred"),
        "replication_snapshot_serve": (ReplicatorQueueProcessor,
                                       "get_replication_checkpoint"),
        "replication_snapshot_install": (NDCHistoryReplicator,
                                         "apply_state_snapshot"),
    }, extra=("replication_install_resume",))


def repl_meta(current):
    from cadence_tpu_torch.cluster import ClusterInformation, ClusterMetadata

    return ClusterMetadata(
        failover_version_increment=10, master_cluster_name="active",
        current_cluster_name=current,
        cluster_info={
            "active": ClusterInformation(initial_failover_version=1),
            "standby": ClusterInformation(initial_failover_version=2),
        })


def repl_cluster(name, shards, device, domain=REPL_DOMAIN,
                 domain_id=REPL_DOMAIN_ID):
    """One port cluster as the reference bench wires one
    (bench.py:650-678): memory persistence, the global domain owned by
    the active cluster, a history service with the cluster metadata of
    ``name`` rebuilding on ``device``, matching and the clients. Not
    started."""
    from types import SimpleNamespace

    from cadence_tpu_torch.client import HistoryClient, MatchingClient
    from cadence_tpu_torch.matching import MatchingEngine
    from cadence_tpu_torch.runtime.domains import DomainCache, register_domain
    from cadence_tpu_torch.runtime.membership import single_host_monitor
    from cadence_tpu_torch.runtime.persistence.memory import (
        create_memory_bundle)
    from cadence_tpu_torch.runtime.service import HistoryService
    from cadence_tpu_torch.utils.metrics import Scope

    persistence = create_memory_bundle()
    domain_id = register_domain(
        persistence.metadata, domain, is_global=True,
        clusters=["active", "standby"], active_cluster="active",
        domain_id=domain_id, failover_version=1)
    domains = DomainCache(persistence.metadata)
    scope = Scope()
    svc = HistoryService(
        shards, persistence, domains, single_host_monitor(f"repl-{name}"),
        cluster_metadata=repl_meta(name), metrics=scope, device=device)
    hc = HistoryClient(svc.controller)
    matching = MatchingEngine(persistence.task, hc)
    svc.wire(MatchingClient(matching), hc)
    return SimpleNamespace(name=name, persistence=persistence,
                           domain=domain, domain_id=domain_id,
                           domains=domains, svc=svc, hc=hc,
                           matching=matching, scope=scope)


class ReplAdapter:
    """A remote cluster's replication verbs over an in-process peer's
    history service; ``consumer`` names the pulling cluster to the emit
    side's acks."""

    def __init__(self, svc, consumer):
        self.svc, self.consumer = svc, consumer

    def get_replication_messages(self, shard_id, last, max_tasks=None):
        return self.svc.get_replication_messages(
            shard_id, last, cluster=self.consumer, max_tasks=max_tasks)

    def get_workflow_history_raw(self, *a):
        return self.svc.get_workflow_history_raw(*a)

    def get_replication_backlog(self, shard_id, last):
        return self.svc.get_replication_backlog(shard_id, last)

    def get_replication_checkpoint(self, *a):
        return self.svc.get_replication_checkpoint(*a)


def repl_processors(svc):
    """The history service's pull-replication consumers, shard order."""
    from cadence_tpu_torch.runtime.replication import (
        ReplicationTaskProcessor)

    with svc.controller._lock:
        handles = sorted(svc.controller._handles.items())
    return [p for _, h in handles for p in h.processors
            if isinstance(p, ReplicationTaskProcessor)]


def repl_state(c, wf, run):
    """One run as the reference's storm test compares it: the canonical
    mutable-state snapshot and the version histories without branch
    tokens, read back through the engine's cache."""
    from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot

    engine = c.svc.controller.get_engine(wf)
    ctx = engine.cache.get_or_create(c.domain_id, wf, run)
    with ctx.lock:
        ctx.clear()
        ms = ctx.load()
    vhs = ms.version_histories.to_dict()
    for h in vhs["histories"]:
        h.pop("branch_token", None)
    return mutable_state_to_snapshot(ms), vhs


def repl_history(c, wf, run):
    engine = c.svc.controller.get_engine(wf)
    events, _ = engine.get_workflow_execution_history(c.domain, wf, run)
    return [e.to_dict() for e in events]


def repl_mismatches(a, b, runs):
    """(state mismatches, history mismatches) between clusters ``a`` and
    ``b`` over ``runs``."""
    states = hists = 0
    for wf, run in runs.items():
        states += repl_state(a, wf, run) != repl_state(b, wf, run)
        hists += repl_history(a, wf, run) != repl_history(b, wf, run)
    return states, hists


def repl_decision_tasks(c, task_list):
    """workflow id -> decision tasks waiting in ``c``'s matching store."""
    tasks = c.persistence.task.get_tasks(
        c.domain_id, task_list, 0, read_level=0, max_read_level=1 << 62,
        batch_size=1 << 30)
    out = {}
    for t in tasks:
        out[t.workflow_id] = out.get(t.workflow_id, 0) + 1
    return out


def repl_tips(c, runs):
    ex = c.persistence.execution
    out = {}
    for wf, run in runs.items():
        shard = c.svc.controller.shard_for(wf)
        try:
            out[wf] = ex.get_workflow_execution(
                shard, c.domain_id, wf, run).next_event_id - 1
        except Exception:
            out[wf] = 0
    return out


def phase_repl_xdc(torch, device):
    """(a): the live backlog, the catch-up, the handover and back."""
    import numpy as np

    from cadence_tpu_torch.runtime.api import (
        SignalRequest, StartWorkflowRequest)
    from cadence_tpu_torch.runtime.replication import (
        ClusterHandle, DomainFailoverCoordinator)
    from cadence_tpu_torch.testing.faults import LinkProfile, chaos_link
    from cadence_tpu_torch.utils.metrics import Scope

    act = repl_cluster("active", XDC_SHARDS, device)
    sby = repl_cluster("standby", XDC_SHARDS, device)
    links = {}
    for c, peer in ((sby, act), (act, sby)):
        client = chaos_link(ReplAdapter(peer.svc, c.name), LinkProfile(),
                            seed=7)
        links[c.name] = client.link
        c.svc.enable_replication_from(peer.name, client)
    # the standby is down while the backlog builds: the active's pull
    # from it is partitioned until it comes up
    links["active"].force_partition(True)
    act.svc.start()
    started = [act]
    wfs = [f"repl-wf-{i:05d}" for i in range(XDC_WORKFLOWS)]
    runs = {}
    lat = {"start": [], "signal": []}
    try:
        t0 = time.perf_counter()
        for wf in wfs:
            ts = time.perf_counter()
            runs[wf] = act.hc.start_workflow_execution(StartWorkflowRequest(
                domain=REPL_DOMAIN, workflow_id=wf, workflow_type="repl",
                task_list=XDC_TASK_LIST, request_id=f"req-{wf}",
                execution_start_to_close_timeout_seconds=7200))
            lat["start"].append(time.perf_counter() - ts)
            for k in range(XDC_SIGNALS):
                ts = time.perf_counter()
                act.hc.signal_workflow_execution(SignalRequest(
                    domain=REPL_DOMAIN, workflow_id=wf, signal_name=f"s{k}",
                    input=b"x" * XDC_PAYLOAD, identity="repl"))
                lat["signal"].append(time.perf_counter() - ts)
        backlog_s = time.perf_counter() - t0
        ex = act.persistence.execution
        last_task = {}
        backlog_tasks = 0
        for s in range(XDC_SHARDS):
            tasks = ex.get_replication_tasks(s, 0, 1 << 30)
            backlog_tasks += len(tasks)
            last_task[s] = max((t.task_id for t in tasks), default=0)
        check(backlog_tasks == XDC_WORKFLOWS * (1 + XDC_SIGNALS),
              f"the active minted {backlog_tasks} replication tasks")
        tips = repl_tips(act, runs)

        # the standby comes up and catches up; the pull pumps' cycles
        # run under the profiler (started first) while this thread waits
        marks = {}

        def come_up():
            marks["up"] = time.perf_counter()
            sby.svc.start()
            started.append(sby)
            links["active"].force_partition(False)
            deadline = time.monotonic() + REPL_DRAIN_S
            procs = repl_processors(sby.svc)
            while not all(p.fetcher.last_retrieved(p.shard.shard_id)
                          >= last_task[p.shard.shard_id] for p in procs):
                check(time.monotonic() < deadline,
                      "the standby did not catch up")
                time.sleep(0.05)
            marks["current"] = time.perf_counter()
            return procs
        busy = device_busy(torch, lambda: marks.setdefault(
            "procs", come_up()))
        procs = marks["procs"]
        catch_up_s = marks["current"] - marks["up"]
        t_up = marks["up"]
        # pull until a whole round applies nothing
        round_applied = sum(p.drain_tasks() for p in procs)
        drained_s = time.perf_counter() - t_up
        check(repl_tips(sby, runs) == tips,
              "a standby run is behind the active's tip")
        reg = sby.scope.registry
        cyc = reg.timer_stats("replication_apply_latency")
        catch = {
            "backlog_tasks": backlog_tasks,
            "backlog_events": sum(tips.values()),
            "backlog_bytes": links["standby"].bytes_total,
            "link_transfers": links["standby"].snapshot()["transfers"],
            "backlog_write_s": backlog_s,
            "start_ms": percentiles(np, [x * 1e3 for x in lat["start"]]),
            "signal_ms": percentiles(np, [x * 1e3 for x in lat["signal"]]),
            "catch_up_s": catch_up_s, "drained_s": drained_s,
            "tasks_applied_per_s": backlog_tasks / catch_up_s,
            "tasks_applied_counter": reg.counter_value(
                "replication_tasks_applied"),
            "residual_round_tasks": round_applied,
            "apply_cycles": cyc.count,
            "apply_cycle_p50_ms": cyc.p50 * 1e3,
            "apply_cycle_p99_ms": cyc.p99 * 1e3,
            "device_busy": busy,
        }
        states, hists = repl_mismatches(act, sby, runs)
        held = repl_decision_tasks(sby, XDC_TASK_LIST)
        catch.update(state_mismatches=states, history_mismatches=hists,
                     standby_matching_tasks=sum(held.values()))
        check(states == 0 and hists == 0,
              f"after the catch-up: {states} states and {hists} histories "
              "differ between the clusters")
        check(not held, "the standby dispatched a passive domain's task")

        # the managed handover to the standby, a signal a workflow on the
        # new active, the drain back
        fo_scope = Scope()
        coord = DomainFailoverCoordinator(
            repl_meta("active"),
            [ClusterHandle(
                name=c.name, metadata=c.persistence.metadata,
                domains=c.domains, history=c.svc,
                processors=repl_processors(c.svc),
                transport=c.svc._replication_sources[peer][2],
                registry=c.scope.registry)
             for c, peer in ((act, "standby"), (sby, "active"))],
            metrics=fo_scope, drain_timeout_s=REPL_DRAIN_S)
        report = coord.managed_handover(REPL_DOMAIN, "standby")
        t0 = time.perf_counter()
        lat_new = []
        for wf in wfs:
            ts = time.perf_counter()
            sby.hc.signal_workflow_execution(SignalRequest(
                domain=REPL_DOMAIN, workflow_id=wf, signal_name="after",
                input=b"y" * XDC_PAYLOAD, identity="repl"))
            lat_new.append(time.perf_counter() - ts)
        signal_s = time.perf_counter() - t0
        t_back = time.perf_counter()
        back_tasks = coord.await_convergence(REPL_DOMAIN)
        back_s = time.perf_counter() - t_back
        tips = repl_tips(sby, runs)
        check(repl_tips(act, runs) == tips,
              "an old-active run is behind the new active's tip")
        # the new active dispatches every held decision: one decision
        # task a workflow whose decision is scheduled
        deadline = time.monotonic() + REPL_DISPATCH_S
        while True:
            dispatched = repl_decision_tasks(sby, XDC_TASK_LIST)
            if len(dispatched) >= len(wfs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        dispatch_s = time.perf_counter() - t0
        scheduled = [wf for wf in wfs
                     if repl_state(sby, wf, runs[wf])[0]["exec"][
                         "dec_schedule_id"] > 0]
        states, hists = repl_mismatches(act, sby, runs)
        back = {
            "handover": report.to_dict(),
            "new_active_signals": len(lat_new),
            "new_active_signal_ms": percentiles(np, [x * 1e3 for x in lat_new]),
            "new_active_signal_s": signal_s,
            "drain_back_tasks": back_tasks, "drain_back_s": back_s,
            "decisions_scheduled": len(scheduled),
            "decision_tasks_dispatched": sum(dispatched.values()),
            "workflows_with_decision_task": len(dispatched),
            "dispatch_wait_s": dispatch_s,
            "state_mismatches": states, "history_mismatches": hists,
            "bytes_back": links["active"].bytes_total,
        }
        check(report.replication_lag_at_promote == 0,
              f"replication lag {report.replication_lag_at_promote} at "
              "promote")
        check(states == 0 and hists == 0,
              f"after the drain back: {states} states and {hists} "
              "histories differ")
        lost = [wf for wf in scheduled if wf not in dispatched]
        check(len(scheduled) == len(wfs) and not lost,
              f"{len(lost)} scheduled decisions lost in the handover")
        return {"catch_up": catch, "handover_and_back": back}
    finally:
        # the pull pumps first: each pulls from the other cluster
        for c in started:
            for p in repl_processors(c.svc):
                p.stop()
        for c in started:
            c.svc.stop()
            c.matching.shutdown()


def storm_box(device):
    """The reference storm test's standby: one shard, the standby's
    cluster metadata, the storm domain owned by the active."""
    c = repl_cluster("standby", 1, device, domain="storm-domain",
                     domain_id="storm-domain-0000")
    c.svc.start()
    c.engine = c.svc.controller.get_engine_for_shard(0)
    return c


def storm_stop(c):
    c.svc.stop()
    c.matching.shutdown()


def spy_rebuilds(rb, record):
    """Record the rebuilder's calls: ("many", n, use_device, wall s) and
    ("one", 1, False, 0)."""
    many, one = rb.rebuild_many, rb.rebuild

    def spy_many(reqs, use_device=True):
        t0 = time.perf_counter()
        out = many(reqs, use_device=use_device)
        record.append(("many", len(reqs), use_device,
                       time.perf_counter() - t0))
        return out

    def spy_one(req):
        record.append(("one", 1, False, 0.0))
        return one(req)

    rb.rebuild_many, rb.rebuild = spy_many, spy_one


def storm_processor(c, client):
    from cadence_tpu_torch.runtime.replication import (
        ReplicationTaskFetcher, ReplicationTaskProcessor)

    return ReplicationTaskProcessor(
        c.engine.shard, c.engine.ndc_replicator,
        ReplicationTaskFetcher("active", client))


def one_at_a_time(tasks, wfs):
    """The sampled workflows' tasks applied one at a time on a CPU box
    (inline host rebuilds): their states."""
    box = storm_box("cpu")
    try:
        keep = {wf for wf, _ in wfs}
        for t in tasks:
            if t.workflow_id in keep:
                box.engine.ndc_replicator.apply_events(t)
        return {wf: repl_state(box, wf, run) for wf, run in wfs}
    finally:
        storm_stop(box)


def phase_repl_storm10k(device):
    """(b1): 10,002 tasks in one cycle, one rebuild_many of 3,334."""
    from cadence_tpu_torch.testing.replication_storm import (
        BacklogClient, decision_storm)

    box = storm_box(device)
    try:
        tasks, wfs = decision_storm(box.domain_id, STORM10K_N)
        proc = storm_processor(box, BacklogClient(tasks))
        record = []
        spy_rebuilds(box.engine.ndc_replicator.rebuilder, record)
        t0 = time.perf_counter()
        applied = proc.drain_tasks()
        wall = time.perf_counter() - t0
        states = {wf: repl_state(box, wf, run) for wf, run in wfs}
    finally:
        storm_stop(box)
    many = [r for r in record if r[0] == "many"]
    ones = [r for r in record if r[0] == "one"]
    open_ = [wf for wf, (snap, vhs) in states.items()
             if snap["exec"]["dec_started_id"] != 3
             or vhs["histories"][vhs["current_index"]]["items"][-1]
             != [3, 12]]
    sample = random.Random(STORM10K_SEED).sample(wfs, STORM10K_SAMPLE)
    want = one_at_a_time(tasks, sample)
    mism = sum(states[wf] != want[wf] for wf, _ in sample)
    rec = {"workflows": STORM10K_N, "tasks": len(tasks), "applied": applied,
           "wall_s": wall, "tasks_per_s": len(tasks) / wall,
           "rebuild_many": [r[:3] for r in many],
           "rebuild_many_s": sum(r[3] for r in many),
           "host_rebuilds": len(ones), "conflicts_open": len(open_),
           "sample": STORM10K_SAMPLE, "sample_mismatches": mism}
    check(applied == len(tasks), f"(b1) applied {applied} of {len(tasks)}")
    check([r[:3] for r in many] == [("many", STORM10K_N, True)] and not ones,
          f"(b1) rebuilds {record[:4]}: not one rebuild_many of "
          f"{STORM10K_N} on the device")
    check(not open_, f"(b1) {len(open_)} conflicts left open")
    check(mism == 0, f"(b1) {mism} sampled states differ from the "
          "one-at-a-time path")
    return rec


def deep_histories():
    """Phase 8's rebuild_warm cohort at version 1."""
    from cadence_tpu_torch.testing import workloads as W

    rng = random.Random(DEEP_SEED)
    return [(f"wf-deep-{i:03d}", f"run-deep-{i:03d}",
             W.retry_deep_history(rng, v=1, depth=DEEP_DEPTH))
            for i in range(DEEP_N)]


def phase_repl_deep(device):
    """(b2): the seeding, the storm cycle and its split, every rebuilt
    state against the host replay. Returns the record and the forked
    branches the storm's rebuild replayed."""
    from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        RebuildRequest, StateRebuilder)
    from cadence_tpu_torch.testing.replication_storm import (
        BacklogClient, conflict_storm)

    hs = deep_histories()
    box = storm_box(device)
    try:
        seed, storm = conflict_storm(box.domain_id, hs, DEEP_VERSION)
        client = BacklogClient(seed, page=DEEP_PAGE)
        proc = storm_processor(box, client)
        t0 = time.perf_counter()
        seeded = proc.drain_tasks(max_rounds=1 << 20)
        seed_s = time.perf_counter() - t0
        check(seeded == len(seed), f"(b2) seeded {seeded} of {len(seed)}")

        ndc = box.engine.ndc_replicator
        record, marks = [], {}
        spy_rebuilds(ndc.rebuilder, record)
        drain = ndc._drain_deferred

        def timed_drain(deferred, order):
            marks["drain0"] = time.perf_counter()
            drain(deferred, order)
            marks["drain1"] = time.perf_counter()
        ndc._drain_deferred = timed_drain
        reg = box.scope.registry
        before = {k: reg.timer_stats(k).total_s
                  for k in ("history_read", "dispatch_wait", "rehydrate")}
        client.extend(storm)
        marks["cycle0"] = time.perf_counter()
        applied = proc.process_once()
        cycle_s = time.perf_counter() - marks["cycle0"]
        check(proc.process_once() == 0, "(b2) the storm took two cycles")
        split = {k: reg.timer_stats(k).total_s - before[k] for k in before}
        many = [r for r in record if r[0] == "many"]
        ones = [r for r in record if r[0] == "one"]
        rebuild_s = sum(r[3] for r in many)
        # every rebuilt workflow against the host StateBuilder replay of
        # its new current branch
        oracle = StateRebuilder(box.persistence.history, device="cpu")
        mism = 0
        t0 = time.perf_counter()
        states = {}
        for wf, run, _ in hs:
            ctx = box.engine.cache.get_or_create(box.domain_id, wf, run)
            with ctx.lock:
                ctx.clear()
                ms = ctx.load()
            cur = ms.version_histories.get_current_version_history()
            want, _, _ = oracle.rebuild(RebuildRequest(
                box.domain_id, wf, run, cur.branch_token))
            mism += (mutable_state_to_snapshot(ms)
                     != mutable_state_to_snapshot(want))
            states[wf] = repl_state(box, wf, run)
        oracle_s = time.perf_counter() - t0
    finally:
        storm_stop(box)
    sample = random.Random(DEEP_SAMPLE_SEED).sample(
        [(wf, run) for wf, run, _ in hs], DEEP_SAMPLE)
    want = one_at_a_time(seed + storm, sample)
    sample_mism = sum(states[wf] != want[wf] for wf, _ in sample)
    forks = [(wf, run, b[:-1]) for wf, run, b in hs]
    replayed = sum(sum(len(b) for b in bs) for _, _, bs in forks)
    plan_s = marks["drain0"] - marks["cycle0"]
    rec = {
        "histories": DEEP_N, "depth": DEEP_DEPTH,
        "seed_tasks": len(seed), "seed_events": sum(
            len(t.events) for t in seed),
        "seed_page": DEEP_PAGE, "seed_wall_s": seed_s,
        "seed_tasks_per_s": len(seed) / seed_s,
        "storm_tasks": len(storm), "applied": applied,
        "storm_cycle_s": cycle_s,
        "split_s": {
            "plan": plan_s,
            "rebuild_many": rebuild_s,
            "rebuild_many_read": split["history_read"],
            "rebuild_many_dispatch": split["dispatch_wait"],
            "rebuild_many_rehydrate": split["rehydrate"],
            "apply": marks["drain1"] - marks["drain0"] - rebuild_s,
        },
        "events_replayed": replayed,
        "conflicts_resolved_per_s": DEEP_N / cycle_s,
        "rebuild_many": [r[:3] for r in many], "host_rebuilds": len(ones),
        "host_replay_mismatches": mism, "host_replay_s": oracle_s,
        "sample": DEEP_SAMPLE, "sample_mismatches": sample_mism,
    }
    check(applied == len(storm), f"(b2) applied {applied} of {len(storm)}")
    check([r[:3] for r in many] == [("many", DEEP_N, True)] and not ones,
          f"(b2) rebuilds {record[:4]}: not one rebuild_many of {DEEP_N} "
          "on the device")
    check(mism == 0, f"(b2) {mism} rebuilt states differ from the host "
          "replay")
    check(sample_mism == 0, f"(b2) {sample_mism} sampled states differ "
          "from the one-at-a-time path")
    return rec, forks


def phase_repl_install(device, routes):
    """(d): a shipped snapshot behind the run's tip, resumed on the card.
    The active serves each run's snapshot after ``INSTALL_BEFORE`` signals
    and then takes ``INSTALL_AFTER`` more; the standby installs the
    snapshot (``apply_state_snapshot``: a tip hit, since its request ends
    at the snapshot's own event) and takes the history's bytes through the
    active's tip (``backfill_history``). The installer's rebuilder
    (``NDCHistoryReplicator._snapshot_rebuilder``) then brings every run to
    that tip in one ``rebuild_many``: it resumes from the installed row and
    replays the suffix on the card. Every state against the host replay of
    the whole stored history."""
    from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot
    from cadence_tpu_torch.runtime.api import (
        SignalRequest, StartWorkflowRequest)
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        RebuildRequest, StateRebuilder)
    from cadence_tpu_torch.runtime.replication.transport import (
        decode_checkpoint_wire)

    act = repl_cluster("active", 1, device)
    sby = repl_cluster("standby", 1, device)
    started = []
    try:
        for c in (act, sby):
            c.svc.start()
            started.append(c)

        def signal(wf, n, tag):
            for k in range(n):
                act.hc.signal_workflow_execution(SignalRequest(
                    domain=REPL_DOMAIN, workflow_id=wf,
                    signal_name=f"{tag}{k}", input=b"z" * XDC_PAYLOAD,
                    identity="install"))
        wfs = [f"install-wf-{i:03d}" for i in range(INSTALL_N)]
        runs, blobs = {}, {}
        for wf in wfs:
            runs[wf] = act.hc.start_workflow_execution(StartWorkflowRequest(
                domain=REPL_DOMAIN, workflow_id=wf, workflow_type="install",
                task_list=XDC_TASK_LIST, request_id=f"req-{wf}",
                execution_start_to_close_timeout_seconds=7200))
            signal(wf, INSTALL_BEFORE, "b")
            blobs[wf] = act.svc.get_replication_checkpoint(
                act.domain_id, wf, runs[wf])
            signal(wf, INSTALL_AFTER, "a")
        ndc = sby.svc.controller.get_engine(wfs[0]).ndc_replicator
        reqs, snap_tips, tips = [], [], []
        for wf in wfs:
            ckpt = decode_checkpoint_wire(blobs[wf])
            res = ndc.apply_state_snapshot(sby.domain_id, wf, runs[wf], ckpt)
            check(res is not None, f"(d) the standby refused {wf}'s "
                  "snapshot")
            batches, items = act.svc.get_workflow_history_raw(
                act.domain_id, wf, runs[wf], 1, 1 << 60)
            ndc.backfill_history(sby.domain_id, wf, runs[wf], batches)
            token = sby.persistence.execution.get_workflow_execution(
                0, sby.domain_id, wf, runs[wf]).snapshot[
                    "execution_info"]["branch_token"]
            reqs.append(RebuildRequest(
                sby.domain_id, wf, runs[wf],
                token.encode() if isinstance(token, str) else token,
                version_history_items=[(it["event_id"], it["version"])
                                       for it in items]))
            snap_tips.append(ckpt.event_id)
            tips.append(items[-1]["event_id"])
        rb, _ = ndc._snapshot_rebuilder()
        reg = sby.scope.registry
        saved0 = reg.counter_value("events_replayed_saved")
        launches0 = routes.counts["replication_install_resume"]
        t0 = time.perf_counter()
        rebuilt = routes.run("replication_install_resume",
                             lambda: rb.rebuild_many(reqs))
        resume_s = time.perf_counter() - t0
        launches = routes.counts["replication_install_resume"] - launches0
        saved = reg.counter_value("events_replayed_saved") - saved0
        oracle = StateRebuilder(sby.persistence.history, device="cpu")
        mism = behind = 0
        for req, tip, got in zip(reqs, tips, rebuilt):
            want, _, _ = oracle.rebuild(req)
            behind += got is None or got[0].next_event_id - 1 != tip
            mism += got is None or (mutable_state_to_snapshot(got[0])
                                    != mutable_state_to_snapshot(want))
    finally:
        for c in started:
            c.svc.stop()
            c.matching.shutdown()
    rec = {"workflows": INSTALL_N, "signals_before": INSTALL_BEFORE,
           "signals_after": INSTALL_AFTER,
           "snapshot_event_id": [min(snap_tips), max(snap_tips)],
           "tip_event_id": [min(tips), max(tips)],
           "suffix_events": sum(tips) - sum(snap_tips),
           "events_replayed_saved": saved, "resume_s": resume_s,
           "fsm_launches": launches, "behind_tip": behind,
           "host_replay_mismatches": mism}
    check(all(t < u for t, u in zip(snap_tips, tips)),
          "(d) a shipped snapshot is not behind its run's tip")
    check(launches > 0, "(d) the suffix resume launched no FSM kernel")
    check(saved == sum(snap_tips), f"(d) the resume saved {saved} events, "
          f"not the {sum(snap_tips)} the snapshots cover")
    check(behind == 0 and mism == 0, f"(d) {behind} runs behind the tip, "
          f"{mism} states differ from the host replay")
    return rec


def time_storm_kernel(torch, np, S, P, RC, forks):
    """The FSM kernel at a ``rebuild_many`` batch (phase 13 (b2)'s storm:
    the forked branches, every event before each divergent tail; phase
    14 (b)'s split flush: the moving workflows), packed as the dispatcher
    packs them at the rebuilder's default capacities."""
    from cadence_tpu_torch.ops.dispatch import depth_buckets

    caps = S.Capacities()
    packs = [(None, P.pack_lanes(bhs, caps=caps,
                                 target_lane_len=REBUILD_LANE_LEN,
                                 seg_align=16), None)
             for _, bhs in depth_buckets(forks)]
    rec = time_packed(torch, np, S, RC, caps, packs)
    for r in rec:
        r["R_pad"] = RC.RowMap(caps).rows_padded
        r["lanes_per_block"] = RC.lanes_per_block(r["R_pad"], r["lanes"])
    return rec


def phase_replication(torch, np, S, P, RC, smi, device="cuda"):
    """Phase 13: the port's replication planes on the card. Returns FSM
    launches by route and the kernel's timing at (b2)'s storm batch."""
    from cadence_tpu_torch.testing.replication_cells import (
        failover_drill, replication_lag)

    t_phase = time.perf_counter()
    routes = ReplicationRoutes(RC)
    start = RC.replay_rows.launches
    walls = {}
    try:
        t0 = time.perf_counter()
        xdc = phase_repl_xdc(torch, device)
        walls["xdc"] = time.perf_counter() - t0
        emit({"phase": "replication", "part": "xdc",
              "shards": XDC_SHARDS, "workflows": XDC_WORKFLOWS,
              "signals_each": XDC_SIGNALS, **xdc, "wall_s": walls["xdc"],
              "nvidia_smi": smi})
        t0 = time.perf_counter()
        b1 = phase_repl_storm10k(device)
        walls["storm_10k"] = time.perf_counter() - t0
        emit({"phase": "replication", "part": "storm_10k", **b1,
              "part_wall_s": walls["storm_10k"], "nvidia_smi": smi})
        t0 = time.perf_counter()
        b2, forks = phase_repl_deep(device)
        walls["storm_deep"] = time.perf_counter() - t0
        emit({"phase": "replication", "part": "storm_deep", **b2,
              "part_wall_s": walls["storm_deep"], "nvidia_smi": smi})
        t0 = time.perf_counter()
        install = phase_repl_install(device, routes)
        walls["install_resume"] = time.perf_counter() - t0
        emit({"phase": "replication", "part": "install_resume", **install,
              "part_wall_s": walls["install_resume"], "nvidia_smi": smi})
        t0 = time.perf_counter()
        lag = replication_lag(**LAG_CELL, device=device)
        walls["replication_lag"] = time.perf_counter() - t0
        emit({"phase": "replication", "part": "replication_lag",
              "cell": LAG_CELL, **lag, "part_wall_s":
              walls["replication_lag"], "nvidia_smi": smi})
        t0 = time.perf_counter()
        drill = failover_drill(**DRILL_CELL, device=device)
        walls["failover_drill"] = time.perf_counter() - t0
        emit({"phase": "replication", "part": "failover_drill",
              "cell": DRILL_CELL, **drill, "part_wall_s":
              walls["failover_drill"], "nvidia_smi": smi})
    finally:
        routes.restore()
    total = RC.replay_rows.launches - start
    # the kernel at (b2)'s batch against its bound, outside the counted
    # window
    storm_kernel = (time_storm_kernel(torch, np, S, P, RC, forks)
                    if device == "cuda" else [])
    emit({"phase": "replication", "part": "storm_kernel",
          "packed_route": storm_kernel, "nvidia_smi": smi})
    emit({"phase": "replication", "part": "routes",
          "fsm_launches": dict(routes.counts), "calls": dict(routes.calls),
          "fsm_launches_total": total, "walls_s": walls,
          "phase_wall_s": time.perf_counter() - t_phase})
    for arm in ("events", "snapshot", "adaptive"):
        check(lag[arm]["converged"], f"replication_lag {arm} did not "
              "converge")
    check(lag["snapshot"]["snapshots_shipped"] > 0,
          "the snapshot arm shipped no snapshot")
    check(drill["slo"]["met"], f"failover_drill slo missed: {drill['slo']}")
    check(sum(routes.counts.values()) == total,
          f"{total - sum(routes.counts.values())} FSM launches of the "
          "phase outside its routes")
    for route in ("replication_conflict", "replication_snapshot_serve",
                  "replication_install_resume"):
        check(routes.counts[route] > 0,
              f"the replication phase made no {route} launch")
    check(routes.calls["replication_snapshot_install"] > 0,
          "the replication phase installed no snapshot")
    return dict(routes.counts), storm_kernel


# -- phase 14: the topology planes ----------------------------------------

# (a) bench.py's queue_drain cell at its size (bench.py:2434-2436)
TOPO_QDRAIN = dict(tasks_per_queue=2000, n_wf=48, parallelism=12,
                   stall_us=250)
# (b) split and merge on the Onebox twin at the history host's size of
# phases 11-13: 4 shards, 4,096 workflows started and signalled once
# (every eighth with a short execution timeout, the timer that must fire
# after the moves), 64 deep workflows of ~1,000 events (start plus 998
# signals) whose ids fall in the class the split moves, and 64 more
# workflows started into the moving class while each plan's flush runs.
# The domain is global, active on this box's cluster of the replication
# tests' two (phase 13's metadata): each shard also runs the standby
# planes of the other cluster, which the executor drives too, and the
# engine keeps version histories, so a moved workflow's state compares
# with the host replay field for field
TOPO_SHARDS, TOPO_WORKFLOWS, TOPO_PARALLEL = 4, 4096, 12
TOPO_DEEP, TOPO_DEEP_SIGNALS, TOPO_DURING = 64, 998, 64
TOPO_SHORT_S, TOPO_LONG_S, TOPO_SHORT_EVERY = 600, 86400, 8
TOPO_DOMAIN, TOPO_TASK_LIST = "topo-domain", "topo-tl"
TOPO_FIRE_S = 120.0
# (c) bench.py's reshard_live cell (bench.py:456, :2397): 16 s, 2 load
# threads, a probe every 4 ms on Onebox(num_shards=2, checkpoints=True)
TOPO_LIVE = dict(duration_s=16.0, load_threads=2, probe_interval_s=0.004)
# (d) bench.py's capacity_diurnal cell (bench.py:1515, :2423-2425), then
# the autopilot's topology loop (tests/test_autopilot.py:500's case): a
# hotspot of TOPO_HOT workflows on shard 0 of a 2-shard box until the
# controller splits it, then idle (the hotspot terminated) until it merges
TOPO_DIURNAL = dict(workflows_per_chunk=8, qps_low=60.0, qps_high=600.0,
                    chunks_low=3, chunks_high=4, chunks_trough=4, lanes=16)
TOPO_HOT, TOPO_EPOCHS = 512, 12


def TopologyRoutes(RC):
    """FSM launches of the topology planes, by route: the reshard
    coordinator's checkpoint flush and its warm of the new owners
    (``ReshardCoordinator._flush_checkpoints`` / ``_warm_new_owners``,
    whoever drives the plan: the admin verbs, the live cell, the
    autopilot) and, tagged by hand, the diurnal cell's serving engine."""
    from cadence_tpu_torch.runtime.resharding import ReshardCoordinator

    return ThreadRoutes(RC, {
        "reshard_flush": (ReshardCoordinator, "_flush_checkpoints"),
        "reshard_warm": (ReshardCoordinator, "_warm_new_owners"),
    }, extra=("topology_diurnal",))


def topo_moving(wf):
    """Whether ``wf`` lies in the class that splitting shard 0 of the
    initial ``TOPO_SHARDS``-shard map moves to the new shard."""
    from cadence_tpu_torch.utils.hashing import fnv1a32

    return fnv1a32(wf) % (2 * TOPO_SHARDS) == TOPO_SHARDS


def topo_ids(prefix, n, moving):
    """The first ``n`` ids ``prefix-k`` in (or out of) the moving class."""
    out, k = [], 0
    while len(out) < n:
        wf = f"{prefix}-{k:05d}"
        if moving is None or topo_moving(wf) == moving:
            out.append(wf)
        k += 1
    return out


def topo_start(box, wf, timeout_s):
    from cadence_tpu_torch.runtime.api import StartWorkflowRequest

    return box.frontend.start_workflow_execution(StartWorkflowRequest(
        domain=TOPO_DOMAIN, workflow_id=wf, workflow_type="topo-wf",
        task_list=TOPO_TASK_LIST, input=b"x", request_id=f"start-{wf}",
        execution_start_to_close_timeout_seconds=timeout_s))


def topo_signal(box, wf, name="s"):
    from cadence_tpu_torch.runtime.api import SignalRequest

    box.frontend.signal_workflow_execution(SignalRequest(
        domain=TOPO_DOMAIN, workflow_id=wf, signal_name=name, input=b"y"))


def topo_rows(box):
    """shard -> workflow ids of the execution rows it holds, over the
    current map's shards."""
    ex = box.persistence.execution
    return {sid: [wf for _, wf, _ in ex.list_concrete_executions(sid)]
            for sid in box.history.controller.shard_map.shard_ids()}


def topo_state(box, domain_id, wf, run):
    """The run's canonical state, loaded afresh by its owner's engine."""
    from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot

    engine = box.history.controller.get_engine(wf)
    ctx = engine.cache.get_or_create(domain_id, wf, run)
    with ctx.lock:
        ctx.clear()
        ms = ctx.load()
    return mutable_state_to_snapshot(ms), ms.execution_info.branch_token


class RebuildSpy:
    """Every ``StateRebuilder.rebuild_many`` call and its results while
    installed, with the route of the calling thread (``routes``), and
    every host ``rebuild`` a coordinator's rebuilder makes."""

    def __init__(self, routes):
        from cadence_tpu_torch.runtime.replication.rebuilder import (
            StateRebuilder)

        self.cls, self.calls, self.host = StateRebuilder, [], []
        many, one, tag = (StateRebuilder.rebuild_many,
                          StateRebuilder.rebuild, routes._tag)
        self._saved = (many, one)

        def spy_many(rb, reqs, use_device=True):
            t0 = time.perf_counter()
            out = many(rb, reqs, use_device=use_device)
            self.calls.append((getattr(tag, "route", None), list(reqs),
                               out, use_device, time.perf_counter() - t0))
            return out

        def spy_one(rb, req):
            route = getattr(tag, "route", None)
            if route is not None:
                self.host.append((route, req.workflow_id))
            return one(rb, req)
        StateRebuilder.rebuild_many, StateRebuilder.rebuild = (
            spy_many, spy_one)

    def take(self):
        out, self.calls = self.calls, []
        return out

    def restore(self):
        self.cls.rebuild_many, self.cls.rebuild = self._saved


def topo_plan(box, domain_id, runs, call, during, spy, epoch, oracle):
    """One plan through the admin verb ``call`` with ``during(step)`` run
    at each protocol step, then its checks: committed at ``epoch``, every
    row on the shard its workflow routes to, every moved open workflow's
    state on its new owner and the warm's device result equal to the host
    replay at its tip, and no host rebuild. Returns the record."""
    from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        RebuildRequest)

    coord = box.history.reshard_coordinator()
    coord._on_step = during
    try:
        t0 = time.perf_counter()
        plan = call()
        wall = time.perf_counter() - t0
    finally:
        coord._on_step = lambda step: None
    calls = spy.take()
    scopes = coord.last_rebuild_scopes
    check(plan["state"] == "COMMITTED" and plan["epoch_to"] == epoch,
          f"(b) plan {plan['kind']} {plan['state']} at epoch "
          f"{plan['epoch_to']}, not committed at {epoch}")
    # every row on the shard its workflow routes to, each exactly once
    rows = topo_rows(box)
    ctl = box.history.controller
    misplaced = sum(ctl.shard_for(wf) != sid
                    for sid, wfs in rows.items() for wf in wfs)
    placed = sorted(wf for wfs in rows.values() for wf in wfs)
    check(misplaced == 0 and placed == sorted(runs),
          f"(b) {misplaced} rows misplaced, {len(placed)} rows for "
          f"{len(runs)} workflows after the {plan['kind']}")
    # the moved open workflows (flushed, and started during the flush):
    # state on the new owner and the warm's device result, both against
    # the host replay at the tip
    warm = {r.workflow_id: mutable_state_to_snapshot(res[0])
            for route, reqs, out, dev, _ in calls if route == "reshard_warm"
            for r, res in zip(reqs, out)}
    flush = [r for route, reqs, _, _, _ in calls
             if route == "reshard_flush" for r in reqs]
    flushed = {r.workflow_id for r in flush}
    t0 = time.perf_counter()
    state_mism = warm_mism = 0
    for wf in sorted(warm):
        got, token = topo_state(box, domain_id, wf, runs[wf])
        want = mutable_state_to_snapshot(oracle.rebuild(RebuildRequest(
            domain_id, wf, runs[wf], token))[0])
        state_mism += got != want
        warm_mism += warm[wf] != want
    oracle_s = time.perf_counter() - t0
    check(flushed and flushed <= set(warm),
          f"(b) the warm rebuilt {len(flushed & set(warm))} of the "
          f"{len(flushed)} flushed workflows")
    check(state_mism == 0 and warm_mism == 0,
          f"(b) of {len(warm)} moved workflows {state_mism} differ from "
          f"the host replay on their new owner, {warm_mism} in the warm's "
          "device result")
    fallbacks = {k: sc.registry.counter_value("host_fallbacks")
                 for k, sc in scopes.items()}
    check(not spy.host and not any(fallbacks.values())
          and all(dev for _, _, _, dev, _ in calls),
          f"(b) moved workflows rebuilt on the host: {spy.host[:4]} "
          f"{fallbacks}")
    split = {k: {t: sc.registry.timer_stats(t).total_s
                 for t in ("history_read", "dispatch_wait", "rehydrate")}
             for k, sc in scopes.items()}
    return {
        **{k: plan[k] for k in (
            "kind", "epoch_to", "sources", "targets", "state",
            "handoff_ms", "pause_ms", "moved_workflows", "moved_tasks",
            "checkpoints_shipped", "suffix_events_replayed")},
        "admin_call_s": wall,
        "rebuild_many_calls": [(route, len(reqs), wall_s)
                               for route, reqs, _, _, wall_s in calls],
        "flush_rebuild_many_s": split.get("flush"),
        "warm_rebuild_many_s": split.get("warm"),
        "flushed": len(flushed), "moved_open_checked": len(warm),
        "state_mismatches": state_mism,
        "warm_mismatches": warm_mism, "host_replay_s": oracle_s,
    }, flush


def topo_decisions(box, domain_id):
    """workflow id -> decision tasks waiting in the box's matching."""
    tasks = box.persistence.task.get_tasks(
        domain_id, TOPO_TASK_LIST, 0, read_level=0,
        max_read_level=1 << 62, batch_size=1 << 30)
    out = {}
    for t in tasks:
        out[t.workflow_id] = out.get(t.workflow_id, 0) + 1
    return out


def phase_topo_split_merge(torch, np, S, P, RC, routes, device):
    """(b): a split and a merge back on the Onebox twin through the admin
    verbs, on the card. Returns the record and the flush's histories."""
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        StateRebuilder)
    from cadence_tpu_torch.testing.onebox import Onebox
    from cadence_tpu_torch.utils.clock import FakeTimeSource

    clock = FakeTimeSource()
    box = Onebox(num_shards=TOPO_SHARDS, checkpoints=True,
                 queue_parallel=TOPO_PARALLEL, start_worker=False,
                 device=device, time_source=clock,
                 cluster_metadata=repl_meta("active")).start()
    spy = RebuildSpy(routes)
    try:
        box.domain_handler.register_domain(
            TOPO_DOMAIN, is_global=True, clusters=["active", "standby"],
            active_cluster="active")
        domain_id = box.domains.get_by_name(TOPO_DOMAIN).info.id
        wfs = topo_ids("topo", TOPO_WORKFLOWS, None)
        deep = topo_ids("topo-deep", TOPO_DEEP, True)
        short = set(wfs[::TOPO_SHORT_EVERY])
        runs = {}
        t0 = time.perf_counter()
        for wf in wfs:
            runs[wf] = topo_start(
                box, wf, TOPO_SHORT_S if wf in short else TOPO_LONG_S)
        for wf in wfs:
            topo_signal(box, wf)
        seed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for wf in deep:
            runs[wf] = topo_start(box, wf, TOPO_LONG_S)
            for _ in range(TOPO_DEEP_SIGNALS):
                topo_signal(box, wf)
        deep_s = time.perf_counter() - t0
        check(box.history.drain_queues(60.0), "(b) queues did not drain "
              "before the split")
        oracle = StateRebuilder(box.persistence.history, device="cpu")

        def during(tag):
            def on_step(step):
                if step != "flushed":
                    return
                # live traffic between the flush and the fence: the warm
                # replays the deep workflows' new suffix; the new
                # workflows' first decisions move with their shard
                for wf in deep:
                    topo_signal(box, wf, f"{tag}-during")
                for wf in topo_ids(f"topo-{tag}", TOPO_DURING, True):
                    runs[wf] = topo_start(box, wf, TOPO_LONG_S)
            return on_step

        split, flush_hs = topo_plan(
            box, domain_id, runs, lambda: box.admin.reshard_split(0),
            during("split"), spy, 1, oracle)
        check(box.history.drain_queues(60.0), "(b) queues did not drain "
              "after the split")
        new_id = split["targets"][0]
        merge, _ = topo_plan(
            box, domain_id, runs,
            lambda: box.admin.reshard_merge(new_id, 0),
            during("merge"), spy, 2, oracle)
        check(box.history.drain_queues(60.0), "(b) queues did not drain "
              "after the merge")
        # no task lost: every open workflow's first decision in matching
        waiting = topo_decisions(box, domain_id)
        missing = [wf for wf in runs if not waiting.get(wf)]
        check(not missing, f"(b) {len(missing)} scheduled decisions never "
              f"reached matching: {missing[:4]}")
        # the moved timers fire: past the short timeout, every short
        # workflow times out on the shard it now lives on
        clock.advance((TOPO_SHORT_S + 1) * 10**9)
        t0 = time.perf_counter()
        pending = set(short)
        while pending and time.perf_counter() - t0 < TOPO_FIRE_S:
            pending = {wf for wf in pending
                       if box.frontend.describe_workflow_execution(
                           TOPO_DOMAIN, wf, runs[wf]).is_running}
            time.sleep(0.05)
        fire_s = time.perf_counter() - t0
        moved_short = [wf for wf in short if topo_moving(wf)]
        check(not pending, f"(b) {len(pending)} of {len(short)} short "
              f"timers never fired ({len([w for w in pending if w in moved_short])} "
              "of them moved)")
        still = sum(box.frontend.describe_workflow_execution(
            TOPO_DOMAIN, wf, runs[wf]).is_running
            for wf in wfs if wf not in short)
        check(still == TOPO_WORKFLOWS - len(short),
              f"(b) {TOPO_WORKFLOWS - len(short) - still} long-timeout "
              "workflows closed")
        ex = box.queue_executor
        rec = {
            "shards": TOPO_SHARDS, "workflows": TOPO_WORKFLOWS,
            "deep": TOPO_DEEP, "deep_events": 2 + TOPO_DEEP_SIGNALS,
            "during_each_plan": TOPO_DURING, "queue_parallel": TOPO_PARALLEL,
            "seed_s": seed_s, "deep_seed_s": deep_s,
            "split": split, "merge": merge,
            "decisions_in_matching": len(runs) - len(missing),
            "short_timers": len(short), "moved_short_timers": len(moved_short),
            "timers_fire_s": fire_s,
            "executor": {"cycles": ex.cycles, "tasks": ex.tasks,
                         "waves": ex.waves, "stale_skipped": ex.stale_skipped,
                         "degraded": ex.degraded},
        }
    finally:
        spy.restore()
        box.stop()
    hs = [(r.workflow_id, r.run_id, oracle._read_batches(r))
          for r in flush_hs]
    return rec, hs


def phase_topo_autopilot(routes, device):
    """(d), second part: the autopilot's topology loop on the Onebox
    twin. A hotspot of open workflows on shard 0 (the controller's shard
    load is each shard's open workflows) until it splits, then idle (the
    hotspot terminated) until it merges. Returns the record."""
    from cadence_tpu_torch.config.static import AutopilotConfig
    from cadence_tpu_torch.runtime.autopilot import CapacityController
    from cadence_tpu_torch.testing.onebox import Onebox
    from cadence_tpu_torch.utils.hashing import fnv1a32

    box = Onebox(num_shards=2, checkpoints=True, start_worker=False,
                 device=device).start()
    try:
        box.domain_handler.register_domain(TOPO_DOMAIN)
        ex = box.persistence.execution
        open_ = set()

        def load():
            return {sid: sum(wf in open_ for _, wf, _ in
                             ex.list_concrete_executions(sid))
                    for sid in box.history.controller.shard_map.shard_ids()}

        ap = CapacityController(
            AutopilotConfig(
                enabled=True, epoch_interval_s=5.0,
                target_p99_ms=60_000.0, ewma_alpha=1.0, min_dwell=1,
                cooldown_epochs=0, reshard_cooldown_epochs=0,
                hot_shard_depth=100, hot_shard_factor=1.5, min_shards=2,
                max_shards=8, cold_shard_frac=0.25),
            registry=box.metrics.registry,
            resharder=box.history.reshard_coordinator,
            history=box.history, shard_load_fn=load, metrics=box.metrics)
        box.history.autopilot = ap
        idle = ap.run_epoch_once()
        check(idle["plans"] == 0, "(d) the autopilot resharded an idle box")
        hot, k = [], 0
        while len(hot) < TOPO_HOT:
            wf = f"topo-hot-{k:05d}"
            if fnv1a32(wf) % 2 == 0:
                hot.append(wf)
            k += 1
        runs = {wf: topo_start(box, wf, TOPO_LONG_S) for wf in hot}
        for wf in hot:
            topo_signal(box, wf)
        open_.update(hot)
        epochs, t0 = [], time.perf_counter()
        while len(box.history.controller.owned_shards()) == 2 \
                and len(epochs) < TOPO_EPOCHS:
            epochs.append(ap.run_epoch_once())
        split_s = time.perf_counter() - t0
        after_split = box.history.controller.owned_shards()
        check(len(after_split) == 3, f"(d) no split in {len(epochs)} "
              f"epochs of a hotspot: {load()}")
        for wf in hot:
            box.frontend.terminate_workflow_execution(
                TOPO_DOMAIN, wf, runs[wf], reason="idle")
        open_.clear()
        n_split, t0 = len(epochs), time.perf_counter()
        while len(box.history.controller.owned_shards()) == 3 \
                and len(epochs) < 2 * TOPO_EPOCHS:
            epochs.append(ap.run_epoch_once())
        merge_s = time.perf_counter() - t0
        after_merge = box.history.controller.owned_shards()
        check(len(after_merge) == 2, f"(d) no merge in "
              f"{len(epochs) - n_split} idle epochs")
        st = box.admin.autopilot_status()
        rec = {"hotspot": TOPO_HOT, "epochs": len(epochs),
               "epochs_to_split": n_split,
               "epochs_to_merge": len(epochs) - n_split,
               "plans_executed": sum(e["plans"] for e in epochs),
               "split_wall_s": split_s, "merge_wall_s": merge_s,
               "shards_after_split": after_split,
               "shards_after_merge": after_merge,
               "reshard_failures": st["reshard_failures"],
               "guardrail_freezes": st["guardrail_freezes"],
               "last_plan": {k: v for k, v in
                             box.admin.reshard_status()["last_plan"].items()
                             if k in ("kind", "state", "epoch_to",
                                      "handoff_ms", "pause_ms",
                                      "moved_workflows",
                                      "checkpoints_shipped")}}
        check(rec["plans_executed"] == 2 and not st["reshard_failures"]
              and not st["guardrail_freezes"],
              f"(d) the topology loop: {rec}")
    finally:
        box.stop()
    return rec


def phase_topology(torch, np, S, P, RC, smi, device="cuda"):
    """Phase 14: the parallel queue executor, elastic resharding and the
    capacity autopilot on the card. Returns FSM launches by route and
    the kernel's timing at (b)'s split flush."""
    from cadence_tpu_torch.testing.topology_cells import (
        capacity_diurnal, queue_drain, reshard_live)

    t_phase = time.perf_counter()
    walls = {}
    t0 = time.perf_counter()
    qd = queue_drain(**TOPO_QDRAIN)
    walls["queue_drain"] = time.perf_counter() - t0
    emit({"phase": "topology", "part": "queue_drain", "cell": TOPO_QDRAIN,
          **qd, "part_wall_s": walls["queue_drain"], "nvidia_smi": smi})
    check(qd["drained"] and qd["state_identical"],
          f"(a) queue_drain: drained {qd['drained']}, states equal "
          f"{qd['state_identical']}")
    check(not qd["degraded"], "(a) the conflict-matrix gate degraded")

    routes = TopologyRoutes(RC)
    start = RC.replay_rows.launches
    try:
        t0 = time.perf_counter()
        b, flush_hs = phase_topo_split_merge(torch, np, S, P, RC, routes,
                                             device)
        walls["split_merge"] = time.perf_counter() - t0
        emit({"phase": "topology", "part": "split_merge", **b,
              "part_wall_s": walls["split_merge"], "nvidia_smi": smi})
        t0 = time.perf_counter()
        live = reshard_live(**TOPO_LIVE, device=device)
        walls["reshard_live"] = time.perf_counter() - t0
        emit({"phase": "topology", "part": "reshard_live", "cell": TOPO_LIVE,
              **live, "part_wall_s": walls["reshard_live"],
              "nvidia_smi": smi})
        check(live["handoff"]["state"] == "COMMITTED"
              and live["workflows_completed"] > 0,
              f"(c) reshard_live: {live['handoff']}, "
              f"{live['workflows_completed']} completed")
        t0 = time.perf_counter()
        diurnal = routes.run("topology_diurnal", lambda: capacity_diurnal(
            **TOPO_DIURNAL, device=device))
        walls["capacity_diurnal"] = time.perf_counter() - t0
        emit({"phase": "topology", "part": "capacity_diurnal",
              "cell": TOPO_DIURNAL, **diurnal,
              "part_wall_s": walls["capacity_diurnal"], "nvidia_smi": smi})
        check(diurnal["rate_tracks_load"]
              and diurnal["operator_calls"] == 0
              and diurnal["guardrail_freezes"] == 0,
              f"(d) capacity_diurnal: tracks {diurnal['rate_tracks_load']}, "
              f"{diurnal['operator_calls']} operator calls, "
              f"{diurnal['guardrail_freezes']} freezes")
        t0 = time.perf_counter()
        loop = phase_topo_autopilot(routes, device)
        walls["autopilot_topology"] = time.perf_counter() - t0
        emit({"phase": "topology", "part": "autopilot_topology", **loop,
              "part_wall_s": walls["autopilot_topology"],
              "nvidia_smi": smi})
    finally:
        routes.restore()
    total = RC.replay_rows.launches - start
    # the kernel at (b)'s split flush against its bound, outside the
    # counted window
    flush_kernel = (time_storm_kernel(torch, np, S, P, RC, flush_hs)
                    if device == "cuda" else [])
    emit({"phase": "topology", "part": "flush_kernel",
          "histories": len(flush_hs), "packed_route": flush_kernel,
          "nvidia_smi": smi})
    emit({"phase": "topology", "part": "routes",
          "fsm_launches": dict(routes.counts), "calls": dict(routes.calls),
          "fsm_launches_total": total, "walls_s": walls,
          "phase_wall_s": time.perf_counter() - t_phase})
    check(sum(routes.counts.values()) == total,
          f"{total - sum(routes.counts.values())} FSM launches of the "
          "phase outside its routes")
    for route in routes.counts:
        check(routes.counts[route] > 0,
              f"the topology phase made no {route} launch")
    return dict(routes.counts), flush_kernel


# -- phase 15: the worker services over the durable store ----------------

# phase 15, the worker services (cadence_tpu_torch/worker) and the durable
# sqlite store (runtime/persistence/sqlite.py, the SqliteCheckpointStore).
# Every count below is cut for the card machine's file system (9p: its
# sqlite commits, each synced as the store's WAL journal syncs them, run
# at 1,310-1,720 a second; a cohort of 256 retry_deep runs is 200,000
# commits, 137 s), and the host paths of a slow host run 1.5-3x slower
# than a fast one's: the run must end inside its time limit there too.
# (a) durable_rebuild: the first 32 runs of phase 8's rebuild_warm
# cohort (256 retry_deep runs of ~1,000 events from random.Random(45);
# 64 until phase 18's whole run took 1,091 s, their write 38 s of it)
# written into a sqlite file one transaction a batch, as store_run
# writes them, then phase 8's prefix,
# cold and warm passes with rebuild_many over that bundle and its
# checkpoint store. (b) worker_services: the Onebox twin over a sqlite
# file with the worker services on (the reference's default), 4 shards,
# checkpoints, a resident engine and 16 sticky SDK workers, as phase 12;
# a domain archiving history and visibility to file:// URIs; 128
# workflows run to completion (an activity each), each close archived by
# the archival system workflow; 8 parents of 4 children, 6 under a
# TERMINATE parent-close policy (applied by the close processor) and 2
# under ABANDON whose children go to the parent-close-policy system
# workflow, as a close processor offloads a large fan-out; 64 open
# workflows terminated by one batch workflow through a visibility query
# (the batcher's own 50 rps pace); the retention delete of every closed
# run, reads then served from the archive; 64 orphan history trees and
# two passes of the history scavenger. The visibility writes also go to
# a bus topic that the Indexer lands in a second store, as a host that
# writes visibility through Kafka does. 128 is cut from the history
# host's 4,096 (phase 11), the parents from 64 and the batch from 256: a
# closed run costs ~210 commits. (c) push_replication: two Onebox
# twins sharing the active's message bus; the active's
# ReplicationPublisher publishes 512 workflows' starts and 4 signals each
# (2,560 tasks), the standby's WorkerService (replication_sources=
# ["active"]) applies them through HistoryReplicationConsumer, and its
# DomainReplicationProcessor the global domain's registration and update
WS_SHARDS, WS_WORKERS, WS_DOMAIN, WS_TASK_LIST = 4, 16, "ws-domain", "ws-tl"
WS_COMPLETED, WS_PARENTS, WS_CHILDREN, WS_OFFLOADED = 128, 8, 4, 2
WS_BATCH, WS_ORPHANS = 64, 64
DURABLE_N = 32
WS_PARENT_TASK_LIST, WS_WAIT_S = "ws-parent-tl", 600.0
PUSH_SHARDS, PUSH_WORKFLOWS, PUSH_SIGNALS = 4, 512, 4
PUSH_DOMAIN, PUSH_TASK_LIST = "push-domain", "push-tl"


def counted_commits(bundle):
    """The sqlite bundle's committed transactions, counted: its ``_Db``'s
    ``txn`` wrapped on the instance (the count rises under the store's
    lock, before the commit)."""
    db, count = bundle._db, [0]
    inner = db.txn

    @contextlib.contextmanager
    def txn():
        with inner() as conn:
            yield conn
            count[0] += 1
    db.txn = txn
    return count


def phase_durable_rebuild(torch, np, S, P, unpack, RC, p8, tmp):
    """Phase 15 (a): the rebuild path over the sqlite store. ``p8`` is
    phase 8's record and its cohort's cold results. Returns the FSM
    launches of the counted window."""
    from cadence_tpu_torch.checkpoint import (
        CheckpointManager, CheckpointPolicy)
    from cadence_tpu_torch.runtime.persistence.sqlite import (
        create_sqlite_bundle)
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        StateRebuilder)
    from cadence_tpu_torch.utils.metrics import Scope

    t_phase = time.perf_counter()
    path = os.path.join(tmp, "durable.db")
    bundle = create_sqlite_bundle(path)
    commits = counted_commits(bundle)
    try:
        t0 = time.perf_counter()
        c = warm_cohort(bundle.history, DURABLE_N)
        setup_s = time.perf_counter() - t0
        prefix_commits = commits[0]
        reqs, store = c["reqs"], bundle.checkpoint

        # the main path, launches counted from zero
        RC.replay_rows.launches = 0
        t0 = time.perf_counter()
        StateRebuilder(bundle.history, lane_len=REBUILD_LANE_LEN,
                       checkpoints=CheckpointManager(
                           store, CheckpointPolicy(every_events=1,
                                                   keep_last=1))
                       ).rebuild_many(reqs)
        prefix_pass_s = time.perf_counter() - t0
        checkpoints_written = store.count_checkpoints()
        n0, t0 = commits[0], time.perf_counter()
        append_tails(c)
        tail_s, tail_commits = time.perf_counter() - t0, commits[0] - n0
        cold_scope, warm_scope = Scope(), Scope()
        cold_s, cold_out = timed_passes(
            StateRebuilder(bundle.history, lane_len=REBUILD_LANE_LEN,
                           metrics=cold_scope), reqs, WARM_ITERS)
        warm_s, warm_out = timed_passes(
            StateRebuilder(bundle.history, lane_len=REBUILD_LANE_LEN,
                           metrics=warm_scope,
                           checkpoints=CheckpointManager(
                               store, CheckpointPolicy(every_events=1 << 30,
                                                       keep_last=1))),
            reqs, WARM_ITERS)
        launches = RC.replay_rows.launches

        # the host replay over the same store, outside the counted window
        t0 = time.perf_counter()
        host = StateRebuilder(bundle.history)
        oracle = [rebuild_key(unpack, host.rebuild(r)) for r in reqs]
        oracle_s = time.perf_counter() - t0
        mism = {name: sum(rebuild_key(unpack, g) != w
                          for g, w in zip(out, oracle))
                for name, out in (("cold", cold_out), ("warm", warm_out))}
        # against phase 8's memory-store results: the branch tokens
        # differ (a store mints its own branch ids), all else equal
        for name, out in (("cold", cold_out), ("warm", warm_out)):
            mism[f"{name}_vs_phase8"] = sum(
                rebuild_key(unpack, g)[:3] != k[:3]
                for g, k in zip(out, p8["cold_keys"][:DURABLE_N]))
        mism["branch_tokens"] = sum(
            g[0].execution_info.branch_token != r.branch_token
            and g[0].execution_info.branch_token != r.branch_token.decode()
            for g, r in zip(cold_out, reqs))
        passes = WARM_ITERS + 1
        reg = warm_scope.registry
        hits = reg.counter_value("checkpoint_hit")
        lookups = hits + reg.counter_value("checkpoint_miss") + \
            reg.counter_value("checkpoint_invalidated")
        saved = reg.counter_value("events_replayed_saved") // passes
        suffix_frac = 1.0 - saved / c["total_events"]
        configured = c["suffix_events"] / c["total_events"]
        fallbacks = {name: sc.registry.counter_value("host_fallbacks")
                     for name, sc in (("cold", cold_scope),
                                      ("warm", warm_scope))}
        kernel = time_rebuild_kernel(torch, np, S, P, RC, c)
        file_bytes = sum(os.path.getsize(path + ext)
                         for ext in ("", "-wal") if os.path.exists(path + ext))
    finally:
        bundle.close()
    rec = {
        "phase": "worker_store", "part": "durable_rebuild",
        "histories": DURABLE_N, "depth": WARM_DEPTH,
        "mean_depth": c["total_events"] / DURABLE_N,
        "store": "sqlite (WAL, busy_timeout 5000, BEGIN IMMEDIATE)",
        "setup_s": setup_s, "write_s": c["write_s"],
        "prefix_batches": c["prefix_batches"],
        "prefix_commits": prefix_commits,
        "commits_per_s": prefix_commits / c["write_s"],
        "tail_commits": tail_commits, "tail_s": tail_s,
        "file_bytes": file_bytes, "prefix_pass_s": prefix_pass_s,
        "checkpoints_written": checkpoints_written,
        "cold_histories_per_s": DURABLE_N / cold_s,
        "warm_histories_per_s": DURABLE_N / warm_s,
        "cold_batch_s": cold_s, "warm_batch_s": warm_s,
        "checkpoint_hit_rate": hits / max(lookups, 1),
        "suffix_frac": suffix_frac, "suffix_frac_configured": configured,
        "host_fallbacks": fallbacks,
        "wall_split_cold": wall_split(cold_scope, passes),
        "wall_split_warm": wall_split(warm_scope, passes),
        "phase8_memory_wall_split_cold":
            p8["rec"]["rebuild_warm"]["wall_split_cold"],
        "phase8_memory_wall_split_warm":
            p8["rec"]["rebuild_warm"]["wall_split_warm"],
        # a run's read, each store's cohort its own size
        "history_read_ms_per_run": {
            "sqlite_cold": wall_split(cold_scope, passes)["history_read_s"]
            / DURABLE_N * 1e3,
            "memory_cold_phase8": p8["rec"]["rebuild_warm"][
                "wall_split_cold"]["history_read_s"] / WARM_N * 1e3},
        "phase8_memory_cold_batch_s":
            p8["rec"]["rebuild_warm"]["cold_batch_s"],
        "phase8_memory_warm_batch_s":
            p8["rec"]["rebuild_warm"]["warm_batch_s"],
        "host_oracle_s": oracle_s, "fsm_launches": launches,
        "kernel": kernel, "mismatches": mism,
        "phase_s": time.perf_counter() - t_phase}
    emit(rec)
    check(not any(mism.values()), f"durable rebuilds differ: {mism}")
    check(checkpoints_written == DURABLE_N,
          f"the prefix pass wrote {checkpoints_written} checkpoints")
    check(prefix_commits == c["prefix_batches"] + DURABLE_N,
          f"{prefix_commits} commits for {c['prefix_batches']} batches "
          f"and {DURABLE_N} branches")
    check(fallbacks["cold"] == fallbacks["warm"] == 0,
          f"the durable rebuild took the host route: {fallbacks}")
    check(hits == lookups == DURABLE_N * passes,
          f"warm checkpoint hits {hits} of {lookups} lookups")
    check(abs(suffix_frac - configured) <= 0.02,
          f"measured suffix_frac {suffix_frac} against {configured}")
    check(launches > 0, "the durable rebuild launched no FSM kernel")
    return launches


class VisibilityTee:
    """A visibility store whose writes also go to a bus topic (the
    indexer's producer side, ``BusVisibilityClient``), as a history host
    that writes visibility through Kafka does; reads stay on the store."""

    def __init__(self, store, producer):
        self._store, self._producer = store, producer

    def __getattr__(self, name):
        return getattr(self._store, name)

    def record_workflow_execution_started(self, rec):
        self._store.record_workflow_execution_started(rec)
        self._producer.record_workflow_execution_started(rec)

    def record_workflow_execution_closed(self, rec):
        self._store.record_workflow_execution_closed(rec)
        self._producer.record_workflow_execution_closed(rec)

    def upsert_workflow_execution(self, rec):
        self._store.upsert_workflow_execution(rec)
        self._producer.upsert_workflow_execution(rec)

    def delete_workflow_execution(self, domain_id, workflow_id, run_id):
        self._store.delete_workflow_execution(domain_id, workflow_id, run_id)
        self._producer.delete_workflow_execution(domain_id, workflow_id,
                                                 run_id)


def ws_echo(ctx, input):
    """A workflow that runs one activity and completes with its result."""
    out = yield ctx.schedule_activity("ws-work", input)
    return out


def ws_sink(ctx, input):
    """A workflow that stays open, taking "ping" signals."""
    while True:
        yield ctx.wait_signal("ping")


def ws_wait(what, done, timeout_s=WS_WAIT_S, every_s=0.1):
    """Poll ``done()`` until it returns a true value; returns (it, s)."""
    t0 = time.perf_counter()
    while True:
        out = done()
        if out:
            return out, time.perf_counter() - t0
        check(time.perf_counter() - t0 < timeout_s,
              f"{what} not done after {timeout_s} s")
        time.sleep(every_s)


def ws_history(box, wf, run):
    """A run's history through the frontend, every page."""
    events, token = box.frontend.get_workflow_execution_history(
        WS_DOMAIN, wf, run)
    while token:
        more, token = box.frontend.get_workflow_execution_history(
            WS_DOMAIN, wf, run, next_token=token)
        events = events + more
    return [e.to_dict() for e in events]


def ws_parents(box, runs):
    """Drive the parents' decisions on their own task list, as a
    scripted poller: the first starts its children (policy TERMINATE
    for the first ``WS_PARENTS - WS_OFFLOADED``, ABANDON for the rest),
    a later one completes the parent once every child has started.
    Returns each parent's child workflow ids."""
    from cadence_tpu_torch.core.enums import (
        DecisionType, EventType, ParentClosePolicy)
    from cadence_tpu_torch.runtime.api import Decision

    children = {wf: [f"{wf}-child-{k}" for k in range(WS_CHILDREN)]
                for wf in runs}
    closed, t0 = set(), time.perf_counter()
    while len(closed) < len(runs):
        check(time.perf_counter() - t0 < WS_WAIT_S,
              f"{len(runs) - len(closed)} parents still open")
        task = box.frontend.poll_for_decision_task(
            WS_DOMAIN, WS_PARENT_TASK_LIST, identity="ws-parents",
            timeout_s=1.0)
        if task is None:
            continue
        types = [e.event_type for e in task.history]
        wf = task.workflow_id
        decisions = []
        if EventType.StartChildWorkflowExecutionInitiated not in types:
            policy = (ParentClosePolicy.Terminate
                      if int(wf.rsplit("-", 1)[1]) < WS_PARENTS - WS_OFFLOADED
                      else ParentClosePolicy.Abandon)
            decisions = [Decision(
                DecisionType.StartChildWorkflowExecution,
                {"workflow_id": cid, "workflow_type": "ws-sink",
                 "task_list": WS_TASK_LIST, "input": b"",
                 "execution_start_to_close_timeout_seconds": 36000,
                 "task_start_to_close_timeout_seconds": 600,
                 "parent_close_policy": int(policy)})
                for cid in children[wf]]
        elif types.count(EventType.ChildWorkflowExecutionStarted) \
                == WS_CHILDREN:
            decisions = [Decision(DecisionType.CompleteWorkflowExecution,
                                  {"result": b"parent done"})]
            closed.add(wf)
        box.frontend.respond_decision_task_completed(task.task_token,
                                                     decisions)
    return children


def ws_closed(box, wf, run=""):
    return not box.frontend.describe_workflow_execution(
        WS_DOMAIN, wf, run).is_running


def phase_worker_services(torch, np, S, RC, smi, tmp, device="cuda"):
    """Phase 15 (b): the worker services on the Onebox twin over sqlite.
    Returns FSM launches by route."""
    from cadence_tpu_torch.archival import ArchiverProvider, URI
    from cadence_tpu_torch.core.enums import CloseStatus
    from cadence_tpu_torch.frontend.domain_handler import ArchivalStatus
    from cadence_tpu_torch.messaging import MessageBus
    from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot
    from cadence_tpu_torch.runtime.api import (
        SignalRequest, StartWorkflowRequest)
    from cadence_tpu_torch.runtime.persistence.errors import (
        EntityNotExistsError)
    from cadence_tpu_torch.runtime.persistence.memory import (
        MemoryVisibilityManager)
    from cadence_tpu_torch.runtime.persistence.records import BranchToken
    from cadence_tpu_torch.runtime.persistence.sqlite import (
        create_sqlite_bundle)
    from cadence_tpu_torch.runtime.queues.retention import (
        delete_workflow_retention)
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        RebuildRequest, StateRebuilder)
    from cadence_tpu_torch.testing.onebox import Onebox
    from cadence_tpu_torch.visibility import AdvancedVisibilityStore
    from cadence_tpu_torch.worker import Worker
    from cadence_tpu_torch.worker.batcher import (
        BATCHER_TASK_LIST, BATCHER_WORKFLOW_TYPE)
    from cadence_tpu_torch.worker.indexer import BusVisibilityClient, Indexer
    from cadence_tpu_torch.worker.parent_close_policy import (
        ParentClosePolicyClient)
    from cadence_tpu_torch.worker.service import SYSTEM_DOMAIN

    t_phase = time.perf_counter()
    routes = FrontendRoutes(RC, prefix="worker")
    path = os.path.join(tmp, "worker.db")
    bundle = create_sqlite_bundle(path)
    commits = counted_commits(bundle)
    vbus = MessageBus()
    bundle.visibility = VisibilityTee(bundle.visibility,
                                      BusVisibilityClient(vbus))
    indexed = AdvancedVisibilityStore(MemoryVisibilityManager())
    indexer = Indexer(vbus, indexed)
    indexer.start()
    box = Onebox(num_shards=WS_SHARDS, persistence=bundle, checkpoints=True,
                 serving=True, device=device)
    routes.wrap(box.serving)
    box.start()
    workers, stopped = [], False
    t_wall = {}
    try:
        check(box.worker is not None and len(box.worker.workers) == 4,
              "the Onebox twin started no worker service")
        hist_uri = f"file://{tmp}/archive-history"
        vis_uri = f"file://{tmp}/archive-visibility"
        box.frontend.register_domain(
            WS_DOMAIN, retention_days=1,
            history_archival_status=ArchivalStatus.ENABLED,
            history_archival_uri=hist_uri,
            visibility_archival_status=ArchivalStatus.ENABLED,
            visibility_archival_uri=vis_uri)
        domain_id = box.domains.get_by_name(WS_DOMAIN).info.id
        for k in range(WS_WORKERS):
            w = Worker(box.frontend, WS_DOMAIN, WS_TASK_LIST,
                       identity=f"ws-worker-{k}")
            w.register_workflow("ws-echo", ws_echo)
            w.register_workflow("ws-sink", ws_sink)
            w.register_workflow("ws-batch-target", ws_sink)
            w.register_activity("ws-work", lambda b: b"done:" + b)
            workers.append(w)
            w.start()

        def start(wf, wtype, task_list=WS_TASK_LIST):
            return box.frontend.start_workflow_execution(StartWorkflowRequest(
                domain=WS_DOMAIN, workflow_id=wf, workflow_type=wtype,
                task_list=task_list, input=wf.encode(),
                request_id=f"ws-start-{wf}",
                execution_start_to_close_timeout_seconds=36000,
                task_start_to_close_timeout_seconds=600))

        # 1. workflows run to completion; each close is archived
        t0 = time.perf_counter()
        echo = {f"ws-echo-{i:05d}": None for i in range(WS_COMPLETED)}
        for wf in echo:
            echo[wf] = start(wf, "ws-echo")
        _, settle_s = ws_wait("the completed workflows", lambda: all(
            ws_closed(box, wf, run) for wf, run in echo.items()), every_s=0.5)
        t_wall["completed_s"] = time.perf_counter() - t0

        # 2. parents of children under a parent-close policy
        t0 = time.perf_counter()
        parents = {f"ws-parent-{i:03d}": None for i in range(WS_PARENTS)}
        for wf in parents:
            parents[wf] = start(wf, "ws-parent", WS_PARENT_TASK_LIST)
        children = ws_parents(box, parents)
        offloaded = list(parents)[WS_PARENTS - WS_OFFLOADED:]
        pcp = ParentClosePolicyClient(box.frontend)
        child_runs = {}
        for wf in parents:
            for cid in children[wf]:
                child_runs[cid] = box.frontend.describe_workflow_execution(
                    WS_DOMAIN, cid).run_id
        for wf in offloaded:
            pcp.send([{"domain": WS_DOMAIN, "workflow_id": cid,
                       "run_id": child_runs[cid], "policy": "terminate"}
                      for cid in children[wf]])
        ws_wait("the children's parent-close policy", lambda: all(
            ws_closed(box, cid, run) for cid, run in child_runs.items()),
            every_s=0.2)
        t_wall["parent_close_s"] = time.perf_counter() - t0
        child_status = [box.frontend.describe_workflow_execution(
            WS_DOMAIN, cid, run).close_status
            for cid, run in child_runs.items()]

        # 3. open workflows: two rounds of serving reads (a signal
        # between), then one batch workflow terminates them
        targets = {f"ws-open-{i:04d}": None for i in range(WS_BATCH)}
        for wf in targets:
            targets[wf] = start(wf, "ws-batch-target")
        box.history.drain_queues()
        reads, read_ms = [], []
        for rnd in range(2):
            for wf, run in targets.items():
                t1 = time.perf_counter()
                got = box.history.serving_read(domain_id, wf, run)
                read_ms.append((time.perf_counter() - t1) * 1e3)
                check(got is not None, f"serving_read of {wf} is None")
                reads.append((wf, got))
                if rnd == 0:
                    box.frontend.signal_workflow_execution(SignalRequest(
                        domain=WS_DOMAIN, workflow_id=wf,
                        signal_name="ping", input=b"1",
                        request_id=f"ws-ping-{wf}"))
        rb = StateRebuilder(box.persistence.history, device="cpu")
        read_mism = []
        for wf, got in reads:
            tip = got.snapshot["exec"]["next_event_id"]
            token = box.persistence.execution.get_workflow_execution(
                box.history.controller.shard_for(wf), domain_id, wf,
                targets[wf]).snapshot["execution_info"]["branch_token"]
            ms, _, _ = rb.rebuild(RebuildRequest(
                domain_id, wf, targets[wf], token, next_event_id=tip))
            if got.snapshot != mutable_state_to_snapshot(ms):
                read_mism.append(wf)
        box.history.drain_queues()
        open_before = {
            wf for wf in list(targets) + list(child_runs)
            if not ws_closed(box, wf)}
        t0 = time.perf_counter()
        batch_run = box.frontend.start_workflow_execution(
            StartWorkflowRequest(
                domain=SYSTEM_DOMAIN, workflow_id="ws-batch-1",
                workflow_type=BATCHER_WORKFLOW_TYPE,
                task_list=BATCHER_TASK_LIST, input=json.dumps({
                    "operation": "terminate", "domain": WS_DOMAIN,
                    "query": "WorkflowType = 'ws-batch-target' "
                             "AND CloseTime = 0",
                    "params": {"reason": "phase 15 batch"}}).encode(),
                execution_start_to_close_timeout_seconds=3600))
        ws_wait("the batch workflow", lambda: not (
            box.frontend.describe_workflow_execution(
                SYSTEM_DOMAIN, "ws-batch-1", batch_run).is_running),
            every_s=0.05)
        t_wall["batch_s"] = time.perf_counter() - t0
        last = box.frontend.get_workflow_execution_history(
            SYSTEM_DOMAIN, "ws-batch-1", batch_run)[0][-1]
        batch_summary = json.loads(last.attributes.get("result", b"{}"))
        batch_closed = {wf for wf in targets
                        if box.frontend.describe_workflow_execution(
                            WS_DOMAIN, wf).close_status
                        == CloseStatus.Terminated}

        # 4. every closed run archived; histories read before retention
        closed = {**echo, **parents, **child_runs, **targets}
        arch = ArchiverProvider.default()
        harch = arch.get_history_archiver("file")
        huri = URI.parse(hist_uri)

        def archived(wf, run):
            try:
                return harch.get(huri, domain_id, wf, run)[0]
            except FileNotFoundError:
                return None

        t0 = time.perf_counter()
        ws_wait("archival of every closed run", lambda: all(
            os.path.exists(harch._path(huri, domain_id, wf, run))
            for wf, run in closed.items()), every_s=0.5)
        t_wall["archive_wait_s"] = time.perf_counter() - t0
        box.history.drain_queues()
        before = {wf: ws_history(box, wf, run) for wf, run in closed.items()}
        close_to_archived = [
            (os.stat(harch._path(huri, domain_id, wf, run)).st_mtime_ns
             - before[wf][-1]["timestamp"]) / 1e6
            for wf, run in closed.items()]
        arch_mism = [wf for wf, run in closed.items()
                     if [e.to_dict() for b in archived(wf, run) for e in b]
                     != before[wf]]
        varch = arch.get_visibility_archiver("file")
        vrecs, token = varch.query(URI.parse(vis_uri), domain_id, "")
        while token:
            more, token = varch.query(URI.parse(vis_uri), domain_id, "",
                                      next_token=token)
            vrecs = vrecs + more
        vis_archived = {(r.workflow_id, r.run_id) for r in vrecs}

        # 5. the indexer's store against the primary's, then retention
        box.history.drain_queues()

        def vis_counts(vis):
            return {"all": vis.count_workflow_executions(domain_id),
                    "open": vis.count_workflow_executions(domain_id,
                                                          open_only=True)}

        counts = {"store": vis_counts(box.visibility)}
        counts["indexer"], t_wall["indexer_wait_s"] = ws_wait(
            "the indexer", lambda: vis_counts(indexed) == counts["store"]
            and counts["store"], 60.0, 0.05)
        t0 = time.perf_counter()
        for wf, run in closed.items():
            sid = box.history.controller.shard_for(wf)
            engine = box.history.controller.get_engine_for_shard(sid)
            delete_workflow_retention(
                engine.shard, engine,
                types.SimpleNamespace(domain_id=domain_id, workflow_id=wf,
                                      run_id=run))
        t_wall["retention_s"] = time.perf_counter() - t0
        still = []
        for wf, run in closed.items():
            try:
                box.persistence.execution.get_workflow_execution(
                    box.history.controller.shard_for(wf), domain_id, wf,
                    run)
                still.append(wf)
            except EntityNotExistsError:
                pass
        t0 = time.perf_counter()
        after_mism = [wf for wf, run in closed.items()
                      if ws_history(box, wf, run) != before[wf]]
        t_wall["archived_reads_s"] = time.perf_counter() - t0
        counts["store_after"] = vis_counts(box.visibility)
        counts["indexer_after"], _ = ws_wait(
            "the indexer's deletes", lambda: vis_counts(indexed)
            == counts["store_after"] and counts["store_after"], 60.0, 0.05)

        # 6. orphan trees and two passes of the history scavenger
        from cadence_tpu_torch.core import history_factory as F

        # two passes first: the trees that starts which collided with a
        # concurrent start left behind (the branch is written before the
        # execution record) go, and the scavenger's memory is settled
        scanner = box.worker.workers[1].activities._activities
        settle = [json.loads(scanner["scavenge_history"](b""))
                  for _ in range(2)]
        h = box.persistence.history
        live_trees = {t for t, _ in h.list_history_trees()}
        orphans = set()
        for i in range(WS_ORPHANS):
            br = h.new_history_branch(tree_id=f"ws-orphan-{i:03d}")
            h.append_history_nodes(br, [F.workflow_execution_started(
                1, 0, 0, task_list="x", workflow_type="t")],
                transaction_id=1)
            orphans.add(br.tree_id)
        passes = []
        for _ in range(2):
            t1 = time.perf_counter()
            out = json.loads(scanner["scavenge_history"](b""))
            passes.append(dict(out, wall_s=time.perf_counter() - t1))
        trees_after = {t for t, _ in h.list_history_trees()}
        # every execution left (the system domain's) keeps its history
        unreadable = []
        for sid in box.history.controller.shard_ids():
            for dom, wf, run in box.persistence.execution \
                    .list_concrete_executions(sid):
                snap = box.persistence.execution.get_workflow_execution(
                    sid, dom, wf, run).snapshot
                token = snap["execution_info"]["branch_token"]
                branch = BranchToken.from_json(
                    token.decode() if isinstance(token, bytes) else token)
                if not h.read_history_branch(branch, 1, 1 << 60)[0]:
                    unreadable.append(wf)

        # the phase's rates, before the drain
        t_wall["before_stop_s"] = time.perf_counter() - t_phase
        commits_total = commits[0]
        for w in workers:
            w.stop()
        t0 = time.perf_counter()
        box.stop()
        stopped = True
        t_wall["stop_s"] = time.perf_counter() - t0
    finally:
        for w in workers:
            w.stop()
        if not stopped:
            box.stop()
        indexer.stop()
        bundle.close()
    lost_live = live_trees - trees_after
    left_orphans = orphans & trees_after
    status_counts = {}
    for st in child_status:
        status_counts[int(st)] = status_counts.get(int(st), 0) + 1
    rec = {
        "phase": "worker_store", "part": "worker_services",
        "shards": WS_SHARDS, "workers": WS_WORKERS,
        "completed": WS_COMPLETED, "parents": WS_PARENTS,
        "children": len(child_runs), "offloaded_parents": WS_OFFLOADED,
        "batch_targets": WS_BATCH, "orphans": WS_ORPHANS,
        "closed_runs": len(closed), "settle_s": settle_s,
        "walls_s": t_wall,
        "close_to_archived_ms": percentiles(np, close_to_archived),
        "serving_read_ms": percentiles(np, read_ms),
        "batch_summary": batch_summary,
        "batch_terminated": len(batch_closed),
        "scavenger_settle_passes": settle, "scavenger_passes": passes,
        "commits": commits_total,
        "commits_per_s": commits_total / t_wall["before_stop_s"],
        "visibility_counts": counts,
        "visibility_archived": len(vis_archived),
        "children_close_status": status_counts,
        "launches_by_route": dict(routes.counts),
        "mismatches": {
            "archived_history": len(arch_mism),
            "archived_reads": len(after_mism),
            "serving_reads": len(read_mism),
            "executions_left": len(still)},
        "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(rec)
    check(not arch_mism, f"{len(arch_mism)} archived histories differ, "
          f"first {arch_mism[:3]}")
    check(not after_mism and not still,
          f"after retention {len(after_mism)} reads differ from the "
          f"archive and {len(still)} executions are left")
    check(not read_mism, f"{len(read_mism)} serving reads differ from the "
          f"host replay, first {read_mism[:3]}")
    check(vis_archived == set(closed.items()),
          f"{len(set(closed.items()) - vis_archived)} visibility records "
          "missing from the archive")
    check(status_counts == {int(CloseStatus.Terminated): len(child_runs)},
          f"children's close statuses {status_counts}")
    check(batch_summary.get("done") == WS_BATCH
          and batch_summary.get("failed") == 0
          and batch_closed == set(targets)
          and open_before == set(targets),
          f"the batch terminated {batch_summary} of {WS_BATCH}")
    check(passes[0]["deleted"] == 0 and passes[1]["deleted"] == WS_ORPHANS
          and not left_orphans and not lost_live and not unreadable,
          f"the scavenger's passes {passes}, {len(left_orphans)} orphans "
          f"left, {len(lost_live)} other trees lost, {len(unreadable)} "
          "executions without their history")
    want_all = WS_COMPLETED + WS_PARENTS + len(child_runs) + WS_BATCH
    check(counts["store"] == counts["indexer"]
          == {"all": want_all, "open": 0}
          and counts["store_after"] == counts["indexer_after"]
          == {"all": 0, "open": 0},
          f"visibility counts {counts}, want {want_all} closed then none")
    for route, k in routes.counts.items():
        check(k > 0, f"the worker phase made no {route} launch")
    return dict(routes.counts)


def phase_push_replication(smi, device="cuda"):
    """Phase 15 (c): the push replicator between two Onebox twins."""
    from cadence_tpu_torch.runtime.api import (
        SignalRequest, StartWorkflowRequest)
    from cadence_tpu_torch.testing.onebox import Onebox
    from cadence_tpu_torch.worker.replicator import (
        ReplicationPublisher, replication_topic)
    from cadence_tpu_torch.worker.service import WorkerService

    t_phase = time.perf_counter()
    active = Onebox(num_shards=PUSH_SHARDS, start_worker=False,
                    cluster_metadata=repl_meta("active"),
                    device=device).start()
    standby = Onebox(num_shards=PUSH_SHARDS, start_worker=False,
                     cluster_metadata=repl_meta("standby"),
                     device=device).start()
    service = WorkerService(
        standby.frontend, standby.persistence, num_shards=PUSH_SHARDS,
        bus=active.bus, domain_handler=standby.domain_handler,
        history_service=standby.history, replication_sources=["active"])
    service.start()
    try:
        # the global domain: registered, then updated, on the active
        domain_id = active.domain_handler.register_domain(
            PUSH_DOMAIN, is_global=True, clusters=["active", "standby"],
            active_cluster="active")
        active.domain_handler.update_domain(
            PUSH_DOMAIN, description="push replication", retention_days=3)
        want_dom = active.domain_handler.describe_domain(name=PUSH_DOMAIN)

        def domain_applied():
            try:
                got = standby.domain_handler.describe_domain(
                    name=PUSH_DOMAIN)
            except Exception:
                return False
            return got.config == want_dom.config and \
                got.info == want_dom.info
        _, domain_s = ws_wait("the domain update on the standby",
                              domain_applied, 60.0, 0.05)

        t0 = time.perf_counter()
        runs = {}
        for i in range(PUSH_WORKFLOWS):
            wf = f"push-{i:04d}"
            runs[wf] = active.frontend.start_workflow_execution(
                StartWorkflowRequest(
                    domain=PUSH_DOMAIN, workflow_id=wf, workflow_type="t",
                    task_list=PUSH_TASK_LIST, request_id=f"push-start-{i}",
                    execution_start_to_close_timeout_seconds=36000,
                    task_start_to_close_timeout_seconds=600))
            for k in range(PUSH_SIGNALS):
                active.frontend.signal_workflow_execution(SignalRequest(
                    domain=PUSH_DOMAIN, workflow_id=wf, signal_name="s",
                    input=b"%d" % k, request_id=f"push-sig-{i}-{k}"))
        write_s = time.perf_counter() - t0
        publisher = ReplicationPublisher(active.history, active.bus,
                                         "active")
        t0 = time.perf_counter()
        published = 0
        while True:
            n = publisher.publish_once()
            published += n
            if not n:
                break
        publish_s = time.perf_counter() - t0
        a = types.SimpleNamespace(svc=active.history, domain_id=domain_id,
                                  domain=PUSH_DOMAIN)
        b = types.SimpleNamespace(svc=standby.history, domain_id=domain_id,
                                  domain=PUSH_DOMAIN)
        tips = repl_tips(types.SimpleNamespace(
            persistence=active.persistence, svc=active.history,
            domain_id=domain_id), runs)

        def applied():
            got = repl_tips(types.SimpleNamespace(
                persistence=standby.persistence, svc=standby.history,
                domain_id=domain_id), runs)
            return got == tips
        _, apply_s = ws_wait("the standby's apply", applied, 300.0, 0.05)
        apply_s += publish_s
        states, hists = repl_mismatches(a, b, runs)
        dlq = len(active.bus.dlq_messages(replication_topic("active")))
    finally:
        service.stop()
        standby.stop()
        active.stop()
    rec = {"phase": "worker_store", "part": "push_replication",
           "shards": PUSH_SHARDS, "workflows": PUSH_WORKFLOWS,
           "signals_each": PUSH_SIGNALS, "published": published,
           "write_s": write_s, "publish_s": publish_s,
           "apply_s": apply_s, "apply_tasks_per_s": published / apply_s,
           "domain_apply_s": domain_s, "dlq": dlq,
           "mismatches": {"states": states, "histories": hists},
           "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(rec)
    want = PUSH_WORKFLOWS * (1 + PUSH_SIGNALS)
    check(published == want, f"published {published} tasks, want {want}")
    check(not (states or hists or dlq),
          f"push replication: {states} states and {hists} histories "
          f"differ, {dlq} tasks in the DLQ")


def phase_worker_store(torch, np, S, P, RC, unpack, smi, p8,
                       device="cuda"):
    """Phase 15: (a) the durable rebuild, (b) the worker services,
    (c) the push replicator. Returns FSM launches by route."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ws_") as tmp:
        durable = phase_durable_rebuild(torch, np, S, P, unpack, RC, p8,
                                        tmp)
        launches = {"durable_rebuild": durable}
        launches.update(phase_worker_services(torch, np, S, RC, smi, tmp,
                                              device=device))
        phase_push_replication(smi, device=device)
    emit({"phase": "worker_store", "part": "summary",
          "phase_s": time.perf_counter() - t0, "launches_by_route": launches,
          "nvidia_smi": smi})
    return launches


# -- phase 16: the server's entry points ----------------------------------

# phase 16, the server's entry points over the wire. (a) config_host: one
# history host's worth of services booted from a config by start_services
# in the script's process (memory store, 4 shards, loopback ports for the
# four services, the serving section on at 512 lanes, a lane a
# workflow), the config read from a YAML file as well; 512 workflows
# (1,024 until phase 18 needed the run's time: a slow host ran the whole
# script in 1,052.5 s) started through a RemoteFrontend (every fourth with an activity, each
# then looping on "ping"), answered by 8 SDK workers (sticky) over gRPC;
# a signal each, then RemoteHistory.serving_read of every workflow (a
# cold miss that seats it), a second signal each, then a second read (a
# resident hit whose tick composes the signal's events), every read
# against the host StateBuilder replay of the history fetched over the
# wire at the read's tip; then the canary's 20 probes over the wire. (b)
# two_process: the CLI's server in a child process with the history and
# matching services over a sqlite file both processes share, 16 shards
# (tests/test_two_process_plane.py's ring), the serving section on, on
# the card; the script's process runs the frontend alone, which routes
# over the ring and gRPC; 256 workflows through it, a signal each, a
# serving_read each over the child's history endpoint against the host
# replay; SIGTERM ends the child. (c) cli: the operator CLI in
# subprocesses against (a)'s frontend, each JSON output against (a)'s
# in-process answer; the schema verbs on a sqlite file; the CLI's Onebox
# server started, pinged and ended by SIGTERM; a pprof device trace around
# one serving tick
ENTRY_SHARDS, ENTRY_WORKFLOWS, ENTRY_WORKERS = 4, 512, 8
ENTRY_BUSY_READS, ENTRY_WAIT_S, ENTRY_READY_S = 256, 300.0, 120.0
ENTRY_PINGS = 256
ENTRY_DOMAIN, ENTRY_TASK_LIST = "entry-domain", "entry-tl"
TWO_PROC_SHARDS, TWO_PROC_WORKFLOWS, TWO_PROC_WORKERS = 16, 256, 4
CLI_DOMAIN, CLI_WORKFLOW, CLI_TOPIC, CLI_TIMEOUT_S = (
    "cli-domain", "cli-wf", "entry-poison", 120)
CLI_CANARY_PROBES = "echo,signal,query"
FSM_KERNEL_NAME = "replay_fsm_kernel"
# idle seconds at each end of the pprof trace: late in this script's
# whole run the profiler dropped every device activity of a ~0.1 s
# window (its runtime calls kept) while a window of seconds kept them,
# as if the device timestamps had drifted out of a short window
ENTRY_TRACE_PAD_S = 2.0


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def entry_raw_config(shards, lanes, store, services):
    """A config dict: ``services`` maps a service to its port, the ring
    seeded with them, the serving section on at ``lanes`` (idle for twice
    that many ticks before a lane evicts)."""
    addrs = {s: f"127.0.0.1:{p}" for s, p in services.items()}
    return {
        "persistence": {"numHistoryShards": shards, **store},
        "services": {s: {"rpcAddress": a} for s, a in addrs.items()},
        "ring": {"bootstrapHosts": {
            s: [addrs[s]] for s in ("history", "matching") if s in addrs}},
        "serving": {"enabled": True, "lanes": lanes,
                    "idleTicks": 2 * lanes},
    }


def host_snapshot(domain_id, wf, run, batches):
    """The port's host oracle: ``StateBuilder`` over event batches, in
    the canonical snapshot form the serving reads carry."""
    from cadence_tpu_torch.core.mutable_state import MutableState
    from cadence_tpu_torch.core.state_builder import StateBuilder
    from cadence_tpu_torch.core.version_history import VersionHistories
    from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot

    ms = MutableState(domain_id=domain_id)
    ms.version_histories = VersionHistories.new_empty()
    StateBuilder(ms).apply_batches(domain_id, "", wf, run, batches)
    return mutable_state_to_snapshot(ms)


def cli_echo(ctx, input):
    """(c)'s workflow: waits for "go", returns the input and the
    signal's payload."""
    payload = yield ctx.wait_signal("go")
    return input + b":" + payload


def entry_workers(RemoteFrontend, Worker, address, domain, n, seen, lat):
    """``n`` SDK workers, each over its own channel to the frontend."""
    out = []
    for k in range(n):
        w = Worker(RemoteFrontend(address), domain, ENTRY_TASK_LIST,
                   identity=f"entry-worker-{k}")
        w.register_workflow("fe-signal-sink", fe_workflow(seen))
        w.register_workflow("cli-echo", cli_echo)
        w.register_activity("fe-work", lambda b: b"done:" + b)
        w.decisions.poll_and_process_one = fe_timed(
            w.decisions.poll_and_process_one, lat)
        w.start()
        out.append(w)
    return out


def stop_workers(workers):
    for w in workers:
        w.stop()
        w.decisions.frontend.close()


def entry_start(fe, StartWorkflowRequest, domain, wfs, lat, tag):
    runs = {}
    for i, wf in enumerate(wfs):
        t0 = time.perf_counter()
        runs[wf] = fe.start_workflow_execution(StartWorkflowRequest(
            domain=domain, workflow_id=wf, workflow_type="fe-signal-sink",
            task_list=ENTRY_TASK_LIST, input=b"%d" % i,
            request_id=f"{tag}-start-{i}",
            execution_start_to_close_timeout_seconds=36000,
            task_start_to_close_timeout_seconds=3600))
        lat.append((time.perf_counter() - t0) * 1e3)
    return runs


def entry_signal(fe, SignalRequest, domain, runs, lat, tag):
    for i, wf in enumerate(runs):
        t0 = time.perf_counter()
        fe.signal_workflow_execution(SignalRequest(
            domain=domain, workflow_id=wf, signal_name="ping",
            input=b"%d" % i, identity="entry-caller",
            request_id=f"{tag}-{i}"))
        lat.append((time.perf_counter() - t0) * 1e3)


def entry_check_read(got, want_batches, domain_id, wf, run):
    """A serving read against the host replay of the batches fetched
    over the wire at its tip; returns whether they agree."""
    return got is not None and got.snapshot == host_snapshot(
        domain_id, wf, run, want_batches)


def entry_reads(hist, fe, domain, domain_id, runs, lat_read, lat_fetch,
                mismatches):
    """A serving read of every workflow over the history endpoint, each
    against the host replay of the history the frontend serves at the
    read's tip (its raw batches, which flatten to its paged history)."""
    reads = {}
    for wf, run in runs.items():
        t0 = time.perf_counter()
        reads[wf] = hist.serving_read(domain_id, wf, run)
        lat_read.append((time.perf_counter() - t0) * 1e3)
    for wf, run in runs.items():
        got = reads[wf]
        tip = got.snapshot["exec"]["next_event_id"]
        t0 = time.perf_counter()
        batches, _ = fe.get_workflow_execution_raw_history(
            domain, wf, run, 1, tip)
        events, token = fe.get_workflow_execution_history(domain, wf, run)
        lat_fetch.append((time.perf_counter() - t0) * 1e3)
        flat = [e.to_dict() for b in batches for e in b]
        if (token or flat != [e.to_dict() for e in events]
                or not entry_check_read(got, batches, domain_id, wf, run)):
            mismatches.append(wf)
    return reads


def entry_host(RC, tmp, yaml, device):
    """(a)'s host, booted by ``start_services`` from a config (read from a
    YAML file too when ``yaml`` imports), with its engine's launches
    counted by route; returns (host, routes, whether the file was read)."""
    from cadence_tpu_torch.config import (
        load_config, load_config_dict, start_services)

    ports = {s: free_port() for s in ("frontend", "history", "matching",
                                      "worker")}
    raw = entry_raw_config(ENTRY_SHARDS, ENTRY_WORKFLOWS,
                           {"defaultStore": "memory"}, ports)
    raw["services"]["frontend"]["pprofPort"] = free_port()
    cfg = load_config_dict(raw)
    from_file = False
    if yaml is not None:
        path = os.path.join(tmp, "config_host.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
        check(load_config(path) == cfg, "load_config of the YAML file "
              "differs from load_config_dict of its dict")
        from_file = True
    host = start_services(cfg, device=device)
    routes = FrontendRoutes(RC, prefix="entry")
    routes.wrap(host.serving)
    return host, routes, from_file


def phase_entry_config_host(torch, np, smi, fe_host_ms, host, fe, hist,
                            boot):
    """(a): the traffic, the reads and the canary over the wire; returns
    the domain id, the runs and the part's record. The SDK workers go
    into ``boot["workers"]`` for the caller to stop."""
    from cadence_tpu_torch.canary import run_canary
    from cadence_tpu_torch.rpc.client import RemoteFrontend
    from cadence_tpu_torch.runtime.api import (
        SignalRequest, StartWorkflowRequest)
    from cadence_tpu_torch.worker import Worker

    t_part = time.perf_counter()
    n = ENTRY_WORKFLOWS
    addr = host.addresses
    lat = {k: [] for k in ("start", "signal", "cold_read", "resident_read",
                           "history_fetch", "sdk_decision", "wire_ping")}
    seen, mismatches = {}, []
    reg = host.metrics.registry
    wfs = [f"entry-wf-{i:05d}" for i in range(n)]
    domain_id = fe.register_domain(ENTRY_DOMAIN)
    workers = entry_workers(RemoteFrontend, Worker, addr["frontend"],
                            ENTRY_DOMAIN, ENTRY_WORKERS, seen,
                            lat["sdk_decision"])
    boot["workers"] = workers
    t_traffic = time.perf_counter()
    runs = entry_start(fe, StartWorkflowRequest, ENTRY_DOMAIN, wfs,
                       lat["start"], "entry")
    entry_signal(fe, SignalRequest, ENTRY_DOMAIN, runs, lat["signal"],
                 "entry-sig-0")
    settle_s = fe_wait_settled(host, domain_id, runs, "the first signal")
    traffic_s = time.perf_counter() - t_traffic
    # the bare round trip: the endpoint's built-in ping, no handler
    for _ in range(ENTRY_PINGS):
        t0 = time.perf_counter()
        check(fe.ping() == {"ok": True}, "the frontend's ping failed")
        lat["wire_ping"].append((time.perf_counter() - t0) * 1e3)

    # the first reads: cold misses that seat, a window under the profiler
    misses0 = reg.counter_value("serving_cold_misses")
    t0 = time.perf_counter()
    head = dict(list(runs.items())[:ENTRY_BUSY_READS])
    tail = dict(list(runs.items())[ENTRY_BUSY_READS:])
    busy = device_busy(torch, lambda: entry_reads(
        hist, fe, ENTRY_DOMAIN, domain_id, head, lat["cold_read"],
        lat["history_fetch"], mismatches))
    entry_reads(hist, fe, ENTRY_DOMAIN, domain_id, tail, lat["cold_read"],
                lat["history_fetch"], mismatches)
    cold_s = time.perf_counter() - t0
    cold_misses = reg.counter_value("serving_cold_misses") - misses0

    # a second signal, then the resident reads whose ticks compose it
    entry_signal(fe, SignalRequest, ENTRY_DOMAIN, runs, lat["signal"],
                 "entry-sig-1")
    settle2_s = fe_wait_settled(host, domain_id, runs, "the second signal")
    hits0 = reg.counter_value("serving_resident_hits")
    t0 = time.perf_counter()
    entry_reads(hist, fe, ENTRY_DOMAIN, domain_id, runs,
                lat["resident_read"], lat["history_fetch"], mismatches)
    resident_s = time.perf_counter() - t0
    resident_hits = reg.counter_value("serving_resident_hits") - hits0
    misses_after = reg.counter_value("serving_cold_misses") - misses0

    # the canary over the wire
    t0 = time.perf_counter()
    canary = run_canary(address=addr["frontend"])
    canary_s = time.perf_counter() - t0
    failed = [r for r in canary if not r["ok"]]
    rec = {
        "phase": "entry_points", "part": "config_host", "workflows": n,
        "workers": ENTRY_WORKERS, "shards": ENTRY_SHARDS,
        "services": sorted(host.services),
        "config_from_yaml_file": boot["from_file"],
        "boot_s": boot["boot_s"], "traffic_s": traffic_s,
        "settle_s": settle_s,
        "settle_second_signal_s": settle2_s,
        # the starts and the first signals, their decisions settled
        "verbs_per_s": 2 * n / traffic_s,
        "cold_reads_s": cold_s, "resident_reads_s": resident_s,
        "reads_per_s": 2 * n / (cold_s + resident_s),
        "host_ms_over_wire": {k: percentiles(np, v) for k, v in lat.items()},
        "host_ms_in_process_phase12": fe_host_ms,
        "cold_misses": cold_misses, "resident_hits": resident_hits,
        "cold_misses_in_resident_pass": misses_after - cold_misses,
        "read_mismatches": len(mismatches),
        "device_busy": {"cold_reads": ENTRY_BUSY_READS, **busy},
        "canary": {"probes": len(canary), "failed": failed,
                   "wall_s": canary_s,
                   "latency_ms": {r["probe"]: r["latency_ms"]
                                  for r in canary}},
        "part_s": time.perf_counter() - t_part, "nvidia_smi": smi}
    check(not mismatches, f"{len(mismatches)} serving reads differ from the "
          f"host replay over the wire, first {mismatches[:3]}")
    check(cold_misses == n and resident_hits == n
          and misses_after == cold_misses,
          f"{cold_misses} cold misses and {resident_hits} resident hits "
          f"({misses_after - cold_misses} misses in the resident pass) for "
          f"{n} workflows")
    check(len(canary) == 20 and not failed,
          f"canary over gRPC: {len(canary)} probes, failed {failed}")
    return domain_id, runs, rec


def cli_env():
    return dict(os.environ, PYTHONPATH=str(ROOT))


def cli_child(args, log):
    """The CLI with ``args`` in a child process, its output in ``log``."""
    with open(log, "w") as lf:
        return subprocess.Popen(
            [sys.executable, "-m", "cadence_tpu_torch.tools.cli", *args],
            cwd=str(ROOT), env=cli_env(), stdout=lf,
            stderr=subprocess.STDOUT, text=True)


def await_ping(child, log, endpoints, what):
    """Seconds until every (service, address) of a child answers a ping;
    fails if the child exits first or takes ENTRY_READY_S."""
    from cadence_tpu_torch.rpc.client import grpc_ping

    t0 = time.perf_counter()
    while not all(grpc_ping(s, a) for s, a in endpoints):
        check(child.poll() is None,
              f"{what} exited: " + Path(log).read_text()[-1500:])
        check(time.perf_counter() - t0 < ENTRY_READY_S,
              f"{what} never answered a ping")
        time.sleep(0.2)
    return time.perf_counter() - t0


def end_child(child):
    """SIGTERM, then the exit code (None if it had to be killed)."""
    if child.poll() is None:
        child.send_signal(signal.SIGTERM)
    try:
        return child.wait(timeout=60)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait(timeout=10)
        return None


def cli_runs(cmds, address=None):
    """The CLI's commands in parallel subprocesses: [(rc, stdout,
    stderr)] in order."""
    base = [sys.executable, "-m", "cadence_tpu_torch.tools.cli"]
    if address:
        base += ["--address", address]
    procs = [subprocess.Popen(base + c, cwd=str(ROOT), env=cli_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    out = []
    for c, p in zip(cmds, procs):
        try:
            o, e = p.communicate(timeout=CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            raise RuntimeError(f"check failed: cli {c} timed out")
        out.append((p.returncode, o, e))
    return out


def cli_json(res, what):
    rc, out, err = res
    check(rc == 0, f"cli {what} exited {rc}: {err[-1500:]}")
    return json.loads(out)


def as_cli_json(obj):
    """What the CLI prints for ``obj``, read back as JSON."""
    from cadence_tpu_torch.tools import cli

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    return json.loads(json.dumps(obj, default=cli._default))


def poison(bus, key):
    """One message nacked past its redelivery budget into the DLQ."""
    bus.publish(CLI_TOPIC, key, b"bad payload")
    consumer = bus.new_consumer(CLI_TOPIC, "entry-g")
    while not bus.dlq_messages(CLI_TOPIC):
        msg = consumer.poll(timeout=1.0)
        check(msg is not None, "the poisoned message vanished")
        consumer.nack(msg)


def trace_kernels(path):
    """The names of the CUDA kernels in a Chrome trace file, and its
    count of events by category."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cats = {}
    for e in events:
        cats[e.get("cat", "")] = cats.get(e.get("cat", ""), 0) + 1
    return (sorted({e["name"] for e in events if e.get("cat") == "kernel"}),
            cats)


def phase_entry_pprof(host, fe, hist, domain_id, runs, tmp):
    """One pprof device-trace round trip around one serving tick: inside
    the trace a signal dirties a seated lane and its decision settles,
    then a read; whichever read composes the lane first (this one, or
    one the host makes meanwhile) ticks it inside the window."""
    import http.client

    wf, run = next(iter(runs.items()))
    trace_dir = os.path.join(tmp, "pprof_trace")

    def post(path):
        h, p = host.pprof.address.rsplit(":", 1)
        conn = http.client.HTTPConnection(h, int(p), timeout=60)
        try:
            conn.request("POST", path)
            resp = conn.getresponse()
            return resp.status, resp.read().decode()
        finally:
            conn.close()

    from cadence_tpu_torch.ops import replay_cuda as RC
    from cadence_tpu_torch.runtime.api import SignalRequest

    launches0 = RC.replay_rows.launches
    status, body = post(f"/debug/pprof/device/start?dir={trace_dir}")
    check(status == 200, f"pprof device start answered {status}: {body}")
    time.sleep(ENTRY_TRACE_PAD_S)
    fe.signal_workflow_execution(SignalRequest(
        domain=ENTRY_DOMAIN, workflow_id=wf, signal_name="ping",
        input=b"pprof", identity="entry-caller", request_id="entry-pprof"))
    fe_wait_settled(host, domain_id, {wf: run}, "the pprof signal")
    got = hist.serving_read(domain_id, wf, run)
    time.sleep(ENTRY_TRACE_PAD_S)
    status, body = post("/debug/pprof/device/stop")
    check(status == 200, f"pprof device stop answered {status}: {body}")
    launches = RC.replay_rows.launches - launches0
    path = body.split("-> ", 1)[1].strip()
    kernels, cats = trace_kernels(path)
    tip = got.snapshot["exec"]["next_event_id"]
    batches, _ = fe.get_workflow_execution_raw_history(
        ENTRY_DOMAIN, wf, run, 1, tip)
    check(entry_check_read(got, batches, domain_id, wf, run),
          "the pprof-traced read differs from the host replay")
    check(any(FSM_KERNEL_NAME in k for k in kernels),
          f"the device trace names no {FSM_KERNEL_NAME}: {kernels[:8]}, "
          f"events by category {cats}, FSM launches in the window "
          f"{launches}")
    return {"trace_file_bytes": os.path.getsize(path),
            "fsm_launches": launches, "events_by_category": cats,
            "kernels": kernels[:8]}


def phase_entry_cli(host, fe, hist, domain_id, runs, smi, tmp, device):
    """(c): the CLI against (a)'s frontend, the schema verbs, the CLI's
    server, the pprof round trip."""
    t_part = time.perf_counter()
    address = host.addresses["frontend"]
    db = os.path.join(tmp, "cli_schema.db")
    # the CLI's Onebox server boots while the verbs run
    port = free_port()
    log = os.path.join(tmp, "cli_server.log")
    server = cli_child(["server", "--db", os.path.join(tmp, "cli_server.db"),
                        "--port", str(port), "--no-worker", "--device",
                        device], log)
    try:
        rec = phase_entry_cli_verbs(host, address, db, smi, tmp, device)
        server_wait_s = await_ping(server, log, [
            ("frontend", f"127.0.0.1:{port}")], "the CLI server")
    finally:
        server_rc = end_child(server)
    server_log = Path(log).read_text()
    pprof = phase_entry_pprof(host, fe, hist, domain_id, runs, tmp)
    rec.update(server_wait_after_verbs_s=server_wait_s, server_rc=server_rc,
               pprof=pprof, part_s=time.perf_counter() - t_part)
    check(server_rc == 0 and f"listening on 127.0.0.1:{port}" in server_log,
          f"the CLI server exited {server_rc}: {server_log[-1500:]}")
    return rec


def phase_entry_cli_verbs(host, address, db, smi, tmp, device):
    """(c)'s verbs against (a)'s frontend and the schema verbs, each
    output against the in-process answer; returns the part's record."""
    from cadence_tpu_torch.runtime.persistence import schema as SC

    poison(host.bus, "k1")
    wf_args = ["--domain", ENTRY_DOMAIN, "--workflow-id", CLI_WORKFLOW]
    (reg, start, desc_host, qstate, dlq, canary) = cli_runs([
        ["domain", "register", "--name", CLI_DOMAIN],
        ["workflow", "start", *wf_args, "--type", "cli-echo",
         "--tasklist", ENTRY_TASK_LIST, "--input", "hello"],
        ["admin", "describe-host"],
        ["admin", "queue-state", "--shard-id", "0"],
        ["admin", "dlq", "read", "--topic", CLI_TOPIC],
        ["canary", "--probes", CLI_CANARY_PROBES, "--device", device],
    ], address)
    (setup,) = cli_runs([["schema", "setup", "--db", db]])
    domain_out = cli_json(reg, "domain register")
    run_id = cli_json(start, "workflow start")["run_id"]
    want_host = as_cli_json(host.admin.describe_history_host())
    got_host = cli_json(desc_host, "admin describe-host")
    got_q = cli_json(qstate, "admin queue-state")
    want_q = as_cli_json(host.admin.describe_queue_states(0))
    got_dlq = cli_json(dlq, "admin dlq read")
    msgs = host.admin.read_dlq_messages(CLI_TOPIC, -1, 100)
    got_canary = cli_json(canary, "canary")
    got_setup = cli_json(setup, "schema setup")
    (desc, sig, version, compat) = cli_runs([
        ["domain", "describe", "--name", CLI_DOMAIN],
        ["workflow", "signal", *wf_args, "--name", "go", "--input", "world"],
    ], address) + cli_runs([["schema", "version", "--db", db],
                            ["schema", "check", "--db", db]])
    got_desc = cli_json(desc, "domain describe")
    want_desc = as_cli_json(host.frontend.describe_domain(name=CLI_DOMAIN))
    got_sig = cli_json(sig, "workflow signal")
    (observe,) = cli_runs([["workflow", "observe", *wf_args,
                            "--timeout", "60"]], address)
    check(observe[0] == 0, f"cli workflow observe exited {observe[0]}: "
          f"{observe[2][-1500:]}")
    lines = observe[1].splitlines()
    brace = lines.index("{")
    observed = [ln.split()[1] for ln in lines[:brace]]
    observe_end = json.loads("\n".join(lines[brace:]))
    (show,) = cli_runs([["workflow", "show", *wf_args]], address)
    events, _ = host.frontend.get_workflow_execution_history(
        ENTRY_DOMAIN, CLI_WORKFLOW, run_id)
    want_show = as_cli_json([{
        "id": e.event_id, "type": e.event_type.name, "version": e.version,
        "attributes": {k: v for k, v in e.attributes.items()
                       if v not in (None, "", b"")}} for e in events])
    got_show = cli_json(show, "workflow show")

    rec = {
        "phase": "entry_points", "part": "cli",
        "verbs": ["domain register", "domain describe", "workflow start",
                  "workflow signal", "workflow observe", "workflow show",
                  "admin describe-host", "admin queue-state",
                  "admin dlq read", "canary", "schema setup",
                  "schema version", "schema check", "server"],
        "observed_events": len(observed), "observe_end": observe_end,
        "canary_probes": [r["probe"] for r in got_canary],
        "schema": {"setup": got_setup, "version": cli_json(
            version, "schema version"), "check": cli_json(
            compat, "schema check")},
        "nvidia_smi": smi}
    check(domain_out == {"domain_id": want_desc["info"]["id"]},
          f"domain register printed {domain_out}")
    check(got_desc == want_desc, "cli domain describe differs from the "
          "in-process describe_domain")
    check(set(got_host) == set(want_host)
          and got_host["host"] == want_host["host"],
          f"cli admin describe-host {got_host} against {want_host}")
    check(got_q["shard_id"] == 0 and [q["queue"] for q in got_q["queues"]]
          == [q["queue"] for q in want_q["queues"]],
          f"cli admin queue-state {got_q} against {want_q}")
    check(got_dlq == {"topic": CLI_TOPIC, "messages": [
        {"offset": m["offset"], "key": m["key"],
         "redelivery_count": m["redelivery_count"],
         "value_bytes": len(m["value"])} for m in msgs]} and len(msgs) == 1,
          f"cli admin dlq read {got_dlq} against {msgs}")
    check(got_sig == {"signaled": CLI_WORKFLOW}, f"cli signal: {got_sig}")
    check(observe_end == {"closed": True, "events": len(events)}
          and observed == [e.event_type.name for e in events],
          f"cli observe {observe_end} {observed} against "
          f"{len(events)} events")
    check(got_show == want_show, "cli workflow show differs from the "
          "in-process history")
    check(got_show[-1]["type"] == "WorkflowExecutionCompleted"
          and got_show[-1]["attributes"]["result"] == "hello:world",
          f"cli-echo closed with {got_show[-1]}")
    check(len(got_canary) == len(CLI_CANARY_PROBES.split(","))
          and all(r["ok"] for r in got_canary),
          f"cli canary: {got_canary}")
    check(got_setup["db_version"] == SC.CURRENT_SCHEMA_VERSION
          and [a["version"] for a in got_setup["applied"]]
          == [m[0] for m in SC.MIGRATIONS],
          f"cli schema setup: {got_setup}")
    check(rec["schema"]["version"] == {
        "db_version": SC.CURRENT_SCHEMA_VERSION,
        "build_version": SC.CURRENT_SCHEMA_VERSION}
          and rec["schema"]["check"] == {"compatible": True},
          f"cli schema version/check: {rec['schema']}")
    return rec


def entry_two_process_child(tmp, device):
    """(b)'s child: the CLI's server with history and matching over a
    sqlite file, the serving section on, on ``device``. Returns its
    config and process."""
    ports = {s: free_port() for s in ("frontend", "history", "matching")}
    raw = entry_raw_config(
        TWO_PROC_SHARDS, TWO_PROC_WORKFLOWS,
        {"defaultStore": "sqlite",
         "sqlitePath": os.path.join(tmp, "two_process.db")}, ports)
    path = os.path.join(tmp, "two_process.yaml")
    with open(path, "w") as f:
        json.dump(raw, f)  # JSON is YAML
    log = os.path.join(tmp, "two_process_child.log")
    child = cli_child(["server", "--config", path, "--services",
                       "history,matching", "--device", device], log)
    return {"raw": raw, "child": child, "log": log,
            "started": time.perf_counter()}


def phase_entry_two_process(np, smi, two, device):
    """(b): the frontend in this process over the child's history and
    matching; the child ends by SIGTERM."""
    from cadence_tpu_torch.config import load_config_dict, start_services
    from cadence_tpu_torch.rpc.client import RemoteFrontend, RemoteHistory
    from cadence_tpu_torch.runtime.api import (
        SignalRequest, StartWorkflowRequest)
    from cadence_tpu_torch.utils.hashing import shard_for_workflow
    from cadence_tpu_torch.worker import Worker

    t_part = time.perf_counter()
    n = TWO_PROC_WORKFLOWS
    raw, child, log = two["raw"], two["child"], two["log"]
    child_h = raw["services"]["history"]["rpcAddress"]
    child_m = raw["services"]["matching"]["rpcAddress"]
    lat = {k: [] for k in ("start", "signal", "serving_read",
                           "history_fetch", "sdk_decision")}
    seen, mismatches, workers = {}, [], []
    front = fe = hist = None
    try:
        await_ping(child, log, [("history", child_h),
                                ("matching", child_m)],
                   "the two-process child")
        child_ready_s = time.perf_counter() - two["started"]
        front = start_services(load_config_dict(raw), ["frontend"],
                               device=device)
        fe = RemoteFrontend(front.addresses["frontend"])
        hist = RemoteHistory(child_h)
        domain_id = fe.register_domain(ENTRY_DOMAIN)
        workers = entry_workers(RemoteFrontend, Worker,
                                front.addresses["frontend"], ENTRY_DOMAIN,
                                TWO_PROC_WORKERS, seen, lat["sdk_decision"])
        t0 = time.perf_counter()
        runs = entry_start(fe, StartWorkflowRequest, ENTRY_DOMAIN,
                           [f"two-wf-{i:05d}" for i in range(n)],
                           lat["start"], "two")
        entry_signal(fe, SignalRequest, ENTRY_DOMAIN, runs, lat["signal"],
                     "two-sig")
        fe_wait_settled(front, domain_id, runs, "the two-process signals",
                        shard_for=lambda wf: shard_for_workflow(
                            wf, TWO_PROC_SHARDS))
        traffic_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for wf, run in runs.items():
            t1 = time.perf_counter()
            got = hist.serving_read(domain_id, wf, run)
            lat["serving_read"].append((time.perf_counter() - t1) * 1e3)
            tip = got.snapshot["exec"]["next_event_id"]
            t1 = time.perf_counter()
            batches, _ = hist.get_workflow_history_raw(
                domain_id, wf, run, 1, tip)
            lat["history_fetch"].append((time.perf_counter() - t1) * 1e3)
            if not entry_check_read(got, batches, domain_id, wf, run):
                mismatches.append(wf)
        reads_s = time.perf_counter() - t0
        child_shards = hist.describe()
    finally:
        stop_workers(workers)
        for c in (fe, hist):
            if c is not None:
                c.close()
        if front is not None:
            front.stop()
        child_rc = end_child(child)
    rec = {
        "phase": "entry_points", "part": "two_process", "workflows": n,
        "shards": TWO_PROC_SHARDS, "workers": TWO_PROC_WORKERS,
        "child_ready_s": child_ready_s,
        "traffic_s": traffic_s, "reads_s": reads_s,
        "host_ms_over_wire": {k: percentiles(np, v) for k, v in lat.items()},
        "child_describe": child_shards,
        "child_fsm_launches": "not visible: the child runs no frontend, so "
                              "neither describe-host, dump_traces nor the "
                              "metrics registry reaches it; the exact reads "
                              "stand for them",
        "read_mismatches": len(mismatches), "child_rc": child_rc,
        "part_s": time.perf_counter() - t_part, "nvidia_smi": smi}
    check(not mismatches, f"{len(mismatches)} of {n} two-process reads "
          f"differ from the host replay, first {mismatches[:3]}")
    check(child_rc == 0, f"the two-process child exited {child_rc}: "
          + Path(log).read_text()[-1500:])
    return rec


def phase_entry_points(torch, np, RC, smi, fe_host_ms, device="cuda"):
    """Phase 16: (a) the config-booted host, (c) the CLI against it,
    (b) the two-process host. Returns FSM launches by route."""
    import grpc

    try:
        import yaml
    except ImportError:  # the YAML file path is skipped, and said so
        yaml = None
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        launches, stop_s = phase_entry_host_and_cli(
            torch, np, RC, smi, fe_host_ms, tmp, yaml, device)
        # the child starts only now: an idle second host's pumps would
        # share the machine's cores with (a)'s measurements
        two = entry_two_process_child(tmp, device)
        try:
            emit(phase_entry_two_process(np, smi, two, device))
        finally:
            end_child(two["child"])
    emit({"phase": "entry_points", "part": "summary", "grpc": True,
          "grpc_version": grpc.__version__, "yaml": yaml is not None,
          "phase_s": time.perf_counter() - t_phase,
          "config_host_stop_s": stop_s, "launches_by_route": launches,
          "nvidia_smi": smi})
    for route, k in launches.items():
        check(k > 0, f"the entry-points phase made no {route} launch")
    return launches


def phase_entry_host_and_cli(torch, np, RC, smi, fe_host_ms, tmp, yaml,
                             device):
    """(a) then (c) on one config-booted host, stopped at the end; returns
    its FSM launches by route and the stop's wall s."""
    from cadence_tpu_torch.rpc.client import RemoteFrontend, RemoteHistory

    t0 = time.perf_counter()
    host, routes, from_file = entry_host(RC, tmp, yaml, device)
    boot = {"boot_s": time.perf_counter() - t0, "from_file": from_file,
            "workers": []}
    fe = RemoteFrontend(host.addresses["frontend"])
    hist = RemoteHistory(host.addresses["history"])
    try:
        domain_id, runs, rec_a = phase_entry_config_host(
            torch, np, smi, fe_host_ms, host, fe, hist, boot)
        emit(rec_a)
        emit(phase_entry_cli(host, fe, hist, domain_id, runs, smi, tmp,
                             device))
    finally:
        stop_workers(boot["workers"])
        fe.close()
        hist.close()
        t0 = time.perf_counter()
        host.stop()
        stop_s = time.perf_counter() - t0
    return dict(routes.counts), stop_s


# -- 17. chaos: fault injection and the witnesses on the card ---------------

CHAOS_SEED, CHAOS_SHARDS, CHAOS_WORKFLOWS = 1234, 4, 256
CHAOS_WORKERS, CHAOS_WAIT_S = 8, 120.0
CHAOS_DOMAIN, CHAOS_TL = "chaos-dom", "chaos-tl"
CKPT_CHAOS_N = 256
FLUSH_CHAOS_LANES = 1024
SAN_WORKFLOWS, SAN_DOMAIN, SAN_TL = 64, "san-dom", "san-tl"


def chaos_counted(RC, counts, route, fn):
    """``fn()`` with the FSM launches made meanwhile added to
    ``counts[route]`` (nothing else launches while a part of phase 17
    runs one)."""
    start = RC.replay_rows.launches
    try:
        return fn()
    finally:
        counts[route] = counts.get(route, 0) + (
            RC.replay_rows.launches - start)


def chaos_doubler(ctx, input):
    """The reference chaos suite's workflow: two chained activities."""
    a = yield ctx.schedule_activity("double", input)
    b = yield ctx.schedule_activity("double", a)
    return b


def chaos_write_faults(seed):
    """The reference chaos suite's write-fault schedule: conflicts on
    15% of the main execution writes, errors on 20% of the transfer-task
    completions, torn writes on 20% of the shard writes."""
    from cadence_tpu_torch.testing.faults import FaultRule, FaultSchedule

    return FaultSchedule(seed=seed, rules=[
        FaultRule(site="persistence.execution",
                  method="update_workflow_execution",
                  probability=0.15, error="ConditionFailedError"),
        FaultRule(site="persistence.execution",
                  method="complete_transfer_task",
                  probability=0.2, error="PersistenceError"),
        FaultRule(site="persistence.shard", method="update_shard",
                  probability=0.2, action="torn_write",
                  error="TimeoutError"),
    ])


def chaos_box(device, faults=None, effects=False):
    """A Onebox twin as the chaos suite's harness builds it: a frozen
    clock, the poll nonce pinned, serving and checkpoints on.
    ``effects`` puts the effect recorder on the store, below the fault
    client the box installs."""
    from cadence_tpu_torch.runtime.persistence.decorators import wrap_bundle
    from cadence_tpu_torch.runtime.persistence.memory import (
        create_memory_bundle)
    from cadence_tpu_torch.testing.onebox import Onebox
    from cadence_tpu_torch.utils.clock import FakeTimeSource

    store = create_memory_bundle()
    if effects:
        store = wrap_bundle(store, effects=True)
    box = Onebox(
        num_shards=CHAOS_SHARDS, persistence=store, faults=faults,
        start_worker=False, time_source=FakeTimeSource(),
        poll_request_id_fn=lambda info: (
            f"rid-{info.workflow_id}-{info.schedule_id}"),
        checkpoints=True, serving=True, device=device).start()
    box.domain_handler.register_domain(CHAOS_DOMAIN)
    return box


def chaos_drive(box, wids):
    """Every workflow started, then each waited on until it closes, with
    ``CHAOS_WORKERS`` SDK workers of one identity; returns the runs and
    each history's canonical JSON."""
    from cadence_tpu_torch.runtime.api import StartWorkflowRequest
    from cadence_tpu_torch.worker import Worker

    workers = []
    for _ in range(CHAOS_WORKERS):
        w = Worker(box.frontend, CHAOS_DOMAIN, CHAOS_TL,
                   identity="chaos-worker", sticky=False)
        w.register_workflow("chaos-wf", chaos_doubler)
        w.register_activity("double", lambda inp: inp * 2)
        w.start()
        workers.append(w)
    try:
        runs = {wid: box.frontend.start_workflow_execution(
            StartWorkflowRequest(
                domain=CHAOS_DOMAIN, workflow_id=wid,
                workflow_type="chaos-wf", task_list=CHAOS_TL, input=b"x",
                request_id=f"req-{wid}",
                execution_start_to_close_timeout_seconds=60))
            for wid in wids}
        deadline = time.monotonic() + CHAOS_WAIT_S
        for wid in wids:
            while box.frontend.describe_workflow_execution(
                    CHAOS_DOMAIN, wid, runs[wid]).is_running:
                check(time.monotonic() < deadline,
                      f"(a) {wid} still running after {CHAOS_WAIT_S} s")
                time.sleep(0.02)
    finally:
        # every poller told first, so the long polls end together
        for w in workers:
            w.decisions._stop.set()
            w.activities._stop.set()
        for w in workers:
            w.stop()
    hist = {}
    for wid in wids:
        events, _ = box.frontend.get_workflow_execution_history(
            CHAOS_DOMAIN, wid, runs[wid])
        hist[wid] = json.dumps([e.to_dict() for e in events],
                               sort_keys=True, default=repr)
    return runs, hist


def chaos_requests(box, runs):
    """A rebuild request per run, its branch token read from the store."""
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        RebuildRequest)

    domain_id = box.domains.get_by_name(CHAOS_DOMAIN).info.id
    ex = box.persistence.execution
    reqs = []
    for wf, run in runs.items():
        snap = ex.get_workflow_execution(
            box.history.controller.shard_for(wf), domain_id, wf,
            run).snapshot
        reqs.append(RebuildRequest(domain_id, wf, run,
                                   snap["execution_info"]["branch_token"]))
    return domain_id, reqs


def phase_chaos_differential(RC, unpack, smi, counts, device):
    """(a) the same 256 workflows on a clean twin and on one under the
    write-fault storm with the effect recorder on; the faulted twin's
    serving reads and one ``rebuild_many`` of every run on the card."""
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        StateRebuilder)
    from cadence_tpu_torch.testing.effect_witness import (
        EffectRecorder, check_witness)
    from cadence_tpu_torch.utils.metrics import Scope

    wids = [f"chaos-wf-{i}" for i in range(CHAOS_WORKFLOWS)]
    walls = {}
    t0 = time.perf_counter()
    box = chaos_box(device)
    try:
        _, clean = chaos_drive(box, wids)
    finally:
        box.stop()
    walls["clean"] = time.perf_counter() - t0

    sched = chaos_write_faults(CHAOS_SEED)
    rec = EffectRecorder().install()
    try:
        t0 = time.perf_counter()
        box = chaos_box(device, faults=sched, effects=True)
        try:
            runs, faulted = chaos_drive(box, wids)
            walls["faulted"] = time.perf_counter() - t0
            domain_id, reqs = chaos_requests(box, runs)
            host_rb = StateRebuilder(box.persistence.history, device="cpu")
            t0 = time.perf_counter()
            oracle = [host_rb.rebuild(r) for r in reqs]
            host_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            reads = chaos_counted(RC, counts, "chaos_serving_read", lambda: [
                box.history.serving_read(domain_id, r.workflow_id, r.run_id)
                for r in reqs])
            reads_s = time.perf_counter() - t0
            scope = Scope()
            t0 = time.perf_counter()
            many = chaos_counted(
                RC, counts, "chaos_rebuild_many",
                lambda: StateRebuilder(box.persistence.history, metrics=scope,
                                       device=device).rebuild_many(reqs))
            many_s = time.perf_counter() - t0
            box_fallbacks = box.metrics.registry.counter_value(
                "host_fallbacks")
        finally:
            box.stop()
    finally:
        rec.uninstall()
    diverged = [w for w in wids if clean[w] != faulted[w]]
    read_mism = sum(
        g is None or g.snapshot != unpack.mutable_state_to_snapshot(o[0])
        for g, o in zip(reads, oracle))
    many_mism = sum(rebuild_key(unpack, g) != rebuild_key(unpack, o)
                    for g, o in zip(many, oracle))
    fallbacks = scope.registry.counter_value("host_fallbacks") + \
        box_fallbacks
    violations = check_witness(rec)
    snap = rec.snapshot()
    faults = sched.snapshot()
    rec_out = {
        "phase": "chaos", "part": "chaos_differential",
        "workflows": CHAOS_WORKFLOWS, "shards": CHAOS_SHARDS,
        "sdk_workers": CHAOS_WORKERS, "seed": CHAOS_SEED,
        "wall_s": walls, "faults_by_rule": faults,
        "faults_injected": sched.injected_total(),
        "histories_diverged": len(diverged),
        "serving_reads": len(reads), "serving_read_s": reads_s,
        "serving_read_mismatches": read_mism,
        "rebuild_many": {"runs": len(reqs), "wall_s": many_s,
                         "mismatches": many_mism},
        "host_oracle_s": host_s, "host_fallbacks": fallbacks,
        "effect_witness": {"task_types": len(snap),
                           "violations": violations},
        "launches": {k: counts.get(k, 0) for k in (
            "chaos_serving_read", "chaos_rebuild_many")},
        "nvidia_smi": smi,
    }
    check(not diverged, f"(a) {len(diverged)} histories differ across the "
          f"arms, first {diverged[:3]}")
    check(all(f["injected"] > 0 for f in faults),
          f"(a) a rule of the storm never fired: {faults}")
    check(read_mism == 0, f"(a) {read_mism} serving reads differ from the "
          "host replay")
    check(many_mism == 0, f"(a) {many_mism} rebuilt runs differ from the "
          "host replay")
    check(fallbacks == 0, f"(a) {fallbacks} host fallbacks")
    check(("transfer", "CloseExecution") in snap and not violations,
          f"(a) effect witness: {violations or 'no close task recorded'}")
    check(counts["chaos_serving_read"] > 0
          and counts["chaos_rebuild_many"] > 0,
          f"(a) launches {rec_out['launches']}")
    return rec_out


def chaos_faulted_store(sched):
    """A memory checkpoint store behind the fault client, at the site
    ``wrap_bundle`` names it (``persistence.checkpoint``)."""
    from cadence_tpu_torch.checkpoint import MemoryCheckpointStore
    from cadence_tpu_torch.testing.faults import FaultInjectionClient

    raw = MemoryCheckpointStore()
    return raw, FaultInjectionClient(raw, sched, manager="checkpoint")


def phase_chaos_checkpoint(RC, unpack, counts, device):
    """(b1) 256 retry_deep runs rebuilt on the card twice, a prefix pass
    and a warm pass after the tails land, by a rebuilder whose checkpoint
    store faults (errors on every verb, torn writes on the puts) and by a
    fault-free one; every state against the other's and the host's."""
    from cadence_tpu_torch.checkpoint import (
        CheckpointManager, CheckpointPolicy, MemoryCheckpointStore)
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        StateRebuilder)
    from cadence_tpu_torch.testing.faults import FaultRule, FaultSchedule
    from cadence_tpu_torch.utils.metrics import Scope

    c = warm_cohort(n=CKPT_CHAOS_N)
    sched = FaultSchedule(seed=CHAOS_SEED, rules=[
        FaultRule(site="persistence.checkpoint", method="put_checkpoint",
                  probability=0.25, action="torn_write",
                  error="TimeoutError"),
        FaultRule(site="persistence.checkpoint", probability=0.15,
                  error="PersistenceError"),
    ])
    raw, faulted_store = chaos_faulted_store(sched)
    clean_store = MemoryCheckpointStore()
    scopes = {"clean": Scope(), "faulted": Scope()}
    rbs = {name: StateRebuilder(
        c["hist"], lane_len=REBUILD_LANE_LEN, metrics=scopes[name],
        checkpoints=CheckpointManager(store, CheckpointPolicy(
            every_events=1, keep_last=1)), device=device)
        for name, store in (("clean", clean_store),
                            ("faulted", faulted_store))}
    out, walls = {}, {}
    for p in ("prefix", "warm"):
        if p == "warm":
            append_tails(c)
        for name, rb in rbs.items():
            t0 = time.perf_counter()
            res = chaos_counted(RC, counts, "chaos_checkpoint_rebuild",
                                 lambda: rb.rebuild_many(c["reqs"]))
            walls[f"{p}_{name}"] = time.perf_counter() - t0
            out[(p, name)] = [rebuild_key(unpack, g) for g in res]
    host_rb = StateRebuilder(c["hist"], device="cpu")
    t0 = time.perf_counter()
    host = [rebuild_key(unpack, host_rb.rebuild(r)) for r in c["reqs"]]
    host_s = time.perf_counter() - t0
    mism = {
        "faulted_vs_clean": sum(
            a != b for p in ("prefix", "warm")
            for a, b in zip(out[(p, "faulted")], out[(p, "clean")])),
        "warm_vs_host": sum(a != b for name in ("clean", "faulted")
                            for a, b in zip(out[("warm", name)], host)),
    }
    reg = {n: s.registry for n, s in scopes.items()}
    fallbacks = sum(r.counter_value("host_fallbacks") for r in reg.values())
    rec = {
        "runs": CKPT_CHAOS_N, "events": c["total_events"],
        "faults_by_rule": sched.snapshot(),
        "faults_injected": sched.injected_total(),
        "landed_checkpoints": raw.count_checkpoints(),
        "checkpoint_hit": {n: r.counter_value("checkpoint_hit")
                           for n, r in reg.items()},
        "events_replayed_saved": {
            n: r.counter_value("events_replayed_saved")
            for n, r in reg.items()},
        "wall_s": walls, "host_oracle_s": host_s, "mismatches": mism,
        "host_fallbacks": fallbacks,
    }
    check(all(f["injected"] > 0 and f["injected"] >= 0.1 * f["matched"]
              for f in rec["faults_by_rule"]),
          f"(b1) the checkpoint storm under 10%: {rec['faults_by_rule']}")
    check(not any(mism.values()), f"(b1) rebuilt states differ: {mism}")
    check(fallbacks == 0, f"(b1) {fallbacks} host fallbacks")
    check(counts.get("chaos_checkpoint_rebuild", 0) > 0,
          "(b1) no FSM launch")
    return rec


def flush_cohort(bundle, caps):
    """``FLUSH_CHAOS_LANES`` open fuzzed histories in ``bundle``'s store,
    seeded as the reference's serving chaos suite seeds its four."""
    from cadence_tpu_torch.testing.event_generator import HistoryFuzzer

    out = []
    for i in range(FLUSH_CHAOS_LANES):
        batches = HistoryFuzzer(seed=CHAOS_SEED + 7 * i, caps=caps).generate(
            target_events=30 + 10 * (i % 3), close=False)
        branch = bundle.history.new_history_branch(tree_id=f"serve-run-{i}")
        for txn, b in enumerate(batches, 1):
            bundle.history.append_history_nodes(branch, b,
                                                transaction_id=txn)
        out.append((f"serve-wf-{i}", f"serve-run-{i}",
                    branch.to_json().encode(), batches))
    return out


def flush_drive(RC, counts, engine, seeded):
    """The reference's serving chaos choreography at engine size: seat
    every prefix in one ``admit_many``, append each Δ suffix in two
    appends, one tick, drain (every flush: the storm fires here),
    re-admit every run in one ``admit_many`` (the checkpoint consult
    resumes or cold-replays), and read each lane; returns the
    canonical snapshot of each read and the readmit's FSM launches."""
    def seat():
        tickets = engine.admit_many([
            dict(domain_id="dom", workflow_id=wf, run_id=run,
                 branch_token=tok, batches=b[:max(1, len(b) // 2)])
            for wf, run, tok, b in seeded])
        check(all(t is not None for t in tickets.values()),
              "(b2) a seat failed")
        for wf, run, _, b in seeded:
            rest = b[max(1, len(b) // 2):]
            per = max(1, len(rest) // 2) if rest else 1
            for j in range(0, len(rest), per):
                check(engine.append(tickets[(wf, run)], rest[j:j + per]),
                      f"(b2) an append to {wf} was refused")
        engine.tick()

    chaos_counted(RC, counts, "chaos_flush_engine", seat)
    drained = engine.drain()
    check(engine.occupancy() == 0.0, "(b2) the drain left lanes seated")
    before = RC.replay_rows.launches
    t0 = time.perf_counter()
    tickets = chaos_counted(RC, counts, "chaos_flush_engine",
                             lambda: engine.admit_many([
                                 dict(domain_id="dom", workflow_id=wf,
                                      run_id=run, branch_token=tok,
                                      batches=b)
                                 for wf, run, tok, b in seeded]))
    readmit_s = time.perf_counter() - t0
    readmit_launches = RC.replay_rows.launches - before
    check(all(t is not None for t in tickets.values()),
          "(b2) a re-admission failed")
    rows = {}
    for wf, run, _, _ in seeded:
        got = engine.read(wf, run)
        check(got is not None and got.resident,
              f"(b2) {wf} is not resident after its re-admission")
        rows[(wf, run)] = got.snapshot
    return rows, drained, readmit_launches, readmit_s


def phase_chaos_flush(RC, counts, device):
    """(b2) a 1,024-lane resident engine three times on the same
    histories: fault-free, with 25% of its checkpoint calls failing, and
    with every flush write failing; the reads of the faulted engines
    against the fault-free one's."""
    from cadence_tpu_torch.checkpoint import (
        CheckpointManager, CheckpointPolicy)
    from cadence_tpu_torch.ops import schema as S
    from cadence_tpu_torch.runtime.persistence.decorators import wrap_bundle
    from cadence_tpu_torch.runtime.persistence.memory import (
        create_memory_bundle)
    from cadence_tpu_torch.serving import ResidentEngine
    from cadence_tpu_torch.testing.faults import FaultRule, FaultSchedule
    from cadence_tpu_torch.utils.metrics import Scope

    caps = S.Capacities(max_events=256)
    arms = {
        "baseline": None,
        "storm": FaultSchedule(seed=CHAOS_SEED, rules=[FaultRule(
            site="persistence.checkpoint", probability=0.25,
            error="PersistenceError")]),
        "total": FaultSchedule(seed=CHAOS_SEED, rules=[FaultRule(
            site="persistence.checkpoint", method="put_checkpoint",
            probability=1.0, error="PersistenceError")]),
    }
    rows, rec = {}, {}
    for name, sched in arms.items():
        raw = create_memory_bundle()
        bundle = wrap_bundle(raw, metrics=Scope(), faults=sched)
        t0 = time.perf_counter()
        seeded = flush_cohort(bundle, caps)
        seed_s = time.perf_counter() - t0
        scope = Scope()
        engine = ResidentEngine(
            lanes=FLUSH_CHAOS_LANES, caps=caps,
            checkpoints=CheckpointManager(bundle.checkpoint, CheckpointPolicy(
                every_events=1, keep_last=4)),
            history=bundle.history, metrics=scope, device=device)
        t0 = time.perf_counter()
        rows[name], drained, readmit_launches, readmit_s = flush_drive(
            RC, counts, engine, seeded)
        reg = scope.registry
        rec[name] = {
            "seed_s": seed_s, "drive_s": time.perf_counter() - t0,
            "drain": drained, "readmit_s": readmit_s,
            "readmit_launches": readmit_launches,
            "stored_checkpoints": raw.checkpoint.count_checkpoints(),
            **serve_counters(reg, "serving_flush_failures",
                             "serving_admit_resume", "serving_admit_cold"),
            "faults_by_rule": sched.snapshot() if sched else [],
        }
    mism = {name: sum(rows[name][k] != rows["baseline"][k]
                      for k in rows["baseline"])
            for name in ("storm", "total")}
    storm, total = rec["storm"], rec["total"]
    rec["read_mismatches_vs_baseline"] = mism
    rec["lanes"] = FLUSH_CHAOS_LANES
    check(not any(mism.values()), f"(b2) reads differ from the fault-free "
          f"engine's: {mism}")
    check(storm["faults_by_rule"][0]["injected"]
          >= 0.1 * storm["faults_by_rule"][0]["matched"] > 0,
          f"(b2) the flush storm under 10%: {storm['faults_by_rule']}")
    check(total["serving_admit_resume"] == 0
          and total["stored_checkpoints"] == 0
          and total["serving_admit_cold"] == 2 * FLUSH_CHAOS_LANES
          and total["readmit_launches"] > 0,
          f"(b2) the total flush failure did not cold-readmit on the "
          f"card: {total}")
    check(rec["baseline"]["serving_admit_resume"] == FLUSH_CHAOS_LANES,
          f"(b2) the fault-free readmit did not resume: {rec['baseline']}")
    return rec


def phase_chaos_sanitized(RC, counts, device):
    """(c) the reference's sanitizer acceptance drive on the card: a
    Onebox twin built under the race witness (sanitize, checkpoints,
    serving, the autopilot parked, a 2-wide queue executor), 64
    workflows, a cold and a resident serving read of each, then the
    gate against the port's static lock graph."""
    from cadence_tpu_torch.analysis import lock_order
    from cadence_tpu_torch.config.static import AutopilotConfig
    from cadence_tpu_torch.runtime.api import StartWorkflowRequest
    from cadence_tpu_torch.testing.onebox import Onebox
    from cadence_tpu_torch.testing.race_witness import (
        GUARDED_FIELDS, RaceWitness, check_race_witness)
    from cadence_tpu_torch.worker import Worker

    class HeldTimes(RaceWitness):
        """The witness, keeping every hold of the engine's locks."""

        def __init__(self):
            super().__init__()
            self.engine_holds = {}

        def on_release(self, lock, entry, held_s):
            super().on_release(lock, entry, held_s)
            if ":ResidentEngine." in lock.name:
                self.engine_holds.setdefault(lock.name, []).append(held_s)

    t0 = time.perf_counter()
    w = HeldTimes().install()
    try:
        box = Onebox(
            num_shards=2, sanitize=True, checkpoints=True, serving=True,
            autopilot=AutopilotConfig(enabled=True, epoch_interval_s=3600),
            queue_parallel=2, device=device).start()
        try:
            box.domain_handler.register_domain(SAN_DOMAIN)
            wkr = Worker(box.frontend, SAN_DOMAIN, SAN_TL,
                         identity="san-worker")

            def wf(ctx, input):
                a = yield ctx.schedule_activity("double", input)
                return a

            wkr.register_workflow("san-wf", wf)
            wkr.register_activity("double", lambda i: i * 2)
            wkr.start()
            try:
                runs = {}
                for i in range(SAN_WORKFLOWS):
                    runs[f"san-{i}"] = box.frontend.start_workflow_execution(
                        StartWorkflowRequest(
                            domain=SAN_DOMAIN, workflow_id=f"san-{i}",
                            workflow_type="san-wf", task_list=SAN_TL,
                            input=b"x", request_id=f"san-req-{i}",
                            execution_start_to_close_timeout_seconds=60))
                deadline = time.monotonic() + CHAOS_WAIT_S
                for wid, run in runs.items():
                    while box.frontend.describe_workflow_execution(
                            SAN_DOMAIN, wid, run).is_running:
                        check(time.monotonic() < deadline,
                              f"(c) {wid} did not complete")
                        time.sleep(0.02)
                dom_id = box.domains.get_by_name(SAN_DOMAIN).info.id

                def reads():
                    return [box.history.serving_read(dom_id, wid, run)
                            for _ in range(2) for wid, run in runs.items()]
                got = chaos_counted(RC, counts, "chaos_sanitized", reads)
            finally:
                wkr.stop()
        finally:
            box.stop()
    finally:
        w.uninstall()
    drive_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = lock_order.build_graph(str(ROOT))
    unwaived = check_race_witness(w, str(ROOT), graph=graph)
    registered = {n.rsplit(":", 1)[-1] for n in w.registered_guard_fields()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_locks_") as tmp:
        wpath = os.path.join(tmp, "lock_witness.json")
        w.save(wpath)
        doc = lock_order.emit_lock_graph(
            str(ROOT), os.path.join(tmp, "lock_graph.json"),
            witness_path=wpath)
    gate_s = time.perf_counter() - t0
    statuses = {}
    for e in doc["baseline_entries"]:
        statuses[e["status"]] = statuses.get(e["status"], 0) + 1
    holds = {}
    for name, hs in sorted(w.engine_holds.items()):
        hs = sorted(hs)
        holds[name.rsplit(":", 1)[-1]] = {
            "count": len(hs), "p99_ms": hs[int(0.99 * (len(hs) - 1))] * 1e3,
            "max_ms": hs[-1] * 1e3}
    resident = sum(bool(g is not None and g.resident) for g in got)
    rec = {
        "workflows": SAN_WORKFLOWS, "drive_s": drive_s, "gate_s": gate_s,
        "serving_reads": len(got), "resident_reads": resident,
        "observed_edges": len(w.observed_edges()),
        "unwaived_findings": [f.format() for f in unwaived],
        "guarded_fields_registered": len(registered & set(GUARDED_FIELDS)),
        "guarded_fields_declared": len(GUARDED_FIELDS),
        "baseline_entries": statuses,
        "runtime_only_edges": len(doc["runtime_only_edges"]),
        "engine_lock_holds": holds,
    }
    check(unwaived == [], "(c) unwaived sanitizer findings: "
          + "; ".join(f.anchor for f in unwaived))
    missing = set(GUARDED_FIELDS) - registered
    check(not missing, f"(c) guarded fields never built: {missing}")
    check(statuses.get("observed", 0) >= 1,
          f"(c) no baselined lock entry observed: {statuses}")
    check(None not in got and resident >= SAN_WORKFLOWS,
          f"(c) {resident} resident reads of {len(got)}")
    check(counts.get("chaos_sanitized", 0) > 0, "(c) no FSM launch")
    return rec


def phase_chaos(RC, unpack, smi, device="cuda"):
    """Phase 17: (a) the chaos differential, (b) checkpoint and serving
    chaos at card size, (c) the sanitized Onebox. Returns FSM launches by
    route."""
    counts = {}
    t_phase = time.perf_counter()
    emit(phase_chaos_differential(RC, unpack, smi, counts, device))
    t0 = time.perf_counter()
    ckpt = phase_chaos_checkpoint(RC, unpack, counts, device)
    ckpt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    flush = phase_chaos_flush(RC, counts, device)
    emit({"phase": "chaos", "part": "checkpoint_serving_chaos",
          "checkpoint_rebuild": dict(ckpt, phase_s=ckpt_s),
          "flush_engine": dict(flush, phase_s=time.perf_counter() - t0),
          "nvidia_smi": smi})
    emit({"phase": "chaos", "part": "sanitized_onebox",
          **phase_chaos_sanitized(RC, counts, device),
          "nvidia_smi": smi})
    emit({"phase": "chaos", "part": "summary",
          "phase_s": time.perf_counter() - t_phase,
          "launches_by_route": counts, "nvidia_smi": smi})
    return counts


# --------------------------------------------------------------------------
# Phase 18: the static-analysis gate and the trace demo
# --------------------------------------------------------------------------

ANALYSIS_GATE_TIMEOUT_S = 240
TRACE_DEMO_TIMEOUT_S = 180
ANALYSIS_GATE_ARGS = ("-m", "cadence_tpu_torch.analysis", "--strict-stale",
                      "--device", "cuda")
TRACE_DEMO_ARGS = ("-m", "cadence_tpu_torch.testing.trace_demo", "--quiet")
# the probe arms on the card, each against the plain step on the CPU
PROBE_ARMS = ("replay_rows", "replay_rows[int16]", "replay_rows_packed")


def start_child(args):
    """A child process of this script, started beside phase 18's
    in-process probe; its output (tens of kB) fits the pipes until read."""
    return subprocess.Popen(
        [sys.executable, *args], cwd=str(ROOT), env=cli_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def child_output(proc, name, timeout_s):
    """(exit code, stdout, stderr) of a child; fails if it has not ended
    ``timeout_s`` after this call (the caller kills it)."""
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        check(False, f"{name} did not end in {timeout_s} s")
    return proc.returncode, out, err


def analysis_gate_result(child):
    """(a) the gate's child: ``python -m cadence_tpu_torch.analysis
    --strict-stale --device cuda``, its surface pass probing the FSM
    kernel on the card: exit code, findings and baselined counts by
    pass, stale entries, and its wall by its own summary line."""
    rc, out, err = child_output(child, "the analysis gate",
                                ANALYSIS_GATE_TIMEOUT_S)
    by_pass = {}
    for line in out.splitlines():
        if line.startswith("== pass "):
            words = line.split()
            by_pass[words[2].rstrip(":")] = {
                "findings": int(words[3]), "baselined": int(words[5])}
    summary = [ln for ln in out.splitlines()
               if ln.startswith("cadence_tpu_torch.analysis:")]
    rec = {"command": " ".join(ANALYSIS_GATE_ARGS), "exit_code": rc,
           "by_pass": by_pass, "summary": summary[-1] if summary else None,
           "stale_lines": [ln for ln in err.splitlines()
                           if "stale baseline entry" in ln],
           "wall_s": (float(summary[-1].rsplit(" in ", 1)[1].rstrip("s"))
                      if summary else None)}
    check(rc == 0, f"the analysis gate exited {rc}: {out[-2000:]} "
          f"{err[-2000:]}")
    check(summary and " 0 new, 0 stale " in summary[-1],
          f"the analysis gate's summary: {summary}")
    return rec


def phase_analysis_surface(torch, np, RC, AC):
    """(b) the transition-surface probe on the card: ``replay_rows``
    (int32, then the int16 narrow stream) and ``replay_rows_packed``,
    each matrix against the plain step's label for label and every
    probe's rows bit for bit, ``diff_surface`` against the baselined
    findings; then every affine group through ``replay_assoc(impl=
    "segscan")`` on the card, its written sets and rows against the
    FSM's. Returns (record, FSM launches, scan launches)."""
    from cadence_tpu_torch.analysis import load_baselines, scope_baseline
    from cadence_tpu_torch.analysis import oracle_ast
    from cadence_tpu_torch.analysis import transition_surface as TS
    from cadence_tpu_torch.ops.assoc import assoc_types
    from cadence_tpu_torch.ops.replay import TYPE_GROUPS

    rel = oracle_ast.extract_rel_ts_attrs(
        (ROOT / "cadence_tpu_torch" / "ops" / "pack.py").read_text())
    _, otable, pack_handled, _ = TS.build(str(ROOT), "cpu")
    surface_bl = scope_baseline(load_baselines(), ["surface"])
    t0 = time.perf_counter()
    plain = TS.probe("replay_rows_plain", "cpu", rel)
    plain_wall = time.perf_counter() - t0
    rec = {"groups": len(plain.matrix.groups), "probes": len(plain.outputs),
           "lanes_per_probe": {
               str(k[0]): int(v.shape[1])
               for k, v in plain.outputs.items() if k[1] == "base"},
           "plain_wall_s": plain_wall, "arms": {}}
    fsm_launches = 0
    fsm_out = None
    for impl in PROBE_ARMS:
        RC.replay_rows.launches = 0
        t0 = time.perf_counter()
        run = TS.probe(impl, "cuda", rel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = RC.replay_rows.launches
        fsm_launches += launches
        diff = sorted(str(k) for k, v in run.outputs.items()
                      if not np.array_equal(v, plain.outputs[k]))
        labels = sorted(
            f"{g.types}" for g, p in zip(run.matrix.groups,
                                         plain.matrix.groups)
            if (g.written, g.ts_cols) != (p.written, p.ts_cols))
        new, _, stale = surface_bl.split(
            TS.diff_surface(run.matrix, otable, pack_handled))
        rec["arms"][impl] = {
            "launches": launches, "wall_s": wall,
            "matrix_equal": run.matrix == plain.matrix,
            "groups_differing": labels, "outputs_differing": diff,
            "new_findings": [f.anchor for f in new],
            "stale_baseline": [e.anchor for e in stale]}
        check(run.matrix == plain.matrix and not diff and not labels,
              f"{impl} on the card: matrix or rows differ from plain: "
              f"{labels} {diff[:8]}")
        check(not new and not stale,
              f"{impl}: diff_surface is not the baselined findings: "
              f"{[f.anchor for f in new]} {[e.anchor for e in stale]}")
        check(launches > 0, f"{impl} launched no FSM kernel")
        if impl == "replay_rows":
            fsm_out = run
    affine = [g for g in TYPE_GROUPS
              if all(int(t) in assoc_types() for t in g)]
    AC.affine_segscan.launches = 0
    RC.replay_rows.launches = 0
    t0 = time.perf_counter()
    run = TS.probe("replay_assoc[segscan]", "cuda", rel, groups=affine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seg_launches = AC.affine_segscan.launches
    fsm_in_assoc = RC.replay_rows.launches
    fsm_launches += fsm_in_assoc
    fsm_groups = {g.types: g for g in fsm_out.matrix.groups}
    written_diff = sorted(
        f"{g.types}" for g in run.matrix.groups
        if g.written != fsm_groups[g.types].written)
    diff = sorted(str(k) for k, v in run.outputs.items()
                  if not np.array_equal(v, fsm_out.outputs[k]))
    rec["arms"]["replay_assoc[segscan]"] = {
        "affine_groups": len(affine), "segscan_launches": seg_launches,
        "fsm_launches": fsm_in_assoc, "wall_s": wall,
        "written_differing": written_diff, "outputs_differing": diff}
    check(not written_diff and not diff,
          f"replay_assoc[segscan] on the card differs from the FSM: "
          f"{written_diff} {diff[:8]}")
    check(seg_launches > 0, "the assoc arm launched no scan kernel")
    return rec, fsm_launches, seg_launches


def trace_demo_result(child):
    """(c) the trace demo's child: ``python -m
    cadence_tpu_torch.testing.trace_demo`` on the card (its default
    device): exit code, span count, the services the trace spans."""
    rc, out, err = child_output(child, "the trace demo", TRACE_DEMO_TIMEOUT_S)
    check(rc == 0, f"the trace demo exited {rc}: {err[-2000:]}")
    doc = json.loads(out)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    services = sorted({m["args"]["name"] for m in doc["traceEvents"]
                       if m.get("ph") == "M"})
    check(len(spans) >= 6, f"the trace demo's trace has {len(spans)} spans")
    return {"exit_code": rc, "spans": len(spans), "services": services}


def phase_analysis(torch, np, RC, AC, smi):
    """Phase 18: (a) the gate and (c) the trace demo in child processes,
    started together, while (b) the transition surface is probed on the
    card in this process. Returns (FSM launches by route, scan
    launches)."""
    t_phase = time.perf_counter()
    children = []
    try:
        gate = start_child(ANALYSIS_GATE_ARGS)
        children.append(gate)
        demo = start_child(TRACE_DEMO_ARGS)
        children.append(demo)
        surface, fsm_launches, seg_launches = phase_analysis_surface(
            torch, np, RC, AC)
        gate_rec = analysis_gate_result(gate)
        demo_rec = trace_demo_result(demo)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.communicate()
    emit({"phase": "analysis", "part": "gate", **gate_rec,
          "nvidia_smi": smi})
    emit({"phase": "analysis", "part": "surface", **surface,
          "nvidia_smi": smi})
    emit({"phase": "analysis", "part": "trace_demo", **demo_rec,
          "nvidia_smi": smi})
    emit({"phase": "analysis", "part": "summary",
          "phase_s": time.perf_counter() - t_phase,
          "fsm_launches": fsm_launches, "segscan_launches": seg_launches,
          "nvidia_smi": smi})
    return {"analysis_surface": fsm_launches}, seg_launches


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
    from cadence_tpu_torch.utils.metrics import Scope

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
    # the bucketed stream with the dispatcher's device-step telemetry on
    stream_scope = Scope()
    stream_log = registry_log(stream_scope)
    stream_res, stream_wall = phase_stream(torch, S, replay_stream, mixed,
                                           bucket=True, metrics=stream_scope)
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
    # one more (warm) bucketed stream under the profiler, without a
    # metrics scope, then the packed route alone at each of its batches
    bare = []
    busy = device_busy(torch, lambda: bare.extend(replay_stream(
        mixed, caps=caps, bucket=True, device="cuda")))
    bare = [(i, p, S.state_to_numpy(f)) for i, p, f in bare]
    mism_bare = sum(g != w for g, w in zip(
        got, stream_snapshots(bare, len(mixed), unpack)))
    packed_timing = time_packed(torch, np, S, RC, caps, stream_res)
    stream_tele = device_telemetry(
        np, stream_scope, stream_log, [p for _, p, _ in stream_res], "lanes",
        [r["int16"]["ms"] for r in packed_timing])
    stream_step = stream_refresh(torch, np, S, RC, R, caps, stream_res)
    emit({"phase": "stream", "route": "replay_stream(bucket=True)",
          "histories": len(mixed), "shallow": N_SHALLOW, "deep": N_DEEP,
          "batches": len(stream_res), "gen_s": gen_s,
          "wall_s": stream_wall,
          "histories_per_s": len(mixed) / stream_wall,
          "host_pack_only_s": pack_only, "plain_cpu_wall_s": plain_wall,
          "fsm_launches": launches_stream, "device_busy": busy,
          "packed_route": packed_timing, "replay_refresh_step": stream_step,
          "device_telemetry": stream_tele,
          "snapshot_mismatches": mism, "unwired_mismatches": mism_bare,
          "unbucketed": {"batch_size": 1024, "batches": len(hist_res),
                         "wall_s": hist_wall, "fsm_launches": launches_hist,
                         "snapshot_mismatches": mism_hist}})
    check(not (mism or mism_hist or mism_bare or None in got
               or None in got_hist),
          f"stream snapshots differ from plain: {mism} bucketed, "
          f"{mism_hist} unbucketed; {mism_bare} from the stream without "
          "telemetry")
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
    assoc_scope = Scope()
    assoc_log = registry_log(assoc_scope)
    stream_assoc, stream_assoc_wall = phase_stream(
        torch, S, replay_stream, mixed, bucket=True, scan_mode="assoc",
        metrics=assoc_scope)
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
    # the parallel-in-time batches run no FSM kernel to hold a step against
    assoc_tele = device_telemetry(np, assoc_scope, assoc_log,
                                  [p for _, p, _ in stream_assoc],
                                  "lanes_assoc")
    emit({"phase": "assoc_lanes", "histories": len(mixed),
          "lanes": lanes_pk.lanes, "scan_len": lanes_pk.scan_len,
          "replay_assoc_lanes_segscan_wall_s": lanes_wall,
          "stream_assoc_wall_s": stream_assoc_wall,
          "stream_assoc_batches": len(stream_assoc),
          "stream_assoc_device_telemetry": assoc_tele,
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
    rebuild, launches_rebuild, cohort = phase_rebuild(torch, np, P, unpack,
                                                      RC)
    rebuild_kernel = time_rebuild_kernel(torch, np, S, P, RC, cohort)
    rebuild_telemetry(np, cohort, rebuild_kernel, smi)
    # phase 15 holds its durable rebuilds against phase 8's
    p8 = {"rec": rebuild, "cold_keys": cohort["cold_keys"]}
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

    # 12. the frontend and the worker SDK over the history host, launches
    # counted by route inside the phase
    frontend_launches, frontend_host_ms = phase_frontend(
        torch, np, S, RC, smi)

    # 13. the replication planes between two port clusters, launches
    # counted by route inside the phase
    replication_launches, storm_kernel = phase_replication(
        torch, np, S, P, RC, smi)

    # 14. the parallel queue executor, resharding and the capacity
    # autopilot, launches counted by route inside the phase
    topology_launches, flush_kernel = phase_topology(
        torch, np, S, P, RC, smi)

    # 15. the worker services and the durable store, launches counted by
    # route inside the phase
    worker_launches = phase_worker_store(torch, np, S, P, RC, unpack, smi,
                                         p8)
    del p8

    # 16. the server's entry points over gRPC, launches counted by route
    # inside the phase
    entry_launches = phase_entry_points(torch, np, RC, smi,
                                        frontend_host_ms)

    # 17. fault injection and the witnesses on the card, launches counted
    # by route inside the phase
    chaos_routes = phase_chaos(RC, unpack, smi)

    # 18. the static-analysis gate, the transition surface on the card and
    # the trace demo, launches counted inside the phase
    analysis_routes, seg_launches_analysis = phase_analysis(
        torch, np, RC, AC, smi)

    # 19. kernels and device
    check(launches > 0, "the main path launched no FSM kernel")
    seg_total = seg_launches + seg_launches_lanes + seg_launches_analysis
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
        + sum(service_launches.values())
        + sum(frontend_launches.values())
        + sum(replication_launches.values())
        + sum(topology_launches.values())
        + sum(worker_launches.values())
        + sum(entry_launches.values())
        + sum(chaos_routes.values())
        + sum(analysis_routes.values()),
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
        "storm_ms": [r["int32"]["ms"] for r in storm_kernel],
        "storm_bound_ms": [r["int32"]["bound_ms"] for r in storm_kernel],
        "storm_shape": [f"T={r['T']} L={r['lanes']} R_pad={r['R_pad']}"
                        for r in storm_kernel],
        "reshard_flush_ms": [r["int32"]["ms"] for r in flush_kernel],
        "reshard_flush_bound_ms": [r["int32"]["bound_ms"]
                                   for r in flush_kernel],
        "reshard_flush_shape": [
            f"T={r['T']} L={r['lanes']} R_pad={r['R_pad']}"
            for r in flush_kernel],
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
                              **service_launches, **frontend_launches,
                              **replication_launches, **topology_launches,
                              **worker_launches, **entry_launches,
                              **chaos_routes, **analysis_routes},
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
        "launches_by_route": {"replay_assoc": seg_launches,
                              "replay_assoc_lanes_and_stream":
                              seg_launches_lanes,
                              "analysis_surface": seg_launches_analysis},
    }]
    emit({"device_passes": [{
        "name": "refresh_tasks_device", "route": "torch ops",
        "source": "cadence_tpu_torch/ops/refresh.py",
        "replaces": "cadence_tpu/ops/refresh.py:79",
        **{k: step[k] for k in ("lanes", "launches", "ms", "device_ms",
                                "graph_ms", "bound_ms", "bound_by",
                                "step_ms", "step_device_ms", "step_graph_ms",
                                "histories_per_sec")},
        "stream": {k: stream_step[k] for k in (
            "lanes", "launches", "ms", "device_ms", "graph_ms", "bound_ms",
            "bound_by", "step_ms")},
    }]})
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
