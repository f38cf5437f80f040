"""The reference bench's three topology cells, over the port.

``reshard_live``: a shard split under sustained load on the Onebox twin,
the probe's start latency overall and within the handoff window, and the
handoff record. ``capacity_diurnal``: the capacity autopilot's closed
loop over a low -> high -> low open-loop stream on a ``ResidentEngine``.
``queue_drain``: the sequential queue pump against the shared
``ParallelQueueExecutor`` over an identical mixed transfer/timer storm.
The first two run their device work (the reshard flush and warm, the
engine's seats and ticks) on ``device``; ``queue_drain`` is host work.

Copies of ``_bench_reshard_live``, ``_bench_capacity_diurnal`` and
``_bench_queue_drain`` of the reference repository's ``bench.py``, with
the same arguments, JSON keys and arithmetic, plus ``device`` (and
``matrix_path`` for the port's conflict-matrix artifact).
"""

from __future__ import annotations

import time


def reshard_live(duration_s: float, load_threads: int = 2,
                 probe_interval_s: float = 0.004, device="cuda"):
    """Elastic resharding under sustained load: a shard split executed
    mid-run while load threads drive the echo workflow end-to-end and a
    probe thread times every frontend start call (the routed write path
    — exactly what stalls while the source shard is fenced).

    Reports the steady-state completion rate next to the handoff
    record: total ``handoff_ms`` (dominated by the pre-fence checkpoint
    flush, which runs under live traffic), the write-unavailability
    ``pause_ms``, and the probe-call p50/p99 — overall and within the
    handoff window, the decision-latency cost of the reconfiguration.
    """
    import threading as _threading

    from ..runtime.api import StartWorkflowRequest
    from ..runtime.resharding import ReshardCoordinator
    from ..testing.onebox import Onebox
    from ..worker import Worker

    box = Onebox(num_shards=2, checkpoints=True,
                 start_worker=False, device=device).start()
    box.domain_handler.register_domain("bench")

    def _echo_wf(ctx, input):
        out = yield ctx.schedule_activity("echo", input)
        return out

    w = Worker(box.frontend, "bench", "bench-tl", identity="bench-w",
               sticky=False)
    w.register_workflow("echo-wf", _echo_wf)
    w.register_activity("echo", lambda x: x)
    w.start()

    stop = _threading.Event()
    completed = [0]
    lock = _threading.Lock()

    def _start(wid):
        return box.frontend.start_workflow_execution(StartWorkflowRequest(
            domain="bench", workflow_id=wid, workflow_type="echo-wf",
            task_list="bench-tl", input=b"x", request_id=f"req-{wid}",
            execution_start_to_close_timeout_seconds=60,
        ))

    def _load(tid):
        i = 0
        while not stop.is_set():
            wid = f"load-{tid}-{i}"
            try:
                rid = _start(wid)
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline and not stop.is_set():
                    d = box.frontend.describe_workflow_execution(
                        "bench", wid, rid
                    )
                    if not d.is_running:
                        with lock:
                            completed[0] += 1
                        break
                    time.sleep(0.002)
            except Exception:
                pass  # fenced-window stragglers: the probe counts those
            i += 1

    probes = []  # (t_monotonic, latency_s)

    def _probe():
        j = 0
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                _start(f"probe-{j}")
            except Exception:
                pass
            probes.append((t0, time.monotonic() - t0))
            j += 1
            time.sleep(probe_interval_s)

    threads = [
        _threading.Thread(target=_load, args=(t,), daemon=True)
        for t in range(load_threads)
    ] + [_threading.Thread(target=_probe, daemon=True)]
    t_run0 = time.monotonic()
    try:
        for t in threads:
            t.start()
        time.sleep(duration_s / 2)

        coord = ReshardCoordinator(
            box.persistence, [box.history.controller], device=device
        )
        t_h0 = time.monotonic()
        plan = coord.split(0)
        t_h1 = time.monotonic()

        time.sleep(duration_s / 2)
    finally:
        # a failed split must not leak live pumps into later configs
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        elapsed = time.monotonic() - t_run0
        w.stop()
        box.stop()

    # headline percentiles through Registry.timer_stats — the same
    # exponential-bucket histograms the serving scopes report
    from ..utils.metrics import Scope as _Scope

    lat_scope = _Scope()
    lat_handoff = []
    for t0, dt in probes:
        lat_scope.record("start_latency", dt)
        if t_h0 <= t0 <= t_h1:
            lat_scope.tagged(window="handoff").record(
                "start_latency_handoff", dt
            )
            lat_handoff.append(dt)
    reg = lat_scope.registry
    lat_all_stats = reg.timer_stats("start_latency")
    lat_handoff_stats = reg.timer_stats("start_latency_handoff")
    return {
        "steady_rate_wf_per_sec": round(completed[0] / elapsed, 2),
        "workflows_completed": completed[0],
        "probe_calls": len(probes),
        "start_p50_ms": round(lat_all_stats.p50 * 1e3, 3),
        "start_p99_ms": round(lat_all_stats.p99 * 1e3, 3),
        "during_handoff": {
            "samples": len(lat_handoff),
            "p50_ms": round(lat_handoff_stats.p50 * 1e3, 3),
            "p99_ms": round(lat_handoff_stats.p99 * 1e3, 3),
            "max_ms": round(max(lat_handoff, default=0.0) * 1e3, 3),
        },
        "handoff": {
            "state": plan.state,
            "epoch": plan.epoch_to,
            "handoff_ms": round(plan.handoff_ms, 1),
            "pause_ms": round(plan.pause_ms, 1),
            "moved_workflows": plan.moved_workflows,
            "moved_tasks": plan.moved_tasks,
            "checkpoints_shipped": plan.checkpoints_shipped,
            "suffix_events_replayed": plan.suffix_events_replayed,
        },
    }


def capacity_diurnal(workflows_per_chunk: int = 8,
                      qps_low: float = 60.0,
                      qps_high: float = 600.0,
                      chunks_low: int = 3, chunks_high: int = 4,
                      chunks_trough: int = 4, lanes: int = 16,
                      min_events: int = 12, max_events: int = 24,
                      initial_rps: float = 150.0, device="cuda"):
    """Capacity autopilot closed loop under a diurnal curve.

    Offers a low -> high -> low open-loop stream against a live
    limiter the ``CapacityController`` retunes between chunks — the
    same sense (windowed serve_decision/serve_shed readings), decide
    (EWMA'd offered-demand + hysteresis gate + guardrail), actuate
    (``set_global_rate`` hook) loop the bootstrap wires. The record
    pins the autopilot story: the admission setpoint tracks the curve
    BOTH directions with zero operator calls and zero guardrail
    freezes, while per-phase p99/shed stay explicit fields."""
    import random as _random

    from ..config.static import AutopilotConfig
    from ..ops import schema as S
    from ..runtime.autopilot import (
        CapacityController,
        KEY_HISTORY_RPS,
    )
    from ..serving import (
        ArrivalProcess,
        OpenLoopHarness,
        ResidentEngine,
        ServeWorkload,
    )
    from ..testing import workloads as W
    from ..utils.metrics import NOOP as _NOOP, Scope, Window
    from ..utils.quotas import (
        MultiStageRateLimiter,
        RetryBudget,
    )

    caps = S.Capacities(
        max_events=512, max_activities=2, max_timers=2,
        max_children=2, max_request_cancels=2, max_signals_ext=4,
        max_version_items=2)

    def make_chunk(rng, serial, tag):
        loads = []
        for _ in range(workflows_per_chunk):
            serial[0] += 1
            batches = W.signal_history(
                rng, min_events=min_events, max_events=max_events)
            cut = max(1, int(len(batches) * 0.4))
            loads.append(ServeWorkload(
                domain_id=f"dom-{serial[0] % 2}",
                workflow_id=f"diurnal-{tag}-wf-{serial[0]}",
                run_id=f"diurnal-{tag}-run-{serial[0]}",
                branch_token=b"",
                prefix=batches[:cut],
                deltas=[batches[k:k + 2]
                        for k in range(cut, len(batches), 2)],
            ))
        return loads

    # warm round on its own engine/registry (serve_overload idiom)
    warm_engine = ResidentEngine(lanes=lanes, caps=caps, metrics=_NOOP,
                                 idle_ticks=2, device=device)
    OpenLoopHarness(
        warm_engine, make_chunk(_random.Random(41), [0], "warm"),
        ArrivalProcess(qps=qps_low, seed=5), metrics=_NOOP,
    ).run()
    warm_engine.drain()

    scope = Scope()
    reg = scope.registry
    engine = ResidentEngine(lanes=lanes, caps=caps, metrics=scope,
                            idle_ticks=2, device=device)
    limiter = MultiStageRateLimiter(
        global_rps=initial_rps, domain_rps=lambda d: 1e9)
    ap = CapacityController(
        AutopilotConfig(
            enabled=True, target_p99_ms=60_000.0, ewma_alpha=0.5,
            min_dwell=1, cooldown_epochs=0, max_step_frac=0.5,
            headroom_frac=0.5, min_rps=5.0),
        registry=reg,
        rate_hooks={KEY_HISTORY_RPS: limiter.set_global_rate},
        initial_rates={KEY_HISTORY_RPS: limiter.global_rps},
        metrics=scope,
    )
    rng = _random.Random(97)
    serial = [0]
    phase_window = Window(reg)

    def run_phase(name, qps, chunks):
        for _ in range(chunks):
            OpenLoopHarness(
                engine, make_chunk(rng, serial, name),
                ArrivalProcess(qps=qps, seed=serial[0]),
                metrics=scope, limiter=limiter,
                retry_budget=RetryBudget(ratio=0.2, cap=16.0,
                                         initial=8.0),
            ).run()
            ap.run_epoch_once()
        r = phase_window.advance()
        st = r.timer_stats("serve_decision")
        shed = r.counter("serve_shed")
        return {
            "chunks": chunks,
            "offered_qps_target": round(qps, 1),
            "admitted": st.count,
            "shed": shed,
            "shed_frac": round(shed / max(shed + st.count, 1), 4),
            "p99_ms": round(st.p99 * 1e3, 3),
            "rate_rps": round(
                ap.status()["rates"][KEY_HISTORY_RPS], 2),
            "demand_rps": round(
                r.gauge("autopilot_demand_rps"), 2),
        }

    try:
        low = run_phase("low", qps_low, chunks_low)
        high = run_phase("high", qps_high, chunks_high)
        trough = run_phase("trough", qps_low, chunks_trough)
    finally:
        drained = engine.drain()

    status = ap.status()
    st = reg.timer_stats("serve_decision")
    total_shed = reg.counter_value("serve_shed")
    ap_tags = {"layer": "autopilot"}
    operator_calls = (
        reg.counter_value("autopilot_pauses", tags=ap_tags)
        + reg.counter_value("autopilot_resumes", tags=ap_tags)
    )
    return {
        "workflows_per_chunk": workflows_per_chunk,
        "lanes": lanes,
        "qps_low": round(qps_low, 1),
        "qps_high": round(qps_high, 1),
        "initial_rps": round(initial_rps, 1),
        "phases": {"low": low, "high": high, "trough": trough},
        "rate_low_rps": low["rate_rps"],
        "rate_high_rps": high["rate_rps"],
        "rate_final_rps": trough["rate_rps"],
        "rate_tracks_load": bool(
            high["rate_rps"] > low["rate_rps"] * 1.2
            and trough["rate_rps"] < high["rate_rps"]
        ),
        "epochs": status["epochs_run"],
        "retunes": reg.counter_value(
            "autopilot_rate_retunes", tags=ap_tags),
        "guardrail_freezes": status["guardrail_freezes"],
        "gate_switches": status["gate_switches"],
        "overloaded_final": status["overloaded"],
        "operator_calls": operator_calls,
        "p99_overall_ms": round(st.p99 * 1e3, 3),
        "shed_frac_overall": round(
            total_shed / max(total_shed + st.count, 1), 4),
        "drain_flush_failed": drained["flush_failed"],
    }


def queue_drain(tasks_per_queue=2000, n_wf=48, parallelism=4,
                batch_size=128, close_every=500, stall_us=150,
                matrix_path=None):
    """Queue-drain throughput: sequential pump vs the conflict-keyed
    wave executor (runtime/queues/parallel.py) over an identical mixed
    transfer/timer storm.

    Three queue pipelines (two transfer shards + one timer) carry
    ``tasks_per_queue`` rows each, round-robin over ``n_wf`` workflows
    with a sprinkle of CloseExecution (the untargeted cross-workflow
    fan-out that serializes its cycle). Both arms run the identical
    handler — a commutative per-(workflow, task-type) accumulator — so
    the final state must match byte-for-byte. The sequential arm is
    the production one-task-at-a-time drain (``QueueProcessorBase``
    own pump, one worker: per-task ack lock + per-task pool submit);
    the parallel arm registers the same pipelines on one shared
    ``ParallelQueueExecutor`` gated on the regenerated conflict-matrix
    artifact (``ensure_conflict_matrix``).

    Each task carries a ``stall_us`` GIL-releasing stall modeling the
    persistence/matching round-trip a real transfer or timer task
    spends most of its wall-clock in — the latency the wave executor
    exists to overlap: the ordered baseline pays it serially, while
    provably-commuting conflict groups overlap it across the worker
    pool (plus batched ack-lock and per-group instead of per-task
    submit amortization). The baseline is ``worker_count=1`` because
    that is the configuration with the SAME ordering guarantee the
    wave schedule preserves; a wider naive pool overlaps arbitrary
    tasks with no commutativity proof. ``matrix_path`` defaults to the
    port's artifact (``parallel.PORT_MATRIX_PATH``).
    """
    import threading as _threading
    from types import SimpleNamespace

    from ..core.enums import TimerTaskType, TransferTaskType
    from ..runtime.queues.ack import QueueAckManager
    from ..runtime.queues.base import QueueProcessorBase
    from ..runtime.queues.parallel import (
        PORT_MATRIX_PATH,
        ParallelQueueExecutor,
        ensure_conflict_matrix,
    )

    queues = ("transfer-0", "transfer-1", "timer-0")

    # closes live at the storm's tail — a workflow's CloseExecution is
    # the last task of its lifecycle, not a uniform sprinkle. The
    # untargeted fan-out serializes its whole cycle, so tail placement
    # also keeps the serialized window where a real drain has it: at
    # the end, once the commuting bulk has already overlapped
    n_close = (tasks_per_queue // close_every) if close_every else 0

    def _mk_tasks(queue):
        rows = []
        for i in range(tasks_per_queue):
            if queue.startswith("timer"):
                tt = (TimerTaskType.UserTimer if i % 3
                      else TimerTaskType.ActivityTimeout)
            elif i >= tasks_per_queue - n_close:
                tt = TransferTaskType.CloseExecution
            else:
                tt = (TransferTaskType.DecisionTask if i % 2
                      else TransferTaskType.ActivityTask)
            rows.append(SimpleNamespace(
                task_id=i + 1, task_type=tt, domain_id="bench",
                workflow_id=f"wf-{i % n_wf}", run_id=f"run-{i % n_wf}",
                target_workflow_id="", target_domain_id="",
            ))
        return rows

    total = len(queues) * tasks_per_queue

    def _run_arm(executor):
        state = {}
        lock = _threading.Lock()
        done = _threading.Event()
        counter = [0]

        def process(task):
            # the persistence/matching round-trip stand-in (GIL
            # released, like the real blocking call)
            if stall_us:
                time.sleep(stall_us / 1e6)
            # commutative per-(workflow, type) accumulator: commuting
            # reorder cannot change it, a lost/duplicated task must.
            # The last task trips the event — drain completion is
            # detected on the worker side, not through a polling loop
            # whose sleep quantum would swamp the measurement
            key = f"{task.workflow_id}:{int(task.task_type)}"
            with lock:
                state[key] = state.get(key, 0) + task.task_id
                counter[0] += 1
                if counter[0] == total:
                    done.set()

        procs = []
        for q in queues:
            rows = _mk_tasks(q)

            def read(level, limit, rows=rows):
                return [t for t in rows if t.task_id > level][:limit]

            procs.append(QueueProcessorBase(
                name=q, ack=QueueAckManager(0), read_batch=read,
                process_task=process, complete_task=lambda t: None,
                task_key=lambda t: t.task_id,
                worker_count=1,  # the one-task-at-a-time baseline
                batch_size=batch_size, poll_interval_s=0.005,
                executor=executor,
            ))
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        if executor is not None:
            executor.start()
            executor.notify()
        else:
            for p in procs:
                p.notify()
        drained = done.wait(timeout=120.0)
        dt = time.perf_counter() - t0
        # let the final acks land and the watermark sweep before teardown
        sweep_deadline = time.monotonic() + 10.0
        while time.monotonic() < sweep_deadline:
            if all(p.ack.update_ack_level() >= tasks_per_queue
                   for p in procs):
                break
            time.sleep(0.002)
        for p in procs:
            p.stop()
        if executor is not None:
            executor.stop()
        rate = total / dt if dt > 0 else 0.0
        return state, rate, drained

    seq_state, seq_rate, seq_drained = _run_arm(None)
    ex = ParallelQueueExecutor(
        parallelism=parallelism, batch_size=batch_size,
        poll_interval_s=0.005,
        matrix_path=ensure_conflict_matrix(
            matrix_path or PORT_MATRIX_PATH),
    )
    par_state, par_rate, par_drained = _run_arm(ex)
    return {
        "tasks": len(queues) * tasks_per_queue,
        "queues": len(queues),
        "n_workflows": n_wf,
        "parallelism": parallelism,
        "seq_tasks_per_sec": round(seq_rate, 1),
        "par_tasks_per_sec": round(par_rate, 1),
        "speedup": round(par_rate / seq_rate, 2) if seq_rate else 0.0,
        # mean concurrent conflict groups per shared cycle (the
        # parqueue_wave_width metric) and the fraction of tasks folded
        # into an already-open group (parqueue_conflict_frac)
        "wave_width_mean": round(ex.waves / max(1, ex.cycles), 2),
        "conflict_frac": round(1.0 - ex.waves / max(1, ex.tasks), 4),
        "cycles": ex.cycles,
        "stale_skipped": ex.stale_skipped,
        "degraded": ex.degraded,
        "drained": bool(seq_drained and par_drained),
        "state_identical": seq_state == par_state,
    }
