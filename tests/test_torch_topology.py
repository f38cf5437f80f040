"""The port's topology planes against the reference package, directly.

The same seeded inputs go through both packages and the results compare
exactly (host structures and integers): the conflict-matrix document and
the footprint fingerprint; ``ShardMap`` split/merge sequences; a split
and a merge back on a seeded box (the plan's counts, every shard's rows
and tasks, every run's stored snapshot); and a ``CapacityController``
fed the same scripted readings, epoch by epoch. The reshard coordinator
also raises when its device replay faults (only a ``PackError`` falls
back), and the port's conflict matrix is written at its own path.
"""

from __future__ import annotations

import importlib
import random

import pytest

from tests.test_torch_service import _Renamer

PKGS = ("cadence_tpu", "cadence_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def test_conflict_matrix_and_fingerprint_equal(tmp_path):
    J = _mod("cadence_tpu", "runtime.queues.effects")
    T = _mod("cadence_tpu_torch", "runtime.queues.effects")
    assert T.footprints_fingerprint() == J.footprints_fingerprint()
    assert T.build_conflict_matrix() == J.build_conflict_matrix()
    # the port's artifact: its own file under build/, loaded back fresh
    par = _mod("cadence_tpu_torch", "runtime.queues.parallel")
    assert par.PORT_MATRIX_PATH.endswith(
        "build/torch_queue_conflict_matrix.json")
    path = str(tmp_path / "m.json")
    assert par.ensure_conflict_matrix(path) == path
    ex = par.ParallelQueueExecutor(parallelism=2, matrix_path=path)
    assert not ex.degraded
    jm = _mod("cadence_tpu", "runtime.queues.parallel").ConflictMatrix.live()
    labels = sorted(f"{a}:{b}" for a, b in J.TASK_FOOTPRINTS)
    for a in labels:
        assert (ex.matrix.untargeted_xwf(a), ex.matrix.targeted_xwf(a),
                ex.matrix.touches_workflow_state(a)) == (
            jm.untargeted_xwf(a), jm.targeted_xwf(a),
            jm.touches_workflow_state(a))
        for b in labels:
            assert ex.matrix.same_workflow_conflict(a, b) == \
                jm.same_workflow_conflict(a, b)


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_shard_map_sequences_equal(seed):
    maps = {p: _mod(p, "runtime.resharding").ShardMap.initial(3)
            for p in PKGS}
    rng = random.Random(seed)
    wids = [f"wf-{i}" for i in range(300)]
    for _ in range(24):
        ids = maps["cadence_tpu"].shard_ids()
        if rng.random() < 0.6 or len(ids) < 2:
            op = ("split", rng.choice(ids))
        else:
            a, b = rng.sample(ids, 2)
            op = ("merge", a, b)
        out = {}
        for p, m in maps.items():
            try:
                nxt = m.split(op[1])[0] if op[0] == "split" \
                    else m.merge(op[1], op[2])
                nxt.validate()
                out[p] = (nxt.to_dict(), [nxt.shard_for(w) for w in wids])
                maps[p] = nxt
            except ValueError as e:
                out[p] = ("ValueError", str(e))
        assert out["cadence_tpu_torch"] == out["cadence_tpu"], op


def _box(pkg):
    onebox = _mod(pkg, "testing.onebox")
    clock = _mod(pkg, "utils.clock").FakeTimeSource()
    kw = {"start_worker": False} if pkg == "cadence_tpu" else {
        "start_worker": False, "device": "cpu"}
    box = onebox.Onebox(num_shards=2, checkpoints=True, time_source=clock,
                        **kw).start()
    box.domain_handler.register_domain("topo")
    return box


def _seed(pkg, box):
    """28 workflows: execution timeouts of three lengths (their timers),
    0-2 signals each on a pending first decision, and every seventh
    terminated (a closed row that moves without a rebuild)."""
    api = _mod(pkg, "runtime.api")
    runs = {}
    for i in range(28):
        wf = f"wf-{i:02d}"
        runs[wf] = box.frontend.start_workflow_execution(
            api.StartWorkflowRequest(
                domain="topo", workflow_id=wf, workflow_type="t",
                task_list="tl", input=b"x", request_id=f"req-{wf}",
                execution_start_to_close_timeout_seconds=600 * (1 + i % 3)))
        for k in range(i % 3):
            box.frontend.signal_workflow_execution(api.SignalRequest(
                domain="topo", workflow_id=wf, signal_name=f"s{k}",
                input=b"y"))
        if i % 7 == 3:
            box.frontend.terminate_workflow_execution(
                "topo", wf, runs[wf], reason="closed")
    assert box.history.drain_queues(20.0)
    return runs


def _shards(box, runs):
    """Every shard's rows, queue tasks and stored snapshots."""
    ex = box.persistence.execution
    out = {}
    for sid in box.history.controller.shard_map.shard_ids():
        rows = sorted(ex.list_concrete_executions(sid),
                      key=lambda r: r[1])
        out[sid] = {
            "rows": rows,
            "transfer": ex.get_transfer_tasks(sid, 0, 1 << 62, 1 << 20),
            "timers": ex.get_timer_tasks(sid, 0, 1 << 62, 1 << 20),
            "snapshots": [
                ex.get_workflow_execution(sid, d, wf, run).snapshot
                for d, wf, run in rows],
        }
    return out


_PLAN_FIELDS = ("kind", "epoch_from", "epoch_to", "map_from", "map_to",
                "sources", "targets", "state", "watermarks",
                "moved_workflows", "moved_tasks", "checkpoints_shipped",
                "suffix_events_replayed", "error")


def test_split_and_merge_on_a_seeded_box_equal():
    got = {}
    for pkg in PKGS:
        box = _box(pkg)
        try:
            runs = _seed(pkg, box)
            split = box.admin.reshard_split(0)
            after_split = _shards(box, runs)
            merge = box.admin.reshard_merge(split["targets"][0], 0)
            after_merge = _shards(box, runs)
        finally:
            box.stop()
        got[pkg] = _Renamer()([
            [{k: split[k] for k in _PLAN_FIELDS}, after_split],
            [{k: merge[k] for k in _PLAN_FIELDS}, after_merge]])
    assert got["cadence_tpu_torch"] == got["cadence_tpu"]
    split, after = got["cadence_tpu_torch"][0]
    assert split["state"] == "COMMITTED" and split["moved_workflows"] > 0
    assert split["checkpoints_shipped"] > 0 and split["moved_tasks"] > 0


def _script(pkg):
    """Scripted epoch readings: steady load, an overload the gate must
    dwell through, a self-inflicted p99 regression (the guardrail), a
    hot shard, then idle shards; the resharder and rate hooks record."""
    R = _mod(pkg, "runtime.autopilot").EpochReading
    rng = random.Random(5)
    out = []
    for e in range(28):
        if e < 6:
            kw = dict(admitted=200, p99_ms=20.0 + e, observed_rps=200.0)
        elif e < 10:
            kw = dict(admitted=400, p99_ms=400.0, shed_frac=0.2,
                      observed_rps=300.0)
        elif e < 14:
            kw = dict(admitted=300, p99_ms=30.0 if e < 12 else 900.0,
                      observed_rps=320.0)
        else:
            kw = dict(admitted=100, p99_ms=15.0, observed_rps=90.0)
        depths = {0: rng.randrange(0, 20), 1: rng.randrange(0, 20),
                  2: rng.randrange(0, 20)}
        if 14 <= e < 18:
            depths[1] = 900
        if e >= 22:
            depths = {0: 0, 1: 0, 2: 0, 3: 0}
        out.append(R(span_s=1.0, shard_depths=depths,
                     domain_rps={"a": kw["observed_rps"] * 0.7,
                                 "b": kw["observed_rps"] * 0.3}, **kw))
    return out


def test_capacity_controller_scripted_readings_equal():
    got = {}
    for pkg in PKGS:
        A = _mod(pkg, "runtime.autopilot")
        cfg = _mod(pkg, "config.static").AutopilotConfig(
            enabled=True, target_p99_ms=100.0, ewma_alpha=0.6,
            min_dwell=2, cooldown_epochs=1, reshard_cooldown_epochs=2,
            max_step_frac=0.25, headroom_frac=0.5, min_rps=5.0,
            guardrail_window=3, guardrail_regression=1.5, freeze_epochs=2,
            hot_shard_depth=64, hot_shard_factor=2.0, min_shards=2,
            cold_shard_frac=0.25)
        calls = []

        class Resharder:
            def split(self, sid):
                calls.append(("split", sid))

            def merge(self, a, b):
                calls.append(("merge", a, b))

        now = [0.0]
        ap = A.CapacityController(
            cfg, rate_hooks={
                k: (lambda v, k=k: calls.append(("rate", k, round(v, 9))))
                for k in (A.KEY_HISTORY_RPS, A.KEY_HISTORY_DOMAIN_RPS,
                          A.KEY_MATCHING_RPS)},
            initial_rates={A.KEY_HISTORY_RPS: 500.0,
                           A.KEY_HISTORY_DOMAIN_RPS: 250.0,
                           A.KEY_MATCHING_RPS: 800.0},
            resharder=Resharder(), clock=lambda: now[0])
        readings = _script(pkg)[::-1]
        ap._sense = readings.pop
        epochs = []
        while readings:
            now[0] += 1.0
            summary = ap.run_epoch_once()
            st = ap.status()
            epochs.append((summary, st, list(calls)))
            calls.clear()
        got[pkg] = epochs
    assert got["cadence_tpu_torch"] == got["cadence_tpu"]
    final = got["cadence_tpu_torch"][-1][1]
    acted = [c for _, _, cs in got["cadence_tpu_torch"] for c in cs]
    assert any(c[0] == "rate" for c in acted)
    assert ("split", 1) in acted and any(c[0] == "merge" for c in acted)
    assert final["guardrail_freezes"] >= 1 and final["gate_switches"] >= 1


def test_device_fault_in_a_handoff_raises(monkeypatch):
    """A fault of the device replay during the flush raises out of the
    plan, which rolls back to the old epoch: no moving workflow is
    rebuilt on the host (the packer's refusal alone takes the host
    route, inside ``rebuild_many``)."""
    from cadence_tpu_torch.runtime.replication import rebuilder as RB
    from cadence_tpu_torch.runtime.resharding import ReshardError

    box = _box("cadence_tpu_torch")
    try:
        runs = _seed("cadence_tpu_torch", box)
        before = _Renamer()(_shards(box, runs))
        host = []
        monkeypatch.setattr(RB.StateRebuilder, "rebuild",
                            lambda rb, req: host.append(req))

        def faulty(d, *a, **kw):
            raise RuntimeError("device fault")
        monkeypatch.setattr(RB.DeviceDispatcher, "submit", faulty)
        with pytest.raises(ReshardError, match="device fault"):
            box.admin.reshard_split(0)
        status = box.admin.reshard_status()
        assert status["epoch"] == 0 and not host
        assert status["last_plan"]["state"] == "ABORTED"
        assert _Renamer()(_shards(box, runs)) == before
    finally:
        box.stop()


def test_coordinator_device_defaults_to_cuda():
    """Without a card, a coordinator built without ``device`` raises at
    its first device replay; it never takes the host route."""
    import torch

    from cadence_tpu_torch.runtime.resharding import ReshardCoordinator
    from cadence_tpu_torch.runtime.service import HistoryService

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import inspect

    assert inspect.signature(ReshardCoordinator).parameters[
        "device"].default == "cuda"
    box = _box("cadence_tpu_torch")
    try:
        _seed("cadence_tpu_torch", box)
        coord = ReshardCoordinator(box.persistence,
                                   [box.history.controller])
        with pytest.raises(Exception) as exc:
            coord.split(0)
        assert "cuda" in str(exc.value).lower() or \
            "device" in str(exc.value).lower()
        assert inspect.signature(HistoryService).parameters[
            "device"].default == "cuda"
    finally:
        box.stop()


def _executor_queue(executor, n, process, read_hook=None):
    from types import SimpleNamespace

    from cadence_tpu_torch.runtime.queues.ack import QueueAckManager
    from cadence_tpu_torch.runtime.queues.base import QueueProcessorBase

    rows = [SimpleNamespace(task_id=k, task_type=0, domain_id="d",
                            workflow_id=f"wf-{k % 5}", run_id="r",
                            target_workflow_id="", target_domain_id="")
            for k in range(1, n + 1)]

    def read(level, limit):
        if read_hook is not None:
            read_hook()
        return [t for t in rows if t.task_id > level][:limit]

    return QueueProcessorBase(
        name="transfer-0", ack=QueueAckManager(0), read_batch=read,
        process_task=process, complete_task=lambda t: None,
        task_key=lambda t: t.task_id, batch_size=8, executor=executor)


def test_executor_takes_back_deferred_tasks():
    """A task deferred in executor mode comes back through the ack
    manager's ``take_retries`` on a later collect and runs; the sweep
    then passes every task."""
    import threading
    import time

    from cadence_tpu_torch.runtime.queues.allocator import DeferTask
    from cadence_tpu_torch.runtime.queues.parallel import (
        ParallelQueueExecutor)

    ran, lock = [], threading.Lock()

    def process(task):
        with lock:
            first = task.task_id not in ran
            ran.append(task.task_id)
        if first and task.task_id % 3 == 0:
            raise DeferTask("d")

    ex = ParallelQueueExecutor(parallelism=4, poll_interval_s=0.01)
    proc = _executor_queue(ex, 24, process)
    ex.start()
    proc.start()
    try:
        deadline = time.monotonic() + 10.0
        while proc.ack.update_ack_level() < 24:
            assert time.monotonic() < deadline, (proc.ack.ack_level, ran)
            ex.notify()
            time.sleep(0.02)
    finally:
        proc.stop()
        ex.stop()
    deferred = [k for k in range(1, 25) if k % 3 == 0]
    assert sorted(ran) == sorted(list(range(1, 25)) + deferred)
    assert proc.ack.outstanding() == 0 and proc.ack.held() == 0


def test_fence_waits_for_a_collect_in_flight():
    """A collect whose read began before the reshard fence paused intake
    holds the fence until the executor has run its wave, so the
    watermark covers every task it took."""
    import threading
    import time

    from cadence_tpu_torch.runtime.queues.parallel import (
        ParallelQueueExecutor)

    reading, release = threading.Event(), threading.Event()

    def hook():
        if not reading.is_set():
            reading.set()
            assert release.wait(5.0)

    ran = []
    ex = ParallelQueueExecutor(parallelism=2, poll_interval_s=0.01)
    proc = _executor_queue(ex, 6, ran.append, read_hook=hook)
    ex.start()
    proc.start()
    try:
        assert reading.wait(5.0)
        got = {}
        fence = threading.Thread(target=lambda: got.update(
            mark=proc.fence_drain(time.monotonic() + 5.0)))
        fence.start()
        time.sleep(0.2)
        assert fence.is_alive()  # the collect is mid-read
        release.set()
        fence.join(5.0)
        assert not fence.is_alive()
    finally:
        release.set()
        proc.stop()
        ex.stop()
    assert got["mark"] == 6 and sorted(t.task_id for t in ran) == \
        list(range(1, 7))
