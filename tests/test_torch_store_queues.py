"""The port's indexed task tables and its coalesced defer wheel.

The memory store keeps each shard's transfer, timer and replication tasks
in a table whose keys are held sorted; its queue reads are checked here
against the reference package's store (which sorts the whole table on
every read) on the same seeded tasks, reads and deletions. The ack
manager releases its deferred entries from one timer thread; a pump that
keeps its deferred tasks takes them back without a read rewind.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

import pytest


def _stores():
    from cadence_tpu.core import tasks as JT
    from cadence_tpu.runtime.persistence import memory as JM
    from cadence_tpu_torch.core import tasks as PT
    from cadence_tpu_torch.runtime.persistence import memory as PM

    return ((JM.MemoryExecutionManager(JM.MemoryShardManager()), JT),
            (PM.MemoryExecutionManager(PM.MemoryShardManager()), PT))


def _put(store, T, rng_seed, n):
    """``n`` seeded transfer, timer and replication tasks on shards 0-1,
    written through the store's own task writer in a shuffled order."""
    rng = random.Random(rng_seed)
    ids = rng.sample(range(1, 50 * n), n)
    for shard in (0, 1):
        snap = type("Snap", (), {})()
        snap.transfer_tasks = [
            T.TransferTask(task_type=T.TransferTaskType.DecisionTask,
                           workflow_id=f"wf-{i % 7}", task_id=i,
                           schedule_id=i % 5)
            for i in ids]
        snap.timer_tasks = [
            T.TimerTask(task_type=T.TimerTaskType.UserTimer,
                        visibility_timestamp=rng.randrange(0, 40) * 1000,
                        workflow_id=f"wf-{i % 7}", task_id=i)
            for i in ids]
        snap.replication_tasks = [
            T.ReplicationTask(workflow_id=f"wf-{i % 7}", task_id=i,
                              first_event_id=i % 9)
            for i in ids]
        store._put_tasks(shard, snap)
    return sorted(ids)


def _rows(tasks):
    return [(type(t).__name__, {k: (v.value if hasattr(v, "value") else v)
                                for k, v in dataclasses.asdict(t).items()})
            for t in tasks]


@pytest.mark.parametrize("seed,run", [(3, 512), (11, 512), (5, 2)])
def test_task_table_reads_equal_reference(seed, run, monkeypatch):
    """``run`` bounds the port's sorted runs of keys: at 2 every insert
    and deletion splits or empties runs."""
    from cadence_tpu_torch.runtime.persistence import memory as PM

    monkeypatch.setattr(PM._TaskTable, "_RUN", run)
    (js, JT), (ps, PT) = _stores()
    ids = _put(js, JT, seed, 300)
    assert _put(ps, PT, seed, 300) == ids
    rng = random.Random(seed + 1)
    for step in range(120):
        shard = rng.randrange(2)
        lo = rng.choice([0, rng.choice(ids), rng.randrange(0, 50 * 300)])
        hi = lo + rng.randrange(0, 4000)
        n = rng.choice([1, 7, 64, 1000])
        got = [(s.get_transfer_tasks(shard, lo, hi, n),
                s.get_replication_tasks(shard, lo, n))
               for s in (js, ps)]
        assert _rows(got[0][0]) == _rows(got[1][0])
        assert _rows(got[0][1]) == _rows(got[1][1])
        ts = rng.randrange(0, 40) * 1000
        after = (None if rng.random() < 0.5
                 else (ts + rng.choice([0, 1000]), rng.choice(ids)))
        top = ts + rng.randrange(1, 20000)
        timers = [s.get_timer_tasks(shard, ts, top, n, after_key=after)
                  for s in (js, ps)]
        assert _rows(timers[0]) == _rows(timers[1])
        # deletions, both ways, keep the tables in step
        if step % 10 == 3 or run == 2:
            tid = rng.choice(ids)
            for s in (js, ps):
                s.complete_transfer_task(shard, tid)
                s.complete_replication_task(shard, tid)
        if step % 25 == 7:
            cut, cut_ts = rng.choice(ids), rng.randrange(0, 20) * 1000
            for s in (js, ps):
                s.range_complete_transfer_tasks(shard, 0, cut)
                s.range_complete_timer_tasks(shard, 0, cut_ts)
    # a read hands out copies: changing one leaves the table alone
    t = ps.get_transfer_tasks(1, 0, 1 << 62, 1)[0]
    t.schedule_id = -5
    assert ps.get_transfer_tasks(1, 0, 1 << 62, 1)[0].schedule_id != -5


def _ack(keep, level=0):
    from cadence_tpu_torch.runtime.queues.ack import QueueAckManager

    ack = QueueAckManager(level)
    wakes = []
    if keep:
        ack.keep_deferred_tasks(lambda: wakes.append("retry"))
    else:
        ack.on_read_rewind = lambda: wakes.append("rewind")
    return ack, wakes


def _wait(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


@pytest.mark.parametrize("keep", [False, True])
def test_defer_wheel_releases_together(keep):
    """200 entries deferred together come back after their delay on one
    wheel thread, with a handful of wake-ups and not one per entry; kept
    tasks come back through ``take_retries`` with no read rewind."""
    ack, wakes = _ack(keep)
    keys = list(range(1, 201))
    for k in keys:
        assert ack.add(k)
    threads = threading.active_count()
    t0 = time.monotonic()
    for k in keys:
        ack.defer(k, 0.1, task=f"task-{k}")
    assert threading.active_count() <= threads + 1
    assert ack.held() == 200 and ack.outstanding() == 0
    if keep:
        got = []
        _wait(lambda: got.extend(ack.take_retries()) or len(got) == 200)
        assert time.monotonic() - t0 >= 0.1
        assert got == [(k, f"task-{k}") for k in keys]
        assert ack.outstanding() == 200 and ack.read_level == 200
        assert not ack.add(1)  # re-taken already
    else:
        _wait(lambda: ack.add(1))
        assert time.monotonic() - t0 >= 0.1
        assert ack.read_level == 0
        assert all(ack.add(k) for k in keys[1:])
    assert 1 <= len(wakes) <= 5
    for k in keys:
        ack.complete(k)
    assert ack.update_ack_level() == 200
    _wait(lambda: ack._wheel is None)


def test_defer_wheel_rewind_drops_held_tasks():
    """A rewind over a held span drops its entries and their kept tasks:
    nothing comes back through ``take_retries`` for them."""
    ack, wakes = _ack(True, level=5)
    for k in range(6, 16):
        ack.add(k)
        ack.defer(k, 0.05, task=k)
    ack.rewind(2)
    assert ack._held_tasks == {}
    time.sleep(0.25)
    assert ack.take_retries() == [] and wakes == []
    assert ack.add(8)  # re-read after the rewind: taken as new


@pytest.mark.parametrize("pkg", ["cadence_tpu", "cadence_tpu_torch"])
def test_rewind_rereads_a_skipped_task_above_a_running_one(pkg):
    """A failover rewind must re-read what was read above its level even
    when a task still running holds the ack level at or below it. The
    new active side's transfer pump took task 25 (slow) and 26 (the live
    workflow's decision, skipped as the standby's and completed) before
    the flip; both failover rewinds came to 25 while 25 still ran. The
    reference's ``rewind`` returns there (its level is not below the
    ack level), so 26 stays completed and the sweep passes it: the
    decision never runs on the new active side. The port re-reads it."""
    import importlib

    QueueAckManager = importlib.import_module(
        f"{pkg}.runtime.queues.ack").QueueAckManager
    persisted = []
    ack = QueueAckManager(24, update_shard_ack=persisted.append)
    gen = ack.generation()
    assert ack.add(25, generation=gen) and ack.add(26, generation=gen)
    ack.complete(26)                       # skipped before the flip
    assert ack.update_ack_level() == 24    # 25 is still running
    ack.rewind(25)                         # the failover listener
    ack.rewind(25)                         # the standby's handover
    ack.complete(25)                       # the slow task finishes
    if pkg == "cadence_tpu":
        assert not ack.add(26)             # the fault the port fixes
        assert ack.update_ack_level() == 26
        return
    assert ack.read_level == 25 and ack.generation() != gen
    assert ack.update_ack_level() == 25 and persisted == [25]
    assert ack.add(26, generation=ack.generation())  # re-read and re-run
    assert ack.update_ack_level() == 25
    ack.complete(26)
    assert ack.update_ack_level() == 26


def test_rewind_keeps_the_retry_of_a_reread_entry():
    """A rewind over a due held entry, then a re-read that holds it
    again: the stale release must not hand the new held task away."""
    ack, wakes = _ack(True, level=0)
    ack.add(3)
    ack.defer(3, 0.01, task="first")
    _wait(lambda: wakes)                 # 3 is due: its key waits
    ack.rewind(1)                        # drops 3 and its held task
    assert ack.add(3)                    # re-read
    ack.defer(3, 5.0, task="second")     # and held again
    assert ack.take_retries() == []
    assert ack._held_tasks == {3: "second"} and ack.held() == 1


def test_stale_wave_runs_the_tasks_a_rewind_kept():
    """An executor wave collected before a rewind skips the entries the
    rewind dropped and runs the ones it kept (at or below its level):
    skipped, a kept entry would stay in flight and wedge the sweep."""
    from cadence_tpu_torch.core.tasks import TransferTask
    from cadence_tpu_torch.core.enums import TransferTaskType
    from cadence_tpu_torch.runtime.queues.ack import QueueAckManager
    from cadence_tpu_torch.runtime.queues.parallel import (
        ParallelQueueExecutor, _SchedTask, _Slot)

    class Proc:
        name = "transfer-0"
        ack = QueueAckManager(0)
        ran = []

        def parallel_run(self, task, key):
            self.ran.append(key)

    ex = ParallelQueueExecutor(parallelism=2)
    proc = Proc()
    gen = proc.ack.generation()
    assert proc.ack.add_batch([1, 2, 3], generation=gen) == [True] * 3
    tasks = [TransferTask(task_type=TransferTaskType.DecisionTask,
                          domain_id="d", workflow_id="wf", task_id=k)
             for k in (1, 2, 3)]
    slot = _Slot(proc)
    group = [_SchedTask(slot, t, t.task_id, gen, (0, i), ex.matrix)
             for i, t in enumerate(tasks)]
    proc.ack.rewind(1)                   # keeps 1, drops 2 and 3
    assert proc.ack.add(2, generation=proc.ack.generation())  # re-read
    ex._run_group(group)
    assert proc.ran == [1] and ex.stale_skipped == 2


def test_handover_drill_with_a_slow_task_below_the_held_decision(
        monkeypatch):
    """The managed-handover drill on the port, with the interleaving
    that lost the live decision: on the new active side a transfer task
    just below the held decision runs for 0.9 s, and the flip lands
    0.1 s after the drain, so both failover rewinds come while it runs.
    The live workflow must still complete on the new active side."""
    from tests import test_torch_replication_cases as H
    from cadence_tpu_torch.runtime.queues import transfer as T
    from cadence_tpu_torch.runtime.replication import failover as F

    process, flip = T.TransferQueueProcessor._process, \
        F.DomainFailoverCoordinator._flip

    def slow_process(self, task):
        cm = self.engine.cluster_metadata
        if cm.current_cluster_name == "standby" \
                and task.workflow_id == "fo-live" \
                and task.task_type == T.TransferTaskType.RecordWorkflowStarted:
            time.sleep(0.9)
        return process(self, task)

    def late_flip(self, *a, **kw):
        time.sleep(0.1)
        return flip(self, *a, **kw)

    monkeypatch.setattr(T.TransferQueueProcessor, "_process", slow_process)
    monkeypatch.setattr(F.DomainFailoverCoordinator, "_flip", late_flip)
    ns = H._load("test_failover_drills")
    run_worker = ns["_run_worker"]
    ns["_run_worker"] = lambda *a, **kw: run_worker(*a, timeout_s=15.0)
    ns["TestFailoverManagedHandover"]() \
        .test_managed_handover_zero_lost_progress()
