"""Benchmark workload histories: echo, signal, timer storm, retry-deep and
the NDC replication storm.

Shapes mirror Cadence's canary workload definitions (canary/const.go):
echo, signal-heavy, timer storm (cron/timeout-class) and
activity-retry/concurrent deep histories, and the NDC storm's fuzzed
mixes (``testing/event_generator.py``). Each generator returns the
transaction-batch list the packer consumes. A copy of
the reference package's generators: the same ``random.Random`` seed
gives the same histories in both packages.
"""

from __future__ import annotations

import random
from typing import List

from ..core import history_factory as F
from ..core.events import HistoryEvent

SECOND = 1_000_000_000
T0 = 1_700_000_000 * SECOND

Batches = List[List[HistoryEvent]]


class _Ids:
    def __init__(self) -> None:
        self.eid = 0
        self.t = T0

    def next(self) -> int:
        self.eid += 1
        return self.eid

    def tick(self, seconds: int = 1) -> int:
        self.t += seconds * SECOND
        return self.t


def _start(ids: _Ids, v: int, workflow_type: str) -> List[HistoryEvent]:
    return [F.workflow_execution_started(
        ids.next(), v, ids.t, task_list="tl", workflow_type=workflow_type,
        execution_start_to_close_timeout_seconds=3600,
        task_start_to_close_timeout_seconds=10,
    )]


def _decision_cycle(ids: _Ids, v: int) -> Batches:
    """scheduled → started → (completed is appended by the caller so it
    can ride in the same batch as the commands it emits)."""
    sch = ids.next()
    out = [[F.decision_task_scheduled(sch, v, ids.t)]]
    sta = ids.next()
    out.append([F.decision_task_started(sta, v, ids.tick(),
                                        scheduled_event_id=sch)])
    return out


def _decision_completed(ids: _Ids, v: int) -> HistoryEvent:
    sta = ids.eid
    return F.decision_task_completed(
        ids.next(), v, ids.tick(), scheduled_event_id=sta - 1,
        started_event_id=sta,
    )


def echo_history(v: int = 10) -> Batches:
    """canary/echo: one activity round-trip, ~11 events, closed."""
    ids = _Ids()
    out = [_start(ids, v, "echo")]
    out += _decision_cycle(ids, v)
    dcomp = _decision_completed(ids, v)
    act = ids.next()
    out.append([dcomp, F.activity_task_scheduled(
        act, v, ids.t, activity_id="a1",
        decision_task_completed_event_id=dcomp.event_id,
    )])
    sta = ids.next()
    out.append([F.activity_task_started(sta, v, ids.tick(),
                                        scheduled_event_id=act)])
    out.append([F.activity_task_completed(
        ids.next(), v, ids.tick(), scheduled_event_id=act,
        started_event_id=sta,
    ), F.decision_task_scheduled(ids.next(), v, ids.t)])
    sch = ids.eid
    sta2 = ids.next()
    out.append([F.decision_task_started(sta2, v, ids.tick(),
                                        scheduled_event_id=sch)])
    dcomp2 = F.decision_task_completed(
        ids.next(), v, ids.tick(), scheduled_event_id=sch,
        started_event_id=sta2,
    )
    out.append([dcomp2, F.workflow_execution_completed(
        ids.next(), v, ids.t,
        decision_task_completed_event_id=dcomp2.event_id,
    )])
    return out


def signal_history(rng: random.Random, v: int = 10,
                   min_events: int = 20, max_events: int = 400) -> Batches:
    """canary/signal: signal-dominated, ragged lengths, left open."""
    ids = _Ids()
    target = rng.randint(min_events, max_events)
    out = [_start(ids, v, "signal")]
    out += _decision_cycle(ids, v)
    out.append([_decision_completed(ids, v)])
    n = 0
    while ids.eid < target:
        # burst of signals, then a decision cycle consuming them
        for _ in range(rng.randint(1, 4)):
            n += 1
            out.append([F.workflow_execution_signaled(
                ids.next(), v, ids.tick(), signal_name=f"sig-{n}",
            )])
        out += _decision_cycle(ids, v)
        out.append([_decision_completed(ids, v)])
    return out


def timer_storm_history(rng: random.Random, v: int = 10,
                        depth: int = 400, fanout: int = 8) -> Batches:
    """canary/cron + canary/timeout: timer-fire-dominated stream — each
    decision starts a fan of timers which then fire back-to-back."""
    ids = _Ids()
    out = [_start(ids, v, "timer-storm")]
    timer_n = 0
    while ids.eid < depth:
        out += _decision_cycle(ids, v)
        dcomp = _decision_completed(ids, v)
        batch = [dcomp]
        started: List[tuple] = []
        for _ in range(fanout):
            timer_n += 1
            tid = f"t{timer_n}"
            sid = ids.next()
            batch.append(F.timer_started(
                sid, v, ids.t, timer_id=tid,
                start_to_fire_timeout_seconds=rng.randint(1, 30),
                decision_task_completed_event_id=dcomp.event_id,
            ))
            started.append((tid, sid))
        out.append(batch)
        for tid, sid in started:
            out.append([F.timer_fired(ids.next(), v, ids.tick(),
                                      timer_id=tid, started_event_id=sid)])
    return out


def retry_deep_history(rng: random.Random, v: int = 10,
                       depth: int = 1000) -> Batches:
    """canary/retry + canary/concurrentExec: deep history of activity
    schedule/start/fail retry loops with interleaved decisions."""
    ids = _Ids()
    out = [_start(ids, v, "retry-deep")]
    act_n = 0
    while ids.eid < depth:
        out += _decision_cycle(ids, v)
        dcomp = _decision_completed(ids, v)
        act_n += 1
        act = ids.next()
        out.append([dcomp, F.activity_task_scheduled(
            act, v, ids.t, activity_id=f"a{act_n}",
            decision_task_completed_event_id=dcomp.event_id,
            schedule_to_close_timeout_seconds=300,
        )])
        attempts = rng.randint(1, 3)
        for attempt in range(attempts):
            sta = ids.next()
            out.append([F.activity_task_started(
                sta, v, ids.tick(), scheduled_event_id=act,
                attempt=attempt,
            )])
            last = attempt == attempts - 1
            if last and rng.random() < 0.7:
                out.append([F.activity_task_completed(
                    ids.next(), v, ids.tick(), scheduled_event_id=act,
                    started_event_id=sta,
                )])
            else:
                out.append([F.activity_task_failed(
                    ids.next(), v, ids.tick(), scheduled_event_id=act,
                    started_event_id=sta, reason="retry",
                )])
                if not last:
                    # server reschedules the retry attempt in place:
                    # same activity slot, fresh schedule event
                    act = ids.next()
                    out.append([F.activity_task_scheduled(
                        act, v, ids.t, activity_id=f"a{act_n}",
                        schedule_to_close_timeout_seconds=300,
                    )])
    return out


def ndc_storm_history(fuzzer, depth: int = 1000) -> Batches:
    """NDC replication storm: the fuzzer's mixed-event histories with
    failover-version bumps. No decision closes them (``close_prob=0``);
    the fuzzer's environment still ends each with a terminate or a
    timeout, as the reference's generator does."""
    return fuzzer.generate(target_events=depth, close_prob=0.0)
