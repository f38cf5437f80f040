"""Benchmark workload histories: retry-deep and the NDC replication
storm.

The retry-deep shape follows Cadence's canary retry workflow
(canary/const.go): activity schedule/start/fail retry loops between
decisions, one activity at a time; the NDC storm's are the fuzzed mixes
of ``event_generator.py``. Each generator returns the transaction-batch
list the packer consumes. A copy of the reference package's generators:
the same ``random.Random`` seed gives the same histories in both
packages.

Frozen copy of ``retry_deep_history`` and ``ndc_storm_history`` (with
their helpers) of ``cadence_tpu_torch/testing/workloads.py`` (the port
as of the first benchmark), kept here so that the benchmark's inputs and
reference cannot change with the program. The port's echo, signal and
timer-storm generators are not copied: no configuration uses them.
"""

from __future__ import annotations

import random
from typing import List

from . import history_factory as F
from .events import HistoryEvent

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


def retry_deep_history(rng: random.Random, v: int = 10,
                       depth: int = 1000) -> Batches:
    """canary/retry: deep history of activity schedule/start/fail retry
    loops with interleaved decisions, one activity at a time."""
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
