"""Model-based random history generator.

The framework's equivalent of the reference's event-graph generator
(Cadence common/testing/event_generator.go:38-551): it simulates a
workflow's legal state machine and emits random *valid* walks — histories
any replayer must accept — grouped into transaction batches the way the
active side persists them. Used as fuzz input for kernel-vs-oracle
differential testing and NDC replication tests.

Every generated history is deterministic in the seed, fits the supplied
``Capacities``, uses whole-second timestamps (the device time quantum),
and keeps failover versions monotonic. A copy of the reference package's
fuzzer: the same seed gives the same events in both packages.

Frozen copy of ``cadence_tpu_torch/testing/event_generator.py`` (the
port as of the first benchmark), kept here so that the benchmark's
inputs and reference cannot change with the program.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Set

from . import history_factory as F
from .enums import ParentClosePolicy, TimeoutType
from .events import HistoryEvent
from .ids import EMPTY_EVENT_ID
from .schema import Capacities

SECOND = 1_000_000_000


class HistoryFuzzer:
    def __init__(
        self,
        seed: int = 0,
        caps: Optional[Capacities] = None,
        version_bump_prob: float = 0.05,
    ) -> None:
        self.rng = random.Random(seed)
        self.caps = caps or Capacities()
        self.version_bump_prob = version_bump_prob

    def generate(
        self,
        target_events: int = 40,
        start_time: int = 1_700_000_000 * SECOND,
        version: int = 10,
        close: bool = True,
        close_prob: float = 0.1,
    ) -> List[List[HistoryEvent]]:
        """One random valid history as a list of transaction batches."""
        rng = self.rng
        caps = self.caps
        batches: List[List[HistoryEvent]] = []

        eid = 1
        t = start_time
        v = version
        version_items = 1
        # simulation state
        dec_scheduled: Optional[int] = None
        dec_started: Optional[int] = None
        dec_attempt = 0
        acts_scheduled: Dict[int, str] = {}   # schedule_id → activity_id
        acts_started: Dict[int, int] = {}     # schedule_id → started_id
        act_names_live: Set[str] = set()
        act_counter = 0
        timers: Dict[str, int] = {}           # timer_id → started_id
        timer_counter = 0
        children_init: Dict[int, Optional[int]] = {}  # initiated → started_id|None
        child_counter = 0
        cancels: Set[int] = set()
        signals: Set[int] = set()
        closed = False

        def bump_time() -> None:
            nonlocal t
            t += rng.randint(0, 5) * SECOND

        def bump_version() -> None:
            nonlocal v, version_items
            if (
                version_items < caps.max_version_items
                and rng.random() < self.version_bump_prob
            ):
                v += rng.randint(1, 3) * 10
                version_items += 1

        def next_id() -> int:
            nonlocal eid
            out = eid
            eid += 1
            return out

        def emit(batch: List[HistoryEvent]) -> None:
            batches.append(batch)

        # ---- start
        emit([F.workflow_execution_started(
            next_id(), v, t,
            task_list="tl", workflow_type="fuzz",
            execution_start_to_close_timeout_seconds=3600,
            task_start_to_close_timeout_seconds=10,
        )])

        def schedule_decision() -> None:
            nonlocal dec_scheduled
            sid = next_id()
            emit([F.decision_task_scheduled(sid, v, t, attempt=dec_attempt)])
            dec_scheduled = sid

        def total_pending() -> int:
            return (
                len(acts_scheduled) + len(timers) + len(children_init)
                + len(cancels) + len(signals)
            )

        while not closed and eid < target_events:
            bump_time()
            bump_version()

            # decision lifecycle drives most progress
            if dec_scheduled is None and dec_started is None:
                choice = rng.random()
                if choice < 0.55:
                    schedule_decision()
                    continue
                # async environment events between decisions
                self._async_event(
                    _Bundle(
                        rng=rng, v=v, t=t, next_id=next_id, emit=emit,
                        acts_scheduled=acts_scheduled, acts_started=acts_started,
                        act_names_live=act_names_live, timers=timers,
                        children_init=children_init, cancels=cancels,
                        signals=signals,
                    )
                )
                continue

            if dec_scheduled is not None and dec_started is None:
                r = rng.random()
                if r < 0.8:
                    sid = next_id()
                    emit([F.decision_task_started(sid, v, t,
                                                  scheduled_event_id=dec_scheduled)])
                    dec_started = sid
                    dec_attempt = 0
                else:
                    # sticky schedule-to-start timeout: decision dropped and
                    # the FSM resets the attempt (fail_decision(False))
                    emit([F.decision_task_timed_out(
                        next_id(), v, t, scheduled_event_id=dec_scheduled,
                        timeout_type=TimeoutType.ScheduleToStart)])
                    dec_scheduled = None
                    dec_attempt = 0
                continue

            # in-flight decision: complete (usually), fail, or time out
            r = rng.random()
            if r < 0.08:
                emit([F.decision_task_failed(
                    next_id(), v, t, scheduled_event_id=dec_scheduled,
                    started_event_id=dec_started)])
                dec_attempt += 1
                # transient decision is in memory; the next scheduled event
                # carries the attempt
                dec_scheduled = dec_started = None
                schedule_decision()
                continue
            if r < 0.14:
                emit([F.decision_task_timed_out(
                    next_id(), v, t, scheduled_event_id=dec_scheduled,
                    started_event_id=dec_started)])
                dec_attempt += 1
                dec_scheduled = dec_started = None
                schedule_decision()
                continue

            # complete + commands in one transaction batch
            batch = [F.decision_task_completed(
                next_id(), v, t, scheduled_event_id=dec_scheduled,
                started_event_id=dec_started)]
            completed_id = batch[0].event_id
            dec_scheduled = dec_started = None

            n_cmds = rng.randint(0, 3)
            for _ in range(n_cmds):
                if eid >= target_events:
                    break
                cmd = rng.random()
                if cmd < 0.35 and len(acts_scheduled) < caps.max_activities - 1:
                    act_counter += 1
                    name = f"act-{act_counter}"
                    sid = next_id()
                    batch.append(F.activity_task_scheduled(
                        sid, v, t, activity_id=name,
                        decision_task_completed_event_id=completed_id,
                        schedule_to_start_timeout_seconds=rng.choice([0, 10]),
                        schedule_to_close_timeout_seconds=rng.choice([0, 60]),
                        start_to_close_timeout_seconds=rng.choice([0, 30]),
                        heartbeat_timeout_seconds=rng.choice([0, 0, 5]),
                    ))
                    acts_scheduled[sid] = name
                    act_names_live.add(name)
                elif cmd < 0.5 and len(timers) < caps.max_timers - 1:
                    timer_counter += 1
                    name = f"timer-{timer_counter}"
                    sid = next_id()
                    batch.append(F.timer_started(
                        sid, v, t, timer_id=name,
                        start_to_fire_timeout_seconds=rng.randint(1, 120),
                        decision_task_completed_event_id=completed_id))
                    timers[name] = sid
                elif cmd < 0.6 and len(children_init) < caps.max_children - 1:
                    child_counter += 1
                    sid = next_id()
                    batch.append(F.start_child_initiated(
                        sid, v, t, domain="dom",
                        workflow_id=f"child-{child_counter}",
                        parent_close_policy=rng.choice(list(ParentClosePolicy)),
                        decision_task_completed_event_id=completed_id))
                    children_init[sid] = None
                elif cmd < 0.68 and len(cancels) < caps.max_request_cancels - 1:
                    sid = next_id()
                    batch.append(F.request_cancel_external_initiated(
                        sid, v, t, domain="dom", workflow_id=f"ext-{sid}",
                        decision_task_completed_event_id=completed_id))
                    cancels.add(sid)
                elif cmd < 0.76 and len(signals) < caps.max_signals_ext - 1:
                    sid = next_id()
                    batch.append(F.signal_external_initiated(
                        sid, v, t, domain="dom", workflow_id=f"ext-{sid}",
                        decision_task_completed_event_id=completed_id))
                    signals.add(sid)
                elif cmd < 0.84:
                    batch.append(F.marker_recorded(
                        next_id(), v, t,
                        decision_task_completed_event_id=completed_id))
                elif cmd < 0.9 and act_names_live:
                    name = rng.choice(sorted(act_names_live))
                    batch.append(F.activity_task_cancel_requested(
                        next_id(), v, t, activity_id=name,
                        decision_task_completed_event_id=completed_id))
                elif cmd < 0.96 and timers:
                    name = rng.choice(sorted(timers))
                    started = timers.pop(name)
                    batch.append(F.timer_canceled(
                        next_id(), v, t, timer_id=name, started_event_id=started,
                        decision_task_completed_event_id=completed_id))
                else:
                    batch.append(F.upsert_workflow_search_attributes(
                        next_id(), v, t,
                        search_attributes={f"k{rng.randint(0,3)}": b"v"},
                        decision_task_completed_event_id=completed_id))

            # maybe close in this same batch
            if close and (eid >= target_events or rng.random() < close_prob):
                closer = rng.random()
                if closer < 0.5:
                    batch.append(F.workflow_execution_completed(
                        next_id(), v, t,
                        decision_task_completed_event_id=completed_id))
                elif closer < 0.75:
                    batch.append(F.workflow_execution_failed(
                        next_id(), v, t,
                        decision_task_completed_event_id=completed_id,
                        reason="fuzz"))
                else:
                    batch.append(F.workflow_execution_canceled(
                        next_id(), v, t,
                        decision_task_completed_event_id=completed_id))
                closed = True
            emit(batch)

        if not closed and close:
            # hard close from the environment: terminate or time out
            # (both legal at any point; timeout is how the timer queue
            # closes an expired run, so replayers must accept it too)
            bump_time()
            if rng.random() < 0.25:
                emit([F.workflow_execution_timed_out(next_id(), v, t)])
            else:
                emit([F.workflow_execution_terminated(
                    next_id(), v, t, reason="fuzz-end")])
        return batches

    # ------------------------------------------------------------------

    def _async_event(self, b: "_Bundle") -> None:
        """One environment-driven transaction batch (activity progress,
        timer fire, child/external resolution, signal, cancel request)."""
        rng = b.rng
        options = []
        unstarted = [sid for sid in b.acts_scheduled if sid not in b.acts_started]
        started = list(b.acts_started)
        if unstarted:
            options.append("act_start")
            options.append("act_s2s_timeout")
        if started:
            options.extend(["act_complete", "act_fail", "act_timeout"])
        if b.timers:
            options.append("timer_fire")
        pending_children = [i for i, s in b.children_init.items() if s is None]
        started_children = [i for i, s in b.children_init.items() if s is not None]
        if pending_children:
            options.extend(["child_start", "child_start_failed"])
        if started_children:
            options.append("child_close")
        if b.cancels:
            options.append("cancel_resolve")
        if b.signals:
            options.append("signal_resolve")
        options.append("wf_signal")
        options.append("wf_cancel_request")
        choice = rng.choice(options)

        if choice == "act_start":
            sid = rng.choice(unstarted)
            ev_id = b.next_id()
            b.emit([F.activity_task_started(ev_id, b.v, b.t, scheduled_event_id=sid)])
            b.acts_started[sid] = ev_id
        elif choice == "act_s2s_timeout":
            sid = rng.choice(unstarted)
            b.emit([F.activity_task_timed_out(
                b.next_id(), b.v, b.t, scheduled_event_id=sid,
                started_event_id=EMPTY_EVENT_ID,
                timeout_type=TimeoutType.ScheduleToStart)])
            b.act_names_live.discard(b.acts_scheduled.pop(sid))
        elif choice in ("act_complete", "act_fail", "act_timeout"):
            sid = rng.choice(started)
            st = b.acts_started.pop(sid)
            name = b.acts_scheduled.pop(sid)
            b.act_names_live.discard(name)
            if choice == "act_complete":
                ev = F.activity_task_completed(
                    b.next_id(), b.v, b.t, scheduled_event_id=sid, started_event_id=st)
            elif choice == "act_fail":
                ev = F.activity_task_failed(
                    b.next_id(), b.v, b.t, scheduled_event_id=sid, started_event_id=st,
                    reason="fuzz")
            else:
                ev = F.activity_task_timed_out(
                    b.next_id(), b.v, b.t, scheduled_event_id=sid, started_event_id=st,
                    timeout_type=rng.choice(
                        [TimeoutType.StartToClose, TimeoutType.Heartbeat]))
            b.emit([ev])
        elif choice == "timer_fire":
            name = rng.choice(sorted(b.timers))
            started = b.timers.pop(name)
            b.emit([F.timer_fired(b.next_id(), b.v, b.t, timer_id=name,
                                  started_event_id=started)])
        elif choice == "child_start":
            init = rng.choice(pending_children)
            ev_id = b.next_id()
            b.emit([F.child_execution_started(
                ev_id, b.v, b.t, initiated_event_id=init,
                workflow_id=f"child-{init}", run_id=f"crun-{init}")])
            b.children_init[init] = ev_id
        elif choice == "child_start_failed":
            init = rng.choice(pending_children)
            del b.children_init[init]
            b.emit([F.start_child_failed(
                b.next_id(), b.v, b.t, initiated_event_id=init, cause=0)])
        elif choice == "child_close":
            init = rng.choice(started_children)
            st = b.children_init.pop(init)
            kind = rng.random()
            if kind < 0.4:
                ev = F.child_execution_completed(
                    b.next_id(), b.v, b.t, initiated_event_id=init, started_event_id=st)
            elif kind < 0.6:
                ev = F.child_execution_failed(
                    b.next_id(), b.v, b.t, initiated_event_id=init, started_event_id=st)
            elif kind < 0.75:
                ev = F.child_execution_canceled(
                    b.next_id(), b.v, b.t, initiated_event_id=init, started_event_id=st)
            elif kind < 0.9:
                ev = F.child_execution_timed_out(
                    b.next_id(), b.v, b.t, initiated_event_id=init, started_event_id=st)
            else:
                ev = F.child_execution_terminated(
                    b.next_id(), b.v, b.t, initiated_event_id=init, started_event_id=st)
            b.emit([ev])
        elif choice == "cancel_resolve":
            init = rng.choice(sorted(b.cancels))
            b.cancels.discard(init)
            if rng.random() < 0.7:
                ev = F.external_workflow_execution_cancel_requested(
                    b.next_id(), b.v, b.t, initiated_event_id=init)
            else:
                ev = F.request_cancel_external_failed(
                    b.next_id(), b.v, b.t, initiated_event_id=init)
            b.emit([ev])
        elif choice == "signal_resolve":
            init = rng.choice(sorted(b.signals))
            b.signals.discard(init)
            if rng.random() < 0.7:
                ev = F.external_workflow_execution_signaled(
                    b.next_id(), b.v, b.t, initiated_event_id=init)
            else:
                ev = F.signal_external_failed(
                    b.next_id(), b.v, b.t, initiated_event_id=init)
            b.emit([ev])
        elif choice == "wf_cancel_request":
            # workflow-level cancel request: legal at any point while
            # running, idempotent on repeat (both replayers set a flag)
            b.emit([F.workflow_execution_cancel_requested(
                b.next_id(), b.v, b.t)])
        else:
            b.emit([F.workflow_execution_signaled(
                b.next_id(), b.v, b.t, signal_name=f"sig-{rng.randint(0, 9)}")])


class _Bundle:
    """Mutable references shared with _async_event."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
