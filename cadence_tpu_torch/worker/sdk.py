"""Deterministic replay-based worker SDK.

The reference's worker daemons run as Cadence workflows via the Go
client SDK (uber-go/cadence); this is the equivalent for this framework:
workflow code is a Python GENERATOR that yields commands; on every
decision task the runner replays the full history through the generator
— commands whose outcome is already recorded feed results back in,
the first unresolved command batch becomes this decision's output.
Determinism contract: workflow code must derive everything from
``ctx``/inputs (no wall clock, no I/O) — identical to the reference
SDK's replay rules.

Workflow code shape::

    def greet(ctx, input):
        name = yield ctx.schedule_activity("fetch-name", input)
        yield ctx.start_timer(5)
        sig = yield ctx.wait_signal("go")
        return b"hello " + name

Activities are plain functions registered on the ActivityWorker.

A copy of the reference package's ``worker/sdk.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import traceback
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple

from ..core.enums import DecisionType, EventType
from ..core.events import HistoryEvent
from ..runtime.api import Decision


def _require_bytes_result(value):
    """Workflow return values must be bytes (or None). Completing with
    b"" for a str/dict return would silently LOSE the result — the same
    loud-failure rule the activity worker applies."""
    if value is None:
        return b""
    if isinstance(value, bytes):
        return value
    raise TypeError(
        f"workflow must return bytes (or None), got {type(value).__name__}"
    )


class ActivityError(Exception):
    """Raised into workflow code when an activity failed/timed out."""

    def __init__(self, reason: str, details: bytes = b"") -> None:
        super().__init__(reason)
        self.reason = reason
        self.details = details


class WorkflowCancelled(Exception):
    """Raise from workflow code to close the run as Canceled.

    The reference SDK's equivalent is returning ctx.Err() after
    ctx.Done() fires (reference canary/cancellation.go); here the
    workflow observes the cancel request via ``ctx.wait_cancel()`` /
    ``ctx.cancel_requested()`` and raises this to emit a
    CancelWorkflowExecution decision.
    """

    def __init__(self, details: bytes = b"") -> None:
        super().__init__(details)
        self.details = details


class _NonDeterminismError(Exception):
    pass


# -- commands yielded by workflow code ------------------------------------


@dataclasses.dataclass
class _ActivityCmd:
    activity_type: str
    input: bytes
    task_list: str
    start_to_close: int
    schedule_to_start: int
    heartbeat: int
    retry_policy: Optional[dict]
    activity_id: str = ""  # assigned by the runner


@dataclasses.dataclass
class _TimerCmd:
    seconds: int
    timer_id: str = ""


@dataclasses.dataclass
class _SignalWaitCmd:
    name: str


@dataclasses.dataclass
class _SignalPollCmd:
    """Non-blocking: next unconsumed signal or None."""

    name: str


@dataclasses.dataclass
class _ChildCmd:
    workflow_type: str
    workflow_id: str
    input: bytes
    task_list: str
    execution_timeout: int
    task_timeout: int
    parent_close_policy: int


@dataclasses.dataclass
class _ContinueAsNewCmd:
    input: bytes
    workflow_type: str = ""
    task_list: str = ""
    execution_timeout: int = 0
    task_timeout: int = 0


@dataclasses.dataclass
class _SignalExternalCmd:
    domain: str
    workflow_id: str
    run_id: str
    signal_name: str
    input: bytes


@dataclasses.dataclass
class _CancelWaitCmd:
    pass


@dataclasses.dataclass
class _CancelExternalCmd:
    domain: str
    workflow_id: str
    run_id: str


@dataclasses.dataclass
class _UpsertSearchAttrsCmd:
    attrs: dict


@dataclasses.dataclass
class _LocalActivityCmd:
    activity_type: str
    input: bytes


@dataclasses.dataclass
class _SideEffectCmd:
    fn: Callable[[], bytes]


@dataclasses.dataclass
class _GetVersionCmd:
    change_id: str
    min_supported: int
    max_supported: int


DEFAULT_VERSION = -1  # reference client.DefaultVersion: pre-change code


class WorkflowContext:
    """Command factory handed to workflow code."""

    def schedule_activity(
        self, activity_type: str, input: bytes = b"",
        task_list: str = "", start_to_close_timeout_seconds: int = 60,
        schedule_to_start_timeout_seconds: int = 60,
        heartbeat_timeout_seconds: int = 0,
        retry_policy: Optional[dict] = None,
    ) -> _ActivityCmd:
        return _ActivityCmd(
            activity_type, input, task_list,
            start_to_close_timeout_seconds,
            schedule_to_start_timeout_seconds,
            heartbeat_timeout_seconds, retry_policy,
        )

    def start_timer(self, seconds: int) -> _TimerCmd:
        return _TimerCmd(seconds)

    def wait_signal(self, name: str) -> _SignalWaitCmd:
        return _SignalWaitCmd(name)

    def poll_signal(self, name: str) -> _SignalPollCmd:
        """Non-blocking signal read: yields the next unconsumed payload
        or None when the recorded history has no more — used to drain
        pending signals before continue-as-new (reference pump.go)."""
        return _SignalPollCmd(name)

    def start_child_workflow(
        self, workflow_type: str, workflow_id: str, input: bytes = b"",
        task_list: str = "", execution_timeout: int = 60,
        task_timeout: int = 10, parent_close_policy: int = 2,
    ) -> _ChildCmd:
        return _ChildCmd(
            workflow_type, workflow_id, input, task_list,
            execution_timeout, task_timeout, parent_close_policy,
        )

    def continue_as_new(self, input: bytes = b"", **kw) -> _ContinueAsNewCmd:
        return _ContinueAsNewCmd(input, **kw)

    def signal_external(
        self, domain: str, workflow_id: str, signal_name: str,
        input: bytes = b"", run_id: str = "",
    ) -> _SignalExternalCmd:
        return _SignalExternalCmd(
            domain, workflow_id, run_id, signal_name, input
        )

    def wait_cancel(self) -> _CancelWaitCmd:
        """Block until this run's cancellation is requested; resumes with
        the request's cause (reference ctx.Done)."""
        return _CancelWaitCmd()

    def request_cancel_external(
        self, domain: str, workflow_id: str, run_id: str = "",
    ) -> _CancelExternalCmd:
        """Request cancellation of another workflow (fire-and-forget,
        reference RequestCancelExternalWorkflowExecution decision)."""
        return _CancelExternalCmd(domain, workflow_id, run_id)

    def upsert_search_attributes(self, attrs: dict) -> _UpsertSearchAttrsCmd:
        """Attach/overwrite advanced-visibility search attributes."""
        return _UpsertSearchAttrsCmd(attrs)

    def local_activity(
        self, activity_type: str, input: bytes = b"",
    ) -> _LocalActivityCmd:
        """Run an activity inline in the decision task; its result is
        recorded as a MarkerRecorded event, so replay never re-executes
        it (reference local activity semantics: no ActivityTaskScheduled
        round-trip through matching)."""
        return _LocalActivityCmd(activity_type, input)

    def side_effect(self, fn: Callable[[], bytes]) -> _SideEffectCmd:
        """Record a non-deterministic value (uuid, random, clock read)
        once; replay returns the recorded bytes without re-running fn
        (reference workflow.SideEffect marker semantics)."""
        return _SideEffectCmd(fn)

    def get_version(
        self, change_id: str, min_supported: int, max_supported: int,
    ) -> _GetVersionCmd:
        """Safe workflow-code versioning (reference workflow.GetVersion):
        the first execution through this point records max_supported in
        a version marker; replays of histories recorded before the
        change see DEFAULT_VERSION (-1); replays of recorded versions
        outside [min_supported, max_supported] fail as non-determinism."""
        return _GetVersionCmd(change_id, min_supported, max_supported)


# -- history → replay state -----------------------------------------------


class _ReplayState:
    def __init__(self, history: List[HistoryEvent]) -> None:
        self.input: bytes = b""
        self.workflow_type = ""
        self.task_list = ""
        # activity_id → ("completed", result) | ("failed", reason, details)
        self.activity_outcome: Dict[str, Tuple] = {}
        self.activities_scheduled: set = set()
        # timer_id → fired?
        self.timers_started: set = set()
        self.timers_fired: set = set()
        # child outcomes by INITIATION ORDER (a workflow may start the
        # same child workflow_id again after it closes)
        self.children_started: set = set()
        self.child_outcome_by_index: Dict[int, Tuple] = {}
        # signals by name (FIFO)
        self.signals: Dict[str, List[bytes]] = {}
        # history-ordered initiation lists: replay matches the Nth yield
        # of a command type to the Nth initiation event, so repeating the
        # same target is not deduped away
        self.signals_external_list: List[tuple] = []
        self.children_list: List[str] = []
        self.cancels_external_list: List[str] = []
        # cancel request on THIS run
        self.cancel_requested = False
        self.cancel_cause: bytes = b""
        # markers by kind, each in record order (replay consumes each
        # stream independently; names disambiguate misuse)
        self.local_markers: List[Tuple[str, bytes]] = []
        self.side_effect_markers: List[bytes] = []
        self.version_markers: Dict[str, int] = {}
        self.upsert_count = 0
        # replay frontier detection for GetVersion/SideEffect: a history
        # with completed decisions is a replay until the driver crosses
        # into new territory (emits a decision, blocks, or has consumed
        # every recorded outcome)
        self.completed_decisions = 0

        sched_to_aid: Dict[int, str] = {}
        init_to_child: Dict[int, str] = {}
        for e in history:
            a = e.attributes
            et = e.event_type
            if et == EventType.WorkflowExecutionStarted:
                self.input = a.get("input", b"") or b""
                self.workflow_type = a.get("workflow_type", "")
                self.task_list = a.get("task_list", "")
            elif et == EventType.ActivityTaskScheduled:
                aid = a.get("activity_id", "")
                self.activities_scheduled.add(aid)
                sched_to_aid[e.event_id] = aid
            elif et == EventType.ActivityTaskCompleted:
                aid = sched_to_aid.get(a.get("scheduled_event_id"))
                if aid:
                    self.activity_outcome[aid] = (
                        "completed", a.get("result", b"")
                    )
            elif et == EventType.ActivityTaskFailed:
                aid = sched_to_aid.get(a.get("scheduled_event_id"))
                if aid:
                    self.activity_outcome[aid] = (
                        "failed", a.get("reason", ""), a.get("details", b"")
                    )
            elif et == EventType.ActivityTaskTimedOut:
                aid = sched_to_aid.get(a.get("scheduled_event_id"))
                if aid:
                    self.activity_outcome[aid] = ("failed", "timeout", b"")
            elif et == EventType.ActivityTaskCanceled:
                aid = sched_to_aid.get(a.get("scheduled_event_id"))
                if aid:
                    self.activity_outcome[aid] = ("failed", "canceled", b"")
            elif et == EventType.TimerStarted:
                self.timers_started.add(a.get("timer_id", ""))
            elif et == EventType.TimerFired:
                self.timers_fired.add(a.get("timer_id", ""))
            elif et == EventType.WorkflowExecutionSignaled:
                self.signals.setdefault(
                    a.get("signal_name", ""), []
                ).append(a.get("input", b"") or b"")
            elif et == EventType.StartChildWorkflowExecutionInitiated:
                wid = a.get("workflow_id", "")
                self.children_started.add(wid)
                init_to_child[e.event_id] = len(self.children_list)
                self.children_list.append(wid)
            elif et == EventType.ChildWorkflowExecutionCompleted:
                idx = init_to_child.get(a.get("initiated_event_id"))
                if idx is not None:
                    self.child_outcome_by_index[idx] = (
                        "completed", a.get("result", b"")
                    )
            elif et in (
                EventType.ChildWorkflowExecutionFailed,
                EventType.ChildWorkflowExecutionTimedOut,
                EventType.ChildWorkflowExecutionCanceled,
                EventType.ChildWorkflowExecutionTerminated,
                EventType.StartChildWorkflowExecutionFailed,
            ):
                idx = init_to_child.get(a.get("initiated_event_id"))
                if idx is None and a.get("workflow_id", "") in (
                    self.children_list
                ):
                    idx = self.children_list.index(a["workflow_id"])
                if idx is not None:
                    self.child_outcome_by_index[idx] = (
                        "failed", a.get("reason", str(et)), b""
                    )
            elif et == EventType.SignalExternalWorkflowExecutionInitiated:
                self.signals_external_list.append(
                    (a.get("workflow_id", ""), a.get("signal_name", ""))
                )
            elif et == (
                EventType.RequestCancelExternalWorkflowExecutionInitiated
            ):
                self.cancels_external_list.append(a.get("workflow_id", ""))
            elif et == EventType.WorkflowExecutionCancelRequested:
                self.cancel_requested = True
                cause = a.get("cause", "") or ""
                self.cancel_cause = (
                    cause.encode() if isinstance(cause, str) else cause
                )
            elif et == EventType.MarkerRecorded:
                name = a.get("marker_name", "")
                details = a.get("details", b"") or b""
                if name.startswith("version:"):
                    try:
                        self.version_markers[name[len("version:"):]] = int(
                            details.decode()
                        )
                    except ValueError:
                        pass
                elif name == "side_effect":
                    self.side_effect_markers.append(details)
                else:
                    self.local_markers.append((name, details))
            elif et == EventType.UpsertWorkflowSearchAttributes:
                self.upsert_count += 1
            elif et == EventType.DecisionTaskCompleted:
                self.completed_decisions += 1

    def total_outcomes(self) -> int:
        """Recorded command outcomes available to replay. The driver is
        'replaying' until they are all consumed — past that point the
        workflow code is executing for the first time.

        Signals and cancel requests are deliberately NOT counted: they
        buffer before the workflow reads them (a delivered-but-unread
        signal is not evidence of code progress), so counting them
        would misclassify genuinely-new code at the frontier as a
        replay. The cost is weaker old-history detection for runs whose
        recorded progress is purely signal-driven — the reference SDK
        resolves this with exact event positions; this build errs
        toward 'executing', which records rather than fails."""
        return (
            len(self.activity_outcome)
            + len(self.timers_fired)
            + len(self.child_outcome_by_index)
            + len(self.local_markers)
            + len(self.side_effect_markers)
            + len(self.version_markers)
        )


# -- the replay runner ----------------------------------------------------


class _Driver:
    def __init__(
        self, fn: Callable, state: _ReplayState,
        local_executor: Optional[Callable] = None,
    ) -> None:
        self.fn = fn
        self.state = state
        self.decisions: List[Decision] = []
        self.seq = {"a": 0, "t": 0, "c": 0, "s": 0, "rc": 0, "m": 0,
                    "se": 0}
        # versions resolved THIS replay that have no history marker yet
        self._version_cache: Dict[str, int] = {}
        self.signal_cursor: Dict[str, int] = {}
        self.closed = False
        # executes local activities inline (activity_type, input) -> bytes
        self.local_executor = local_executor
        # replay frontier: the run is a replay while recorded outcomes
        # remain unconsumed; emitting a decision or blocking also
        # crosses into new execution (matches the reference SDK's
        # isReplaying transition at the last DecisionTaskStarted)
        self._crossed = state.completed_decisions == 0
        self._total_outcomes = state.total_outcomes()
        self._consumed = 0

    @property
    def replaying(self) -> bool:
        return not self._crossed and self._consumed < self._total_outcomes

    def _consume(self) -> None:
        self._consumed += 1

    def _next_id(self, kind: str) -> str:
        self.seq[kind] += 1
        return f"{kind}{self.seq[kind]}"

    def run(self) -> List[Decision]:
        ctx = WorkflowContext()
        gen = self.fn(ctx, self.state.input)
        if not isinstance(gen, Generator):
            # plain function: complete immediately with its return value
            try:
                result = _require_bytes_result(gen)
            except TypeError:
                self.decisions.append(
                    Decision(
                        DecisionType.FailWorkflowExecution,
                        {
                            "reason": "workflow code raised",
                            "details": traceback.format_exc().encode(),
                        },
                    )
                )
                return self.decisions
            self.decisions.append(
                Decision(
                    DecisionType.CompleteWorkflowExecution,
                    {"result": result},
                )
            )
            return self.decisions
        try:
            to_send: Any = None
            to_throw: Optional[BaseException] = None
            while True:
                cmd = (
                    gen.throw(to_throw) if to_throw is not None
                    else gen.send(to_send)
                )
                to_send, to_throw, blocked = self._handle(cmd)
                if blocked:
                    return self.decisions
        except StopIteration as done:
            try:
                result = _require_bytes_result(done.value)
            except TypeError:
                # a wrong-typed return is a workflow-code bug of the
                # same class as raising: fail the RUN loudly (silently
                # completing with b"" would lose the result)
                if not self.closed:
                    self.decisions.append(
                        Decision(
                            DecisionType.FailWorkflowExecution,
                            {
                                "reason": "workflow code raised",
                                "details": traceback.format_exc().encode(),
                            },
                        )
                    )
                return self.decisions
            if not self.closed:
                self.decisions.append(
                    Decision(
                        DecisionType.CompleteWorkflowExecution,
                        {"result": result},
                    )
                )
            return self.decisions
        except _NonDeterminismError:
            raise
        except WorkflowCancelled as wc:
            if not self.closed:
                self.decisions.append(
                    Decision(
                        DecisionType.CancelWorkflowExecution,
                        {"details": wc.details},
                    )
                )
            return self.decisions
        except Exception:
            if not self.closed:
                self.decisions.append(
                    Decision(
                        DecisionType.FailWorkflowExecution,
                        {
                            "reason": "workflow code raised",
                            "details": traceback.format_exc().encode(),
                        },
                    )
                )
            return self.decisions

    def _handle(self, cmd) -> Tuple[Any, Optional[BaseException], bool]:
        """Returns (value_to_send, exc_to_throw, blocked)."""
        before = len(self.decisions)
        out = self._handle_inner(cmd)
        if out[2] or len(self.decisions) > before:
            # crossed the frontier: subsequent code is NEW execution
            self._crossed = True
        return out

    def _handle_inner(self, cmd) -> Tuple[Any, Optional[BaseException], bool]:
        st = self.state
        if isinstance(cmd, _ActivityCmd):
            aid = cmd.activity_id or self._next_id("a")
            outcome = st.activity_outcome.get(aid)
            if outcome is not None:
                self._consume()
                if outcome[0] == "completed":
                    return outcome[1], None, False
                return None, ActivityError(outcome[1], outcome[2]), False
            if aid not in st.activities_scheduled:
                self.decisions.append(
                    Decision(
                        DecisionType.ScheduleActivityTask,
                        {
                            "activity_id": aid,
                            "activity_type": cmd.activity_type,
                            "task_list": cmd.task_list or st.task_list,
                            "input": cmd.input,
                            "schedule_to_start_timeout_seconds": cmd.schedule_to_start,
                            "start_to_close_timeout_seconds": cmd.start_to_close,
                            "heartbeat_timeout_seconds": cmd.heartbeat,
                            "retry_policy": cmd.retry_policy,
                        },
                    )
                )
            return None, None, True  # awaiting the outcome
        if isinstance(cmd, _TimerCmd):
            tid = cmd.timer_id or self._next_id("t")
            if tid in st.timers_fired:
                self._consume()
                return None, None, False
            if tid not in st.timers_started:
                self.decisions.append(
                    Decision(
                        DecisionType.StartTimer,
                        {
                            "timer_id": tid,
                            "start_to_fire_timeout_seconds": cmd.seconds,
                        },
                    )
                )
            return None, None, True
        if isinstance(cmd, _SignalWaitCmd):
            cursor = self.signal_cursor.get(cmd.name, 0)
            queue = st.signals.get(cmd.name, [])
            if cursor < len(queue):
                self.signal_cursor[cmd.name] = cursor + 1
                return queue[cursor], None, False
            return None, None, True  # wait for the signal
        if isinstance(cmd, _SignalPollCmd):
            cursor = self.signal_cursor.get(cmd.name, 0)
            queue = st.signals.get(cmd.name, [])
            if cursor < len(queue):
                self.signal_cursor[cmd.name] = cursor + 1
                return queue[cursor], None, False
            return None, None, False  # nothing recorded: None, no block
        if isinstance(cmd, _ChildCmd):
            wid = cmd.workflow_id
            child_idx = self.seq["c"]
            self.seq["c"] += 1
            if child_idx < len(st.children_list) and (
                st.children_list[child_idx] != wid
            ):
                # the Nth yield must match the Nth recorded initiation;
                # silently crossing outcomes between reordered children
                # corrupts downstream decisions
                raise _NonDeterminismError(
                    f"child #{child_idx} in history is "
                    f"{st.children_list[child_idx]!r}, workflow code "
                    f"started {wid!r}"
                )
            outcome = st.child_outcome_by_index.get(child_idx)
            if outcome is not None:
                self._consume()
                if outcome[0] == "completed":
                    return outcome[1], None, False
                return None, ActivityError(outcome[1]), False
            if child_idx >= len(st.children_list):
                self.decisions.append(
                    Decision(
                        DecisionType.StartChildWorkflowExecution,
                        {
                            "workflow_id": wid,
                            "workflow_type": cmd.workflow_type,
                            "task_list": cmd.task_list or st.task_list,
                            "input": cmd.input,
                            "execution_start_to_close_timeout_seconds": (
                                cmd.execution_timeout
                            ),
                            "task_start_to_close_timeout_seconds": (
                                cmd.task_timeout
                            ),
                            "parent_close_policy": cmd.parent_close_policy,
                        },
                    )
                )
            return None, None, True
        if isinstance(cmd, _SignalExternalCmd):
            sig_idx = self.seq["s"]
            self.seq["s"] += 1
            if sig_idx < len(st.signals_external_list) and (
                st.signals_external_list[sig_idx]
                != (cmd.workflow_id, cmd.signal_name)
            ):
                # same rule as children: the Nth yield must match the
                # Nth recorded initiation, else a code change silently
                # drops one signal and duplicates another
                raise _NonDeterminismError(
                    f"external signal #{sig_idx} in history targets "
                    f"{st.signals_external_list[sig_idx]!r}, workflow "
                    f"code signals "
                    f"{(cmd.workflow_id, cmd.signal_name)!r}"
                )
            if sig_idx >= len(st.signals_external_list):
                self.decisions.append(
                    Decision(
                        DecisionType.SignalExternalWorkflowExecution,
                        {
                            "domain": cmd.domain,
                            "workflow_id": cmd.workflow_id,
                            "run_id": cmd.run_id,
                            "signal_name": cmd.signal_name,
                            "input": cmd.input,
                        },
                    )
                )
            return None, None, False  # fire and forget
        if isinstance(cmd, _CancelWaitCmd):
            if st.cancel_requested:
                return st.cancel_cause, None, False
            return None, None, True  # wait for the cancel request
        if isinstance(cmd, _CancelExternalCmd):
            rc_idx = self.seq["rc"]
            self.seq["rc"] += 1
            if rc_idx < len(st.cancels_external_list) and (
                st.cancels_external_list[rc_idx] != cmd.workflow_id
            ):
                raise _NonDeterminismError(
                    f"external cancel #{rc_idx} in history targets "
                    f"{st.cancels_external_list[rc_idx]!r}, workflow "
                    f"code cancels {cmd.workflow_id!r}"
                )
            if rc_idx >= len(st.cancels_external_list):
                self.decisions.append(
                    Decision(
                        DecisionType.RequestCancelExternalWorkflowExecution,
                        {
                            "domain": cmd.domain,
                            "workflow_id": cmd.workflow_id,
                            "run_id": cmd.run_id,
                        },
                    )
                )
            return None, None, False  # fire and forget
        if isinstance(cmd, _UpsertSearchAttrsCmd):
            if self.seq.setdefault("u", 0) >= st.upsert_count:
                self.decisions.append(
                    Decision(
                        DecisionType.UpsertWorkflowSearchAttributes,
                        {"search_attributes": dict(cmd.attrs)},
                    )
                )
            self.seq["u"] += 1
            return None, None, False
        if isinstance(cmd, _LocalActivityCmd):
            m_idx = self.seq["m"]
            self.seq["m"] += 1
            if m_idx < len(st.local_markers):
                name, details = st.local_markers[m_idx]
                want = f"local_activity:{cmd.activity_type}"
                if name != want:
                    raise _NonDeterminismError(
                        f"marker {m_idx} is {name!r}, workflow code "
                        f"asked for {want!r}"
                    )
                self._consume()
                return details, None, False
            if self.local_executor is None:
                raise _NonDeterminismError(
                    "local activity yielded but no executor is wired "
                    "(replay_decide without a DecisionWorker)"
                )
            result = self.local_executor(cmd.activity_type, cmd.input)
            if not isinstance(result, bytes):
                raise TypeError(
                    f"local activity {cmd.activity_type!r} must return "
                    f"bytes, got {type(result).__name__}"
                )
            self.decisions.append(
                Decision(
                    DecisionType.RecordMarker,
                    {"marker_name": f"local_activity:{cmd.activity_type}",
                     "details": result},
                )
            )
            return result, None, False
        if isinstance(cmd, _SideEffectCmd):
            se_idx = self.seq["se"]
            self.seq["se"] += 1
            if se_idx < len(st.side_effect_markers):
                self._consume()
                return st.side_effect_markers[se_idx], None, False
            if self.replaying:
                raise _NonDeterminismError(
                    "side effect has no recorded marker during replay — "
                    "gate new side effects behind ctx.get_version"
                )
            result = cmd.fn()
            if not isinstance(result, bytes):
                raise TypeError(
                    "side_effect fn must return bytes, got "
                    f"{type(result).__name__}"
                )
            self.decisions.append(
                Decision(
                    DecisionType.RecordMarker,
                    {"marker_name": "side_effect", "details": result},
                )
            )
            return result, None, False
        if isinstance(cmd, _GetVersionCmd):
            recorded = st.version_markers.get(cmd.change_id)
            if recorded is not None and cmd.change_id not in (
                self._version_cache
            ):
                # each recorded change counts once toward the frontier
                self._version_cache[cmd.change_id] = recorded
                self._consume()
            if recorded is None and cmd.change_id in self._version_cache:
                recorded = self._version_cache[cmd.change_id]
            if recorded is not None:
                if not cmd.min_supported <= recorded <= cmd.max_supported:
                    raise _NonDeterminismError(
                        f"history recorded version {recorded} for change "
                        f"{cmd.change_id!r}, workflow code supports "
                        f"[{cmd.min_supported}, {cmd.max_supported}]"
                    )
                return recorded, None, False
            if self.replaying:
                # history predates this GetVersion point: old behavior
                if cmd.min_supported > DEFAULT_VERSION:
                    raise _NonDeterminismError(
                        f"history predates change {cmd.change_id!r} but "
                        f"min_supported={cmd.min_supported} drops the "
                        "pre-change path"
                    )
                self._version_cache[cmd.change_id] = DEFAULT_VERSION
                return DEFAULT_VERSION, None, False
            self._version_cache[cmd.change_id] = cmd.max_supported
            self.decisions.append(
                Decision(
                    DecisionType.RecordMarker,
                    {"marker_name": f"version:{cmd.change_id}",
                     "details": str(cmd.max_supported).encode()},
                )
            )
            return cmd.max_supported, None, False
        if isinstance(cmd, _ContinueAsNewCmd):
            self.decisions.append(
                Decision(
                    DecisionType.ContinueAsNewWorkflowExecution,
                    {
                        "workflow_type": cmd.workflow_type or st.workflow_type,
                        "task_list": cmd.task_list or st.task_list,
                        "input": cmd.input,
                        "execution_start_to_close_timeout_seconds": (
                            cmd.execution_timeout or 60
                        ),
                        "task_start_to_close_timeout_seconds": (
                            cmd.task_timeout or 10
                        ),
                    },
                )
            )
            self.closed = True
            raise StopIteration(b"")
        raise _NonDeterminismError(f"unknown command {cmd!r}")


# -- registries + workers -------------------------------------------------


class WorkflowRegistry:
    def __init__(self) -> None:
        self._workflows: Dict[str, Callable] = {}
        self._query_handlers: Dict[str, Callable] = {}
        self._local_activities: Dict[str, Callable] = {}

    def register_local_activity(
        self, activity_type: str, fn: Callable
    ) -> None:
        """Local activities run inline in the decision task (not via
        matching), so they register with the workflow side."""
        self._local_activities[activity_type] = fn

    def local_activity(self, activity_type: str) -> Callable:
        fn = self._local_activities.get(activity_type)
        if fn is None:
            raise KeyError(
                f"local activity {activity_type!r} not registered"
            )
        return fn

    def register_workflow(self, workflow_type: str, fn: Callable) -> None:
        self._workflows[workflow_type] = fn

    def register_query_handler(
        self, workflow_type: str, fn: Callable[[str, bytes], bytes]
    ) -> None:
        self._query_handlers[workflow_type] = fn

    def workflow(self, workflow_type: str) -> Callable:
        fn = self._workflows.get(workflow_type)
        if fn is None:
            raise KeyError(f"workflow type {workflow_type!r} not registered")
        return fn

    def query_handler(self, workflow_type: str):
        return self._query_handlers.get(workflow_type)


def replay_decide(
    registry: WorkflowRegistry, history: List[HistoryEvent],
    state: Optional[_ReplayState] = None,
) -> List[Decision]:
    """Pure function: full history → this decision's output."""
    if state is None:
        state = _ReplayState(history)
    fn = registry.workflow(state.workflow_type)

    def local_executor(activity_type: str, input: bytes) -> bytes:
        return registry.local_activity(activity_type)(input)

    return _Driver(fn, state, local_executor=local_executor).run()


class DecisionWorker:
    """Decision poller with sticky execution.

    Reference worker semantics: after the first decision the worker
    advertises a host-specific sticky task list; the engine then
    dispatches follow-up decisions there with a PARTIAL history (the
    delta since the worker's previous decision), and the worker merges
    it onto its cached prefix. A schedule-to-start timeout on the
    sticky list falls back to the normal list with full history
    (timer queue clears stickiness), so a dead worker never wedges the
    workflow.
    """

    STICKY_TIMEOUT_S = 5
    CACHE_RUNS = 200

    def __init__(
        self, frontend, domain: str, task_list: str,
        registry: WorkflowRegistry, identity: str = "decision-worker",
        sticky: bool = True,
    ) -> None:
        self.frontend = frontend
        self.domain = domain
        self.task_list = task_list
        self.registry = registry
        self.identity = identity
        self.sticky = sticky
        self.sticky_task_list = (
            f"{identity}:{uuid.uuid4().hex[:8]}:sticky" if sticky else ""
        )
        # (workflow_id, run_id) → contiguous event prefix seen so far
        self._history_cache: "OrderedDict[tuple, List[HistoryEvent]]" = (
            OrderedDict()
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_and_process_one(self, timeout_s: float = 1.0) -> bool:
        task = None
        if self.sticky:
            # drain the sticky list first (short poll), then the
            # normal list — the reference worker multiplexes both
            task = self.frontend.poll_for_decision_task(
                self.domain, self.sticky_task_list,
                identity=self.identity,
                timeout_s=min(0.05, timeout_s),
            )
        if task is None:
            task = self.frontend.poll_for_decision_task(
                self.domain, self.task_list,
                identity=self.identity, timeout_s=timeout_s,
            )
        if task is None:
            return False
        if task.query is not None:
            self._answer_direct_query(task)
            return True
        history = self._full_history(task)
        state = _ReplayState(history)
        try:
            decisions = replay_decide(self.registry, history, state)
        except Exception:
            self._history_cache.pop(
                (task.workflow_id, task.run_id), None
            )
            self.frontend.respond_decision_task_failed(
                task.task_token, identity=self.identity,
                details=traceback.format_exc().encode(),
            )
            return True
        query_results = {}
        for qid, q in (task.queries or {}).items():
            query_results[qid] = self._run_query_handler(
                state, q.get("query_type", ""), q.get("query_args", b"")
            )
        self.frontend.respond_decision_task_completed(
            task.task_token, decisions, identity=self.identity,
            query_results=query_results or None,
            sticky_task_list=self.sticky_task_list,
            sticky_schedule_to_start_timeout_seconds=(
                self.STICKY_TIMEOUT_S if self.sticky else 0
            ),
        )
        return True

    def _full_history(self, task) -> List[HistoryEvent]:
        """Merge a (possibly partial) poll history onto the cached
        prefix; a cache miss or gap re-reads the full history."""
        key = (task.workflow_id, task.run_id)
        events = list(task.history)
        first = events[0].event_id if events else 1
        if first > 1:
            cached = self._history_cache.get(key, [])
            prefix = [e for e in cached if e.event_id < first]
            if not prefix or prefix[-1].event_id != first - 1:
                # the sticky cache is cold (worker restart / eviction):
                # fetch the real prefix instead of failing the decision
                full, _ = self.frontend.get_workflow_execution_history(
                    self.domain, task.workflow_id, task.run_id
                )
                prefix = [e for e in full if e.event_id < first]
            events = prefix + events
        if self.sticky:
            self._history_cache[key] = events
            self._history_cache.move_to_end(key)
            while len(self._history_cache) > self.CACHE_RUNS:
                self._history_cache.popitem(last=False)
        return events

    def _run_query_handler(self, state, query_type: str, args: bytes):
        handler = self.registry.query_handler(state.workflow_type)
        if handler is None:
            return {"error": f"no query handler for {state.workflow_type}"}
        try:
            return {"result": handler(query_type, args)}
        except Exception as e:
            return {"error": str(e)}

    def _answer_direct_query(self, task) -> None:
        q = task.query
        # direct queries carry no history; look the workflow up
        try:
            events, _ = self.frontend.get_workflow_execution_history(
                self.domain, task.workflow_id, task.run_id
            )
            state = _ReplayState(events)
            out = self._run_query_handler(
                state, q.get("query_type", ""), q.get("query_args", b"")
            )
        except Exception as e:
            out = {"error": str(e)}
        self.frontend.respond_query_task_completed(
            self.task_list, q["query_id"],
            result=out.get("result", b"") or b"",
            error=out.get("error", "") or "",
        )

    def run_until_stopped(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_and_process_one(timeout_s=0.2)
            except Exception:
                self._stop.wait(0.1)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run_until_stopped,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def activity_method(fn: Callable) -> Callable:
    """Marker decorator for activity implementations."""
    fn.__is_activity__ = True
    return fn


# thread-local activity execution context: lets long-running activity
# code heartbeat without threading a token through every signature
# (reference: go client activity.RecordHeartbeat via context.Context)
_activity_ctx = threading.local()


def activity_heartbeat(details: bytes = b"") -> None:
    """Record a heartbeat for the activity running on this thread.
    No-op outside an activity (e.g. unit tests calling the fn
    directly)."""
    ctx = getattr(_activity_ctx, "ctx", None)
    if ctx is None:
        return
    frontend, token, identity = ctx
    frontend.record_activity_task_heartbeat(
        token, details=details, identity=identity
    )


class ActivityWorker:
    def __init__(
        self, frontend, domain: str, task_list: str,
        identity: str = "activity-worker",
    ) -> None:
        self.frontend = frontend
        self.domain = domain
        self.task_list = task_list
        self.identity = identity
        self._activities: Dict[str, Callable] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register_activity(self, activity_type: str, fn: Callable) -> None:
        self._activities[activity_type] = fn

    def register_activities_from(self, obj: Any) -> None:
        for name in dir(obj):
            fn = getattr(obj, name)
            if callable(fn) and getattr(fn, "__is_activity__", False):
                self._activities[name] = fn

    def poll_and_process_one(self, timeout_s: float = 1.0) -> bool:
        task = self.frontend.poll_for_activity_task(
            self.domain, self.task_list,
            identity=self.identity, timeout_s=timeout_s,
        )
        if task is None:
            return False
        fn = self._activities.get(task.activity_type)
        if fn is None:
            self.frontend.respond_activity_task_failed(
                task.task_token,
                reason=f"activity {task.activity_type!r} not registered",
                identity=self.identity,
            )
            return True
        try:
            _activity_ctx.ctx = (self.frontend, task.task_token,
                                 self.identity)
            try:
                result = fn(task.input)
            finally:
                _activity_ctx.ctx = None
            if result is None:
                result = b""
            if not isinstance(result, bytes):
                # fail LOUDLY: silently recording b"" loses the result
                # and surfaces far downstream in workflow code
                raise TypeError(
                    f"activity {task.activity_type!r} must return "
                    f"bytes (or None), got {type(result).__name__}"
                )
        except Exception as e:
            self.frontend.respond_activity_task_failed(
                task.task_token, reason=str(e) or type(e).__name__,
                details=traceback.format_exc().encode(),
                identity=self.identity,
            )
            return True
        self.frontend.respond_activity_task_completed(
            task.task_token, result=result, identity=self.identity,
        )
        return True

    def run_until_stopped(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_and_process_one(timeout_s=0.2)
            except Exception:
                self._stop.wait(0.1)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run_until_stopped,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class Worker:
    """Decision + activity workers on one (domain, task list)."""

    def __init__(
        self, frontend, domain: str, task_list: str,
        identity: str = "worker", sticky: bool = True,
    ) -> None:
        self.registry = WorkflowRegistry()
        self.decisions = DecisionWorker(
            frontend, domain, task_list, self.registry,
            identity=f"{identity}-decider", sticky=sticky,
        )
        self.activities = ActivityWorker(
            frontend, domain, task_list, identity=f"{identity}-activities"
        )

    def register_workflow(self, workflow_type: str, fn: Callable) -> None:
        self.registry.register_workflow(workflow_type, fn)

    def register_activity(self, activity_type: str, fn: Callable) -> None:
        self.activities.register_activity(activity_type, fn)

    def register_query_handler(self, workflow_type: str, fn) -> None:
        self.registry.register_query_handler(workflow_type, fn)

    def register_local_activity(self, activity_type: str, fn) -> None:
        self.registry.register_local_activity(activity_type, fn)

    def start(self) -> None:
        self.decisions.start()
        self.activities.start()

    def stop(self) -> None:
        self.decisions.stop()
        self.activities.stop()
