"""MutableState: the workflow finite-state machine.

This is the host-side (and semantic source-of-truth) twin of the reference's
``mutableStateBuilder`` (Cadence service/history/mutableStateBuilder.go:68-133
struct; Replicate* transitions :1639-3650) plus its decision-task sub-FSM
(Cadence service/history/mutableStateDecisionTaskManager.go).

Design: all *state* lives in plain dataclasses (ExecutionInfo + pending-info
maps) so that
  * the host runtime mutates it directly (active path),
  * ``ops.pack``/``ops.unpack`` convert it to/from the dense tensor
    layout the CUDA kernel replays (passive/rebuild path), and
  * differential tests compare host-oracle replay vs device-kernel replay
    field by field.

The ``replicate_*`` methods are pure state transitions driven by a
``HistoryEvent`` — no I/O, no persistence — exactly the contract the replay
kernel vectorizes. A copy of the reference package's module; the rebuild
path compares the two packages' states field by field. ``snapshot``
converts the records with ``_asdict``, a field walk with the names cached
per class, which gives what ``dataclasses.asdict`` gives on these records
in a third of its time (it runs on every persisted write).
"""

from __future__ import annotations

import copy
import dataclasses
import enum
from typing import Any, Dict, List, Optional, Set, Tuple

from .enums import (
    CloseStatus,
    EventType,
    ParentClosePolicy,
    TimeoutType,
    WorkflowState,
    TIMER_TASK_STATUS_NONE,
)
from .events import HistoryEvent, RetryPolicy
from .ids import EMPTY_EVENT_ID, EMPTY_UUID, EMPTY_VERSION, FIRST_EVENT_ID

SECOND = 1_000_000_000  # ns


class InvalidHistoryError(Exception):
    """Raised when an event cannot legally apply to the current state."""


class StateTransitionError(Exception):
    """Raised on an illegal workflow state/close-status transition."""


@dataclasses.dataclass
class ExecutionInfo:
    """The workflow execution "state vector".

    Field-for-field model of the reference's WorkflowExecutionInfo
    (Cadence common/persistence/dataInterfaces.go:259-316).
    """

    domain_id: str = ""
    workflow_id: str = ""
    run_id: str = ""
    parent_domain_id: str = ""
    parent_workflow_id: str = ""
    parent_run_id: str = ""
    initiated_id: int = EMPTY_EVENT_ID
    completion_event_batch_id: int = EMPTY_EVENT_ID
    task_list: str = ""
    workflow_type_name: str = ""
    workflow_timeout: int = 0  # seconds
    decision_timeout_value: int = 0  # seconds
    execution_context: bytes = b""
    state: WorkflowState = WorkflowState.Created
    close_status: CloseStatus = CloseStatus.NONE
    last_first_event_id: int = EMPTY_EVENT_ID
    last_event_task_id: int = EMPTY_EVENT_ID
    next_event_id: int = FIRST_EVENT_ID
    last_processed_event: int = EMPTY_EVENT_ID
    start_timestamp: int = 0  # ns
    last_updated_timestamp: int = 0  # ns
    create_request_id: str = ""
    signal_count: int = 0
    # decision sub-FSM
    decision_version: int = EMPTY_VERSION
    decision_schedule_id: int = EMPTY_EVENT_ID
    decision_started_id: int = EMPTY_EVENT_ID
    decision_request_id: str = EMPTY_UUID
    decision_timeout: int = 0  # seconds
    decision_attempt: int = 0
    decision_started_timestamp: int = 0  # ns
    decision_scheduled_timestamp: int = 0  # ns
    decision_original_scheduled_timestamp: int = 0  # ns
    cancel_requested: bool = False
    cancel_request_id: str = ""
    sticky_task_list: str = ""
    sticky_schedule_to_start_timeout: int = 0
    client_library_version: str = ""
    client_feature_version: str = ""
    client_impl: str = ""
    auto_reset_points: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    memo: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    search_attributes: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    # workflow retry
    attempt: int = 0
    has_retry_policy: bool = False
    initial_interval: int = 0
    backoff_coefficient: float = 0.0
    maximum_interval: int = 0
    expiration_time: int = 0  # ns
    maximum_attempts: int = 0
    non_retriable_errors: List[str] = dataclasses.field(default_factory=list)
    branch_token: bytes = b""
    # cron
    cron_schedule: str = ""
    expiration_seconds: int = 0
    # first-decision backoff (cron/retry continued runs): absolute ns
    # deadline; task refresh re-arms the WorkflowBackoffTimer from it
    first_decision_backoff_deadline: int = 0
    # stats
    history_size: int = 0


@dataclasses.dataclass
class ActivityInfo:
    """Pending-activity entry (reference: dataInterfaces.go:625-662)."""

    version: int = EMPTY_VERSION
    schedule_id: int = EMPTY_EVENT_ID
    scheduled_event_batch_id: int = EMPTY_EVENT_ID
    scheduled_time: int = 0  # ns
    started_id: int = EMPTY_EVENT_ID
    started_time: int = 0  # ns
    activity_id: str = ""
    request_id: str = ""
    details: bytes = b""
    schedule_to_start_timeout: int = 0
    schedule_to_close_timeout: int = 0
    start_to_close_timeout: int = 0
    heartbeat_timeout: int = 0
    cancel_requested: bool = False
    cancel_request_id: int = EMPTY_EVENT_ID
    last_heartbeat_updated_time: int = 0  # ns
    timer_task_status: int = TIMER_TASK_STATUS_NONE
    attempt: int = 0
    domain_id: str = ""
    started_identity: str = ""
    task_list: str = ""
    has_retry_policy: bool = False
    initial_interval: int = 0
    backoff_coefficient: float = 0.0
    maximum_interval: int = 0
    expiration_time: int = 0  # ns
    maximum_attempts: int = 0
    non_retriable_errors: List[str] = dataclasses.field(default_factory=list)
    last_failure_reason: str = ""
    last_worker_identity: str = ""
    last_failure_details: bytes = b""


@dataclasses.dataclass
class TimerInfo:
    """Pending user-timer entry (reference: dataInterfaces.go:665-671)."""

    version: int = EMPTY_VERSION
    timer_id: str = ""
    started_id: int = EMPTY_EVENT_ID
    expiry_time: int = 0  # ns
    task_status: int = TIMER_TASK_STATUS_NONE


@dataclasses.dataclass
class ChildExecutionInfo:
    """Pending child-workflow entry (reference: dataInterfaces.go:674-691)."""

    version: int = EMPTY_VERSION
    initiated_id: int = EMPTY_EVENT_ID
    initiated_event_batch_id: int = EMPTY_EVENT_ID
    started_id: int = EMPTY_EVENT_ID
    started_workflow_id: str = ""
    started_run_id: str = ""
    create_request_id: str = ""
    domain_name: str = ""
    workflow_type_name: str = ""
    parent_close_policy: ParentClosePolicy = ParentClosePolicy.Abandon


@dataclasses.dataclass
class RequestCancelInfo:
    """Pending external-cancel entry (reference: dataInterfaces.go RequestCancelInfo)."""

    version: int = EMPTY_VERSION
    initiated_id: int = EMPTY_EVENT_ID
    initiated_event_batch_id: int = EMPTY_EVENT_ID
    cancel_request_id: str = ""
    # target coordinates (from the initiated event) — task refresh must
    # be able to regenerate a full CancelExecution transfer task
    target_domain_id: str = ""
    target_workflow_id: str = ""
    target_run_id: str = ""
    target_child_workflow_only: bool = False


@dataclasses.dataclass
class SignalInfo:
    """Pending external-signal entry (reference: dataInterfaces.go SignalInfo)."""

    version: int = EMPTY_VERSION
    initiated_id: int = EMPTY_EVENT_ID
    initiated_event_batch_id: int = EMPTY_EVENT_ID
    signal_request_id: str = ""
    signal_name: str = ""
    input: bytes = b""
    control: bytes = b""
    # target coordinates (from the initiated event) — see RequestCancelInfo
    target_domain_id: str = ""
    target_workflow_id: str = ""
    target_run_id: str = ""
    target_child_workflow_only: bool = False


@dataclasses.dataclass
class DecisionInfo:
    """In-flight decision descriptor (reference: service/history/mutableState.go decisionInfo)."""

    version: int = EMPTY_VERSION
    schedule_id: int = EMPTY_EVENT_ID
    started_id: int = EMPTY_EVENT_ID
    request_id: str = EMPTY_UUID
    decision_timeout: int = 0  # seconds
    task_list: str = ""
    attempt: int = 0
    scheduled_timestamp: int = 0  # ns
    started_timestamp: int = 0  # ns
    original_scheduled_timestamp: int = 0  # ns


# Legal (state, close_status) pairs — mirrors the reference validator
# (common/persistence/workflowStateCloseStatusValidator.go): only the
# Completed state may carry a non-NONE close status, and it must carry one.
def _validate_state_close(state: WorkflowState, close: CloseStatus) -> None:
    if state == WorkflowState.Completed:
        if close == CloseStatus.NONE:
            raise StateTransitionError("completed state requires a close status")
    elif close != CloseStatus.NONE:
        raise StateTransitionError(
            f"state {state.name} cannot carry close status {close.name}"
        )



_ATOMIC = (int, float, str, bytes, bool, type(None))
_FIELD_NAMES: Dict[type, Tuple[str, ...]] = {}


def _plain(v):
    """``v`` as ``dataclasses.asdict`` renders a field value: atoms and
    enum members as they are, records as dicts, lists, tuples and dicts
    rebuilt, anything else deep-copied."""
    t = type(v)
    if t in _ATOMIC or isinstance(v, enum.Enum):
        return v
    if t is list:
        return [_plain(x) for x in v]
    if t is dict:
        return {_plain(k): _plain(x) for k, x in v.items()}
    if t is tuple:
        return tuple(_plain(x) for x in v)
    if t in _FIELD_NAMES or (dataclasses.is_dataclass(v)
                             and not isinstance(v, type)):
        return _asdict(v)
    return copy.deepcopy(v)


def _asdict(obj) -> Dict[str, Any]:
    """``dataclasses.asdict(obj)``, with the field names cached per
    class."""
    names = _FIELD_NAMES.get(type(obj))
    if names is None:
        names = _FIELD_NAMES[type(obj)] = tuple(
            f.name for f in dataclasses.fields(obj))
    return {n: _plain(getattr(obj, n)) for n in names}


class MutableState:
    """The full workflow mutable state + its replicate transitions."""

    def __init__(
        self,
        domain_id: str = "",
        current_version: int = EMPTY_VERSION,
    ) -> None:
        self.execution_info = ExecutionInfo(domain_id=domain_id)
        self.current_version = current_version

        # Pending maps, keyed exactly like the reference keeps them
        # (mutableStateBuilder.go:68-133).
        self.pending_activities: Dict[int, ActivityInfo] = {}  # schedule_id →
        self.activity_by_id: Dict[str, int] = {}  # activity_id → schedule_id
        self.pending_timers: Dict[str, TimerInfo] = {}  # timer_id →
        self.timer_by_started_id: Dict[int, str] = {}  # started_event_id → timer_id
        self.pending_children: Dict[int, ChildExecutionInfo] = {}  # initiated_id →
        self.pending_request_cancels: Dict[int, RequestCancelInfo] = {}
        self.pending_signals: Dict[int, SignalInfo] = {}
        self.signal_requested_ids: Set[str] = set()

        self.buffered_events: List[HistoryEvent] = []

        # NDC version histories (core.version_history.VersionHistories);
        # kept as Any to avoid a core→runtime dependency.
        self.version_histories: Optional[Any] = None

        # events written to the events cache by transitions (activity
        # scheduled / child initiated / completion events): the host runtime
        # drains this into its events cache.
        self.cached_events: List[HistoryEvent] = []

    # -- queries ----------------------------------------------------------

    @property
    def next_event_id(self) -> int:
        return self.execution_info.next_event_id

    def is_workflow_execution_running(self) -> bool:
        return self.execution_info.state not in (
            WorkflowState.Completed,
            WorkflowState.Zombie,
            WorkflowState.Void,
            WorkflowState.Corrupted,
        )

    def has_pending_decision(self) -> bool:
        # reference: mutableStateDecisionTaskManager.go:704-706
        return self.execution_info.decision_schedule_id != EMPTY_EVENT_ID

    def has_inflight_decision(self) -> bool:
        return self.execution_info.decision_started_id > 0

    def get_decision_info(self) -> Optional[DecisionInfo]:
        if not self.has_pending_decision():
            return None
        ei = self.execution_info
        return DecisionInfo(
            version=ei.decision_version,
            schedule_id=ei.decision_schedule_id,
            started_id=ei.decision_started_id,
            request_id=ei.decision_request_id,
            decision_timeout=ei.decision_timeout,
            task_list=ei.task_list,
            attempt=ei.decision_attempt,
            scheduled_timestamp=ei.decision_scheduled_timestamp,
            started_timestamp=ei.decision_started_timestamp,
            original_scheduled_timestamp=ei.decision_original_scheduled_timestamp,
        )

    def get_activity_info(self, schedule_id: int) -> Optional[ActivityInfo]:
        return self.pending_activities.get(schedule_id)

    def get_activity_by_activity_id(self, activity_id: str) -> Optional[ActivityInfo]:
        sid = self.activity_by_id.get(activity_id)
        return None if sid is None else self.pending_activities.get(sid)

    def get_user_timer(self, timer_id: str) -> Optional[TimerInfo]:
        return self.pending_timers.get(timer_id)

    def get_child_execution_info(self, initiated_id: int) -> Optional[ChildExecutionInfo]:
        return self.pending_children.get(initiated_id)

    def get_request_cancel_info(self, initiated_id: int) -> Optional[RequestCancelInfo]:
        return self.pending_request_cancels.get(initiated_id)

    def get_signal_info(self, initiated_id: int) -> Optional[SignalInfo]:
        return self.pending_signals.get(initiated_id)

    def has_parent_execution(self) -> bool:
        return (
            self.execution_info.parent_workflow_id != ""
            and self.execution_info.initiated_id != EMPTY_EVENT_ID
        )

    # -- generic state plumbing ------------------------------------------

    def update_current_version(self, version: int, force: bool = False) -> None:
        """Track the failover version of the event stream being applied."""
        if force or version > self.current_version or self.current_version == EMPTY_VERSION:
            self.current_version = version

    def update_workflow_state_close_status(
        self, state: WorkflowState, close_status: CloseStatus
    ) -> None:
        _validate_state_close(state, close_status)
        self.execution_info.state = state
        self.execution_info.close_status = close_status

    def clear_stickiness(self) -> None:
        self.execution_info.sticky_task_list = ""
        self.execution_info.sticky_schedule_to_start_timeout = 0

    def is_sticky_task_list_enabled(self) -> bool:
        return self.execution_info.sticky_task_list != ""

    def _write_event_to_cache(self, event: HistoryEvent) -> None:
        self.cached_events.append(event)

    # -- decision sub-FSM (reference: mutableStateDecisionTaskManager.go) --

    def _update_decision(self, d: DecisionInfo) -> None:
        # reference: mutableStateDecisionTaskManager.go:677-702
        ei = self.execution_info
        ei.decision_version = d.version
        ei.decision_schedule_id = d.schedule_id
        ei.decision_started_id = d.started_id
        ei.decision_request_id = d.request_id
        ei.decision_timeout = d.decision_timeout
        ei.decision_attempt = d.attempt
        ei.decision_started_timestamp = d.started_timestamp
        ei.decision_scheduled_timestamp = d.scheduled_timestamp
        ei.decision_original_scheduled_timestamp = d.original_scheduled_timestamp

    def delete_decision(self) -> None:
        # reference: mutableStateDecisionTaskManager.go:659-674
        self._update_decision(
            DecisionInfo(
                version=EMPTY_VERSION,
                schedule_id=EMPTY_EVENT_ID,
                started_id=EMPTY_EVENT_ID,
                request_id=EMPTY_UUID,
                decision_timeout=0,
                attempt=0,
                started_timestamp=0,
                scheduled_timestamp=0,
                original_scheduled_timestamp=self.execution_info.decision_original_scheduled_timestamp,
            )
        )

    def fail_decision(self, increment_attempt: bool, now: int = 0) -> None:
        # reference: mutableStateDecisionTaskManager.go:635-656
        self.clear_stickiness()
        d = DecisionInfo(
            version=EMPTY_VERSION,
            schedule_id=EMPTY_EVENT_ID,
            started_id=EMPTY_EVENT_ID,
            request_id=EMPTY_UUID,
            decision_timeout=0,
            started_timestamp=0,
            original_scheduled_timestamp=0,
        )
        if increment_attempt:
            d.attempt = self.execution_info.decision_attempt + 1
            d.scheduled_timestamp = now
        self._update_decision(d)

    # -- replicate transitions (the vectorized surface) -------------------

    def replicate_workflow_execution_started_event(
        self,
        parent_domain_id: Optional[str],
        workflow_id: str,
        run_id: str,
        request_id: str,
        event: HistoryEvent,
    ) -> None:
        # reference: mutableStateBuilder.go:1639-1718
        a = event.attributes
        ei = self.execution_info
        ei.create_request_id = request_id
        ei.workflow_id = workflow_id
        ei.run_id = run_id
        ei.task_list = a.get("task_list", "")
        ei.workflow_type_name = a.get("workflow_type", "")
        ei.workflow_timeout = a.get("execution_start_to_close_timeout_seconds", 0)
        ei.decision_timeout_value = a.get("task_start_to_close_timeout_seconds", 0)
        self.update_workflow_state_close_status(WorkflowState.Created, CloseStatus.NONE)
        ei.last_processed_event = EMPTY_EVENT_ID
        ei.last_first_event_id = event.event_id
        ei.decision_version = EMPTY_VERSION
        ei.decision_schedule_id = EMPTY_EVENT_ID
        ei.decision_started_id = EMPTY_EVENT_ID
        ei.decision_request_id = EMPTY_UUID
        ei.decision_timeout = 0
        ei.cron_schedule = a.get("cron_schedule", "")
        if parent_domain_id is not None:
            ei.parent_domain_id = parent_domain_id
        if a.get("parent_workflow_id"):
            ei.parent_workflow_id = a["parent_workflow_id"]
            ei.parent_run_id = a.get("parent_run_id", "")
        ei.initiated_id = a.get("parent_initiated_event_id", EMPTY_EVENT_ID)
        ei.attempt = a.get("attempt", 0)
        backoff_s = a.get("first_decision_task_backoff_seconds", 0) or 0
        ei.first_decision_backoff_deadline = (
            event.timestamp + backoff_s * 1_000_000_000 if backoff_s else 0
        )
        if a.get("expiration_timestamp", 0):
            ei.expiration_time = a["expiration_timestamp"]
        rp = RetryPolicy.from_dict(a.get("retry_policy"))
        if rp is not None:
            ei.has_retry_policy = True
            ei.backoff_coefficient = rp.backoff_coefficient
            ei.expiration_seconds = rp.expiration_interval_seconds
            ei.initial_interval = rp.initial_interval_seconds
            ei.maximum_attempts = rp.maximum_attempts
            ei.maximum_interval = rp.maximum_interval_seconds
            ei.non_retriable_errors = list(rp.non_retriable_error_reasons)
        ei.start_timestamp = event.timestamp
        if a.get("memo"):
            ei.memo = dict(a["memo"])
        if a.get("search_attributes"):
            ei.search_attributes = dict(a["search_attributes"])
        self._write_event_to_cache(event)

    def replicate_decision_task_scheduled_event(
        self,
        version: int,
        schedule_id: int,
        task_list: str,
        start_to_close_timeout_seconds: int,
        attempt: int,
        schedule_timestamp: int,
        original_scheduled_timestamp: int,
    ) -> DecisionInfo:
        # reference: mutableStateDecisionTaskManager.go:143-167
        d = DecisionInfo(
            version=version,
            schedule_id=schedule_id,
            started_id=EMPTY_EVENT_ID,
            request_id=EMPTY_UUID,
            decision_timeout=start_to_close_timeout_seconds,
            task_list=task_list,
            attempt=attempt,
            scheduled_timestamp=schedule_timestamp,
            started_timestamp=0,
            original_scheduled_timestamp=original_scheduled_timestamp,
        )
        self._update_decision(d)
        return d

    def replicate_transient_decision_task_scheduled(
        self, now: int
    ) -> Optional[DecisionInfo]:
        # reference: mutableStateDecisionTaskManager.go:169-198
        if self.has_pending_decision() or self.execution_info.decision_attempt == 0:
            return None
        d = DecisionInfo(
            version=self.current_version,
            schedule_id=self.execution_info.next_event_id,
            started_id=EMPTY_EVENT_ID,
            request_id=EMPTY_UUID,
            decision_timeout=self.execution_info.decision_timeout_value,
            task_list=self.execution_info.task_list,
            attempt=self.execution_info.decision_attempt,
            scheduled_timestamp=now,
            started_timestamp=0,
        )
        self._update_decision(d)
        return d

    def replicate_decision_task_started_event(
        self,
        decision: Optional[DecisionInfo],
        version: int,
        schedule_id: int,
        started_id: int,
        request_id: str,
        timestamp: int,
    ) -> DecisionInfo:
        # reference: mutableStateDecisionTaskManager.go:200-253
        if decision is None:
            decision = self.get_decision_info()
            if decision is None or decision.schedule_id != schedule_id:
                raise InvalidHistoryError(f"unable to find decision {schedule_id}")
            # replication path: reset attempt so a half-replicated transient
            # decision can still time out correctly
            decision.attempt = 0

        if self.execution_info.state == WorkflowState.Created:
            self.update_workflow_state_close_status(
                WorkflowState.Running, CloseStatus.NONE
            )

        d = DecisionInfo(
            version=version,
            schedule_id=schedule_id,
            started_id=started_id,
            request_id=request_id,
            decision_timeout=decision.decision_timeout,
            attempt=decision.attempt,
            started_timestamp=timestamp,
            scheduled_timestamp=decision.scheduled_timestamp,
            task_list=decision.task_list,
            original_scheduled_timestamp=decision.original_scheduled_timestamp,
        )
        self._update_decision(d)
        return d

    # reference: dynamicconfig MaxAutoResetPoints (default 20)
    MAX_RESET_POINTS = 20

    @staticmethod
    def record_reset_point(
        points: List[Dict[str, Any]], checksum: str, run_id: str,
        completed_event_id: int, created_time: int,
    ) -> None:
        """Append the first-completed-decision-per-binary reset anchor
        (reference addBinaryCheckSumIfNotExists) with dedup + cap. The
        ONE implementation shared by the live replicate path and the
        device packer (ops/pack.py) so rebuilt state always agrees."""
        if not checksum or any(
            p.get("binary_checksum") == checksum for p in points
        ):
            return
        points.append({
            "binary_checksum": checksum,
            "run_id": run_id,
            "first_decision_completed_id": completed_event_id,
            "created_time": created_time,
            "resettable": True,
        })
        del points[:-MutableState.MAX_RESET_POINTS]

    def replicate_decision_task_completed_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateDecisionTaskManager.go:255-262,789-800
        self.delete_decision()
        self.execution_info.last_processed_event = event.attributes.get(
            "started_event_id", EMPTY_EVENT_ID
        )
        # auto reset points live on the replicate path so active,
        # replicated, and rebuilt state all agree
        ei = self.execution_info
        self.record_reset_point(
            ei.auto_reset_points,
            event.attributes.get("binary_checksum", "") or "",
            ei.run_id, event.event_id, event.timestamp,
        )

    def replicate_decision_task_failed_event(self, now: int = 0) -> None:
        # reference: mutableStateDecisionTaskManager.go:264-267
        self.fail_decision(True, now)

    def replicate_decision_task_timed_out_event(
        self, timeout_type: TimeoutType, now: int = 0
    ) -> None:
        # reference: mutableStateDecisionTaskManager.go:269-279 — sticky
        # (schedule-to-start) timeouts do not increment the attempt.
        self.fail_decision(timeout_type != TimeoutType.ScheduleToStart, now)

    # activities

    def replicate_activity_task_scheduled_event(
        self, first_event_id: int, event: HistoryEvent
    ) -> ActivityInfo:
        # reference: mutableStateBuilder.go:1982-2029
        a = event.attributes
        schedule_to_close = a.get("schedule_to_close_timeout_seconds", 0)
        ai = ActivityInfo(
            version=event.version,
            schedule_id=event.event_id,
            scheduled_event_batch_id=first_event_id,
            scheduled_time=event.timestamp,
            started_id=EMPTY_EVENT_ID,
            started_time=0,
            activity_id=a.get("activity_id", ""),
            schedule_to_start_timeout=a.get("schedule_to_start_timeout_seconds", 0),
            schedule_to_close_timeout=schedule_to_close,
            start_to_close_timeout=a.get("start_to_close_timeout_seconds", 0),
            heartbeat_timeout=a.get("heartbeat_timeout_seconds", 0),
            cancel_requested=False,
            cancel_request_id=EMPTY_EVENT_ID,
            timer_task_status=TIMER_TASK_STATUS_NONE,
            task_list=a.get("task_list", ""),
            has_retry_policy=a.get("retry_policy") is not None,
        )
        ai.expiration_time = ai.scheduled_time + schedule_to_close * SECOND
        rp = RetryPolicy.from_dict(a.get("retry_policy"))
        if rp is not None:
            ai.initial_interval = rp.initial_interval_seconds
            ai.backoff_coefficient = rp.backoff_coefficient
            ai.maximum_interval = rp.maximum_interval_seconds
            ai.maximum_attempts = rp.maximum_attempts
            ai.non_retriable_errors = list(rp.non_retriable_error_reasons)
            if rp.expiration_interval_seconds > schedule_to_close:
                ai.expiration_time = (
                    ai.scheduled_time + rp.expiration_interval_seconds * SECOND
                )
        self.pending_activities[ai.schedule_id] = ai
        self.activity_by_id[ai.activity_id] = ai.schedule_id
        self._write_event_to_cache(event)
        return ai

    def replicate_activity_task_started_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:2083-2098
        schedule_id = event.attributes.get("scheduled_event_id", EMPTY_EVENT_ID)
        ai = self.pending_activities.get(schedule_id)
        if ai is None:
            raise InvalidHistoryError(f"activity started for unknown schedule {schedule_id}")
        ai.version = event.version
        ai.started_id = event.event_id
        ai.request_id = event.attributes.get("request_id", "")
        ai.started_time = event.timestamp
        ai.last_heartbeat_updated_time = ai.started_time
        ai.attempt = event.attributes.get("attempt", ai.attempt)
        ai.started_identity = event.attributes.get("identity", "")

    def _delete_activity(self, schedule_id: int) -> None:
        ai = self.pending_activities.pop(schedule_id, None)
        if ai is None:
            raise InvalidHistoryError(f"delete of unknown activity {schedule_id}")
        # only drop the secondary index if it still points at us
        if self.activity_by_id.get(ai.activity_id) == schedule_id:
            del self.activity_by_id[ai.activity_id]

    def retry_activity(self, ai: ActivityInfo, now: int, failure_reason: str = ""):
        """Schedule the next attempt in place; returns the
        ActivityRetryTimer task or None when retries are exhausted
        (reference: mutableStateBuilder.go RetryActivity). No history
        event is written — only the final failure is recorded."""
        from ..utils.backoff import (
            NO_INTERVAL,
            RetryPolicy as BackoffPolicy,
            next_backoff_interval_seconds,
        )

        from .tasks import TimerTask
        from .enums import TimerTaskType

        if not ai.has_retry_policy or ai.cancel_requested:
            return None
        policy = BackoffPolicy(
            initial_interval_seconds=ai.initial_interval,
            backoff_coefficient=ai.backoff_coefficient,
            maximum_interval_seconds=ai.maximum_interval,
            maximum_attempts=ai.maximum_attempts,
            expiration_seconds=1 if ai.expiration_time else 0,
            non_retriable_errors=tuple(ai.non_retriable_errors),
        )
        interval = next_backoff_interval_seconds(
            policy, ai.attempt, ai.expiration_time, now,
            error_reason=failure_reason,
        )
        if interval == NO_INTERVAL:
            return None
        ai.version = self.current_version
        ai.attempt += 1
        ai.scheduled_time = now + interval * SECOND
        ai.started_id = EMPTY_EVENT_ID
        ai.started_time = 0
        ai.request_id = ""
        ai.timer_task_status = TIMER_TASK_STATUS_NONE
        if failure_reason:
            ai.last_failure_reason = failure_reason
        return TimerTask(
            task_type=TimerTaskType.ActivityRetryTimer,
            visibility_timestamp=ai.scheduled_time,
            event_id=ai.schedule_id,
            schedule_attempt=ai.attempt,
            version=ai.version,
        )

    def replicate_activity_task_completed_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:2132-2140
        self._delete_activity(event.attributes.get("scheduled_event_id", EMPTY_EVENT_ID))

    def replicate_activity_task_failed_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:2174-2182
        self._delete_activity(event.attributes.get("scheduled_event_id", EMPTY_EVENT_ID))

    def replicate_activity_task_timed_out_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:2220-2228
        self._delete_activity(event.attributes.get("scheduled_event_id", EMPTY_EVENT_ID))

    def replicate_activity_task_cancel_requested_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:2292+ — looked up by activity ID;
        # a missing activity is a corrupt history.
        activity_id = event.attributes.get("activity_id", "")
        ai = self.get_activity_by_activity_id(activity_id)
        if ai is None:
            raise InvalidHistoryError(
                f"cancel requested for unknown activity {activity_id!r}"
            )
        ai.version = event.version
        ai.cancel_requested = True
        ai.cancel_request_id = event.event_id

    def replicate_activity_task_canceled_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:2346-2354
        self._delete_activity(event.attributes.get("scheduled_event_id", EMPTY_EVENT_ID))

    # timers

    def replicate_timer_started_event(self, event: HistoryEvent) -> TimerInfo:
        # reference: mutableStateBuilder.go:2877-2901; a duplicate pending
        # timer ID is treated as corrupt history (the active path can never
        # produce one — AddStartTimer validates), keeping host-replay and
        # pack-time strictness identical.
        a = event.attributes
        timer_id = a.get("timer_id", "")
        if timer_id in self.pending_timers:
            raise InvalidHistoryError(f"duplicate pending timer {timer_id!r}")
        ti = TimerInfo(
            version=event.version,
            timer_id=timer_id,
            expiry_time=event.timestamp
            + a.get("start_to_fire_timeout_seconds", 0) * SECOND,
            started_id=event.event_id,
            task_status=TIMER_TASK_STATUS_NONE,
        )
        self.pending_timers[timer_id] = ti
        self.timer_by_started_id[ti.started_id] = timer_id
        return ti

    def _delete_user_timer(self, timer_id: str) -> None:
        ti = self.pending_timers.pop(timer_id, None)
        if ti is None:
            raise InvalidHistoryError(f"delete of unknown timer {timer_id!r}")
        self.timer_by_started_id.pop(ti.started_id, None)

    def replicate_timer_fired_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:2930-2939
        self._delete_user_timer(event.attributes.get("timer_id", ""))

    def replicate_timer_canceled_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:2982-2991
        self._delete_user_timer(event.attributes.get("timer_id", ""))

    # workflow-level

    def replicate_workflow_execution_signaled(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:3082-3089
        self.execution_info.signal_count += 1

    def replicate_workflow_execution_cancel_requested_event(
        self, event: HistoryEvent
    ) -> None:
        # reference: mutableStateBuilder.go:2504-2510
        self.execution_info.cancel_requested = True
        self.execution_info.cancel_request_id = event.attributes.get("cancel_request_id", "")

    def _close_execution(
        self, first_event_id: int, event: HistoryEvent, close_status: CloseStatus
    ) -> None:
        self.update_workflow_state_close_status(WorkflowState.Completed, close_status)
        self.execution_info.completion_event_batch_id = first_event_id
        self.clear_stickiness()
        self._write_event_to_cache(event)

    def replicate_workflow_execution_completed_event(
        self, first_event_id: int, event: HistoryEvent
    ) -> None:
        # reference: mutableStateBuilder.go:2379-2395
        self._close_execution(first_event_id, event, CloseStatus.Completed)

    def replicate_workflow_execution_failed_event(
        self, first_event_id: int, event: HistoryEvent
    ) -> None:
        # reference: mutableStateBuilder.go:2419-2436
        self._close_execution(first_event_id, event, CloseStatus.Failed)

    def replicate_workflow_execution_timedout_event(
        self, first_event_id: int, event: HistoryEvent
    ) -> None:
        # reference: mutableStateBuilder.go:2456-2472
        self._close_execution(first_event_id, event, CloseStatus.TimedOut)

    def replicate_workflow_execution_canceled_event(
        self, first_event_id: int, event: HistoryEvent
    ) -> None:
        # reference: mutableStateBuilder.go:2535-2551
        self._close_execution(first_event_id, event, CloseStatus.Canceled)

    def replicate_workflow_execution_terminated_event(
        self, first_event_id: int, event: HistoryEvent
    ) -> None:
        # reference: mutableStateBuilder.go:3047-3063
        self._close_execution(first_event_id, event, CloseStatus.Terminated)

    def replicate_workflow_execution_continued_as_new_event(
        self, first_event_id: int, event: HistoryEvent
    ) -> None:
        # reference: mutableStateBuilder.go:3207-3225
        self._close_execution(first_event_id, event, CloseStatus.ContinuedAsNew)

    def replicate_upsert_workflow_search_attributes_event(
        self, event: HistoryEvent
    ) -> None:
        # reference: mutableStateBuilder.go:2746-2757 — merge semantics
        upserts = event.attributes.get("search_attributes", {})
        self.execution_info.search_attributes.update(upserts)

    # external cancel / signal

    def replicate_request_cancel_external_initiated_event(
        self, first_event_id: int, event: HistoryEvent, cancel_request_id: str
    ) -> RequestCancelInfo:
        # reference: mutableStateBuilder.go:2577-2607
        rci = RequestCancelInfo(
            version=event.version,
            initiated_id=event.event_id,
            initiated_event_batch_id=first_event_id,
            cancel_request_id=cancel_request_id,
        )
        self.pending_request_cancels[rci.initiated_id] = rci
        return rci

    def _delete_pending_request_cancel(self, initiated_id: int) -> None:
        if self.pending_request_cancels.pop(initiated_id, None) is None:
            raise InvalidHistoryError(f"delete of unknown request-cancel {initiated_id}")

    def replicate_external_workflow_execution_cancel_requested(
        self, event: HistoryEvent
    ) -> None:
        # reference: mutableStateBuilder.go:2626-2633
        self._delete_pending_request_cancel(
            event.attributes.get("initiated_event_id", EMPTY_EVENT_ID)
        )

    def replicate_request_cancel_external_failed_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:2666-2673
        self._delete_pending_request_cancel(
            event.attributes.get("initiated_event_id", EMPTY_EVENT_ID)
        )

    def replicate_signal_external_initiated_event(
        self, first_event_id: int, event: HistoryEvent, signal_request_id: str
    ) -> SignalInfo:
        # reference: mutableStateBuilder.go:2701-2736
        a = event.attributes
        si = SignalInfo(
            version=event.version,
            initiated_id=event.event_id,
            initiated_event_batch_id=first_event_id,
            signal_request_id=signal_request_id,
            signal_name=a.get("signal_name", ""),
            input=a.get("input", b""),
            control=a.get("control", b""),
        )
        self.pending_signals[si.initiated_id] = si
        return si

    def _delete_pending_signal(self, initiated_id: int) -> None:
        if self.pending_signals.pop(initiated_id, None) is None:
            raise InvalidHistoryError(f"delete of unknown external signal {initiated_id}")

    def replicate_external_workflow_execution_signaled(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:2799-2806
        self._delete_pending_signal(
            event.attributes.get("initiated_event_id", EMPTY_EVENT_ID)
        )

    def replicate_signal_external_failed_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:2840-2847
        self._delete_pending_signal(
            event.attributes.get("initiated_event_id", EMPTY_EVENT_ID)
        )

    # children

    def replicate_start_child_initiated_event(
        self, first_event_id: int, event: HistoryEvent, create_request_id: str
    ) -> ChildExecutionInfo:
        # reference: mutableStateBuilder.go:3256-3281
        a = event.attributes
        ci = ChildExecutionInfo(
            version=event.version,
            initiated_id=event.event_id,
            initiated_event_batch_id=first_event_id,
            started_id=EMPTY_EVENT_ID,
            started_workflow_id=a.get("workflow_id", ""),
            create_request_id=create_request_id,
            domain_name=a.get("domain", ""),
            workflow_type_name=a.get("workflow_type", ""),
            parent_close_policy=ParentClosePolicy(
                a.get("parent_close_policy", int(ParentClosePolicy.Abandon))
            ),
        )
        self.pending_children[ci.initiated_id] = ci
        self._write_event_to_cache(event)
        return ci

    def replicate_child_execution_started_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:3312-3325
        initiated_id = event.attributes.get("initiated_event_id", EMPTY_EVENT_ID)
        ci = self.pending_children.get(initiated_id)
        if ci is None:
            raise InvalidHistoryError(f"child started for unknown initiated {initiated_id}")
        ci.started_id = event.event_id
        ci.started_run_id = event.attributes.get("run_id", "")

    def _delete_pending_child(self, initiated_id: int) -> None:
        if self.pending_children.pop(initiated_id, None) is None:
            raise InvalidHistoryError(f"delete of unknown child {initiated_id}")

    def replicate_start_child_failed_event(self, event: HistoryEvent) -> None:
        # reference: mutableStateBuilder.go:3355-3368
        self._delete_pending_child(
            event.attributes.get("initiated_event_id", EMPTY_EVENT_ID)
        )

    def replicate_child_execution_completed_event(self, event: HistoryEvent) -> None:
        self._delete_pending_child(
            event.attributes.get("initiated_event_id", EMPTY_EVENT_ID)
        )

    def replicate_child_execution_failed_event(self, event: HistoryEvent) -> None:
        self._delete_pending_child(
            event.attributes.get("initiated_event_id", EMPTY_EVENT_ID)
        )

    def replicate_child_execution_canceled_event(self, event: HistoryEvent) -> None:
        self._delete_pending_child(
            event.attributes.get("initiated_event_id", EMPTY_EVENT_ID)
        )

    def replicate_child_execution_terminated_event(self, event: HistoryEvent) -> None:
        self._delete_pending_child(
            event.attributes.get("initiated_event_id", EMPTY_EVENT_ID)
        )

    def replicate_child_execution_timed_out_event(self, event: HistoryEvent) -> None:
        self._delete_pending_child(
            event.attributes.get("initiated_event_id", EMPTY_EVENT_ID)
        )

    # -- snapshotting -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """A plain-dict snapshot for persistence / comparison."""
        return {
            "execution_info": _asdict(self.execution_info),
            "pending_activities": {
                k: _asdict(v) for k, v in self.pending_activities.items()
            },
            "pending_timers": {
                k: _asdict(v) for k, v in self.pending_timers.items()
            },
            "pending_children": {
                k: _asdict(v) for k, v in self.pending_children.items()
            },
            "pending_request_cancels": {
                k: _asdict(v)
                for k, v in self.pending_request_cancels.items()
            },
            "pending_signals": {
                k: _asdict(v) for k, v in self.pending_signals.items()
            },
            "signal_requested_ids": sorted(self.signal_requested_ids),
            "current_version": self.current_version,
            "buffered_events": [e.to_dict() for e in self.buffered_events],
            "version_histories": (
                self.version_histories.to_dict()
                if self.version_histories is not None
                else None
            ),
        }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "MutableState":
        ms = cls()
        ei = dict(snap["execution_info"])
        ei["state"] = WorkflowState(ei["state"])
        ei["close_status"] = CloseStatus(ei["close_status"])
        ms.execution_info = ExecutionInfo(**ei)
        for k, v in snap.get("pending_activities", {}).items():
            ai = ActivityInfo(**v)
            ms.pending_activities[int(k)] = ai
            ms.activity_by_id[ai.activity_id] = int(k)
        for k, v in snap.get("pending_timers", {}).items():
            ti = TimerInfo(**v)
            ms.pending_timers[k] = ti
            ms.timer_by_started_id[ti.started_id] = k
        for k, v in snap.get("pending_children", {}).items():
            v = dict(v)
            v["parent_close_policy"] = ParentClosePolicy(v["parent_close_policy"])
            ms.pending_children[int(k)] = ChildExecutionInfo(**v)
        for k, v in snap.get("pending_request_cancels", {}).items():
            ms.pending_request_cancels[int(k)] = RequestCancelInfo(**v)
        for k, v in snap.get("pending_signals", {}).items():
            ms.pending_signals[int(k)] = SignalInfo(**v)
        ms.signal_requested_ids = set(snap.get("signal_requested_ids", []))
        ms.current_version = snap.get("current_version", EMPTY_VERSION)
        ms.buffered_events = [
            HistoryEvent.from_dict(d) for d in snap.get("buffered_events", [])
        ]
        vh = snap.get("version_histories")
        if vh is not None:
            from .version_history import VersionHistories

            ms.version_histories = VersionHistories.from_dict(vh)
        return ms
