"""Workflow event/decision/state enumerations.

Semantics match the reference's Thrift IDL
(Cadence idl/github.com/uber/cadence/shared.thrift:152-196 EventType,
:136-150 DecisionType, :119-124 TimeoutType, :239-246 CloseStatus) and the
persistence-level workflow state constants
(Cadence common/persistence/dataInterfaces.go WorkflowState*).

Values are dense small ints on purpose: ``EventType`` is the event-type
code the replay kernel switches on (ops/csrc/replay_fsm.cu), so the enum
ordering is part of the on-device ABI. A copy of the reference package's
enums, kept byte-compatible with it.
"""

from __future__ import annotations

import enum


class EventType(enum.IntEnum):
    """History event types; order mirrors the reference IDL enum."""

    WorkflowExecutionStarted = 0
    WorkflowExecutionCompleted = 1
    WorkflowExecutionFailed = 2
    WorkflowExecutionTimedOut = 3
    DecisionTaskScheduled = 4
    DecisionTaskStarted = 5
    DecisionTaskCompleted = 6
    DecisionTaskTimedOut = 7
    DecisionTaskFailed = 8
    ActivityTaskScheduled = 9
    ActivityTaskStarted = 10
    ActivityTaskCompleted = 11
    ActivityTaskFailed = 12
    ActivityTaskTimedOut = 13
    ActivityTaskCancelRequested = 14
    RequestCancelActivityTaskFailed = 15
    ActivityTaskCanceled = 16
    TimerStarted = 17
    TimerFired = 18
    CancelTimerFailed = 19
    TimerCanceled = 20
    WorkflowExecutionCancelRequested = 21
    WorkflowExecutionCanceled = 22
    RequestCancelExternalWorkflowExecutionInitiated = 23
    RequestCancelExternalWorkflowExecutionFailed = 24
    ExternalWorkflowExecutionCancelRequested = 25
    MarkerRecorded = 26
    WorkflowExecutionSignaled = 27
    WorkflowExecutionTerminated = 28
    WorkflowExecutionContinuedAsNew = 29
    StartChildWorkflowExecutionInitiated = 30
    StartChildWorkflowExecutionFailed = 31
    ChildWorkflowExecutionStarted = 32
    ChildWorkflowExecutionCompleted = 33
    ChildWorkflowExecutionFailed = 34
    ChildWorkflowExecutionCanceled = 35
    ChildWorkflowExecutionTimedOut = 36
    ChildWorkflowExecutionTerminated = 37
    SignalExternalWorkflowExecutionInitiated = 38
    SignalExternalWorkflowExecutionFailed = 39
    ExternalWorkflowExecutionSignaled = 40
    UpsertWorkflowSearchAttributes = 41


NUM_EVENT_TYPES = len(EventType)


class DecisionType(enum.IntEnum):
    """Client decision types (the workflow "instruction set")."""

    ScheduleActivityTask = 0
    RequestCancelActivityTask = 1
    StartTimer = 2
    CompleteWorkflowExecution = 3
    FailWorkflowExecution = 4
    CancelTimer = 5
    CancelWorkflowExecution = 6
    RequestCancelExternalWorkflowExecution = 7
    RecordMarker = 8
    ContinueAsNewWorkflowExecution = 9
    StartChildWorkflowExecution = 10
    SignalExternalWorkflowExecution = 11
    UpsertWorkflowSearchAttributes = 12


class ContinueAsNewInitiator(enum.IntEnum):
    """Why a run continued-as-new (reference: shared.thrift
    ContinueAsNewInitiator; stateBuilder treats 2 == CronSchedule)."""

    Decider = 0
    RetryPolicy = 1
    CronSchedule = 2


class TimeoutType(enum.IntEnum):
    StartToClose = 0
    ScheduleToStart = 1
    ScheduleToClose = 2
    Heartbeat = 3


class ParentClosePolicy(enum.IntEnum):
    Abandon = 0
    RequestCancel = 1
    Terminate = 2


class WorkflowState(enum.IntEnum):
    """Lifecycle state of a workflow execution record.

    Mirrors WorkflowStateCreated/Running/Completed/Zombie/Void/Corrupted in
    the reference persistence layer.
    """

    Created = 0
    Running = 1
    Completed = 2
    Zombie = 3
    Void = 4
    Corrupted = 5


class CloseStatus(enum.IntEnum):
    """Close status; ``NONE`` means still open."""

    NONE = 0
    Completed = 1
    Failed = 2
    Canceled = 3
    Terminated = 4
    ContinuedAsNew = 5
    TimedOut = 6


class PendingActivityState(enum.IntEnum):
    Scheduled = 0
    Started = 1
    CancelRequested = 2


class IDReusePolicy(enum.IntEnum):
    AllowDuplicateFailedOnly = 0
    AllowDuplicate = 1
    RejectDuplicate = 2


class QueryResultType(enum.IntEnum):
    Answered = 0
    Failed = 1


class DecisionTaskFailedCause(enum.IntEnum):
    UnhandledDecision = 0
    BadScheduleActivityAttributes = 1
    BadRequestCancelActivityAttributes = 2
    BadStartTimerAttributes = 3
    BadCancelTimerAttributes = 4
    BadRecordMarkerAttributes = 5
    BadCompleteWorkflowExecutionAttributes = 6
    BadFailWorkflowExecutionAttributes = 7
    BadCancelWorkflowExecutionAttributes = 8
    BadRequestCancelExternalAttributes = 9
    BadContinueAsNewAttributes = 10
    StartTimerDuplicateID = 11
    ResetStickyTaskList = 12
    WorkflowWorkerUnhandledFailure = 13
    BadSignalWorkflowExecutionAttributes = 14
    BadStartChildExecutionAttributes = 15
    ForceCloseDecision = 16
    FailoverCloseDecision = 17
    BadSignalInputSize = 18
    ResetWorkflow = 19
    BadBinary = 20
    ScheduleActivityDuplicateID = 21
    BadSearchAttributes = 22


class CancelExternalWorkflowFailedCause(enum.IntEnum):
    """reference: shared.thrift CancelExternalWorkflowExecutionFailedCause."""

    UnknownExternalWorkflowExecution = 0


class SignalExternalWorkflowFailedCause(enum.IntEnum):
    """reference: shared.thrift SignalExternalWorkflowExecutionFailedCause."""

    UnknownExternalWorkflowExecution = 0


class ChildWorkflowFailedCause(enum.IntEnum):
    """reference: shared.thrift ChildWorkflowExecutionFailedCause."""

    WorkflowAlreadyRunning = 0


class TransferTaskType(enum.IntEnum):
    """Transfer-queue task kinds (reference: common/persistence TransferTaskType*)."""

    DecisionTask = 0
    ActivityTask = 1
    CloseExecution = 2
    CancelExecution = 3
    StartChildExecution = 4
    SignalExecution = 5
    RecordWorkflowStarted = 6
    ResetWorkflow = 7
    UpsertWorkflowSearchAttributes = 8


class TimerTaskType(enum.IntEnum):
    """Timer-queue task kinds (reference: TaskTypeDecisionTimeout etc.)."""

    DecisionTimeout = 0
    ActivityTimeout = 1
    UserTimer = 2
    WorkflowTimeout = 3
    DeleteHistoryEvent = 4
    ActivityRetryTimer = 5
    WorkflowBackoffTimer = 6


class WorkflowBackoffType(enum.IntEnum):
    Retry = 0
    Cron = 1


class TaskListType(enum.IntEnum):
    Decision = 0
    Activity = 1


# Workflow close event type -> CloseStatus recorded on X_CLOSE_STATUS:
# the single source of truth every replay kernel (sequential XLA scan,
# Pallas, both associative evaluators in ops/assoc.py) derives its
# close-status arithmetic from, so a new close type lands in all of
# them at once instead of four hand-kept copies.
WORKFLOW_CLOSE_STATUS = (
    (EventType.WorkflowExecutionCompleted, CloseStatus.Completed),
    (EventType.WorkflowExecutionFailed, CloseStatus.Failed),
    (EventType.WorkflowExecutionTimedOut, CloseStatus.TimedOut),
    (EventType.WorkflowExecutionCanceled, CloseStatus.Canceled),
    (EventType.WorkflowExecutionTerminated, CloseStatus.Terminated),
    (EventType.WorkflowExecutionContinuedAsNew, CloseStatus.ContinuedAsNew),
)


def decision_attempt_increment(dfail, dto, a0):
    """Which decision fail/timeout steps bump X_DEC_ATTEMPT — the oracle's
    ``fail_decision`` precondition, shared by every replay kernel: a
    DecisionTaskFailed always increments; a DecisionTaskTimedOut
    increments unless its timeout type (``a0``) is ScheduleToStart.
    Pure ``|``/``&``/``!=`` so numpy and torch bool masks both work."""
    return dfail | (dto & (a0 != int(TimeoutType.ScheduleToStart)))


# Activity timer-task dedup status bitmask, mirrors the reference's
# TimerTaskStatus* bit flags (service/history/mutableStateBuilder.go).
TIMER_TASK_STATUS_NONE = 0
TIMER_TASK_STATUS_CREATED = 1
TIMER_TASK_STATUS_CREATED_START_TO_CLOSE = 1 << 1
TIMER_TASK_STATUS_CREATED_SCHEDULE_TO_START = 1 << 2
TIMER_TASK_STATUS_CREATED_SCHEDULE_TO_CLOSE = 1 << 3
TIMER_TASK_STATUS_CREATED_HEARTBEAT = 1 << 4
