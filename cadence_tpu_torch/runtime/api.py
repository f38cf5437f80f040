"""Public API request/response types + service errors.

The wire-model subset of the reference's shared.thrift the runtime
speaks (StartWorkflowExecutionRequest etc., workflowHandler.go request
validation). Decisions carry their attributes as plain dicts keyed
exactly like the corresponding event attributes — the same convention
the event model uses.

A copy of the reference package's ``runtime/api.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ..core.enums import DecisionType, IDReusePolicy
from ..core.events import HistoryEvent, RetryPolicy


# -- errors ---------------------------------------------------------------


class ServiceError(Exception):
    pass


class BadRequestError(ServiceError):
    pass


class EntityNotExistsServiceError(ServiceError):
    pass


class WorkflowExecutionAlreadyStartedServiceError(ServiceError):
    def __init__(self, msg: str, start_request_id: str = "", run_id: str = ""):
        super().__init__(msg)
        self.start_request_id = start_request_id
        self.run_id = run_id


class DomainNotActiveError(ServiceError):
    def __init__(self, msg: str, active_cluster: str = ""):
        super().__init__(msg)
        self.active_cluster = active_cluster


class CancellationAlreadyRequestedError(ServiceError):
    pass


class QueryFailedError(ServiceError):
    pass


class InternalServiceError(ServiceError):
    pass


class ServiceBusyError(ServiceError):
    """Rate limit / overload shed. RETRYABLE: carries a
    ``retry_after_s`` hint (derived from the rejecting bucket's refill
    horizon or the admission queue depth) so clients back off for the
    right interval instead of hammering a saturated stage."""

    def __init__(self, msg: str = "", retry_after_s: float = 0.0) -> None:
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


# -- requests -------------------------------------------------------------


@dataclasses.dataclass
class StartWorkflowRequest:
    domain: str
    workflow_id: str
    workflow_type: str
    task_list: str
    execution_start_to_close_timeout_seconds: int
    task_start_to_close_timeout_seconds: int = 10
    input: bytes = b""
    identity: str = ""
    request_id: str = ""
    workflow_id_reuse_policy: IDReusePolicy = IDReusePolicy.AllowDuplicateFailedOnly
    retry_policy: Optional[RetryPolicy] = None
    cron_schedule: str = ""
    memo: Optional[Dict[str, bytes]] = None
    search_attributes: Optional[Dict[str, bytes]] = None
    # parent execution (set when started as a child workflow by the
    # transfer queue; reference: historyEngine StartWorkflowExecution
    # with ParentExecutionInfo)
    parent_domain: str = ""
    parent_workflow_id: str = ""
    parent_run_id: str = ""
    parent_initiated_id: int = 0

    def validate(self) -> None:
        if not self.domain:
            raise BadRequestError("domain is not set")
        if not self.workflow_id:
            raise BadRequestError("workflowId is not set")
        if not self.workflow_type:
            raise BadRequestError("workflowType is not set")
        if not self.task_list:
            raise BadRequestError("taskList is not set")
        if self.execution_start_to_close_timeout_seconds <= 0:
            raise BadRequestError(
                "executionStartToCloseTimeoutSeconds must be positive"
            )
        if self.task_start_to_close_timeout_seconds <= 0:
            raise BadRequestError(
                "taskStartToCloseTimeoutSeconds must be positive"
            )
        if self.retry_policy is not None:
            from ..utils.backoff import validate_retry_policy

            try:
                validate_retry_policy(self.retry_policy)
            except (ValueError, TypeError) as e:
                raise BadRequestError(str(e))


@dataclasses.dataclass
class SignalRequest:
    domain: str
    workflow_id: str
    run_id: str = ""
    signal_name: str = ""
    input: bytes = b""
    identity: str = ""
    request_id: str = ""

    def validate(self) -> None:
        if not self.domain:
            raise BadRequestError("domain is not set")
        if not self.workflow_id:
            raise BadRequestError("workflowId is not set")
        if not self.signal_name:
            raise BadRequestError("signalName is not set")


@dataclasses.dataclass
class SignalWithStartRequest:
    start: StartWorkflowRequest
    signal_name: str = ""
    signal_input: bytes = b""

    def validate(self) -> None:
        self.start.validate()
        if not self.signal_name:
            raise BadRequestError("signalName is not set")


@dataclasses.dataclass
class Decision:
    decision_type: DecisionType
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RespondDecisionTaskCompletedRequest:
    task_token: Dict[str, Any]
    decisions: List[Decision] = dataclasses.field(default_factory=list)
    identity: str = ""
    binary_checksum: str = ""
    execution_context: bytes = b""
    sticky_task_list: str = ""
    sticky_schedule_to_start_timeout_seconds: int = 0
    return_new_decision_task: bool = False


@dataclasses.dataclass
class PollForDecisionTaskResponse:
    task_token: Dict[str, Any]
    workflow_id: str
    run_id: str
    workflow_type: str
    previous_started_event_id: int
    started_event_id: int
    attempt: int
    history: List[HistoryEvent]
    backlog_count_hint: int = 0
    scheduled_timestamp: int = 0
    started_timestamp: int = 0
    # direct (sync) query task: {"query_id", "query_type", "query_args"}
    query: Optional[Dict[str, Any]] = None
    # consistent queries piggybacked on a real decision task
    queries: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PollForActivityTaskResponse:
    task_token: Dict[str, Any]
    workflow_id: str
    run_id: str
    activity_id: str
    activity_type: str
    input: bytes
    scheduled_timestamp: int
    started_timestamp: int
    schedule_to_close_timeout_seconds: int
    start_to_close_timeout_seconds: int
    heartbeat_timeout_seconds: int
    attempt: int
    heartbeat_details: bytes = b""


@dataclasses.dataclass
class DescribeWorkflowResponse:
    workflow_id: str
    run_id: str
    workflow_type: str
    start_time: int
    close_time: int
    close_status: int
    is_running: bool
    history_length: int
    pending_activities: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    pending_children: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    search_attributes: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    memo: Dict[str, bytes] = dataclasses.field(default_factory=dict)


def make_task_token(
    domain_id: str, workflow_id: str, run_id: str, schedule_id: int,
    started_id: int = 0, activity_id: str = "",
) -> Dict[str, Any]:
    return {
        "domain_id": domain_id,
        "workflow_id": workflow_id,
        "run_id": run_id,
        "schedule_id": schedule_id,
        "started_id": started_id,
        "activity_id": activity_id,
    }
