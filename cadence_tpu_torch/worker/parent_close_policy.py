"""Parent-close-policy processor as a system workflow.

Reference: service/worker/parentclosepolicy/ — when a closing parent
has many started children, the close processor offloads the
terminate/cancel fan-out to this system workflow instead of doing it
inline (processor.go + workflow.go). The inline path lives in the
transfer queue (_apply_parent_close_policy); this workflow covers the
offloaded shape.

A copy of the reference package's ``worker/parent_close_policy.py``.
"""

from __future__ import annotations

import json
from typing import List

from ..runtime.api import (
    SignalWithStartRequest,
    StartWorkflowRequest,
)

from .sdk import Worker
from .archiver import SYSTEM_DOMAIN

PCP_WORKFLOW_TYPE = "cadence-sys-parent-close-policy-workflow"
PCP_WORKFLOW_ID = "cadence-parent-close-policy"
PCP_TASK_LIST = "cadence-parent-close-policy-tl"
PCP_SIGNAL = "parent-close-request"
_REQUESTS_PER_RUN = 500


class ParentClosePolicyClient:
    def __init__(self, frontend) -> None:
        self.frontend = frontend

    def send(self, children: List[dict]) -> None:
        """children: [{domain, workflow_id, run_id, policy}] with policy
        'terminate' | 'cancel'."""
        self.frontend.signal_with_start_workflow_execution(
            SignalWithStartRequest(
                start=StartWorkflowRequest(
                    domain=SYSTEM_DOMAIN,
                    workflow_id=PCP_WORKFLOW_ID,
                    workflow_type=PCP_WORKFLOW_TYPE,
                    task_list=PCP_TASK_LIST,
                    execution_start_to_close_timeout_seconds=3600 * 24,
                    task_start_to_close_timeout_seconds=30,
                ),
                signal_name=PCP_SIGNAL,
                signal_input=json.dumps(children).encode(),
            )
        )


def parent_close_policy_workflow(ctx, input: bytes):
    handled = 0
    while handled < _REQUESTS_PER_RUN:
        payload = yield ctx.wait_signal(PCP_SIGNAL)
        yield ctx.schedule_activity(
            "apply_parent_close_policy", payload,
            start_to_close_timeout_seconds=300,
        )
        handled += 1
    # drain signals recorded but unconsumed — continue-as-new would
    # orphan those close requests (same pattern as archival_workflow)
    while True:
        payload = yield ctx.poll_signal(PCP_SIGNAL)
        if payload is None:
            break
        yield ctx.schedule_activity(
            "apply_parent_close_policy", payload,
            start_to_close_timeout_seconds=300,
        )
    yield ctx.continue_as_new(b"")


class ParentClosePolicyActivities:
    def __init__(self, frontend) -> None:
        self.frontend = frontend

    def apply_parent_close_policy(self, payload: bytes) -> bytes:
        from ..runtime.api import (
            CancellationAlreadyRequestedError,
            EntityNotExistsServiceError,
        )

        children = json.loads(payload)
        applied = 0
        for child in children:
            try:
                if child["policy"] == "terminate":
                    self.frontend.terminate_workflow_execution(
                        child["domain"], child["workflow_id"],
                        child.get("run_id", ""),
                        reason="by parent close policy",
                    )
                elif child["policy"] == "cancel":
                    self.frontend.request_cancel_workflow_execution(
                        child["domain"], child["workflow_id"],
                        child.get("run_id", ""),
                    )
                applied += 1
            except (EntityNotExistsServiceError,
                    CancellationAlreadyRequestedError):
                continue  # child already closed/gone: policy satisfied
            # any OTHER failure (transient store/RPC error) must fail
            # the activity so redelivery retries — swallowing it would
            # permanently drop the terminate/cancel (ref
            # service/worker/parentclosepolicy processor retries)
        return str(applied).encode()


def build_parent_close_policy_worker(frontend) -> Worker:
    acts = ParentClosePolicyActivities(frontend)
    w = Worker(frontend, SYSTEM_DOMAIN, PCP_TASK_LIST, identity="pcp")
    w.register_workflow(PCP_WORKFLOW_TYPE, parent_close_policy_workflow)
    w.register_activity(
        "apply_parent_close_policy", acts.apply_parent_close_policy
    )
    return w
