"""Auto-restart on close: workflow retry policy and cron schedule.

Reference: service/history/workflowExecutionContext.go, where a close
converts into a continue-as-new instead — ``retryWorkflow`` when a
failed/timed-out run's retry policy grants another attempt (backoff per
service/history/retry.go getBackoffInterval), else ``cronWorkflow``
when the run has a cron schedule (attempt resets, backoff is the cron
delay, service/history/mutableStateBuilder.go GetCronBackoffDuration).
Completion consults only cron; fail/timeout consult retry first.

The new run starts with a WorkflowBackoffTimer instead of an immediate
first decision (state_builder.py handles initiator==CronSchedule /
RetryPolicy when generating the new-run tasks), so the restart fires
after the computed delay.

A copy of the reference package's ``runtime/engine/cron_retry.py``.
"""

from __future__ import annotations

import uuid

from ...core.events import HistoryEvent, RetryPolicy
from ...core.enums import ContinueAsNewInitiator
from ...utils.backoff import (
    NO_INTERVAL,
    RetryPolicy as BackoffPolicy,
    next_backoff_interval_seconds,
)
from ...utils.cron import next_cron_delay_seconds


def try_continue_after_close(
    txn,
    ms,
    started_event_fn,
    close: str,
    now: int,
    error_reason: str = "",
    decision_completed_id: int = 0,
) -> bool:
    """If this close should restart the workflow, stage the
    continue-as-new on ``txn`` and return True.

    close: "complete" | "fail" | "timeout". ``now`` is ns.
    ``started_event_fn`` lazily fetches the run's started event (may be
    a persistence read) — it is only called once a restart is decided,
    so the common no-cron/no-retry close never pays for it. The caller
    must NOT also add its close event when this returns True.
    """
    ei = ms.execution_info
    initiator = None
    backoff = 0
    attempt = 0

    if close in ("fail", "timeout") and ei.has_retry_policy:
        policy = BackoffPolicy(
            initial_interval_seconds=ei.initial_interval,
            backoff_coefficient=ei.backoff_coefficient or 2.0,
            maximum_interval_seconds=ei.maximum_interval,
            maximum_attempts=ei.maximum_attempts,
            expiration_seconds=ei.expiration_seconds,
            non_retriable_errors=tuple(ei.non_retriable_errors),
        )
        delay = next_backoff_interval_seconds(
            policy, ei.attempt, ei.expiration_time, now,
            error_reason=error_reason,
        )
        if delay != NO_INTERVAL:
            initiator = ContinueAsNewInitiator.RetryPolicy
            backoff = delay
            attempt = ei.attempt + 1

    if initiator is None and ei.cron_schedule:
        # anchor '@every' at this run's execution time (start + first-
        # decision backoff) the way mutableStateBuilder.GetCronBackoffDuration
        # does (Cadence service/history/mutableStateBuilder.go:1048-1064)
        anchor = (ei.first_decision_backoff_deadline
                  or ei.start_timestamp) / 1e9
        delay = next_cron_delay_seconds(ei.cron_schedule, now / 1e9, anchor)
        if delay > 0:
            initiator = ContinueAsNewInitiator.CronSchedule
            backoff = delay
            attempt = 0

    if initiator is None:
        return False

    started_event: HistoryEvent | None = (
        started_event_fn() if started_event_fn else None
    )
    started_attrs = started_event.attributes if started_event else {}
    retry_policy = None
    if ei.has_retry_policy:
        retry_policy = RetryPolicy(
            initial_interval_seconds=ei.initial_interval,
            backoff_coefficient=ei.backoff_coefficient,
            maximum_interval_seconds=ei.maximum_interval,
            maximum_attempts=ei.maximum_attempts,
            expiration_interval_seconds=ei.expiration_seconds,
            non_retriable_error_reasons=list(ei.non_retriable_errors),
        )
    # retries keep the run's absolute expiration; a cron fire is a fresh
    # run whose retry budget (if any) restarts from its own start
    if initiator == ContinueAsNewInitiator.RetryPolicy:
        expiration_ts = ei.expiration_time
    elif ei.has_retry_policy and ei.expiration_seconds:
        expiration_ts = now + (backoff + ei.expiration_seconds) * 1_000_000_000
    else:
        expiration_ts = 0
    txn.add_continued_as_new(
        decision_completed_id, now, str(uuid.uuid4()),
        workflow_type=ei.workflow_type_name,
        task_list=ei.task_list,
        execution_start_to_close_timeout_seconds=ei.workflow_timeout,
        task_start_to_close_timeout_seconds=ei.decision_timeout_value,
        input=started_attrs.get("input", b"") or b"",
        backoff_start_interval_seconds=backoff,
        initiator=int(initiator),
        retry_policy=retry_policy,
        attempt=attempt,
        expiration_timestamp=expiration_ts,
        cron_schedule=ei.cron_schedule,
        identity=started_attrs.get("identity", ""),
        memo=started_attrs.get("memo"),
        search_attributes=started_attrs.get("search_attributes"),
    )
    return True
