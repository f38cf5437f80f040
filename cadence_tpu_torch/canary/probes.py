"""Canary probe workflows.

Reference canary workflow set (canary/const.go:64-84): echo, signal,
signal.external, visibility, searchAttributes, concurrent-execution,
query, timeout, localactivity, cancellation, cancellation.external,
retry, reset.base/reset, cron, sanity (the batch/archival probes drive
worker subsystems and live with their services). Each probe here is
(workflow fn + activities + check fn); the check runs against any
frontend (local handler or gRPC stub) and asserts the outcome.

A copy of the reference package's ``canary/probes.py`` over the port's
worker SDK, worker services, archival and domain handler.
"""

from __future__ import annotations

import time
import uuid
from typing import Callable, Dict

from ..core.enums import EventType
from ..core.events import RetryPolicy
from ..runtime.api import SignalRequest, StartWorkflowRequest
from ..worker.sdk import WorkflowCancelled

TASK_LIST = "canary-tl"


# -- workflow definitions -------------------------------------------------


def echo_workflow(ctx, input):
    out = yield ctx.schedule_activity("echo_activity", input)
    return out


def signal_workflow(ctx, input):
    payload = yield ctx.wait_signal("canary-signal")
    return b"signaled:" + payload


def timer_workflow(ctx, input):
    yield ctx.start_timer(1)
    return b"timer-done"


def retry_workflow(ctx, input):
    from ..worker.sdk import ActivityError

    attempts = 0
    while True:
        try:
            out = yield ctx.schedule_activity("flaky_activity", input)
            return out + b":after-" + str(attempts).encode() + b"-retries"
        except ActivityError:
            attempts += 1
            if attempts > 3:
                raise


def concurrent_workflow(ctx, input):
    results = []
    for i in range(3):
        r = yield ctx.start_child_workflow(
            "canary-echo", f"canary-child-{input.decode()}-{i}",
            input=str(i).encode(), task_list=TASK_LIST,
        )
        results.append(r)
    return b",".join(results)


def query_workflow(ctx, input):
    yield ctx.wait_signal("done")
    return b"ok"


def sleeper_workflow(ctx, input):
    # blocks forever: the timeout probe closes it via workflow timeout
    yield ctx.wait_signal("never")
    return b"unreachable"


def cancellation_workflow(ctx, input):
    # reference canary/cancellation.go: await ctx.Done, return its error
    cause = yield ctx.wait_cancel()
    raise WorkflowCancelled(cause or b"canceled")


def canceller_workflow(ctx, input):
    # reference canary/cancellation.go external variant
    yield ctx.request_cancel_external("", input.decode())
    return b"cancel-sent"


def signaller_workflow(ctx, input):
    yield ctx.signal_external("", input.decode(), "canary-signal", b"ext")
    return b"signal-sent"


def local_activity_workflow(ctx, input):
    # result comes back through a MarkerRecorded event, never matching
    out = yield ctx.local_activity("echo_local", input)
    return b"local:" + out


def search_attr_workflow(ctx, input):
    yield ctx.upsert_search_attributes(
        {"CustomKeywordField": input.decode()}
    )
    return b"upserted"


def fail_once_workflow(ctx, input):
    # whole-RUN failure on the first attempt; the engine's workflow
    # retry policy starts attempt 2, which succeeds
    out = yield ctx.schedule_activity("fail_once_activity", input)
    return out


def cron_tick_workflow(ctx, input):
    return b"tick"


def sanity_workflow(ctx, input):
    # reference canary/sanity.go: the sanity workflow fans out one
    # child per probe workflow type and fails if any child fails
    key = input.decode()
    results = []
    for i, child_type in enumerate(
        ("canary-echo", "canary-timer", "canary-cron-tick")
    ):
        r = yield ctx.start_child_workflow(
            child_type, f"sanity-{key}-{i}", input=b"s",
            task_list=TASK_LIST,
        )
        results.append(r)
    return b"sanity:" + str(len(results)).encode()


def batch_parent_workflow(ctx, input):
    # reference canary/batch.go: waves of children
    key = input.decode()
    total = 0
    for wave in range(2):
        for i in range(2):
            yield ctx.start_child_workflow(
                "canary-echo", f"batch-{key}-{wave}-{i}", input=b"b",
                task_list=TASK_LIST,
            )
            total += 1
    return b"children:" + str(total).encode()


_flaky_counters: Dict[str, int] = {}


def make_activities():
    def echo_activity(data: bytes) -> bytes:
        return data

    def flaky_activity(data: bytes) -> bytes:
        key = data.decode() or "default"
        n = _flaky_counters.get(key, 0) + 1
        _flaky_counters[key] = n
        if n < 3:
            raise RuntimeError(f"flaking (attempt {n})")
        return b"succeeded"

    def fail_once_activity(data: bytes) -> bytes:
        key = "wf-retry:" + (data.decode() or "default")
        n = _flaky_counters.get(key, 0) + 1
        _flaky_counters[key] = n
        if n < 2:
            raise RuntimeError(f"failing the whole run (attempt {n})")
        return b"retried"

    return {
        "echo_activity": echo_activity,
        "flaky_activity": flaky_activity,
        "fail_once_activity": fail_once_activity,
    }


WORKFLOWS: Dict[str, Callable] = {
    "canary-echo": echo_workflow,
    "canary-signal": signal_workflow,
    "canary-timer": timer_workflow,
    "canary-retry": retry_workflow,
    "canary-concurrent": concurrent_workflow,
    "canary-query": query_workflow,
    "canary-sleeper": sleeper_workflow,
    "canary-cancellation": cancellation_workflow,
    "canary-canceller": canceller_workflow,
    "canary-signaller": signaller_workflow,
    "canary-local-activity": local_activity_workflow,
    "canary-search-attr": search_attr_workflow,
    "canary-fail-once": fail_once_workflow,
    "canary-cron-tick": cron_tick_workflow,
    "canary-sanity": sanity_workflow,
    "canary-batch-parent": batch_parent_workflow,
}

LOCAL_ACTIVITIES: Dict[str, Callable] = {
    "echo_local": lambda data: b"<" + data + b">",
}


# -- probe checks ---------------------------------------------------------


def _wait_result(fe, domain, wf_id, run_id, timeout_s=20.0) -> bytes:
    """Wait for a COMPLETED close and return its result."""
    last = _wait_close(fe, domain, wf_id, run_id, timeout_s)
    if last.event_type != EventType.WorkflowExecutionCompleted:
        raise AssertionError(
            f"closed as {last.event_type.name}: {last.attributes}"
        )
    return last.attributes.get("result", b"")


def _start(fe, domain, wf_type, wf_id, input=b"", timeout=120, **kw):
    return fe.start_workflow_execution(
        StartWorkflowRequest(
            domain=domain, workflow_id=wf_id, workflow_type=wf_type,
            task_list=TASK_LIST, input=input,
            execution_start_to_close_timeout_seconds=timeout,
            **kw,
        )
    )


def _wait_close(fe, domain, wf_id, run_id, timeout_s=20.0):
    """Wait for the run to close; returns its final history event."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        desc = fe.describe_workflow_execution(domain, wf_id, run_id)
        if not desc.is_running:
            events, _ = fe.get_workflow_execution_history(
                domain, wf_id, run_id
            )
            return events[-1]
        time.sleep(0.05)
    raise TimeoutError(f"{wf_id} still running after {timeout_s}s")


def probe_echo(fe, domain) -> None:
    wf = f"canary-echo-{uuid.uuid4().hex[:8]}"
    run = _start(fe, domain, "canary-echo", wf, b"ping")
    assert _wait_result(fe, domain, wf, run) == b"ping"


def probe_signal(fe, domain) -> None:
    wf = f"canary-signal-{uuid.uuid4().hex[:8]}"
    run = _start(fe, domain, "canary-signal", wf)
    fe.signal_workflow_execution(
        SignalRequest(
            domain=domain, workflow_id=wf,
            signal_name="canary-signal", input=b"hello",
        )
    )
    assert _wait_result(fe, domain, wf, run) == b"signaled:hello"


def probe_timer(fe, domain) -> None:
    wf = f"canary-timer-{uuid.uuid4().hex[:8]}"
    run = _start(fe, domain, "canary-timer", wf)
    assert _wait_result(fe, domain, wf, run) == b"timer-done"


def probe_retry(fe, domain) -> None:
    key = uuid.uuid4().hex[:8]
    wf = f"canary-retry-{key}"
    run = _start(fe, domain, "canary-retry", wf, key.encode())
    out = _wait_result(fe, domain, wf, run)
    assert out.startswith(b"succeeded"), out


def probe_concurrent(fe, domain) -> None:
    key = uuid.uuid4().hex[:8]
    wf = f"canary-concurrent-{key}"
    run = _start(fe, domain, "canary-concurrent", wf, key.encode())
    assert _wait_result(fe, domain, wf, run) == b"0,1,2"


def probe_query(fe, domain) -> None:
    wf = f"canary-query-{uuid.uuid4().hex[:8]}"
    _start(fe, domain, "canary-query", wf)
    time.sleep(0.3)  # allow the first decision to settle
    out = fe.query_workflow(
        domain, wf, query_type="status", timeout_s=10.0
    )
    assert out == b"canary-query-alive", out


def probe_visibility(fe, domain) -> None:
    wf = f"canary-vis-{uuid.uuid4().hex[:8]}"
    run = _start(fe, domain, "canary-echo", wf, b"v")
    _wait_result(fe, domain, wf, run)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        n = fe.count_workflow_executions(
            domain, f"WorkflowID = '{wf}' AND CloseStatus = 'COMPLETED'"
        )
        if n == 1:
            return
        time.sleep(0.1)
    raise AssertionError("closed workflow never became visible")


def probe_reset(fe, domain) -> None:
    wf = f"canary-reset-{uuid.uuid4().hex[:8]}"
    run = _start(fe, domain, "canary-echo", wf, b"r")
    _wait_result(fe, domain, wf, run)
    events, _ = fe.get_workflow_execution_history(domain, wf, run)
    completed = [
        e for e in events
        if e.event_type == EventType.DecisionTaskCompleted
    ][0]
    new_run = fe.reset_workflow_execution(
        domain, wf, run, reason="canary",
        decision_finish_event_id=completed.event_id,
    )
    assert _wait_result(fe, domain, wf, new_run) == b"r"


def probe_timeout(fe, domain) -> None:
    # reference canary/timeout.go: a run that must close as TimedOut
    wf = f"canary-timeout-{uuid.uuid4().hex[:8]}"
    run = _start(fe, domain, "canary-sleeper", wf, timeout=1)
    last = _wait_close(fe, domain, wf, run, timeout_s=20.0)
    assert last.event_type == EventType.WorkflowExecutionTimedOut, (
        last.event_type
    )


def probe_cancellation(fe, domain) -> None:
    wf = f"canary-cancel-{uuid.uuid4().hex[:8]}"
    run = _start(fe, domain, "canary-cancellation", wf)
    fe.request_cancel_workflow_execution(domain, wf, run,
                                         identity="canary")
    last = _wait_close(fe, domain, wf, run)
    assert last.event_type == EventType.WorkflowExecutionCanceled, (
        last.event_type
    )


def probe_cancellation_external(fe, domain) -> None:
    key = uuid.uuid4().hex[:8]
    victim = f"canary-cancel-victim-{key}"
    victim_run = _start(fe, domain, "canary-cancellation", victim)
    canceller = f"canary-canceller-{key}"
    run = _start(fe, domain, "canary-canceller", canceller,
                 victim.encode())
    assert _wait_result(fe, domain, canceller, run) == b"cancel-sent"
    last = _wait_close(fe, domain, victim, victim_run)
    assert last.event_type == EventType.WorkflowExecutionCanceled, (
        last.event_type
    )


def probe_signal_external(fe, domain) -> None:
    key = uuid.uuid4().hex[:8]
    receiver = f"canary-sig-receiver-{key}"
    receiver_run = _start(fe, domain, "canary-signal", receiver)
    sender = f"canary-signaller-{key}"
    run = _start(fe, domain, "canary-signaller", sender, receiver.encode())
    assert _wait_result(fe, domain, sender, run) == b"signal-sent"
    assert _wait_result(fe, domain, receiver, receiver_run) == (
        b"signaled:ext"
    )


def probe_local_activity(fe, domain) -> None:
    wf = f"canary-local-{uuid.uuid4().hex[:8]}"
    run = _start(fe, domain, "canary-local-activity", wf, b"la")
    assert _wait_result(fe, domain, wf, run) == b"local:<la>"
    events, _ = fe.get_workflow_execution_history(domain, wf, run)
    kinds = {e.event_type for e in events}
    assert EventType.MarkerRecorded in kinds, "no marker recorded"
    assert EventType.ActivityTaskScheduled not in kinds, (
        "local activity went through matching"
    )


def probe_search_attributes(fe, domain) -> None:
    key = f"canary-{uuid.uuid4().hex[:8]}"
    wf = f"canary-sa-{uuid.uuid4().hex[:8]}"
    run = _start(fe, domain, "canary-search-attr", wf, key.encode())
    assert _wait_result(fe, domain, wf, run) == b"upserted"
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if fe.count_workflow_executions(
            domain, f"CustomKeywordField = '{key}'"
        ) >= 1:
            return
        time.sleep(0.1)
    raise AssertionError("upserted search attribute never became queryable")


def probe_workflow_retry(fe, domain) -> None:
    # run 1 fails; the workflow-level retry policy restarts it
    key = uuid.uuid4().hex[:8]
    wf = f"canary-wfretry-{key}"
    run = _start(
        fe, domain, "canary-fail-once", wf, key.encode(),
        retry_policy=RetryPolicy(
            initial_interval_seconds=1, backoff_coefficient=1.0,
            maximum_attempts=3, expiration_interval_seconds=0,
        ),
    )
    first = _wait_close(fe, domain, wf, run)
    assert first.event_type == EventType.WorkflowExecutionContinuedAsNew, (
        first.event_type
    )
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        desc = fe.describe_workflow_execution(domain, wf)
        if desc.run_id != run and not desc.is_running:
            assert _wait_result(fe, domain, wf, desc.run_id) == b"retried"
            return
        time.sleep(0.1)
    raise TimeoutError("retry attempt never completed")


def probe_cron(fe, domain) -> None:
    # reference canary/cron.go: the schedule keeps producing runs
    wf = f"canary-cron-{uuid.uuid4().hex[:8]}"
    run = _start(fe, domain, "canary-cron-tick", wf,
                 cron_schedule="@every 1s")
    try:
        first = _wait_close(fe, domain, wf, run)
        assert first.event_type == (
            EventType.WorkflowExecutionContinuedAsNew
        ), first.event_type
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            n = fe.count_workflow_executions(
                domain,
                f"WorkflowID = '{wf}' AND "
                "CloseStatus = 'CONTINUED_AS_NEW'",
            )
            if n >= 2:
                return
            time.sleep(0.1)
        raise AssertionError("cron chain produced fewer than 2 fires")
    finally:
        try:
            fe.terminate_workflow_execution(
                domain, wf, reason="canary cron stop"
            )
        except Exception:
            pass  # the chain may be between runs


def probe_sanity(fe, domain) -> None:
    key = uuid.uuid4().hex[:8]
    wf = f"canary-sanity-{key}"
    run = _start(fe, domain, "canary-sanity", wf, key.encode())
    assert _wait_result(fe, domain, wf, run, timeout_s=30.0) == b"sanity:3"


def probe_batch_children(fe, domain) -> None:
    key = uuid.uuid4().hex[:8]
    wf = f"canary-batch-{key}"
    run = _start(fe, domain, "canary-batch-parent", wf, key.encode())
    assert _wait_result(fe, domain, wf, run, timeout_s=30.0) == b"children:4"


def probe_batch_operation(fe, domain) -> None:
    """Bulk terminate through the batcher system workflow
    (service/worker/batcher; canary batch coverage of the service)."""
    import json

    from ..worker.archiver import SYSTEM_DOMAIN
    from ..worker.batcher import (
        BATCHER_TASK_LIST,
        BATCHER_WORKFLOW_TYPE,
    )

    key = uuid.uuid4().hex[:8]
    victims = [f"canary-bt-{key}-{i}" for i in range(3)]
    runs = {
        wf: _start(fe, domain, "canary-sleeper", wf) for wf in victims
    }
    batch_wf = f"canary-batch-op-{key}"
    payload = json.dumps({
        "operation": "terminate",
        "domain": domain,
        "executions": [{"workflow_id": wf} for wf in victims],
        "params": {"reason": "canary batch"},
    }).encode()
    fe.start_workflow_execution(
        StartWorkflowRequest(
            domain=SYSTEM_DOMAIN, workflow_id=batch_wf,
            workflow_type=BATCHER_WORKFLOW_TYPE,
            task_list=BATCHER_TASK_LIST, input=payload,
            execution_start_to_close_timeout_seconds=60,
        )
    )
    for wf in victims:
        last = _wait_close(fe, domain, wf, runs[wf], timeout_s=30.0)
        assert last.event_type == EventType.WorkflowExecutionTerminated, (
            wf, last.event_type,
        )


def probe_archival(fe, domain) -> None:
    """Close → archived history in the filestore (host/archival_test.go
    shape). Uses ONE idempotently-registered archival-enabled domain —
    a periodic canary must not leak a domain per run — and closes the
    workflow by terminate so no worker is involved."""
    import os
    import tempfile

    from ..archival import ArchiverProvider, URI
    from ..frontend.domain_handler import (
        ArchivalStatus,
        DomainAlreadyExistsError,
    )

    tmp = os.path.join(tempfile.gettempdir(), "canary-archival")
    adomain = "canary-archival"
    try:
        fe.register_domain(
            adomain, retention_days=1,
            history_archival_status=ArchivalStatus.ENABLED,
            history_archival_uri=f"file://{tmp}/h",
            visibility_archival_status=ArchivalStatus.ENABLED,
            visibility_archival_uri=f"file://{tmp}/v",
        )
    except DomainAlreadyExistsError:
        pass
    key = uuid.uuid4().hex[:8]
    wf = f"canary-arch-wf-{key}"
    run = fe.start_workflow_execution(
        StartWorkflowRequest(
            domain=adomain, workflow_id=wf, workflow_type="canary-echo",
            task_list=TASK_LIST,
            execution_start_to_close_timeout_seconds=60,
        )
    )
    fe.terminate_workflow_execution(adomain, wf, run, reason="archive me")

    archiver = ArchiverProvider.default().get_history_archiver("file")
    uri = URI.parse(f"file://{tmp}/h")
    domain_id = fe.describe_domain(name=adomain).info.id
    deadline = time.monotonic() + 20.0
    batches = None
    while time.monotonic() < deadline:
        try:
            batches, _ = archiver.get(uri, domain_id, wf, run)
        except FileNotFoundError:
            batches = None  # not archived yet
        if batches:
            break
        time.sleep(0.2)
    assert batches, "history never reached the archive store"
    events = [e for b in batches for e in b]
    assert events[0].event_type == EventType.WorkflowExecutionStarted
    assert events[-1].event_type == EventType.WorkflowExecutionTerminated


PROBES: Dict[str, Callable] = {
    "echo": probe_echo,
    "signal": probe_signal,
    "timer": probe_timer,
    "retry": probe_retry,
    "concurrent": probe_concurrent,
    "query": probe_query,
    "visibility": probe_visibility,
    "reset": probe_reset,
    "timeout": probe_timeout,
    "cancellation": probe_cancellation,
    "cancellation_external": probe_cancellation_external,
    "signal_external": probe_signal_external,
    "local_activity": probe_local_activity,
    "search_attributes": probe_search_attributes,
    "workflow_retry": probe_workflow_retry,
    "cron": probe_cron,
    "sanity": probe_sanity,
    "batch": probe_batch_children,
    "batch_operation": probe_batch_operation,
    "archival": probe_archival,
}
