"""The history engine: all workflow mutations for one shard.

Reference: service/history/historyEngine.go (Start :408, Signal :1493,
SignalWithStart :1606, Terminate, RequestCancel, RecordDecisionTask
Started, RespondDecisionTaskCompleted via decisionHandler.go:258-340,
activity RPCs) — per-workflow lock + optimistic-concurrency retry
(Update_History_Loop, decisionHandler.go:291-311) around every mutation.

A copy of the reference package's ``runtime/engine/engine.py``. The
replication entry points (``ndc_replicator``, ``replicator_queue``,
``replicate_events_v2``, ``get_replication_messages``,
``get_replication_backlog``, ``get_replication_checkpoint``) wait for
the port of the replication plane.
"""

from __future__ import annotations

import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from ...core.active_transaction import (
    ActiveTransaction,
    TransactionResult,
    WorkflowStateError,
)
from ...core.enums import (
    CloseStatus,
    DecisionTaskFailedCause,
    EventType,
    IDReusePolicy,
    TimeoutType,
    WorkflowState,
)
from ...core.events import HistoryEvent
from ...core.ids import (
    EMPTY_EVENT_ID,
    EMPTY_VERSION,
    FIRST_EVENT_ID,
    TRANSIENT_EVENT_ID,
)
from ...core.mutable_state import MutableState
from ...core.version_history import VersionHistories
from ...utils.log import get_logger
from ...utils.metrics import NOOP, Scope

from ..api import (
    BadRequestError,
    CancellationAlreadyRequestedError,
    Decision,
    DescribeWorkflowResponse,
    EntityNotExistsServiceError,
    InternalServiceError,
    ServiceBusyError,
    SignalRequest,
    SignalWithStartRequest,
    StartWorkflowRequest,
    WorkflowExecutionAlreadyStartedServiceError,
    make_task_token,
)
from ..domains import DomainCache
from ..persistence.errors import (
    ConditionFailedError,
    EntityNotExistsError,
    WorkflowAlreadyStartedError,
)
from ..persistence.records import CreateWorkflowMode
from ..shard import ShardContext
from .cache import HistoryCache
from .context import WorkflowExecutionContext
from .events_cache import EventsCache
from .decision_handler import DecisionFailure, DecisionTaskHandler
from .notifier import HistoryEventNotifier
from .query import QueryRegistry

_CONDITION_RETRY_COUNT = 5  # reference: workflowExecutionContext conditionalRetryCount


class HistoryEngine:
    def __init__(
        self,
        shard: ShardContext,
        domain_cache: DomainCache,
        metrics: Scope = NOOP,
        task_notifier: Optional[Callable[[], None]] = None,
        timer_notifier: Optional[Callable[[], None]] = None,
    ) -> None:
        self.shard = shard
        self.domains = domain_cache
        self.metrics = metrics.tagged(service="history", shard=str(shard.shard_id))
        self.log = get_logger("cadence_tpu_torch.history", shard=shard.shard_id)
        self.event_notifier = HistoryEventNotifier()
        self.events_cache = EventsCache()
        self.cache = HistoryCache(
            lambda d, w, r: WorkflowExecutionContext(
                shard, d, w, r, on_persist=self._publish_progress,
                events_cache=self.events_cache,
            )
        )
        self.query_registry = QueryRegistry()
        self.matching_client = None  # wired by the service for queries
        # per-API requests/latency/errors (ref common/metrics/defs.go
        # history scopes)
        from ...utils.metrics_defs import (
            HISTORY_OPS,
            instrument_methods,
        )

        instrument_methods(self, self.metrics, HISTORY_OPS)
        # queue processors poke these after each persisted transaction
        self._task_notifier = task_notifier or (lambda: None)
        self._timer_notifier = timer_notifier or (lambda: None)
        # overload control: a MultiStageRateLimiter wired by
        # HistoryService — None (the default) costs one attribute read.
        # The frontend's limiter alone cannot protect this layer: queue
        # processors, replication appliers, and cross-shard calls all
        # reach the engine without passing a frontend
        self.rate_limiter = None

    # -- helpers ------------------------------------------------------

    def _shed_check(self, domain_key: str, op: str) -> None:
        """Coordinated shedding: consult the service-level limiter and
        shed with the RETRYABLE ``ServiceBusyError`` (retry-after hint
        = the rejecting bucket's refill horizon) — clients spend their
        retry budget instead of stacking work on a saturated shard."""
        lim = self.rate_limiter
        if lim is None:
            return
        if not lim.allow(domain_key):
            hint = getattr(lim, "retry_after_s", None)
            raise ServiceBusyError(
                f"history overloaded ({op}, domain {domain_key})",
                retry_after_s=hint(domain_key) if hint else 0.0,
            )

    def _domain_version(self, domain_record) -> int:
        return (
            domain_record.failover_version
            if domain_record.is_global
            else EMPTY_VERSION
        )

    def _publish_progress(self, ms: MutableState) -> None:
        ei = ms.execution_info
        # trace joining for the asynchronous hops: bind this workflow to
        # the caller's (sampled) trace so the queue tasks this persist
        # just scheduled — processed later on pump threads — land in
        # the SAME trace (utils/tracing.py; queues/base.task_span does
        # the lookup). No active trace → one thread-local read, no bind.
        from ...utils.tracing import TRACER

        TRACER.bind(("wf", ei.workflow_id))
        self.event_notifier.notify(
            ei.domain_id, ei.workflow_id, ei.run_id,
            ms.next_event_id, ms.is_workflow_execution_running(),
        )
        # continuous-batching serving feed (config `serving:`): O(1) —
        # marks a seated lane behind; the next serving tick composes
        # just the Δ suffix. Unseated workflows are one dict miss
        serving = getattr(self, "serving", None)
        if serving is not None:
            serving.on_persisted(
                ei.domain_id, ei.workflow_id, ei.run_id,
                ms.next_event_id,
                running=ms.is_workflow_execution_running(),
            )

    def _notify(self, result: TransactionResult) -> None:
        if result.transfer_tasks or result.new_run_transfer_tasks:
            self._task_notifier()
        if result.timer_tasks or result.new_run_timer_tasks:
            self._timer_notifier()

    def _current_run_id(self, domain_id: str, workflow_id: str) -> str:
        try:
            return self.shard.persistence.execution.get_current_execution(
                self.shard.shard_id, domain_id, workflow_id
            ).run_id
        except EntityNotExistsError:
            raise EntityNotExistsServiceError(
                f"workflow {workflow_id} not found"
            )

    def _update_workflow(
        self,
        domain_id: str,
        workflow_id: str,
        run_id: str,
        action: Callable[[WorkflowExecutionContext, MutableState], Any],
    ) -> Any:
        """The Update_History_Loop: lock, load, act, persist; reload and
        retry on optimistic-concurrency failure."""
        if not run_id:
            run_id = self._current_run_id(domain_id, workflow_id)
        ctx = self.cache.get_or_create(domain_id, workflow_id, run_id)
        with ctx.lock:
            for _ in range(_CONDITION_RETRY_COUNT):
                try:
                    ms = ctx.load()
                except EntityNotExistsError:
                    raise EntityNotExistsServiceError(
                        f"workflow {workflow_id}/{run_id} not found"
                    )
                next_id_before = ms.next_event_id
                try:
                    out = action(ctx, ms)
                except ConditionFailedError:
                    ctx.clear()
                    continue
                except BaseException:
                    # the action may have mutated the cached ms before
                    # failing (staged events, then a persistence I/O
                    # error): drop the cache so the next load re-reads
                    # durable state instead of serving a completed-in-
                    # memory/unchanged-in-store split brain. Read-path
                    # errors (no events staged) keep the cache warm
                    if ms.next_event_id != next_id_before:
                        ctx.clear()
                    raise
                # size check only after a MUTATING transaction (the
                # reference enforces post-update; a read must never
                # terminate as a side effect)
                if ms.next_event_id > next_id_before:
                    self._enforce_history_limits(ctx, ms)
                return out
            raise InternalServiceError(
                f"workflow {workflow_id} update failed after "
                f"{_CONDITION_RETRY_COUNT} condition retries"
            )

    # reference: dynamicconfig HistorySizeLimitError (200MB) /
    # HistoryCountLimitError (200k events) — a runaway history is
    # force-terminated before it can take the shard down with it
    HISTORY_SIZE_LIMIT_BYTES = 200 * 1024 * 1024
    HISTORY_COUNT_LIMIT = 200_000

    def _enforce_history_limits(self, ctx, ms) -> None:
        """Force-terminate a run whose history outgrew the limits
        (reference workflowExecutionContext enforceSizeCheck)."""
        ei = ms.execution_info
        if not ms.is_workflow_execution_running():
            return
        if (
            ei.history_size <= self.HISTORY_SIZE_LIMIT_BYTES
            and ms.next_event_id <= self.HISTORY_COUNT_LIMIT
        ):
            return
        self.log.warn(
            f"terminating {ei.workflow_id}/{ei.run_id}: history "
            f"{ei.history_size}B / {ms.next_event_id - 1} events "
            "exceeds the limit"
        )
        try:
            txn = self._txn(ctx, ms, ms.current_version)
            txn.add_workflow_execution_terminated(
                self.shard.now(),
                reason="history size or count exceeds the limit",
                identity="history-service",
            )
            result = txn.close()
            ctx.update_workflow(ms, result)
            self._notify(result)
        except Exception:
            # the cached ms was mutated by the staged terminate — drop
            # it so the next load re-reads durable state instead of a
            # closed-in-memory/running-in-store split brain
            ctx.clear()
            self.log.exception("history-limit termination failed")

    def _txn(
        self, ctx: WorkflowExecutionContext, ms: MutableState,
        version: int, request_id: str = "",
    ) -> ActiveTransaction:
        return ActiveTransaction(
            ms, ctx.domain_id, ctx.workflow_id, ctx.run_id, version,
            request_id=request_id,
            domain_resolver=lambda name: (
                self.domains.resolve(name).info.id if name else ""
            ),
        )

    # -- StartWorkflowExecution ---------------------------------------

    def start_workflow_execution(
        self, request: StartWorkflowRequest, domain_id: str = "",
        signal_name: str = "", signal_input: bytes = b"",
    ) -> str:
        """Returns the new run_id (reference historyEngine.go:408)."""
        request.validate()
        self._shed_check(request.domain, "start_workflow_execution")
        domain = (
            self.domains.get_by_id(domain_id)
            if domain_id
            else self.domains.get_by_name(request.domain)
        )
        domain_id = domain.info.id
        run_id = str(uuid.uuid4())
        request_id = request.request_id or str(uuid.uuid4())
        version = self._domain_version(domain)
        now = self.shard.now()

        ms = MutableState(domain_id=domain_id, current_version=version)
        if domain.is_global:
            ms.version_histories = VersionHistories.new_empty()
        txn = ActiveTransaction(
            ms, domain_id, request.workflow_id, run_id, version,
            request_id=request_id,
            domain_resolver=lambda name: (
                self.domains.resolve(name).info.id if name else ""
            ),
        )
        txn.add_workflow_execution_started(
            now,
            workflow_type=request.workflow_type,
            task_list=request.task_list,
            execution_start_to_close_timeout_seconds=(
                request.execution_start_to_close_timeout_seconds
            ),
            task_start_to_close_timeout_seconds=(
                request.task_start_to_close_timeout_seconds
            ),
            input=request.input,
            identity=request.identity,
            retry_policy=request.retry_policy,
            # absolute retry budget: expiration_interval_seconds counts
            # from the first run's start (reference historyEngine
            # startWorkflow: ExpirationTime = now + ExpirationInterval)
            expiration_timestamp=(
                now + request.retry_policy.expiration_interval_seconds
                * 1_000_000_000
                if request.retry_policy
                and request.retry_policy.expiration_interval_seconds
                else 0
            ),
            cron_schedule=request.cron_schedule,
            memo=request.memo,
            search_attributes=request.search_attributes,
            parent_workflow_domain=request.parent_domain or None,
            parent_workflow_id=request.parent_workflow_id or None,
            parent_run_id=request.parent_run_id or None,
            parent_initiated_event_id=(
                request.parent_initiated_id
                if request.parent_workflow_id
                else None
            ),
        )
        if signal_name:
            txn.add_workflow_execution_signaled(
                signal_name, signal_input, request.identity, now
            )
        txn.add_decision_task_scheduled(now)
        result = txn.close()

        ctx = self.cache.get_or_create(domain_id, request.workflow_id, run_id)
        with ctx.lock:
            try:
                ctx.create_workflow(ms, result)
            except WorkflowAlreadyStartedError as e:
                return self._handle_start_collision(
                    request, domain_id, ms, result, ctx, e, request_id
                )
        self._notify(result)
        self.metrics.inc("workflow_started")
        return run_id

    def _handle_start_collision(
        self, request, domain_id, ms, result, ctx, err, request_id
    ) -> str:
        # request-id dedup: same start request -> same run (reference
        # historyEngine.go startWorkflow dedup on CreateRequestID)
        if err.start_request_id == request_id:
            return err.run_id
        policy = request.workflow_id_reuse_policy
        if err.state != int(WorkflowState.Completed):
            raise WorkflowExecutionAlreadyStartedServiceError(
                f"workflow {request.workflow_id} already running",
                err.start_request_id, err.run_id,
            )
        if policy == IDReusePolicy.RejectDuplicate:
            raise WorkflowExecutionAlreadyStartedServiceError(
                f"workflow {request.workflow_id} already finished "
                "(RejectDuplicate)",
                err.start_request_id, err.run_id,
            )
        if (
            policy == IDReusePolicy.AllowDuplicateFailedOnly
            and err.close_status
            in (int(CloseStatus.Completed), int(CloseStatus.ContinuedAsNew))
        ):
            raise WorkflowExecutionAlreadyStartedServiceError(
                f"workflow {request.workflow_id} completed successfully "
                "(AllowDuplicateFailedOnly)",
                err.start_request_id, err.run_id,
            )
        ctx.create_workflow(
            ms, result,
            mode=CreateWorkflowMode.WORKFLOW_ID_REUSE,
            prev_run_id=err.run_id,
        )
        self._notify(result)
        return ms.execution_info.run_id

    # -- signals ------------------------------------------------------

    def signal_workflow_execution(self, request: SignalRequest) -> None:
        request.validate()
        self._shed_check(request.domain, "signal_workflow_execution")
        domain = self.domains.get_by_name(request.domain)
        version = self._domain_version(domain)

        def action(ctx, ms):
            if request.request_id and request.request_id in ms.signal_requested_ids:
                return  # dedup
            txn = self._txn(ctx, ms, version)
            try:
                txn.add_workflow_execution_signaled(
                    request.signal_name, request.input, request.identity,
                    self.shard.now(),
                )
                if not ms.has_pending_decision() and not txn.has_buffered_events():
                    txn.add_decision_task_scheduled(self.shard.now())
            except WorkflowStateError as e:
                raise EntityNotExistsServiceError(str(e))
            if request.request_id:
                ms.signal_requested_ids.add(request.request_id)
            result = txn.close()
            ctx.update_workflow(ms, result)
            self._notify(result)

        self._update_workflow(
            domain.info.id, request.workflow_id, request.run_id, action
        )

    def signal_with_start_workflow_execution(
        self, request: SignalWithStartRequest
    ) -> str:
        request.validate()
        start = request.start
        domain = self.domains.get_by_name(start.domain)
        # running workflow -> plain signal (reference historyEngine.go:1606)
        try:
            cur = self.shard.persistence.execution.get_current_execution(
                self.shard.shard_id, domain.info.id, start.workflow_id
            )
            run_id = cur.run_id
            if cur.state != int(WorkflowState.Completed):
                # delegate through the RAW methods: the instance's are
                # metric-wrapped (instrument_methods), and going through
                # them would phantom-count every SignalWithStart as a
                # start/signal RPC too (the reference instruments at
                # the handler boundary only)
                from ...utils.metrics_defs import raw_method

                raw_method(self.signal_workflow_execution)(
                    SignalRequest(
                        domain=start.domain,
                        workflow_id=start.workflow_id,
                        run_id=run_id,
                        signal_name=request.signal_name,
                        input=request.signal_input,
                        identity=start.identity,
                    )
                )
                return run_id
        except (EntityNotExistsServiceError, EntityNotExistsError):
            pass
        from ...utils.metrics_defs import raw_method

        return raw_method(self.start_workflow_execution)(
            start,
            domain_id=domain.info.id,
            signal_name=request.signal_name,
            signal_input=request.signal_input,
        )

    # -- terminate / cancel -------------------------------------------

    def terminate_workflow_execution(
        self, domain_name: str, workflow_id: str, run_id: str = "",
        reason: str = "", details: bytes = b"", identity: str = "",
    ) -> None:
        domain = self.domains.get_by_name(domain_name)
        version = self._domain_version(domain)

        def action(ctx, ms):
            txn = self._txn(ctx, ms, version)
            try:
                txn.add_workflow_execution_terminated(
                    self.shard.now(), reason=reason, details=details,
                    identity=identity,
                )
            except WorkflowStateError as e:
                raise EntityNotExistsServiceError(str(e))
            result = txn.close()
            ctx.update_workflow(ms, result)
            self._notify(result)

        if not run_id:
            # queries buffer under the CONCRETE run id
            run_id = self._current_run_id(domain.info.id, workflow_id)
        self._update_workflow(domain.info.id, workflow_id, run_id, action)
        # a terminated run never runs another decision: buffered
        # consistent queries fail now rather than timing out
        self.query_registry.fail_all(
            domain.info.id, workflow_id, run_id,
            "workflow terminated before the query could run",
        )

    def request_cancel_workflow_execution(
        self, domain_name: str, workflow_id: str, run_id: str = "",
        cause: str = "", identity: str = "", request_id: str = "",
    ) -> None:
        domain = self.domains.get_by_name(domain_name)
        version = self._domain_version(domain)

        def action(ctx, ms):
            txn = self._txn(ctx, ms, version)
            try:
                txn.add_workflow_execution_cancel_requested(
                    cause, identity, self.shard.now(),
                    request_id=request_id,
                )
                if not ms.has_pending_decision():
                    txn.add_decision_task_scheduled(self.shard.now())
            except WorkflowStateError as e:
                if ms.execution_info.cancel_requested:
                    # same requester retrying is idempotent success
                    # (reference historyEngine RequestCancel dedup by
                    # requestID)
                    if (
                        request_id
                        and ms.execution_info.cancel_request_id
                        == request_id
                    ):
                        return
                    raise CancellationAlreadyRequestedError(str(e))
                raise EntityNotExistsServiceError(str(e))
            result = txn.close()
            ctx.update_workflow(ms, result)
            self._notify(result)

        self._update_workflow(domain.info.id, workflow_id, run_id, action)

    # -- decision task lifecycle --------------------------------------

    def record_decision_task_started(
        self, domain_id: str, workflow_id: str, run_id: str,
        schedule_id: int, request_id: str, identity: str = "",
    ) -> Dict[str, Any]:
        """Called by matching on dispatch; returns poll-response fields
        (reference decisionHandler.handleDecisionTaskStarted)."""

        def action(ctx, ms):
            ei = ms.execution_info
            if not ms.has_pending_decision() or ei.decision_schedule_id != schedule_id:
                # stale dispatch: decision already handled
                raise EntityNotExistsServiceError(
                    f"decision {schedule_id} not found "
                    f"(current {ei.decision_schedule_id})"
                )
            if ei.decision_started_id != EMPTY_EVENT_ID:
                if ei.decision_request_id == request_id:
                    pass  # duplicate dispatch of same poll: return same
                else:
                    raise EntityNotExistsServiceError(
                        f"decision {schedule_id} already started"
                    )
            version = ms.current_version
            txn = self._txn(ctx, ms, version)
            if ei.decision_started_id == EMPTY_EVENT_ID:
                try:
                    txn.add_decision_task_started(
                        schedule_id, request_id, identity, self.shard.now()
                    )
                except WorkflowStateError as e:
                    raise EntityNotExistsServiceError(str(e))
                result = txn.close()
                ctx.update_workflow(ms, result)
                self._notify(result)
            # sticky dispatch ships only the delta since the worker's
            # last decision — its cache holds the prefix (reference
            # historyEngine createPollForDecisionTaskResponse: sticky ⇒
            # partial history from previousStartedEventID + 1)
            first = 1
            if (
                ms.is_sticky_task_list_enabled()
                and ms.execution_info.last_processed_event > 0
            ):
                first = ms.execution_info.last_processed_event + 1
            history, _ = ctx.read_history(ms, first_event_id=first)
            return {
                "workflow_type": ms.execution_info.workflow_type_name,
                "previous_started_event_id": ms.execution_info.last_processed_event,
                "scheduled_event_id": ms.execution_info.decision_schedule_id,
                "started_event_id": ms.execution_info.decision_started_id,
                "attempt": ms.execution_info.decision_attempt,
                "history": history,
                "task_token": make_task_token(
                    domain_id, workflow_id, run_id,
                    ms.execution_info.decision_schedule_id,
                    ms.execution_info.decision_started_id,
                ),
            }

        resp = self._update_workflow(domain_id, workflow_id, run_id, action)
        # consistent queries ride the decision task (queryRegistry
        # buffered → started). Attached only AFTER the dispatch
        # persisted — a condition-retried action must not consume them.
        resp["queries"] = {
            q.id: {"query_type": q.query_type, "query_args": q.query_args}
            for q in self.query_registry.take_buffered(
                domain_id, workflow_id, run_id
            )
        }
        return resp

    def respond_decision_task_completed(
        self,
        task_token: Dict[str, Any],
        decisions: List[Decision],
        identity: str = "",
        binary_checksum: str = "",
        sticky_task_list: str = "",
        sticky_schedule_to_start_timeout_seconds: int = 0,
        query_results: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> None:
        domain_id = task_token["domain_id"]
        workflow_id = task_token["workflow_id"]
        run_id = task_token["run_id"]
        schedule_id = task_token["schedule_id"]

        def action(ctx, ms):
            ei = ms.execution_info
            if (
                ei.decision_schedule_id != schedule_id
                or ei.decision_started_id == EMPTY_EVENT_ID
            ):
                raise EntityNotExistsServiceError(
                    f"decision {schedule_id} not in flight"
                )
            started_id = ei.decision_started_id
            version = ms.current_version
            now = self.shard.now()
            # bad-binary gate (reference handleDecisionTaskCompleted →
            # checkBadBinary): a worker running a checksum the domain
            # marked bad must not make progress
            if binary_checksum and binary_checksum in (
                self.domains.get_by_id(domain_id).config.bad_binaries
            ):
                self._fail_decision_task(
                    ctx, schedule_id,
                    int(DecisionTaskFailedCause.BadBinary),
                    f"binary {binary_checksum!r} is marked bad for "
                    "this domain",
                    identity,
                )
                return
            txn = self._txn(ctx, ms, version)
            had_buffered = txn.has_buffered_events()
            completed = txn.add_decision_task_completed(
                schedule_id, started_id, now,
                identity=identity, binary_checksum=binary_checksum,
            )
            # reset points record in the shared StateBuilder replicate
            # path (mutable_state.replicate_decision_task_completed_
            # event) so active, replicated, and rebuilt state agree
            # stickiness (reference: handleDecisionTaskCompleted).
            # A non-positive timeout would arm an instantly-firing
            # ScheduleToStart timer on every decision — normalize to
            # the standard 5s sticky window
            if sticky_task_list:
                ei.sticky_task_list = sticky_task_list
                ei.sticky_schedule_to_start_timeout = (
                    sticky_schedule_to_start_timeout_seconds
                    if sticky_schedule_to_start_timeout_seconds > 0
                    else 5
                )
            else:
                ms.clear_stickiness()

            handler = DecisionTaskHandler(
                txn, completed.event_id, now, identity=identity,
                had_buffered_events=had_buffered,
                started_event_fn=lambda: ctx.get_event(ms, FIRST_EVENT_ID),
            )
            try:
                handler.handle(decisions)
            except DecisionFailure as failure:
                # reset and fail the decision task instead
                # (reference decisionTaskHandler failDecision path)
                ctx.clear()
                self._fail_decision_task(
                    ctx, schedule_id, failure.cause, str(failure), identity
                )
                return
            # events needing a fresh decision: flushed buffered events, a
            # dropped close, or queries buffered after this decision
            # dispatched (reference handleDecisionTaskCompleted schedules
            # a new decision to carry outstanding buffered queries)
            if not handler.workflow_closed and (
                handler.unhandled_close_dropped
                or self._needs_new_decision(txn, completed.event_id)
                or self.query_registry.buffered_count(
                    domain_id, workflow_id, run_id
                ) > 0
            ):
                txn.add_decision_task_scheduled(now)
            result = txn.close()
            ctx.update_workflow(ms, result)
            self._notify(result)
            committed.append(True)
            if handler.workflow_closed:
                # no carrier decision will ever run: buffered queries
                # fail NOW instead of hanging out their full timeout
                self.query_registry.fail_all(
                    domain_id, workflow_id, run_id,
                    "workflow closed before the query could run",
                )

        committed: List[bool] = []
        self._update_workflow(domain_id, workflow_id, run_id, action)
        # consistent-query answers apply only when the completion actually
        # committed — a stale/failed completion must not answer queries
        # with state that never took effect
        if committed and query_results:
            self.query_registry.complete(
                domain_id, workflow_id, run_id, query_results
            )

    @staticmethod
    def _needs_new_decision(txn, completed_id: int) -> bool:
        """Flushed buffered events after the completion require a new
        decision so the worker sees them."""
        from ...core.active_transaction import _BUFFERABLE

        return any(
            e.event_id > completed_id and e.event_type in _BUFFERABLE
            for e in txn.batch
        )

    def _fail_decision_task(
        self, ctx, schedule_id: int, cause: int, message: str, identity: str
    ) -> None:
        ms = ctx.load()
        ei = ms.execution_info
        if ei.decision_schedule_id != schedule_id:
            return
        txn = self._txn(ctx, ms, ms.current_version)
        txn.add_decision_task_failed(
            schedule_id, ei.decision_started_id, self.shard.now(),
            cause=cause, identity=identity, details=message.encode(),
        )
        result = txn.close()
        ctx.update_workflow(ms, result)
        self._notify(result)

    def respond_decision_task_failed(
        self, task_token: Dict[str, Any], cause: int = 0,
        details: bytes = b"", identity: str = "",
    ) -> None:
        def action(ctx, ms):
            ei = ms.execution_info
            if (
                ei.decision_schedule_id != task_token["schedule_id"]
                or ei.decision_started_id == EMPTY_EVENT_ID
            ):
                raise EntityNotExistsServiceError("decision not in flight")
            txn = self._txn(ctx, ms, ms.current_version)
            txn.add_decision_task_failed(
                ei.decision_schedule_id, ei.decision_started_id,
                self.shard.now(), cause=cause, identity=identity,
                details=details,
            )
            result = txn.close()
            ctx.update_workflow(ms, result)
            self._notify(result)

        self._update_workflow(
            task_token["domain_id"], task_token["workflow_id"],
            task_token["run_id"], action,
        )

    # -- activity task lifecycle --------------------------------------

    def record_activity_task_started(
        self, domain_id: str, workflow_id: str, run_id: str,
        schedule_id: int, request_id: str, identity: str = "",
    ) -> Dict[str, Any]:
        def action(ctx, ms):
            ai = ms.get_activity_info(schedule_id)
            if ai is None:
                raise EntityNotExistsServiceError(
                    f"activity {schedule_id} not pending"
                )
            if ai.started_id != EMPTY_EVENT_ID:
                if ai.request_id == request_id:
                    pass  # duplicate dispatch
                else:
                    raise EntityNotExistsServiceError(
                        f"activity {schedule_id} already started"
                    )
            else:
                txn = self._txn(ctx, ms, ms.current_version)
                txn.record_activity_task_started(
                    ai, request_id, identity, self.shard.now()
                )
                result = txn.close()
                ctx.update_workflow(ms, result)
            # the poll response needs the scheduled event's payload:
            # events cache first, history branch on miss
            scheduled_event = ctx.get_event(
                ms, schedule_id,
                first_event_id=max(1, ai.scheduled_event_batch_id),
            )
            return {
                "activity_id": ai.activity_id,
                "scheduled_time": ai.scheduled_time,
                "started_time": ai.started_time,
                "attempt": ai.attempt,
                "heartbeat_details": ai.details,
                "schedule_to_close_timeout_seconds": ai.schedule_to_close_timeout,
                "start_to_close_timeout_seconds": ai.start_to_close_timeout,
                "heartbeat_timeout_seconds": ai.heartbeat_timeout,
                "scheduled_event": scheduled_event,
                "task_token": make_task_token(
                    domain_id, workflow_id, run_id, schedule_id,
                    activity_id=ai.activity_id,
                ),
            }

        return self._update_workflow(domain_id, workflow_id, run_id, action)

    def _respond_activity(
        self, task_token: Dict[str, Any],
        add: Callable[[ActiveTransaction, int, int], None],
    ) -> None:
        schedule_id = task_token["schedule_id"]

        def action(ctx, ms):
            txn = self._txn(ctx, ms, ms.current_version)
            now = self.shard.now()
            try:
                add(txn, schedule_id, now)
                if not ms.has_pending_decision() and not txn.has_buffered_events():
                    txn.add_decision_task_scheduled(now)
            except WorkflowStateError as e:
                raise EntityNotExistsServiceError(str(e))
            result = txn.close()
            ctx.update_workflow(ms, result)
            self._notify(result)

        self._update_workflow(
            task_token["domain_id"], task_token["workflow_id"],
            task_token["run_id"], action,
        )

    def respond_activity_task_completed(
        self, task_token: Dict[str, Any], result: bytes = b"",
        identity: str = "",
    ) -> None:
        self._respond_activity(
            task_token,
            lambda txn, sid, now: txn.add_activity_task_completed(
                sid, now, result=result, identity=identity
            ),
        )

    def respond_activity_task_failed(
        self, task_token: Dict[str, Any], reason: str = "",
        details: bytes = b"", identity: str = "",
    ) -> None:
        self._respond_activity(
            task_token,
            lambda txn, sid, now: txn.add_activity_task_failed(
                sid, now, reason=reason, details=details, identity=identity
            ),
        )

    def respond_activity_task_canceled(
        self, task_token: Dict[str, Any], details: bytes = b"",
        identity: str = "",
    ) -> None:
        self._respond_activity(
            task_token,
            lambda txn, sid, now: txn.add_activity_task_canceled(
                sid, EMPTY_EVENT_ID, now, details=details, identity=identity
            ),
        )

    def record_activity_task_heartbeat(
        self, task_token: Dict[str, Any], details: bytes = b"",
        identity: str = "",
    ) -> bool:
        """Returns cancel_requested (reference historyEngine
        RecordActivityTaskHeartbeat — state-only update, no event)."""
        schedule_id = task_token["schedule_id"]

        def action(ctx, ms):
            ai = ms.get_activity_info(schedule_id)
            if ai is None:
                raise EntityNotExistsServiceError(
                    f"activity {schedule_id} not pending"
                )
            ai.details = details
            ai.last_heartbeat_updated_time = self.shard.now()
            result = TransactionResult(
                events=[], transfer_tasks=[], timer_tasks=[]
            )
            ctx.update_workflow(ms, result)
            return ai.cancel_requested

        return self._update_workflow(
            task_token["domain_id"], task_token["workflow_id"],
            task_token["run_id"], action,
        )

    def with_workflow(
        self, domain_id: str, workflow_id: str, run_id: str,
        fn: Callable[[WorkflowExecutionContext, MutableState], Any],
    ) -> Any:
        """Run ``fn(ctx, ms)`` under the workflow lock with condition
        retries (read-only callers just return values)."""
        return self._update_workflow(domain_id, workflow_id, run_id, fn)

    def refresh_workflow_tasks(
        self, domain_id: str, workflow_id: str, run_id: str = ""
    ) -> int:
        """Regenerate this run's transfer/timer tasks from its current
        mutable state (reference adminHandler.RefreshWorkflowTasks →
        mutableStateTaskRefresher) — the operator fix for a run whose
        tasks were lost or surgically removed. Returns the task count."""
        from ...core.task_refresher import refresh_tasks

        def action(ctx, ms):
            transfer, timer = refresh_tasks(ms)
            txn = self._txn(ctx, ms, ms.current_version)
            for t in transfer:
                txn.schedule_transfer_task(t)
            for t in timer:
                txn.schedule_timer_task(t)
            result = txn.close()
            ctx.update_workflow(ms, result)
            self._notify(result)
            return len(transfer) + len(timer)

        return self._update_workflow(domain_id, workflow_id, run_id, action)

    # -- cross-workflow callbacks (invoked by the transfer queue) ------
    # Reference: transferQueueActiveProcessor.go record*Completed/Failed
    # helpers and historyEngine.RecordChildExecutionCompleted — each
    # appends a result event to the source workflow and schedules a
    # decision if none is pending.

    def _record_external_result(
        self, domain_id: str, workflow_id: str, run_id: str,
        mutate: Callable[[ActiveTransaction, MutableState, int], bool],
    ) -> None:
        def action(ctx, ms):
            if not ms.is_workflow_execution_running():
                raise EntityNotExistsServiceError(
                    f"workflow {workflow_id} already closed"
                )
            now = self.shard.now()
            txn = self._txn(ctx, ms, ms.current_version)
            try:
                if not mutate(txn, ms, now):
                    return  # duplicate task; nothing to record
                if not ms.has_pending_decision() and not txn.has_buffered_events():
                    txn.add_decision_task_scheduled(now)
            except WorkflowStateError as e:
                raise EntityNotExistsServiceError(str(e))
            result = txn.close()
            ctx.update_workflow(ms, result)
            self._notify(result)

        self._update_workflow(domain_id, workflow_id, run_id, action)

    def record_child_execution_started(
        self, domain_id: str, workflow_id: str, run_id: str,
        initiated_id: int, child_domain: str, child_workflow_id: str,
        child_run_id: str, workflow_type: str,
    ) -> None:
        def mutate(txn, ms, now):
            ci = ms.get_child_execution_info(initiated_id)
            if ci is None:
                raise WorkflowStateError(f"child {initiated_id} not pending")
            if ci.started_id != EMPTY_EVENT_ID:
                return False  # duplicate start notification
            txn.add_child_started(
                initiated_id, child_domain, child_workflow_id, child_run_id,
                workflow_type, now,
            )
            return True

        self._record_external_result(domain_id, workflow_id, run_id, mutate)

    def record_start_child_execution_failed(
        self, domain_id: str, workflow_id: str, run_id: str,
        initiated_id: int, child_domain: str, child_workflow_id: str,
        workflow_type: str, cause: int,
    ) -> None:
        def mutate(txn, ms, now):
            if ms.get_child_execution_info(initiated_id) is None:
                return False
            txn.add_start_child_failed(
                initiated_id, child_domain, child_workflow_id, workflow_type,
                cause, now,
            )
            return True

        self._record_external_result(domain_id, workflow_id, run_id, mutate)

    def record_child_execution_completed(
        self, domain_id: str, workflow_id: str, run_id: str,
        initiated_id: int, close_event_type: EventType,
        child_run_id: str = "",
        **close_attrs: Any,
    ) -> None:
        """Parent-side close notification (historyEngine.go
        RecordChildExecutionCompleted). ``child_run_id`` backfills the
        started event when the close raced ahead of the started
        notification (ci.started_run_id is unset in exactly that race)."""

        def mutate(txn, ms, now):
            ci = ms.get_child_execution_info(initiated_id)
            if ci is None:
                return False  # already recorded (duplicate)
            if ci.started_id == EMPTY_EVENT_ID:
                # close raced ahead of the started notification: record
                # the started event first so the history stays legal
                txn.add_child_started(
                    initiated_id, ci.domain_name, ci.started_workflow_id,
                    ci.started_run_id or child_run_id,
                    ci.workflow_type_name, now,
                )
            txn.add_child_closed(initiated_id, close_event_type, now, **close_attrs)
            return True

        self._record_external_result(domain_id, workflow_id, run_id, mutate)

    def record_external_cancel_result(
        self, domain_id: str, workflow_id: str, run_id: str,
        initiated_id: int, target_domain: str, target_workflow_id: str,
        target_run_id: str, failed_cause: Optional[int] = None,
    ) -> None:
        def mutate(txn, ms, now):
            if ms.get_request_cancel_info(initiated_id) is None:
                return False
            if failed_cause is None:
                txn.add_external_cancel_requested(
                    initiated_id, target_domain, target_workflow_id,
                    target_run_id, now,
                )
            else:
                txn.add_request_cancel_external_failed(
                    initiated_id, target_domain, target_workflow_id,
                    target_run_id, failed_cause, now,
                )
            return True

        self._record_external_result(domain_id, workflow_id, run_id, mutate)

    def record_external_signal_result(
        self, domain_id: str, workflow_id: str, run_id: str,
        initiated_id: int, target_domain: str, target_workflow_id: str,
        target_run_id: str, control: bytes = b"",
        failed_cause: Optional[int] = None,
    ) -> None:
        def mutate(txn, ms, now):
            if ms.get_signal_info(initiated_id) is None:
                return False
            if failed_cause is None:
                txn.add_external_signaled(
                    initiated_id, target_domain, target_workflow_id,
                    target_run_id, control, now,
                )
            else:
                txn.add_signal_external_failed(
                    initiated_id, target_domain, target_workflow_id,
                    target_run_id, failed_cause, now,
                )
            return True

        self._record_external_result(domain_id, workflow_id, run_id, mutate)

    # -- reads --------------------------------------------------------

    def get_workflow_execution_history(
        self, domain_name: str, workflow_id: str, run_id: str = "",
        first_event_id: int = 1, page_size: int = 0, next_token: int = 0,
        wait_for_new_event: bool = False, long_poll_timeout_s: float = 10.0,
    ) -> Tuple[List[HistoryEvent], int]:
        domain_id = self.domains.get_by_name(domain_name).info.id
        if not run_id:
            run_id = self._current_run_id(domain_id, workflow_id)

        def probe(ctx, ms):
            return ms.next_event_id, ms.is_workflow_execution_running()

        if wait_for_new_event:
            # long-poll: block until events past first_event_id exist.
            # Subscribe BEFORE probing — an event persisted between probe
            # and subscribe must not be missed (reference notifier
            # ordering: watch, then read).
            sub = self.event_notifier.subscribe(
                domain_id, workflow_id, run_id
            )
            try:
                next_id, running = self._update_workflow(
                    domain_id, workflow_id, run_id, probe
                )
                sub.publish(next_id, running)  # seed with current state
                if next_id <= first_event_id and running:
                    sub.wait_for(first_event_id, long_poll_timeout_s)
            finally:
                self.event_notifier.unsubscribe(
                    domain_id, workflow_id, run_id, sub
                )

        def action(ctx, ms):
            return ctx.read_history(
                ms, first_event_id=first_event_id, page_size=page_size,
                next_token=next_token,
            )

        return self._update_workflow(domain_id, workflow_id, run_id, action)

    def describe_workflow_execution(
        self, domain_name: str, workflow_id: str, run_id: str = ""
    ) -> DescribeWorkflowResponse:
        domain_id = self.domains.get_by_name(domain_name).info.id

        def action(ctx, ms):
            ei = ms.execution_info
            return DescribeWorkflowResponse(
                workflow_id=ei.workflow_id,
                run_id=ei.run_id,
                workflow_type=ei.workflow_type_name,
                start_time=ei.start_timestamp,
                close_time=0,
                close_status=int(ei.close_status),
                is_running=ms.is_workflow_execution_running(),
                history_length=ms.next_event_id - 1,
                pending_activities=[
                    {
                        "schedule_id": sid,
                        "activity_id": ai.activity_id,
                        "state": (
                            "STARTED"
                            if ai.started_id != EMPTY_EVENT_ID
                            else "SCHEDULED"
                        ),
                        "attempt": ai.attempt,
                    }
                    for sid, ai in sorted(ms.pending_activities.items())
                ],
                pending_children=[
                    {
                        "initiated_id": cid,
                        "workflow_id": ci.started_workflow_id,
                        "run_id": ci.started_run_id,
                    }
                    for cid, ci in sorted(ms.pending_children.items())
                ],
                search_attributes=dict(ei.search_attributes),
                memo=dict(ei.memo),
            )

        return self._update_workflow(domain_id, workflow_id, run_id, action)

    # -- re-replication read ------------------------------------------
    # The replication entry points of the reference package's engine
    # (ndc_replicator, replicator_queue, replicate_events_v2 and the
    # replication-message verbs) wait for the port of the replication
    # plane.

    def get_workflow_history_raw(
        self, domain_id: str, workflow_id: str, run_id: str,
        start_event_id: int, end_event_id: int,
    ):
        """Raw history + version-history items for re-replication
        (reference: adminHandler GetWorkflowExecutionRawHistoryV2)."""
        from ..persistence.records import (
            BranchToken,
            current_version_history,
        )

        resp = self.shard.persistence.execution.get_workflow_execution(
            self.shard.shard_id, domain_id, workflow_id, run_id
        )
        token_str, item_pairs = current_version_history(resp.snapshot)
        if not token_str:
            token_str = (resp.snapshot or {}).get(
                "execution_info", {}
            ).get("branch_token", "")
            if isinstance(token_str, bytes):
                token_str = token_str.decode()
        items = [
            {"event_id": e, "version": v} for e, v in item_pairs
        ]
        branch = BranchToken.from_json(token_str)
        batches, _ = self.shard.persistence.history.read_history_branch(
            branch, start_event_id, end_event_id
        )
        return batches, items

    # -- consistent query (queryRegistry + queryStateMachine) ----------

    def query_workflow(
        self,
        domain_name: str,
        workflow_id: str,
        run_id: str = "",
        query_type: str = "",
        query_args: bytes = b"",
        timeout_s: float = 10.0,
        reject_not_open: bool = False,
    ) -> bytes:
        """Reference historyEngine QueryWorkflow: buffer on a pending
        decision (piggyback on its dispatch) or sync-dispatch a query
        task straight to matching when the workflow is idle."""
        from ..api import QueryFailedError

        domain_id = self.domains.get_by_name(domain_name).info.id
        if not run_id:
            run_id = self._current_run_id(domain_id, workflow_id)

        def probe(ctx, ms):
            return (
                ms.is_workflow_execution_running(),
                ms.has_pending_decision(),
                ms.execution_info.task_list,
            )

        running, pending_decision, task_list = self._update_workflow(
            domain_id, workflow_id, run_id, probe
        )
        if reject_not_open and not running:
            raise QueryFailedError("workflow is not open")

        if pending_decision and running:
            q = self.query_registry.buffer(
                domain_id, workflow_id, run_id, query_type, query_args
            )
            # the decision may have completed between the probe and the
            # buffer (its buffered-query check then saw nothing): re-probe
            # and fall through to the direct path if the workflow is idle
            _, still_pending, task_list = self._update_workflow(
                domain_id, workflow_id, run_id, probe
            )
            if still_pending:
                if not q.wait(timeout_s):
                    self.query_registry.fail(
                        domain_id, workflow_id, run_id, q, "query timed out"
                    )
                    raise QueryFailedError("query timed out")
                if q.error:
                    raise QueryFailedError(q.error)
                return q.result or b""
            self.query_registry.fail(
                domain_id, workflow_id, run_id, q, "rerouted to direct path"
            )

        if self.matching_client is None:
            raise InternalServiceError("matching client not wired for query")
        return self.matching_client.query_workflow(
            domain_id, task_list, workflow_id, run_id,
            query_type, query_args, timeout_s,
        )

    # -- workflow reset (workflowResetor.go) ---------------------------

    def reset_workflow_execution(
        self,
        domain_name: str,
        workflow_id: str,
        run_id: str = "",
        reason: str = "",
        decision_finish_event_id: int = 0,
        request_id: str = "",
        identity: str = "",
    ) -> str:
        """Fork at a decision boundary and restart from there; returns
        the new run id."""
        from .resetor import WorkflowResetor

        domain_id = self.domains.get_by_name(domain_name).info.id
        if not run_id:
            run_id = self._current_run_id(domain_id, workflow_id)
        return WorkflowResetor(self).reset_workflow_execution(
            domain_id, workflow_id, run_id, reason,
            decision_finish_event_id, request_id, identity,
        )

    def reset_sticky_task_list(
        self, domain_name: str, workflow_id: str, run_id: str = ""
    ) -> None:
        """Clear sticky execution attributes (frontend ResetStickyTaskList
        → historyEngine.ResetStickyTaskList)."""
        domain_id = self.domains.get_by_name(domain_name).info.id

        def action(ctx, ms):
            ms.clear_stickiness()
            txn = self._txn(ctx, ms, ms.current_version)
            ctx.update_workflow(ms, txn.close())

        self._update_workflow(domain_id, workflow_id, run_id, action)
