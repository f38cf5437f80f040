"""WorkflowHandler: the full public API surface.

Reference: service/frontend/workflowHandler.go:247-2850 — every RPC
validates (domain status, ID lengths, payload sizes), rate-limits per
domain, resolves the domain, then delegates to the history/matching
clients or the visibility store. Worker task-list APIs poll matching;
visibility queries go to the visibility manager (advanced queries via
the query translator in visibility/).

A copy of the reference package's ``frontend/handler.py``.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..core.enums import EventType
from ..matching import PollRequest
from ..runtime.api import (
    BadRequestError,
    Decision,
    EntityNotExistsServiceError,
    ServiceBusyError,
    SignalRequest,
    SignalWithStartRequest,
    StartWorkflowRequest,
)
from ..runtime.domains import DomainCache
from ..runtime.persistence.errors import (
    EntityNotExistsError as PersistenceEntityNotExistsError,
)
from ..utils.quotas import MultiStageRateLimiter

from .domain_handler import DomainHandler
from .version_checker import ClientVersionChecker

_MAX_ID_LENGTH = 1000  # reference workflowHandler maxIDLengthLimit
_DEFAULT_BLOB_LIMIT = 2 * 1024 * 1024  # blobSizeLimitError default


class WorkflowHandler:
    def __init__(
        self,
        domain_handler: DomainHandler,
        domain_cache: DomainCache,
        history_client,
        matching_client,
        visibility=None,
        rate_limiter: Optional[MultiStageRateLimiter] = None,
        version_checker: Optional[ClientVersionChecker] = None,
        blob_size_limit: int = _DEFAULT_BLOB_LIMIT,
        metrics=None,
    ) -> None:
        self.domain_handler = domain_handler
        self.domains = domain_cache
        self.history = history_client
        self.matching = matching_client
        self.visibility = visibility
        self.limiter = rate_limiter or MultiStageRateLimiter(
            global_rps=100000.0, domain_rps=lambda domain: 100000.0
        )
        self.versions = version_checker or ClientVersionChecker()
        # per-API requests/latency/errors (ref common/metrics/defs.go
        # frontend scopes, applied as in the scoped metrics clients)
        from ..utils.metrics import NOOP
        from ..utils.metrics_defs import (
            FRONTEND_OPS,
            instrument_methods,
        )

        from ..utils.log import get_logger

        self._log = get_logger("cadence_tpu_torch.frontend")
        self.metrics = (metrics or NOOP).tagged(service="frontend")
        instrument_methods(self, self.metrics, FRONTEND_OPS)

    # -- request plumbing ----------------------------------------------

    def _check(
        self, domain_name: str,
        client_impl: str = "", feature_version: str = "",
    ) -> str:
        """Common preamble: version gate, rate limit, domain resolution.
        Returns the domain id."""
        self.versions.check(client_impl, feature_version)
        if not domain_name:
            raise BadRequestError("domain is not set")
        if len(domain_name) > _MAX_ID_LENGTH:
            raise BadRequestError("domain name too long")
        if not self.limiter.allow(domain_name):
            # shed with a retry-after hint (the bucket's refill
            # horizon) so well-behaved clients pace their re-offer
            # instead of hammering a saturated frontend; counted under
            # tags (service=frontend, domain=...) — the overload
            # dashboard's per-tenant shed rate
            self.metrics.tagged(domain=domain_name).inc(
                "frontend_requests_shed"
            )
            hint = getattr(self.limiter, "retry_after_s", None)
            raise ServiceBusyError(
                f"domain {domain_name} rate limit",
                retry_after_s=hint(domain_name) if hint else 0.0,
            )
        try:
            rec = self.domains.get_by_name(domain_name)
        except PersistenceEntityNotExistsError:
            raise EntityNotExistsServiceError(
                f"domain {domain_name} not found"
            )
        if rec.info.status != 0:
            raise EntityNotExistsServiceError(
                f"domain {domain_name} is deprecated"
            )
        return rec.info.id

    def _check_id(self, value: str, what: str) -> None:
        if not value:
            raise BadRequestError(f"{what} is not set")
        if len(value) > _MAX_ID_LENGTH:
            raise BadRequestError(f"{what} exceeds {_MAX_ID_LENGTH} chars")

    def _check_blob(self, payload: Optional[bytes], what: str) -> None:
        if payload and len(payload) > _DEFAULT_BLOB_LIMIT:
            raise BadRequestError(f"{what} exceeds the blob size limit")

    # -- domain API ----------------------------------------------------

    def register_domain(self, name: str, **kwargs) -> str:
        return self.domain_handler.register_domain(name, **kwargs)

    def describe_domain(self, name: str = "", id: str = ""):
        return self.domain_handler.describe_domain(name=name, id=id)

    def list_domains(self):
        return self.domain_handler.list_domains()

    def update_domain(self, name: str, **kwargs):
        return self.domain_handler.update_domain(name, **kwargs)

    def deprecate_domain(self, name: str) -> None:
        self.domain_handler.deprecate_domain(name)

    # -- workflow lifecycle --------------------------------------------

    def start_workflow_execution(
        self, request: StartWorkflowRequest, **headers
    ) -> str:
        self._check(request.domain, **headers)
        self._check_id(request.workflow_id, "workflowId")
        self._check_id(request.workflow_type, "workflowType")
        self._check_id(request.task_list, "taskList")
        self._check_blob(request.input, "input")
        self._check_cron(request.cron_schedule)
        return self.history.start_workflow_execution(request)

    @staticmethod
    def _check_cron(cron_schedule: str) -> None:
        if not cron_schedule:
            return
        from ..utils.cron import validate_cron_schedule

        try:
            validate_cron_schedule(cron_schedule)
        except ValueError as e:
            raise BadRequestError(str(e))

    def signal_workflow_execution(
        self, request: SignalRequest, **headers
    ) -> None:
        self._check(request.domain, **headers)
        self._check_id(request.workflow_id, "workflowId")
        self._check_id(request.signal_name, "signalName")
        self._check_blob(request.input, "signal input")
        self.history.signal_workflow_execution(request)

    def signal_with_start_workflow_execution(
        self, request: SignalWithStartRequest, **headers
    ) -> str:
        self._check(request.start.domain, **headers)
        self._check_id(request.start.workflow_id, "workflowId")
        # the embedded START must pass the same frontend limits as
        # start_workflow_execution — without these, oversized inputs /
        # overlong identifiers bypass the limits entirely on this path
        self._check_id(request.start.workflow_type, "workflowType")
        self._check_id(request.start.task_list, "taskList")
        self._check_blob(request.start.input, "workflow input")
        self._check_id(request.signal_name, "signalName")
        self._check_blob(request.signal_input, "signal input")
        self._check_cron(request.start.cron_schedule)
        return self.history.signal_with_start_workflow_execution(request)

    def terminate_workflow_execution(
        self, domain: str, workflow_id: str, run_id: str = "",
        reason: str = "", details: bytes = b"", identity: str = "",
        **headers,
    ) -> None:
        self._check(domain, **headers)
        self._check_id(workflow_id, "workflowId")
        self.history.terminate_workflow_execution(
            domain, workflow_id, run_id,
            reason=reason, details=details, identity=identity,
        )

    def request_cancel_workflow_execution(
        self, domain: str, workflow_id: str, run_id: str = "",
        identity: str = "", request_id: str = "", **headers,
    ) -> None:
        self._check(domain, **headers)
        self._check_id(workflow_id, "workflowId")
        self.history.request_cancel_workflow_execution(
            domain, workflow_id, run_id,
            identity=identity, request_id=request_id or str(uuid.uuid4()),
        )

    def reset_workflow_execution(
        self, domain: str, workflow_id: str, run_id: str = "",
        reason: str = "", decision_finish_event_id: int = 0,
        request_id: str = "", reset_type: str = "",
        bad_binary_checksum: str = "", **headers,
    ) -> str:
        """Reset at a decision boundary. Either an explicit
        ``decision_finish_event_id`` or a ``reset_type`` the handler
        resolves (reference tools/cli resetTypes):

          FirstDecisionCompleted | LastDecisionCompleted |
          BadBinary (with bad_binary_checksum: the event BEFORE that
          binary's first completed decision, i.e. undo its work)
        """
        self._check(domain, **headers)
        self._check_id(workflow_id, "workflowId")
        if not decision_finish_event_id:
            if not reset_type:
                raise BadRequestError(
                    "either decisionFinishEventId or resetType is "
                    "required"
                )
            if not run_id:
                # pin the concrete run NOW: resolving the reset point
                # against one run and resetting "the current run" later
                # races continue-as-new
                run_id = self.history.describe_workflow_execution(
                    domain, workflow_id
                ).run_id
            decision_finish_event_id = self._resolve_reset_point(
                domain, workflow_id, run_id, reset_type,
                bad_binary_checksum,
            )
        return self.history.reset_workflow_execution(
            domain, workflow_id, run_id,
            reason=reason,
            decision_finish_event_id=decision_finish_event_id,
            request_id=request_id,
        )

    def _resolve_reset_point(
        self, domain: str, workflow_id: str, run_id: str,
        reset_type: str, bad_binary_checksum: str,
    ) -> int:
        if not reset_type:
            raise BadRequestError(
                "either decisionFinishEventId or resetType is required"
            )
        events, _ = self.history.get_workflow_execution_history(
            domain, workflow_id, run_id
        )
        completed = [
            e for e in events
            if e.event_type == EventType.DecisionTaskCompleted
        ]
        if reset_type == "FirstDecisionCompleted":
            if not completed:
                raise BadRequestError("run has no completed decision")
            return completed[0].event_id
        if reset_type == "LastDecisionCompleted":
            if not completed:
                raise BadRequestError("run has no completed decision")
            return completed[-1].event_id
        if reset_type == "BadBinary":
            if not bad_binary_checksum:
                raise BadRequestError(
                    "BadBinary reset needs badBinaryChecksum"
                )
            # fork AT the bad binary's first completed decision: the
            # cut keeps everything before it and re-drives that
            # decision on a good binary (reference resetter uses the
            # reset point's FirstDecisionCompletedId)
            for e in completed:
                if e.attributes.get(
                    "binary_checksum", ""
                ) == bad_binary_checksum:
                    return e.event_id
            raise BadRequestError(
                f"binary {bad_binary_checksum!r} completed no decision "
                "in this run"
            )
        raise BadRequestError(f"unknown resetType {reset_type!r}")

    def query_workflow(
        self, domain: str, workflow_id: str, run_id: str = "",
        query_type: str = "", query_args: bytes = b"",
        timeout_s: float = 10.0, reject_not_open: bool = False,
        **headers,
    ) -> bytes:
        """reject_not_open: the reference's QueryRejectCondition — fail
        the query instead of answering from a closed run's state."""
        self._check(domain, **headers)
        self._check_id(workflow_id, "workflowId")
        self._check_id(query_type, "queryType")
        return self.history.query_workflow(
            domain, workflow_id, run_id,
            query_type=query_type, query_args=query_args,
            reject_not_open=reject_not_open,
            timeout_s=timeout_s,
        )

    def describe_workflow_execution(
        self, domain: str, workflow_id: str, run_id: str = "", **headers
    ):
        self._check(domain, **headers)
        self._check_id(workflow_id, "workflowId")
        return self.history.describe_workflow_execution(
            domain, workflow_id, run_id
        )

    def get_workflow_execution_history(
        self, domain: str, workflow_id: str, run_id: str = "",
        first_event_id: int = 1, page_size: int = 0, next_token: int = 0,
        wait_for_new_event: bool = False, **headers,
    ):
        self._check(domain, **headers)
        self._check_id(workflow_id, "workflowId")
        if next_token < 0:
            # a token this handler issued from the archive (negative
            # tag distinguishes it from live event-id tokens): resume
            # the archive read directly. Transient archiver failures
            # propagate (retryable), only a truly-missing blob is 404
            archived = self._archived_history(
                domain, workflow_id, run_id,
                first_event_id=first_event_id, page_size=page_size,
                next_token=-next_token, strict=True,
            )
            if archived is None:
                raise EntityNotExistsServiceError(
                    f"archived history for {workflow_id}/{run_id} "
                    "is gone"
                )
            return archived
        try:
            return self.history.get_workflow_execution_history(
                domain, workflow_id, run_id,
                first_event_id=first_event_id, page_size=page_size,
                next_token=next_token,
                wait_for_new_event=wait_for_new_event,
            )
        except EntityNotExistsServiceError:
            # retention already deleted the run: serve the archive
            # (reference workflowHandler.getArchivedHistory fallback).
            # Only a fresh read falls back — a live-issued token is an
            # event id, meaningless as an archive batch index
            if next_token:
                raise
            archived = self._archived_history(
                domain, workflow_id, run_id,
                first_event_id=first_event_id, page_size=page_size,
            )
            if archived is None:
                raise
            return archived

    def _archival_target(self, domain: str, kind: str):
        """(parsed URI, domain_id) when ``kind`` ('history'/'visibility')
        archival is enabled for the domain, else None."""
        from ..archival import URI
        from .domain_handler import ArchivalStatus

        rec = self.domains.get_by_name(domain)
        cfg = rec.config
        status = getattr(cfg, f"{kind}_archival_status")
        uri = getattr(cfg, f"{kind}_archival_uri")
        if status != ArchivalStatus.ENABLED or not uri:
            return None
        try:
            return URI.parse(uri), rec.info.id
        except Exception:
            # a malformed archival URI reads as "not archived", never
            # as an internal error on an unrelated request
            self._log.exception(
                f"domain {domain} has a malformed {kind} archival "
                f"URI {uri!r}"
            )
            return None

    def _archived_history(self, domain: str, workflow_id: str,
                          run_id: str, first_event_id: int = 1,
                          page_size: int = 0, next_token: int = 0,
                          strict: bool = False):

        if not run_id:
            return None  # the archive is keyed by concrete run
        target = self._archival_target(domain, "history")
        if target is None:
            return None
        uri, domain_id = target
        try:
            archiver = self._archival_provider().get_history_archiver(
                uri.scheme
            )
            batches, token = archiver.get(
                uri, domain_id, workflow_id, run_id,
                page_size=page_size, next_token=next_token,
            )
        except FileNotFoundError:
            return None
        except Exception:
            self._log.exception(
                f"archived-history read failed for {domain}/{workflow_id}"
            )
            if strict:
                # a resume KNOWS the blob exists — surface the
                # retryable failure instead of faking a permanent 404
                raise
            # fresh-read fallback: the caller re-raises the original
            # live-store NOT_FOUND
            return None
        events = [e for b in batches for e in b]
        if first_event_id > 1:
            events = [e for e in events if e.event_id >= first_event_id]
        # tag archive continuation tokens negative so the next request
        # routes back here instead of the live store
        return events, (-token if token else 0)

    def _archival_provider(self):
        if getattr(self, "_arch_provider", None) is None:
            from ..archival import ArchiverProvider

            self._arch_provider = ArchiverProvider.default()
        return self._arch_provider

    # -- worker APIs ---------------------------------------------------

    def poll_for_decision_task(
        self, domain: str, task_list: str, identity: str = "",
        timeout_s: float = 1.0, **headers,
    ):
        domain_id = self._check(domain, **headers)
        self._check_id(task_list, "taskList")
        return self.matching.poll_for_decision_task(
            PollRequest(domain_id, task_list, identity, timeout_s)
        )

    def poll_for_activity_task(
        self, domain: str, task_list: str, identity: str = "",
        timeout_s: float = 1.0, **headers,
    ):
        domain_id = self._check(domain, **headers)
        self._check_id(task_list, "taskList")
        return self.matching.poll_for_activity_task(
            PollRequest(domain_id, task_list, identity, timeout_s)
        )

    def respond_decision_task_completed(
        self, task_token: Dict[str, Any], decisions: List[Decision],
        **kwargs,
    ) -> None:
        self.history.respond_decision_task_completed(
            task_token, decisions, **kwargs
        )

    def respond_decision_task_failed(
        self, task_token: Dict[str, Any], **kwargs
    ) -> None:
        self.history.respond_decision_task_failed(task_token, **kwargs)

    def respond_activity_task_completed(self, task_token, **kwargs) -> None:
        self._check_blob(kwargs.get("result"), "activity result")
        self.history.respond_activity_task_completed(task_token, **kwargs)

    def respond_activity_task_failed(self, task_token, **kwargs) -> None:
        self.history.respond_activity_task_failed(task_token, **kwargs)

    def respond_activity_task_canceled(self, task_token, **kwargs) -> None:
        self.history.respond_activity_task_canceled(task_token, **kwargs)

    def record_activity_task_heartbeat(self, task_token, **kwargs):
        return self.history.record_activity_task_heartbeat(
            task_token, **kwargs
        )

    # ByID variants (workflowHandler RespondActivityTaskCompletedByID
    # etc.): resolve the task token from the pending-activity table
    def _activity_token_by_id(
        self, domain: str, workflow_id: str, run_id: str, activity_id: str
    ) -> Dict[str, Any]:
        domain_id = self._check(domain)
        desc = self.history.describe_workflow_execution(
            domain, workflow_id, run_id
        )
        for pa in desc.pending_activities:
            if pa["activity_id"] == activity_id:
                return {
                    "domain_id": domain_id,
                    "workflow_id": workflow_id,
                    "run_id": run_id or desc.run_id,
                    "schedule_id": pa["schedule_id"],
                    "started_id": 0,
                    "activity_id": activity_id,
                }
        raise EntityNotExistsServiceError(
            f"activity {activity_id} not pending"
        )

    def respond_activity_task_completed_by_id(
        self, domain: str, workflow_id: str, run_id: str,
        activity_id: str, **kwargs,
    ) -> None:
        token = self._activity_token_by_id(
            domain, workflow_id, run_id, activity_id
        )
        self.history.respond_activity_task_completed(token, **kwargs)

    def respond_activity_task_failed_by_id(
        self, domain: str, workflow_id: str, run_id: str,
        activity_id: str, **kwargs,
    ) -> None:
        token = self._activity_token_by_id(
            domain, workflow_id, run_id, activity_id
        )
        self.history.respond_activity_task_failed(token, **kwargs)

    def respond_activity_task_canceled_by_id(
        self, domain: str, workflow_id: str, run_id: str,
        activity_id: str, **kwargs,
    ) -> None:
        token = self._activity_token_by_id(
            domain, workflow_id, run_id, activity_id
        )
        self.history.respond_activity_task_canceled(token, **kwargs)

    def record_activity_task_heartbeat_by_id(
        self, domain: str, workflow_id: str, run_id: str,
        activity_id: str, **kwargs,
    ):
        token = self._activity_token_by_id(
            domain, workflow_id, run_id, activity_id
        )
        return self.history.record_activity_task_heartbeat(token, **kwargs)

    def respond_query_task_completed(
        self, task_list: str, query_id: str, result: bytes = b"",
        error: str = "",
    ) -> None:
        self.matching.respond_query_task_completed(
            task_list, query_id, result, error
        )

    def reset_sticky_task_list(
        self, domain: str, workflow_id: str, run_id: str = "", **headers
    ) -> None:
        self._check(domain, **headers)
        self.history.reset_sticky_task_list(domain, workflow_id, run_id)

    def describe_task_list(
        self, domain: str, task_list: str, task_type: int = 0, **headers
    ):
        domain_id = self._check(domain, **headers)
        return self.matching.describe_task_list(
            domain_id, task_list, task_type
        )

    def list_task_list_partitions(
        self, domain: str, task_list: str, **headers
    ) -> dict:
        """Partition layout + owning hosts (reference
        workflowHandler.ListTaskListPartitions)."""
        domain_id = self._check(domain, **headers)
        self._check_id(task_list, "taskList")
        out = self.matching.list_task_list_partitions(
            domain_id, task_list
        )
        # owner decoration is best-effort: an empty ring (startup
        # race) must not fail the listing itself
        monitor = getattr(self.matching, "monitor", None)
        if monitor is not None:
            resolver = monitor.resolver("matching")
            try:
                for plist in out.values():
                    for p in plist:
                        p["owner_host"] = resolver.lookup(
                            p["name"]
                        ).identity
            except RuntimeError:
                pass  # no hosts joined yet: return undecorated
        return out

    # -- visibility ----------------------------------------------------

    def _vis(self):
        if self.visibility is None:
            raise BadRequestError("visibility store not configured")
        return self.visibility

    def list_open_workflow_executions(
        self, domain: str, page_size: int = 100, next_token: int = 0,
        workflow_type: str = "", workflow_id: str = "",
        earliest_start: int = 0, latest_start: int = 2**63 - 1, **headers,
    ):
        domain_id = self._check(domain, **headers)
        return self._vis().list_open_workflow_executions(
            domain_id, earliest_start, latest_start,
            workflow_type, workflow_id, page_size, next_token,
        )

    def list_closed_workflow_executions(
        self, domain: str, page_size: int = 100, next_token: int = 0,
        workflow_type: str = "", workflow_id: str = "",
        close_status: int = -1,
        earliest_start: int = 0, latest_start: int = 2**63 - 1, **headers,
    ):
        domain_id = self._check(domain, **headers)
        return self._vis().list_closed_workflow_executions(
            domain_id, earliest_start, latest_start,
            workflow_type, workflow_id, close_status, page_size, next_token,
        )

    def list_workflow_executions(
        self, domain: str, query: str = "", page_size: int = 100,
        next_token: int = 0, **headers,
    ):
        """Advanced visibility: SQL-like query string
        (reference ListWorkflowExecutions + esql translation)."""
        domain_id = self._check(domain, **headers)
        vis = self._vis()
        if hasattr(vis, "list_workflow_executions"):
            return vis.list_workflow_executions(
                domain_id, query, page_size, next_token
            )
        raise BadRequestError("advanced visibility not configured")

    def scan_workflow_executions(
        self, domain: str, query: str = "", page_size: int = 100,
        next_token: int = 0, **headers,
    ):
        return self.list_workflow_executions(
            domain, query, page_size, next_token, **headers
        )

    def health(self) -> dict:
        """Liveness probe (reference workflowHandler.Health)."""
        return {"ok": True, "service": "frontend"}

    def get_cluster_info(self) -> dict:
        """Server capabilities + supported client versions (reference
        workflowHandler.GetClusterInfo)."""
        return {
            "supported_client_versions": dict(self.versions.supported),
            "server": "cadence-tpu",
        }

    def list_archived_workflow_executions(
        self, domain: str, query: str = "", page_size: int = 100,
        next_token: int = 0, **headers,
    ):
        """Query the domain's visibility archive (reference
        workflowHandler.ListArchivedWorkflowExecutions — serves records
        whose retention already deleted them from live visibility)."""
        self._check(domain, **headers)
        target = self._archival_target(domain, "visibility")
        if target is None:
            raise BadRequestError(
                f"domain {domain} has no visibility archival enabled"
            )
        uri, domain_id = target
        archiver = self._archival_provider().get_visibility_archiver(
            uri.scheme
        )
        return archiver.query(
            uri, domain_id, query,
            page_size=page_size, next_token=next_token,
        )

    def count_workflow_executions(
        self, domain: str, query: str = "", **headers
    ) -> int:
        domain_id = self._check(domain, **headers)
        vis = self._vis()
        if query:
            if not hasattr(vis, "count_workflow_executions_by_query"):
                # answering the TOTAL count for a filtered query would
                # be a silently wrong answer
                raise BadRequestError(
                    "advanced visibility is not configured; "
                    "count with a query is unavailable"
                )
            return vis.count_workflow_executions_by_query(domain_id, query)
        return vis.count_workflow_executions(domain_id)

    def get_search_attributes(self) -> Dict[str, str]:
        """Valid search attribute keys (reference GetSearchAttributes)."""
        from ..visibility.search_attributes import (
            DEFAULT_SEARCH_ATTRIBUTES,
        )

        return dict(DEFAULT_SEARCH_ATTRIBUTES)
