"""Archiver: archival as a system workflow.

Reference: service/worker/archiver/ — client_worker.go (the archival
system workflow + activities on a system domain), workflow.go:39 /
pump.go:83 (drain a batch of signaled archival requests, then
continue-as-new), activities.go:52-122 (uploadHistoryActivity /
archiveVisibilityActivity / deleteHistoryActivity). The trigger side is
the history close-execution processor (archivalClient.Archive →
SignalWithStart on the system workflow).

A copy of the reference package's ``worker/archiver.py``; the port's
``ArchivalClient.attach`` wires the trigger onto a history service's
close processors (the Onebox twin and ``config.start_services`` use it).
"""

from __future__ import annotations

import json
from typing import Optional

from ..archival import (
    ArchiveHistoryRequest,
    ArchiveVisibilityRequest,
    ArchiverProvider,
    HistoryIterator,
    URI,
)
from ..runtime.api import (
    SignalWithStartRequest,
    StartWorkflowRequest,
)

from .sdk import ActivityError, Worker

SYSTEM_DOMAIN = "cadence-system"
ARCHIVAL_WORKFLOW_TYPE = "cadence-sys-archival-workflow"
ARCHIVAL_WORKFLOW_ID = "cadence-archival"
ARCHIVAL_TASK_LIST = "cadence-archival-tl"
ARCHIVAL_SIGNAL = "archival-request"
_REQUESTS_PER_RUN = 500  # pump.go batch before continue-as-new


class ArchivalClient:
    """Trigger side, called by the transfer close processor."""

    def __init__(self, frontend, domain_cache) -> None:
        self.frontend = frontend
        self.domains = domain_cache

    def maybe_archive(self, task, snap: dict) -> None:
        """Signal the archival workflow when the domain archives."""
        from ..frontend.domain_handler import ArchivalStatus

        rec = self.domains.get_by_id(task.domain_id)
        cfg = rec.config
        want_history = (
            cfg.history_archival_status == ArchivalStatus.ENABLED
            and cfg.history_archival_uri
        )
        want_visibility = (
            cfg.visibility_archival_status == ArchivalStatus.ENABLED
            and cfg.visibility_archival_uri
        )
        if not want_history and not want_visibility:
            return
        branch_token = snap.get("branch_token", b"")
        payload = {
            "domain_id": task.domain_id,
            "domain_name": rec.info.name,
            "workflow_id": task.workflow_id,
            "run_id": task.run_id,
            "branch_token": (
                branch_token.decode()
                if isinstance(branch_token, bytes)
                else branch_token
            ),
            "workflow_type": snap["workflow_type"],
            "start_time": snap["start_time"],
            "close_time": snap["close_time"],
            "close_status": snap["close_status"],
            "history_length": snap["history_length"],
            "history_uri": cfg.history_archival_uri if want_history else "",
            "visibility_uri": (
                cfg.visibility_archival_uri if want_visibility else ""
            ),
        }
        self.frontend.signal_with_start_workflow_execution(
            SignalWithStartRequest(
                start=StartWorkflowRequest(
                    domain=SYSTEM_DOMAIN,
                    workflow_id=ARCHIVAL_WORKFLOW_ID,
                    workflow_type=ARCHIVAL_WORKFLOW_TYPE,
                    task_list=ARCHIVAL_TASK_LIST,
                    execution_start_to_close_timeout_seconds=3600 * 24,
                    task_start_to_close_timeout_seconds=30,
                ),
                signal_name=ARCHIVAL_SIGNAL,
                signal_input=json.dumps(payload).encode(),
            )
        )

    def attach(self, history_service) -> None:
        """Become the archival trigger of every close processor of the
        shards ``history_service`` owns now."""
        controller = history_service.controller
        for shard_id in controller.owned_shards():
            for p in controller._handles[shard_id].processors:
                if hasattr(p, "_process_close"):
                    p.archival_client = self


# transient store errors must not fail the system run: one poisoned
# upload would kill every other buffered request on it (the reference
# retries archival activities with an unlimited-attempt policy,
# service/worker/archiver/activities.go)
_ARCHIVE_RETRY = {
    "initial_interval_seconds": 2,
    "backoff_coefficient": 2.0,
    "maximum_interval_seconds": 60,
    "maximum_attempts": 10,
}


def _archive_one(ctx, payload):
    try:
        yield ctx.schedule_activity(
            "upload_history", payload,
            start_to_close_timeout_seconds=300,
            retry_policy=_ARCHIVE_RETRY,
        )
        yield ctx.schedule_activity(
            "archive_visibility", payload,
            start_to_close_timeout_seconds=60,
            retry_policy=_ARCHIVE_RETRY,
        )
    except ActivityError:
        # retry budget exhausted for THIS request: drop it, keep the
        # pump alive for the other buffered requests
        pass


def archival_workflow(ctx, input: bytes):
    """Drain archival-request signals; continue-as-new after a batch
    (reference workflow.go + pump.go)."""
    handled = int(input or b"0")
    while handled < _REQUESTS_PER_RUN:
        payload = yield ctx.wait_signal(ARCHIVAL_SIGNAL)
        yield from _archive_one(ctx, payload)
        handled += 1
    # drain signals already recorded but not yet consumed — continuing
    # as new would orphan them (pump.go drains before CAN)
    while True:
        payload = yield ctx.poll_signal(ARCHIVAL_SIGNAL)
        if payload is None:
            break
        yield from _archive_one(ctx, payload)
    yield ctx.continue_as_new(b"0")


class ArchiverActivities:
    def __init__(
        self, history_manager, provider: Optional[ArchiverProvider] = None
    ) -> None:
        self.history = history_manager
        self.provider = provider or ArchiverProvider.default()

    def upload_history(self, payload: bytes) -> bytes:
        req = json.loads(payload)
        if not req.get("history_uri"):
            return b"skipped"
        uri = URI.parse(req["history_uri"])
        archiver = self.provider.get_history_archiver(uri.scheme)
        # resolve the branch token from the run's mutable state
        branch_token = req.get("branch_token", "").encode()
        if not branch_token:
            branch_token = self._branch_token_of(req)
            if branch_token is None:
                return b"no-branch"
        batches = HistoryIterator(self.history, branch_token).all_batches()
        archiver.archive(
            uri,
            ArchiveHistoryRequest(
                domain_id=req["domain_id"],
                domain_name=req.get("domain_name", ""),
                workflow_id=req["workflow_id"],
                run_id=req["run_id"],
            ),
            batches,
        )
        return b"uploaded"

    def _branch_token_of(self, req) -> Optional[bytes]:
        execution = getattr(self, "execution_manager", None)
        shard_resolver = getattr(self, "shard_resolver", None)
        if execution is None or shard_resolver is None:
            return None
        shard_id = shard_resolver(req["workflow_id"])
        try:
            resp = execution.get_workflow_execution(
                shard_id, req["domain_id"], req["workflow_id"], req["run_id"]
            )
        except Exception:
            return None
        raw = resp.snapshot.get("execution_info", {}).get("branch_token", b"")
        return raw if isinstance(raw, bytes) else str(raw).encode()

    def archive_visibility(self, payload: bytes) -> bytes:
        req = json.loads(payload)
        if not req.get("visibility_uri"):
            return b"skipped"
        uri = URI.parse(req["visibility_uri"])
        archiver = self.provider.get_visibility_archiver(uri.scheme)
        archiver.archive(
            uri,
            ArchiveVisibilityRequest(
                domain_id=req["domain_id"],
                domain_name=req.get("domain_name", ""),
                workflow_id=req["workflow_id"],
                run_id=req["run_id"],
                workflow_type=req.get("workflow_type", ""),
                start_time=req.get("start_time", 0),
                close_time=req.get("close_time", 0),
                close_status=req.get("close_status", 0),
                history_length=req.get("history_length", 0),
            ),
        )
        return b"archived"


def build_archiver_worker(
    frontend, history_manager, execution_manager=None,
    shard_resolver=None, provider: Optional[ArchiverProvider] = None,
) -> Worker:
    """Assemble the archival system worker (client_worker.go)."""
    acts = ArchiverActivities(history_manager, provider)
    acts.execution_manager = execution_manager
    acts.shard_resolver = shard_resolver
    w = Worker(frontend, SYSTEM_DOMAIN, ARCHIVAL_TASK_LIST,
               identity="archiver")
    w.register_workflow(ARCHIVAL_WORKFLOW_TYPE, archival_workflow)
    w.register_activity("upload_history", acts.upload_history)
    w.register_activity("archive_visibility", acts.archive_visibility)
    return w
