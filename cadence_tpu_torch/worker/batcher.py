"""Batcher: bulk terminate/cancel/signal as a system workflow.

Reference: service/worker/batcher/ — batcher.go + workflow.go: a batch
request (operation + target query/list) runs as a workflow whose
activity pages through matching executions applying the operation with
a rate cap, heartbeating progress.

A copy of the reference package's ``worker/batcher.py``.
"""

from __future__ import annotations

import json
from typing import List, Optional

from ..runtime.api import SignalRequest
from ..utils.quotas import TokenBucket

from .sdk import Worker, activity_heartbeat
from .archiver import SYSTEM_DOMAIN

BATCHER_WORKFLOW_TYPE = "cadence-sys-batch-workflow"
BATCHER_TASK_LIST = "cadence-batcher-tl"


def batch_workflow(ctx, input: bytes):
    """input: json {operation, domain, query|executions, params}."""
    summary = yield ctx.schedule_activity(
        "run_batch", input, start_to_close_timeout_seconds=3600,
        heartbeat_timeout_seconds=120,
    )
    return summary


class BatcherActivities:
    def __init__(self, frontend) -> None:
        self.frontend = frontend

    # per-activity RPS cap (reference batcher DefaultRPS); burst 1 makes
    # the cap a hard pace, not a front-loaded burst
    DEFAULT_RPS = 50.0

    def run_batch(self, payload: bytes) -> bytes:
        import time as _time

        req = json.loads(payload)
        operation = req["operation"]
        if operation not in ("terminate", "cancel", "signal"):
            raise ValueError(f"unknown operation {operation!r}")
        domain = req["domain"]
        params = req.get("params", {})
        bucket = TokenBucket(float(params.get("rps", self.DEFAULT_RPS)),
                             burst=1)
        done = 0
        errors: List[str] = []
        for wf_id, run_id in self._targets(req):
            while not bucket.allow():
                _time.sleep(0.005)
            try:
                if operation == "terminate":
                    self.frontend.terminate_workflow_execution(
                        domain, wf_id, run_id,
                        reason=params.get("reason", "batch terminate"),
                    )
                elif operation == "cancel":
                    self.frontend.request_cancel_workflow_execution(
                        domain, wf_id, run_id
                    )
                elif operation == "signal":
                    self.frontend.signal_workflow_execution(
                        SignalRequest(
                            domain=domain, workflow_id=wf_id, run_id=run_id,
                            signal_name=params.get("signal_name", ""),
                            input=params.get(
                                "signal_input", ""
                            ).encode(),
                        )
                    )
                done += 1
            except Exception as e:
                errors.append(f"{wf_id}: {e}")
        return json.dumps(
            {"done": done, "failed": len(errors), "errors": errors[:10]}
        ).encode()

    def _targets(self, req):
        """Stream targets page-by-page (a 100k-execution query must not
        be materialized in one list), heartbeating once per page so a
        dead worker is detected within the heartbeat window instead of
        the full start-to-close timeout."""
        if req.get("executions"):
            for e in req["executions"]:
                yield (e["workflow_id"], e.get("run_id", ""))
            return
        query = req.get("query", "")
        token = 0
        while True:
            recs, token = self.frontend.list_workflow_executions(
                req["domain"], query, page_size=200, next_token=token
            )
            activity_heartbeat(str(len(recs)).encode())
            for r in recs:
                yield (r.workflow_id, r.run_id)
            if not token:
                return


def build_batcher_worker(frontend) -> Worker:
    acts = BatcherActivities(frontend)
    w = Worker(frontend, SYSTEM_DOMAIN, BATCHER_TASK_LIST,
               identity="batcher")
    w.register_workflow(BATCHER_WORKFLOW_TYPE, batch_workflow)
    w.register_activity("run_batch", acts.run_batch)
    return w
