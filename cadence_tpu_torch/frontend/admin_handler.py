"""Admin API.

Reference: service/frontend/adminHandler.go — operator-facing RPCs:
DescribeHistoryHost (shard distribution), CloseShard, RemoveTask,
raw history reads for replication debugging, and an admin
DescribeWorkflowExecution exposing the shard id + raw mutable state.

A copy of the reference package's ``frontend/admin_handler.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..runtime.api import BadRequestError, EntityNotExistsServiceError
from ..runtime.persistence.errors import EntityNotExistsError


class AdminHandler:
    def __init__(self, history_service, domain_cache, bus=None) -> None:
        self.history = history_service
        self.domains = domain_cache
        # message bus for DLQ operator verbs (None on hosts that don't
        # run the messaging plane)
        self.bus = bus

    # -- elastic resharding (runtime/resharding.py) --------------------

    @property
    def resharder(self):
        """The host's shared reshard coordinator — built and owned by
        ``HistoryService.reshard_coordinator()`` so the admin verbs and
        the capacity autopilot serialize plans on the SAME coordinator
        lock (one plan at a time is a host property, not a caller
        property). Multi-host in-process clusters build their own
        coordinator spanning every controller."""
        return self.history.reshard_coordinator()

    def reshard_split(self, shard_id: int) -> Dict[str, Any]:
        """Online shard split 1→2 (admin verb; returns the committed
        plan record)."""
        self._check_resharding_enabled()
        return self.resharder.split(int(shard_id)).to_dict()

    def reshard_merge(self, source_id: int, target_id: int) -> Dict[str, Any]:
        """Online shard merge 2→1."""
        self._check_resharding_enabled()
        return self.resharder.merge(int(source_id), int(target_id)).to_dict()

    def reshard_status(self) -> Dict[str, Any]:
        """Current routing epoch + the last plan's write-ahead record."""
        return self.resharder.status()

    def _check_resharding_enabled(self) -> None:
        cfg = getattr(self.history, "resharding_config", None)
        if cfg is not None and not cfg.enabled:
            raise BadRequestError("resharding is disabled by config")

    # -- capacity autopilot (runtime/autopilot.py) ---------------------

    def _require_autopilot(self):
        ap = getattr(self.history, "autopilot", None)
        if ap is None:
            raise BadRequestError(
                "capacity autopilot is not enabled on this host"
            )
        return ap

    def autopilot_status(self) -> Dict[str, Any]:
        """The controller's full decision state: setpoints, EWMAs, gate
        + freeze + pause flags, cooldowns, last sensed reading."""
        return self._require_autopilot().status()

    def autopilot_pause(self, reason: str = "") -> Dict[str, Any]:
        """Operator override: stop actuating (sensing continues) until
        ``autopilot_resume``. The last word stays with the human."""
        ap = self._require_autopilot()
        ap.pause(reason or "admin verb")
        return ap.status()

    def autopilot_resume(self) -> Dict[str, Any]:
        ap = self._require_autopilot()
        ap.resume()
        return ap.status()

    def describe_queue_states(self, shard_id: int) -> Dict[str, Any]:
        """Per-queue cursor/depth introspection for one owned shard
        (reference tools/cli/adminQueueCommands.go DescribeQueue) —
        collection lives on HistoryService, next to describe()."""
        try:
            return self.history.describe_queue_states(shard_id)
        except KeyError:
            raise EntityNotExistsServiceError(
                f"shard {shard_id} is not owned by this host"
            )

    # -- DLQ verbs (reference tools/cli/adminDLQCommands.go over
    # adminHandler Get/Purge/MergeDLQMessages) -------------------------

    def _require_bus(self):
        if self.bus is None:
            raise BadRequestError("no message bus on this host")
        return self.bus

    def read_dlq_messages(
        self, topic: str, last_message_id: int = -1, count: int = 100,
    ) -> List[Dict[str, Any]]:
        msgs = self._require_bus().dlq_read(topic, last_message_id, count)
        return [
            {
                "offset": m.offset,
                "key": m.key,
                "value": m.value,
                "redelivery_count": m.redelivery_count,
            }
            for m in msgs
        ]

    def purge_dlq_messages(
        self, topic: str, last_message_id: int = -1,
    ) -> int:
        return self._require_bus().dlq_purge(topic, last_message_id)

    def merge_dlq_messages(
        self, topic: str, last_message_id: int = -1,
    ) -> int:
        return self._require_bus().dlq_merge(topic, last_message_id)

    def dump_traces(self, trace_id: str = "") -> Dict[str, Any]:
        """The tracing flight recorder (utils/tracing.py) as
        Chrome-trace-format JSON — the RPC twin of
        ``GET /debug/pprof/traces``. ``trace_id`` filters to one
        request's trace; empty dumps the whole ring buffer."""
        from ..utils.tracing import TRACER

        return TRACER.chrome_trace(trace_id or None)

    def describe_history_host(self) -> Dict[str, Any]:
        desc = self.history.describe()
        desc["host"] = self.history.monitor.self_identity
        return desc

    def close_shard(self, shard_id: int) -> None:
        """Force-release one shard (reference adminHandler.CloseShard)."""
        self.history.controller.release_shard(shard_id)

    def remove_task(self, shard_id: int, task_type: str, task_id: int,
                    visibility_timestamp: int = 0) -> None:
        """Surgically drop a poisoned queue task."""
        execution = self.history.persistence.execution
        if task_type == "transfer":
            execution.complete_transfer_task(shard_id, task_id)
        elif task_type == "timer":
            execution.complete_timer_task(
                shard_id, visibility_timestamp, task_id
            )
        elif task_type == "replication":
            execution.complete_replication_task(shard_id, task_id)
        else:
            raise BadRequestError(f"unknown task type {task_type!r}")

    def get_workflow_execution_raw_history(
        self, domain_name: str, workflow_id: str, run_id: str,
        start_event_id: int = 1, end_event_id: int = 1 << 60,
    ):
        """Raw batches + version-history items (replication debugging)."""
        domain_id = self.domains.get_by_name(domain_name).info.id
        return self.history.get_workflow_history_raw(
            domain_id, workflow_id, run_id, start_event_id, end_event_id
        )

    def refresh_workflow_tasks(
        self, domain_name: str, workflow_id: str, run_id: str = ""
    ) -> Dict[str, Any]:
        """Regenerate a run's queue tasks from state (reference
        adminHandler.RefreshWorkflowTasks) — pairs with remove_task for
        recovering from a poisoned or lost task."""
        domain_id = self.domains.get_by_name(domain_name).info.id
        engine = self.history.controller.get_engine(workflow_id)
        n = engine.refresh_workflow_tasks(domain_id, workflow_id, run_id)
        return {"tasks_generated": n}

    def admin_describe_workflow_execution(
        self, domain_name: str, workflow_id: str, run_id: str = ""
    ) -> Dict[str, Any]:
        """RPC-reachable name for the admin variant: the frontend
        endpoint dispatches by name across [frontend, admin] targets
        with first-match, so the shared name
        ``describe_workflow_execution`` always resolves to the PUBLIC
        WorkflowHandler — this alias keeps the admin introspection
        surface reachable over the wire."""
        return self.describe_workflow_execution(
            domain_name, workflow_id, run_id
        )

    def describe_workflow_execution(
        self, domain_name: str, workflow_id: str, run_id: str = ""
    ) -> Dict[str, Any]:
        """Admin variant: shard id + raw mutable-state snapshot."""
        domain_id = self.domains.get_by_name(domain_name).info.id
        # epoch-versioned routing: the controller's ShardMap, not a
        # static modulo (a resharded workflow lives on its NEW shard)
        shard_id = self.history.controller.shard_for(workflow_id)
        engine = self.history.controller.get_engine_for_shard(shard_id)
        if not run_id:
            run_id = engine._current_run_id(domain_id, workflow_id)
        try:
            resp = engine.shard.persistence.execution.get_workflow_execution(
                shard_id, domain_id, workflow_id, run_id
            )
        except EntityNotExistsError:
            raise EntityNotExistsServiceError(
                f"workflow {workflow_id}/{run_id} not found"
            )
        return {
            "shard_id": shard_id,
            "history_host": self.history.monitor.self_identity,
            "mutable_state": resp.snapshot,
            "next_event_id": resp.next_event_id,
        }
