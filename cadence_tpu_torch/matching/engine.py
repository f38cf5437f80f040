"""MatchingEngine: task-list manager registry + Add/Poll task RPCs.

Reference: Cadence service/matching/matchingEngine.go:118-683 —
AddDecisionTask/AddActivityTask persist-or-sync-match through a
taskListManager; PollForDecisionTask/PollForActivityTask rendezvous with
the matcher then call back into history (RecordDecisionTaskStarted /
RecordActivityTaskStarted) to materialize the Started event before
returning the task to the worker.

A copy of the reference package's ``matching/engine.py``.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
import uuid
from typing import Dict, Optional

from ..runtime.api import (
    EntityNotExistsServiceError,
    PollForActivityTaskResponse,
    PollForDecisionTaskResponse,
    ServiceBusyError,
)
from ..runtime.persistence.interfaces import TaskManager
from ..runtime.persistence.records import TaskInfo
from ..utils.clock import RealTimeSource, TimeSource
from ..utils.dynamicconfig import Collection
from ..utils.locks import make_guarded, make_lock
from ..utils.log import get_logger
from ..utils.metrics import NOOP, Scope

from .forwarder import Forwarder
from .matcher import TaskMatcher
from .poller_history import PollerHistory
from .task_list import (
    TASK_TYPE_ACTIVITY,
    TASK_TYPE_DECISION,
    InternalTask,
    TaskListID,
    TaskListManager,
)


@dataclasses.dataclass
class PollRequest:
    domain_id: str
    task_list: str
    identity: str = ""
    timeout_s: float = 1.0


class MatchingEngine:
    def __init__(
        self,
        task_manager: TaskManager,
        history_client,  # record_decision_task_started / record_activity_task_started
        config: Optional[Collection] = None,
        time_source: Optional[TimeSource] = None,
        metrics: Scope = NOOP,
        poll_request_id_fn=None,
        rate_limiter=None,
    ) -> None:
        self._store = task_manager
        self._history = history_client
        self._time = time_source or RealTimeSource()
        # poll-delivery nonce for the started-event dedup handshake.
        # Default: a fresh uuid per dequeued task. Injectable (called
        # with the TaskInfo) so deterministic harnesses — the chaos
        # suite's byte-identical differential replay — can derive it
        # from the task instead of entropy.
        self._poll_request_id_fn = poll_request_id_fn
        self._log = get_logger("cadence_tpu_torch.matching")
        self.metrics = metrics.tagged(service="matching")
        # per-API requests/latency/errors (ref common/metrics/defs.go
        # matching scopes)
        from ..utils.metrics_defs import (
            MATCHING_OPS,
            instrument_methods,
        )

        instrument_methods(self, self.metrics, MATCHING_OPS)
        self._lock = make_lock("MatchingEngine._lock")
        self._managers: Dict[tuple, TaskListManager] = make_guarded(
            {}, "MatchingEngine._managers", self._lock
        )
        self._creating: Dict[tuple, object] = make_guarded(
            {}, "MatchingEngine._creating", self._lock
        )
        self._pollers: Dict[tuple, PollerHistory] = {}
        cfg = config or Collection()
        self._n_write_partitions = cfg.int_property(
            "matching.numTasklistWritePartitions", 1
        )
        self._n_read_partitions = cfg.int_property(
            "matching.numTasklistReadPartitions", 1
        )
        self._tasklist_rps = cfg.float_property("matching.rps", 100000.0)
        # overload control: a MultiStageRateLimiter over
        # task ADDS (polls stay unmetered — a parked poller is the
        # backpressure, not the overload). None (the default) is one
        # attribute read per add
        self.rate_limiter = rate_limiter
        # in-flight sync queries: query_id → (event, result slot)
        self._query_lock = make_lock("MatchingEngine._query_lock")
        self._pending_queries: Dict[str, tuple] = make_guarded(
            {}, "MatchingEngine._pending_queries", self._query_lock
        )

    # -- manager registry ----------------------------------------------

    def _get_manager(self, tl_id: TaskListID) -> TaskListManager:
        key = tl_id.key()
        with self._lock:
            mgr = self._managers.get(key)
            if mgr is not None:
                return mgr
            # per-key creation lock: construction leases from the store
            # (blocking I/O) and starts threads — it must run outside
            # the engine lock, but TWO racing constructors would both
            # take store leases, fencing each other's rangeID and
            # churning the lease on every creation race.
            # Serializing per key means the loser never constructs.
            creating_lock = self._creating.setdefault(
                key, make_lock("MatchingEngine.creating_lock")
            )
        with creating_lock:
            with self._lock:
                mgr = self._managers.get(key)
            if mgr is not None:
                return mgr
            forwarder = Forwarder(tl_id, self)
            from ..utils.quotas import TokenBucket

            matcher = TaskMatcher(
                # matching.rps dynamic config, read at manager creation
                # (reference taskListManager rate limiter)
                rate_limiter=TokenBucket(self._tasklist_rps()),
                forward_offer=(
                    forwarder.forward_offer if forwarder.enabled else None
                ),
                forward_poll=(
                    forwarder.forward_poll if forwarder.enabled else None
                ),
            )
            fresh = TaskListManager(
                tl_id, self._store, matcher, time_source=self._time
            )
            with self._lock:
                # NOTE: the _creating entry is deliberately never popped
                # — a racer still parked on this lock object must
                # re-check through the SAME lock after an unload/
                # re-create cycle, or two constructors can race again.
                # Cardinality is bounded by distinct task lists, same
                # as _pollers.
                self._managers[key] = fresh
            return fresh

    def _pick_partition(self, domain_id: str, name: str, write: bool) -> str:
        if TaskListID("", name, 0).is_partition:
            return name  # already partition-addressed
        n = (
            self._n_write_partitions(domain=domain_id, task_list=name)
            if write
            else self._n_read_partitions(domain=domain_id, task_list=name)
        )
        if n <= 1:
            return name
        return TaskListID.partition_name(name, random.randrange(n))

    # -- add (called by history transfer queue) ------------------------

    def _add_task(
        self, domain_id: str, name: str, task_type: int, info: TaskInfo
    ) -> bool:
        lim = self.rate_limiter
        if lim is not None and not lim.allow(domain_id):
            # retryable shed: the queue processor's at-least-once
            # retry re-offers the task after the hint — coordinated
            # backpressure instead of unbounded task-list growth
            hint = getattr(lim, "retry_after_s", None)
            raise ServiceBusyError(
                f"matching overloaded (domain {domain_id})",
                retry_after_s=hint(domain_id) if hint else 0.0,
            )
        part = self._pick_partition(domain_id, name, write=True)
        mgr = self._get_manager(TaskListID(domain_id, part, task_type))
        return mgr.add_task(info)

    def add_decision_task(
        self,
        domain_id: str,
        workflow_id: str,
        run_id: str,
        task_list: str,
        schedule_id: int,
        schedule_to_start_timeout_seconds: int = 0,
    ) -> bool:
        return self._add_task(
            domain_id, task_list, TASK_TYPE_DECISION,
            TaskInfo(
                domain_id=domain_id, workflow_id=workflow_id, run_id=run_id,
                task_id=0, schedule_id=schedule_id,
                schedule_to_start_timeout_seconds=schedule_to_start_timeout_seconds,
            ),
        )

    def add_activity_task(
        self,
        domain_id: str,
        workflow_id: str,
        run_id: str,
        task_list: str,
        schedule_id: int,
        schedule_to_start_timeout_seconds: int = 0,
    ) -> bool:
        return self._add_task(
            domain_id, task_list, TASK_TYPE_ACTIVITY,
            TaskInfo(
                domain_id=domain_id, workflow_id=workflow_id, run_id=run_id,
                task_id=0, schedule_id=schedule_id,
                schedule_to_start_timeout_seconds=schedule_to_start_timeout_seconds,
            ),
        )

    # -- poll (called by workers via frontend) -------------------------

    def _poll_loop(self, req: PollRequest, task_type: int):
        """Poll → record-started → respond; stale tasks are acked and the
        poll continues until the deadline (matchingEngine.getTask loop)."""
        part = self._pick_partition(req.domain_id, req.task_list, write=False)
        tl_id = TaskListID(req.domain_id, part, task_type)
        mgr = self._get_manager(tl_id)
        self._poller_history(tl_id).record(req.identity)
        deadline = time.monotonic() + req.timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None, None
            task: Optional[InternalTask] = mgr.get_task(remaining)
            if task is None:
                if mgr.matcher.is_shutdown:
                    # unload/shutdown raced this long poll: get_task now
                    # returns instantly — re-looping would busy-spin at
                    # full speed for the rest of the poll deadline
                    return None, None
                continue  # interrupted or forwarded miss; re-check deadline
            info = task.info
            if task.query is not None:
                # sync query task: no started event, no history write
                task.finish(None)
                return task, {"query": task.query}
            request_id = (
                self._poll_request_id_fn(info)
                if self._poll_request_id_fn is not None
                else str(uuid.uuid4())
            )
            try:
                if task_type == TASK_TYPE_DECISION:
                    resp = self._history.record_decision_task_started(
                        info.domain_id, info.workflow_id, info.run_id,
                        info.schedule_id, request_id, req.identity,
                    )
                else:
                    resp = self._history.record_activity_task_started(
                        info.domain_id, info.workflow_id, info.run_id,
                        info.schedule_id, request_id, req.identity,
                    )
            except EntityNotExistsServiceError as e:
                task.finish(e)  # stale task (already started/completed)
                continue
            except Exception as e:  # transient history failure
                task.finish(e)
                if task.sync:
                    # a sync-matched task was never persisted; dropping
                    # it here would strand the workflow until a timeout
                    # fires — put it on the backlog for redelivery
                    try:
                        mgr.add_task(info)
                    except Exception:
                        self._log.exception(
                            "failed to re-enqueue sync-matched task "
                            f"{info.workflow_id}/{info.schedule_id}"
                        )
                raise
            task.finish(None)
            return task, resp

    def poll_for_decision_task(
        self, req: PollRequest
    ) -> Optional[PollForDecisionTaskResponse]:
        task, resp = self._poll_loop(req, TASK_TYPE_DECISION)
        if task is None:
            return None
        if "query" in resp:
            q = resp["query"]
            return PollForDecisionTaskResponse(
                task_token={"query_id": q["query_id"]},
                workflow_id=task.info.workflow_id,
                run_id=task.info.run_id,
                workflow_type="",
                previous_started_event_id=0,
                started_event_id=0,
                attempt=0,
                history=[],
                query=q,
            )
        return PollForDecisionTaskResponse(
            task_token=resp["task_token"],
            workflow_id=task.info.workflow_id,
            run_id=task.info.run_id,
            workflow_type=resp["workflow_type"],
            previous_started_event_id=resp["previous_started_event_id"],
            started_event_id=resp["started_event_id"],
            attempt=resp["attempt"],
            history=resp["history"],
            queries=resp.get("queries") or {},
        )

    def poll_for_activity_task(
        self, req: PollRequest
    ) -> Optional[PollForActivityTaskResponse]:
        task, resp = self._poll_loop(req, TASK_TYPE_ACTIVITY)
        if task is None:
            return None
        scheduled = resp["scheduled_event"]
        attrs = scheduled.attributes if scheduled is not None else {}
        return PollForActivityTaskResponse(
            task_token=resp["task_token"],
            workflow_id=task.info.workflow_id,
            run_id=task.info.run_id,
            activity_id=resp["activity_id"],
            activity_type=attrs.get("activity_type", ""),
            input=attrs.get("input", b""),
            scheduled_timestamp=resp["scheduled_time"],
            started_timestamp=resp["started_time"],
            schedule_to_close_timeout_seconds=resp[
                "schedule_to_close_timeout_seconds"
            ],
            start_to_close_timeout_seconds=resp["start_to_close_timeout_seconds"],
            heartbeat_timeout_seconds=resp["heartbeat_timeout_seconds"],
            attempt=resp["attempt"],
            heartbeat_details=resp["heartbeat_details"],
        )

    # -- sync query (matcher OfferQuery / RespondQueryTaskCompleted) ----

    def query_workflow(
        self,
        domain_id: str,
        task_list: str,
        workflow_id: str,
        run_id: str,
        query_type: str,
        query_args: bytes = b"",
        timeout_s: float = 10.0,
    ) -> bytes:
        """Dispatch a query task to a live poller and wait for its
        answer (reference matchingEngine.QueryWorkflow — queries are
        never persisted; no poller in time → query fails)."""
        from ..runtime.api import QueryFailedError

        query_id = str(uuid.uuid4())
        info = TaskInfo(
            domain_id=domain_id, workflow_id=workflow_id, run_id=run_id,
            task_id=-1, schedule_id=-1,
        )
        task = InternalTask(info, finish=None, sync=True)
        task.query = {
            "query_id": query_id,
            "query_type": query_type,
            "query_args": query_args,
        }
        done = threading.Event()
        slot: dict = {}
        with self._query_lock:
            self._pending_queries[query_id] = (done, slot)
        try:
            # try every partition (pollers may be parked on any sibling —
            # a single random pick would miss them)
            n_parts = max(1, self._n_read_partitions(
                domain=domain_id, task_list=task_list
            ))
            names = [
                TaskListID.partition_name(task_list, i)
                for i in range(n_parts)
            ] if not TaskListID("", task_list, 0).is_partition else [task_list]
            # ONE budget end to end: the offer phase spends at most
            # half, and the answer wait gets whatever remains — the
            # caller's timeout_s is a hard deadline, not per phase
            overall = time.monotonic() + timeout_s
            deadline = time.monotonic() + timeout_s / 2
            offered = False
            while not offered:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                per_try = max(0.05, remaining / (2 * len(names)))
                for part in names:
                    mgr = self._get_manager(
                        TaskListID(domain_id, part, TASK_TYPE_DECISION)
                    )
                    if mgr.matcher.offer(task, timeout=min(per_try, max(
                        0.0, deadline - time.monotonic()
                    ))):
                        offered = True
                        break
            if not offered:
                raise QueryFailedError(
                    f"no poller on task list {task_list} to answer query"
                )
            if not done.wait(max(0.0, overall - time.monotonic())):
                raise QueryFailedError("query timed out")
            if slot.get("error"):
                raise QueryFailedError(slot["error"])
            return slot.get("result") or b""
        finally:
            with self._query_lock:
                self._pending_queries.pop(query_id, None)

    def respond_query_task_completed(
        self, query_id: str, result: bytes = b"", error: str = ""
    ) -> None:
        with self._query_lock:
            entry = self._pending_queries.get(query_id)
        if entry is None:
            return  # query already timed out / completed
        done, slot = entry
        slot["result"] = result
        slot["error"] = error
        done.set()

    # -- admin ----------------------------------------------------------

    def _poller_history(self, tl_id: TaskListID) -> PollerHistory:
        with self._lock:
            ph = self._pollers.get(tl_id.key())
            if ph is None:
                ph = self._pollers[tl_id.key()] = PollerHistory()
            return ph

    def describe_task_list(
        self, domain_id: str, name: str, task_type: int
    ) -> dict:
        tl_id = TaskListID(domain_id, name, task_type)
        with self._lock:
            mgr = self._managers.get(tl_id.key())
        out = mgr.describe() if mgr else {"task_list": name, "task_type": task_type}
        out["pollers"] = self._poller_history(tl_id).get()
        return out

    def list_task_list_partitions(
        self, domain_id: str, name: str
    ) -> dict:
        """Partition names for a scalable task list (reference
        matchingEngine ListTaskListPartitions): the union of read and
        write partitioning, per task type."""
        n = max(
            self._n_read_partitions(domain=domain_id, task_list=name),
            self._n_write_partitions(domain=domain_id, task_list=name),
            1,
        )
        partitions = [
            {"name": TaskListID.partition_name(name, i), "partition": i}
            for i in range(n)
        ]
        return {
            "decision_task_list_partitions": partitions,
            "activity_task_list_partitions": [dict(p) for p in partitions],
        }

    def cancel_outstanding_polls(
        self, domain_id: str, name: str, task_type: int
    ) -> None:
        with self._lock:
            mgr = self._managers.get(TaskListID(domain_id, name, task_type).key())
        if mgr is not None:
            mgr.matcher.interrupt_all()

    def unload_idle_task_lists(self) -> int:
        """GC managers idle past their TTL (taskListManager idle unload).

        stop() joins the writer thread and does store I/O — it runs
        OUTSIDE the engine lock, or one stalled task list turns a
        periodic sweep into an engine-wide matching outage."""
        stopping = []
        with self._lock:
            for key, mgr in list(self._managers.items()):
                if mgr.idle_since_s() > mgr.idle_ttl_s:
                    del self._managers[key]
                    stopping.append(mgr)
        for mgr in stopping:
            mgr.stop()
        return len(stopping)

    def shutdown(self) -> None:
        with self._lock:
            managers = list(self._managers.values())
            self._managers.clear()
        for mgr in managers:
            mgr.stop()
