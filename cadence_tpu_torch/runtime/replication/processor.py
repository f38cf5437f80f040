"""Pull-model replication consumers.

Reference: service/history/replicationTaskFetcher.go:65-247 (per remote
cluster, batched GetReplicationMessages RPCs) and
replicationTaskProcessor.go:85-434 (applies fetched tasks to the local
engine, converts RetryTaskV2 errors into re-replication, acks progress
back to the source on the next fetch).

A copy of the reference package's ``runtime/replication/processor.py``.
Deviation: a failed batched drain falls back to the one-task-at-a-time
path only for what the reference means by it (a task that needs
re-replication, ``RetryTaskV2Error``; a store error; a packer refusal,
``PackError``); any other exception, a fault of the device replay of the
cycle's conflict rebuilds among them, raises out of ``process_once``
rather than being rebuilt again on the host.
"""

from __future__ import annotations

import collections
import json
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ...utils.backoff import BackoffLadder
from ...utils.log import get_logger
from ...utils.task_processor import KeyedSequentialProcessor

from ...ops.pack import PackError
from ..persistence.errors import ConditionFailedError, PersistenceError
from ..shard import ShardContext
from .messages import HistoryTaskV2, ReplicationMessages, RetryTaskV2Error
from .ndc import NDCHistoryReplicator
from .rereplicator import HistoryRereplicator

logger = get_logger("cadence_tpu_torch.replication")

# what sends a failed batched drain to the one-task-at-a-time path
_SEQUENTIAL_FALLBACK = (RetryTaskV2Error, PersistenceError, PackError)


class RemoteClusterClient:
    """What a fetcher needs from a remote cluster (implemented by the
    remote cluster's history service / admin handler in-process, or a
    gRPC stub across hosts)."""

    def get_replication_messages(
        self, shard_id: int, last_retrieved_id: int,
        max_tasks: Optional[int] = None,
    ) -> ReplicationMessages:
        raise NotImplementedError

    def get_workflow_history_raw(
        self,
        domain_id: str,
        workflow_id: str,
        run_id: str,
        start_event_id: int,
        end_event_id: int,
    ):
        raise NotImplementedError


class ReplicationTaskFetcher:
    """Per-remote-cluster fetch plane; one instance serves all local
    shards (the reference aggregates per-shard requests into one RPC —
    here the aggregation is a shared client + per-shard cursor)."""

    def __init__(
        self, cluster: str, client: RemoteClusterClient,
    ) -> None:
        self.cluster = cluster
        self.client = client
        self._cursor: Dict[int, int] = {}
        self._lock = threading.Lock()

    def last_retrieved(self, shard_id: int) -> int:
        with self._lock:
            return self._cursor.get(shard_id, 0)

    def fetch(self, shard_id: int,
              max_tasks: Optional[int] = None) -> ReplicationMessages:
        """Read past the committed cursor WITHOUT advancing it — the
        processor commits only after tasks apply, so a failed apply is
        re-fetched (at-least-once, matching the reference's
        lastProcessedMessageId ack). ``max_tasks`` caps the emit page
        (the adaptive transport's per-link paging); None keeps the
        emit side's static default."""
        if max_tasks is None:
            return self.client.get_replication_messages(
                shard_id, self.last_retrieved(shard_id)
            )
        return self.client.get_replication_messages(
            shard_id, self.last_retrieved(shard_id), max_tasks=max_tasks
        )

    def commit(self, shard_id: int, applied_through: int) -> None:
        with self._lock:
            if applied_through > self._cursor.get(shard_id, 0):
                self._cursor[shard_id] = applied_through


class ReplicationTaskProcessor:
    """Applies one remote cluster's replication stream to one shard."""

    def __init__(
        self,
        shard: ShardContext,
        replicator: NDCHistoryReplicator,
        fetcher: ReplicationTaskFetcher,
        rereplicator: Optional[HistoryRereplicator] = None,
        max_retry: int = 3,
        metrics=None,
        transport=None,
        backoff_max_s: float = 5.0,
    ) -> None:
        from ...utils.metrics import NOOP

        self.shard = shard
        self.replicator = replicator
        self.fetcher = fetcher
        self.rereplicator = rereplicator
        self.max_retry = max_retry
        self._metrics = (metrics or NOOP).tagged(
            service="history_replication", shard=str(shard.shard_id),
            cluster=fetcher.cluster,
        )
        # bandwidth-adaptive transport (transport.AdaptiveTransport),
        # shared per remote cluster like the fetcher; None = the
        # pre-adaptive pure event-stream consumer, byte-for-byte
        self.transport = transport
        # a failed cycle's retry delay doubles up to this cap (jittered)
        # and resets on the first successful cycle
        self.backoff_max_s = backoff_max_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._backoff_rng = random.Random(shard.shard_id)
        # deferred history backfill owed by snapshot-shipped catch-ups:
        # (domain_id, workflow_id, run_id, from_event_id, through_id)
        self._backfill = collections.deque()
        # how many fetch attempts one owed range gets before it is
        # abandoned (loudly): a source that GC'd the range can never
        # serve it, and one poison item must not wedge the whole plane
        self.backfill_max_attempts = 8
        self._backfill_attempts: Dict[tuple, int] = {}
        if self.rereplicator is not None and transport is not None:
            # the processor owns the deferred-backfill sink; the
            # transport is only filled in when the caller didn't wire
            # one (never clobber an explicit choice)
            if self.rereplicator.transport is None:
                self.rereplicator.transport = transport
            self.rereplicator.backfill_sink = self._enqueue_backfill
        # durable replication progress (cursor + mode), keyed
        # (shard, cluster); absent on pre-v5 stores → in-memory only
        self._progress_supported = hasattr(
            shard.persistence.shard, "get_replication_progress"
        )
        self._persisted_cursor = 0
        self._persisted_debt: tuple = ()
        self._restore_progress()
        # per-workflow-sequential, cross-workflow-parallel fallback
        # apply plane; created on first use, recreated after stop() so
        # a stop/start cycle (or a post-stop synchronous drain) works
        self._seq: Optional[KeyedSequentialProcessor] = None

    def _get_seq(self) -> KeyedSequentialProcessor:
        if self._seq is None or self._seq.is_shutdown:
            self._seq = KeyedSequentialProcessor(
                worker_count=4, name=f"repl-{self.shard.shard_id}"
            )
        return self._seq

    # -- synchronous drain (tests + backlog catch-up) ------------------

    # flush budget for the keyed fallback; drain() shrinks it to
    # fit its own deadline so a failover drain isn't held hostage
    # by one slow apply
    APPLY_FLUSH_TIMEOUT_S = 120.0

    def process_once(self) -> int:
        """One fetch + apply cycle; returns number of tasks applied.

        The whole fetched cycle drains through the replicator's batched
        path first (conflict rebuilds across the cycle collapse into one
        device scan — the replication-storm configuration); the cursor
        then commits through the cycle. On any batch failure it falls
        back to the sequential per-task path, which commits per task and
        converts RetryTaskV2 errors into re-replication — a re-fetched
        duplicate is detected and skipped by version-history bookkeeping
        (at-least-once, matching the reference's lastProcessedMessageId
        ack)."""
        import time as _time

        t0 = _time.perf_counter()
        applied = self._process_cycle()
        if applied:
            self._metrics.inc("replication_tasks_applied", applied)
            self._metrics.record(
                "replication_apply_latency", _time.perf_counter() - t0
            )
        return applied

    def _process_cycle(self) -> int:
        t0 = time.monotonic()
        # per-link dynamic paging: a throttled link fetches pages sized
        # to its measured budget instead of the emit side's static page
        page_hint = (
            self.transport.page_size()
            if self.transport is not None else None
        )
        msgs = self.fetcher.fetch(self.shard.shard_id, max_tasks=page_hint)
        if self.transport is not None:
            # the fetch IS the link probe: bytes + wall time feed the
            # bandwidth/bytes-per-event EWMAs the mode controller reads
            self.transport.observe_messages(msgs, time.monotonic() - t0)
        if msgs.source_time_ns:
            # the stream carries the source cluster's clock; standby
            # timer processing fires against it (ref syncShardStatus)
            self.shard.set_remote_cluster_current_time(
                self.fetcher.cluster, msgs.source_time_ns
            )
        if not msgs.tasks:
            # nothing to apply in the range: safe to move past it
            self.fetcher.commit(self.shard.shard_id, msgs.last_retrieved_id)
            self._record_lag(msgs)
            done = self._drain_backfill()
            self._persist_progress()
            return done
        applied = self._apply_cycle(msgs)
        # page-derived lag first: a catch-up below re-gauges with the
        # exact probe-derived residue, which must not be clobbered by
        # this page's stale has_more proxy
        self._record_lag(msgs)
        if msgs.has_more and self.transport is not None \
                and self.rereplicator is not None:
            # deep backlog behind this page: switch to the adaptive
            # catch-up plane instead of paying the event stream
            # page-by-page over a link that may not afford it
            applied += self._adaptive_catchup()
        applied += self._drain_backfill()
        self._persist_progress()
        return applied

    def _apply_cycle(self, msgs: ReplicationMessages) -> int:
        if len(msgs.tasks) > 1:
            try:
                self.replicator.apply_events_batch(msgs.tasks)
                self.fetcher.commit(
                    self.shard.shard_id, msgs.tasks[-1].task_id
                )
                return len(msgs.tasks)
            except _SEQUENTIAL_FALLBACK:
                # sequential fallback below re-applies idempotently; a
                # persistent failure here means every cycle pays double
                # work, so make it visible
                logger.exception(
                    "batched replication drain failed; falling back to "
                    "sequential apply", shard=self.shard.shard_id,
                )
        return self._apply_keyed(msgs.tasks)

    # -- adaptive catch-up (bandwidth-adaptive state transfer) ---------

    def _local_tip(self, domain_id: str, workflow_id: str,
                   run_id: str) -> int:
        try:
            resp = self.shard.persistence.execution.get_workflow_execution(
                self.shard.shard_id, domain_id, workflow_id, run_id
            )
            return max(0, resp.next_event_id - 1)
        except Exception:
            return 0

    def _adaptive_catchup(self) -> int:
        """Summary-driven backlog recovery: one tiny backlog probe
        (per-run spans, no event payloads), then per run the mode
        controller chooses snapshot shipping or an event heal — both
        via the rereplicator, which owns the fallback ladder. The
        cursor fast-forwards past the summarized span only when EVERY
        run healed; any failure leaves it put so the next cycle retries
        (at-least-once, both paths idempotent)."""
        cursor = self.fetcher.last_retrieved(self.shard.shard_id)
        summary = self.transport.fetch_backlog(self.shard.shard_id, cursor)
        if not summary or not summary.get("runs"):
            return 0
        total_gap = 0
        healed = 0
        all_ok = True
        for run in summary["runs"]:
            d, wf, r = (
                run["domain_id"], run["workflow_id"], run["run_id"],
            )
            local_tip = self._local_tip(d, wf, r)
            gap = max(0, run["next_event_id"] - 1 - local_tip)
            total_gap += gap
            if gap == 0:
                healed += run["tasks"]
                continue
            err = RetryTaskV2Error(
                "adaptive catch-up",
                domain_id=d, workflow_id=wf, run_id=r,
                start_event_id=local_tip,
                end_event_id=run["next_event_id"],
            )
            try:
                self.rereplicator.rereplicate(err)
                healed += run["tasks"]
            except Exception:
                all_ok = False
                logger.exception(
                    "adaptive catch-up failed for workflow; cursor "
                    "held for retry",
                    shard=self.shard.shard_id, workflow=wf, run=r,
                )
        # the probe knew the gap exactly; after a fully healed pass the
        # residue is zero (the seconds view keeps its last
        # fetch-derived estimate — the summary carries no event
        # timestamps)
        self.transport.record_lag(
            0 if all_ok else total_gap,
            self.transport.estimator.lag_seconds,
        )
        if all_ok:
            # debt becomes durable BEFORE the cursor that fast-forwards
            # past it can be acked to the source (the ack rides the
            # NEXT fetch) — one write for the whole healed span, not
            # one per shipped run
            self._persist_progress()
            self.fetcher.commit(
                self.shard.shard_id, summary["max_task_id"]
            )
        return healed

    def _enqueue_backfill(self, domain_id: str, workflow_id: str,
                          run_id: str, from_event_id: int,
                          through_event_id: int) -> None:
        """Record the history debt a snapshot ship owes. The debt rides
        the durable progress row next to the cursor — a restart must
        never hold a fast-forwarded cursor without the owed ranges
        beside it (state current, bytes gone, forever). The durable
        write itself batches at the catch-up/cycle boundary, always
        before the cursor can be acked to the source."""
        item = (domain_id, workflow_id, run_id, from_event_id,
                through_event_id)
        if item not in self._backfill:
            self._backfill.append(item)

    def _drain_backfill(self, budget: int = 2) -> int:
        """Fetch + append up to ``budget`` owed history ranges (the
        byte-identity debt of snapshot shipping). A failed range
        rotates to the BACK of the queue (later debt keeps draining)
        and raises so the pump backs off; after
        ``backfill_max_attempts`` failures the range is abandoned with
        a loud log — a source that GC'd the history can never serve
        it, and one poison range must not wedge the plane forever."""
        if self.rereplicator is None:
            return 0
        done = 0
        while self._backfill and done < budget:
            item = self._backfill.popleft()
            try:
                self.rereplicator.backfill(*item)
                self._backfill_attempts.pop(item, None)
                done += 1
            except Exception:
                attempts = self._backfill_attempts.get(item, 0) + 1
                if attempts >= self.backfill_max_attempts:
                    self._backfill_attempts.pop(item, None)
                    logger.exception(
                        "history backfill range abandoned after "
                        f"{attempts} attempts (source no longer serves "
                        "it?); the standby is missing those bytes",
                        shard=self.shard.shard_id, range=item,
                    )
                else:
                    self._backfill_attempts[item] = attempts
                    self._backfill.append(item)
                raise
        return done

    # -- lag observability ---------------------------------------------

    @staticmethod
    def _lag_seconds_from(source_time_ns: int,
                          newest_event_ts_ns: Optional[int]) -> float:
        if not source_time_ns:
            return 0.0
        if not newest_event_ts_ns:
            return 0.0
        return max(0.0, (source_time_ns - newest_event_ts_ns) / 1e9)

    def _record_lag(self, msgs: ReplicationMessages) -> None:
        if self.transport is None:
            return
        newest_ts = None
        n_events = 0
        for t in msgs.tasks:
            n_events += len(t.events)
            if t.events:
                newest_ts = t.events[-1].timestamp
        # after a full apply the fetched span is current; only a
        # has_more backlog leaves a known residue behind this page
        lag_events = n_events if msgs.has_more else 0
        self.transport.record_lag(
            lag_events,
            self._lag_seconds_from(msgs.source_time_ns, newest_ts),
        )

    # -- durable progress (replication_progress rows) ------------------

    def _progress_blob(self, cursor: int) -> str:
        mode = "events"
        switches = 0
        if self.transport is not None:
            mode = self.transport.controller.mode
            switches = self.transport.controller.switches
        return json.dumps({
            "applied_through": cursor,
            "mode": mode,
            "mode_switches": switches,
            # owed history ranges from snapshot-shipped catch-ups: the
            # byte-identity debt survives a restart with the cursor
            "backfill": [list(item) for item in self._backfill],
        }, sort_keys=True)

    def _restore_progress(self) -> None:
        """Resume the fetch cursor from the durable progress row — a
        restarted standby re-fetches from where it durably applied, not
        from task id 0."""
        if not self._progress_supported:
            return
        try:
            row = self.shard.persistence.shard.get_replication_progress(
                self.shard.shard_id, self.fetcher.cluster
            )
        except Exception:
            return
        if not row:
            return
        try:
            blob = json.loads(row[1])
            cursor = int(blob.get("applied_through", 0))
            debt = [tuple(item) for item in blob.get("backfill", [])]
        except (ValueError, TypeError):
            return
        if cursor > 0:
            self.fetcher.commit(self.shard.shard_id, cursor)
            self._persisted_cursor = cursor
        for item in debt:
            if item not in self._backfill:
                self._backfill.append(item)
        self._persisted_debt = tuple(self._backfill)

    def _persist_progress(self) -> None:
        """Best-effort durable write of (cursor, mode, backfill debt)
        under a version LWT. Torn-write semantics match
        ``reshard_state``: a retry that reads back exactly the blob it
        tried to write treats the torn write as landed. Writes fire on
        cursor advance OR debt change — a drained (or newly owed)
        backfill range must reach the row even when the cursor sat
        still."""
        if not self._progress_supported:
            return
        cursor = self.fetcher.last_retrieved(self.shard.shard_id)
        debt = tuple(self._backfill)
        if cursor <= self._persisted_cursor and \
                debt == self._persisted_debt:
            return
        blob = self._progress_blob(cursor)
        mgr = self.shard.persistence.shard
        for _ in range(3):
            try:
                row = mgr.get_replication_progress(
                    self.shard.shard_id, self.fetcher.cluster
                )
                version = row[0] if row else 0
                mgr.set_replication_progress(
                    self.shard.shard_id, self.fetcher.cluster, blob,
                    version,
                )
                self._persisted_cursor = cursor
                self._persisted_debt = debt
                return
            except Exception as e:
                try:
                    row = mgr.get_replication_progress(
                        self.shard.shard_id, self.fetcher.cluster
                    )
                except Exception:
                    row = None
                if row and row[1] == blob:
                    # the torn write landed; the lost ack is paid
                    self._persisted_cursor = cursor
                    self._persisted_debt = debt
                    return
                if not isinstance(e, ConditionFailedError):
                    logger.warn(
                        "replication progress write failed "
                        f"({type(e).__name__}); cursor stays in-memory",
                        shard=self.shard.shard_id,
                    )
                    return

    def _apply_keyed(self, tasks) -> int:
        """Per-task fallback: runs sequentially PER WORKFLOW (a
        continue-as-new chain's runs must apply in order — the batched
        path barriers on the same key), concurrently across workflows
        (reference: replication tasks feed a keyed sequential task
        processor, common/task/sequentialTaskProcessor.go). The cursor
        commits through the longest finished-and-successful prefix, so
        a failed or still-running task re-fetches while already-applied
        peers dedup via version-history bookkeeping."""
        failures: List[tuple] = []  # (task_id, exception)
        flock = threading.Lock()

        def run(t: HistoryTaskV2) -> None:
            try:
                self._process_task(t)
            except Exception as e:
                with flock:
                    failures.append((t.task_id, e))
                logger.exception(
                    "replication task apply failed",
                    shard=self.shard.shard_id, task_id=t.task_id,
                    workflow=t.workflow_id,
                )

        seq = self._get_seq()
        for task in tasks:
            seq.submit(
                (task.domain_id, task.workflow_id),
                lambda t=task: run(t),
            )
        if not seq.flush(timeout_s=self.APPLY_FLUSH_TIMEOUT_S):
            # tasks still in flight: committing past them could lose
            # them forever (the cursor only moves forward). Raise —
            # returning 0 would read as "stream quiescent" to a
            # failover drain while work is still outstanding
            raise TimeoutError(
                f"shard {self.shard.shard_id}: keyed replication apply "
                "timed out with work in flight"
            )
        cutoff = min(tid for tid, _ in failures) if failures else None
        applied = 0
        last_ok = None
        for task in tasks:
            if cutoff is not None and task.task_id >= cutoff:
                break
            last_ok = task.task_id
            applied += 1
        if last_ok is not None:
            # the cursor is a monotonic watermark: one commit covers
            # the whole successful prefix
            self.fetcher.commit(self.shard.shard_id, last_ok)
        if applied == 0 and failures:
            # no progress at all: surface the failure to the caller
            # (drain()/pump) exactly like the old sequential loop did
            raise failures[0][1]
        return applied

    def drain_tasks(self, max_rounds: int = 100) -> int:
        """Pull+apply until a fetch comes back empty; returns the task
        count (test/assembly harness surface)."""
        total = 0
        for _ in range(max_rounds):
            n = self.process_once()
            total += n
            if n == 0:
                return total
        return total

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Queue-processor drain contract (HistoryService.drain_queues):
        True when the remote stream is quiescent within the budget. The
        keyed-apply flush budget shrinks to the caller's deadline for
        the duration — a single hung apply must not turn a 5s drain
        into a 120s stall."""
        deadline = time.monotonic() + timeout_s
        saved = self.APPLY_FLUSH_TIMEOUT_S
        self.APPLY_FLUSH_TIMEOUT_S = max(0.5, timeout_s)
        try:
            while time.monotonic() < deadline:
                if self.process_once() == 0:
                    return True
        finally:
            self.APPLY_FLUSH_TIMEOUT_S = saved
        return False

    def _process_task(self, task: HistoryTaskV2) -> None:
        for attempt in range(self.max_retry):
            try:
                self.replicator.apply_events(task)
                return
            except RetryTaskV2Error as e:
                if self.rereplicator is None or attempt == self.max_retry - 1:
                    raise
                self.rereplicator.rereplicate(e)

    # -- background pump -----------------------------------------------

    def start(self, interval_s: float = 0.05) -> None:
        if self._thread is not None:
            return

        def pump() -> None:
            # capped jittered exponential backoff on FAILED cycles: a
            # dead remote link costs one retry per backoff_max_s (not a
            # log line every interval_s), and the first successful
            # cycle resets the ladder so a healed link resumes at full
            # pull cadence immediately. Jitter keeps concurrent shards
            # pulling one dead link from retrying in phase.
            ladder = BackoffLadder(
                interval_s, max(self.backoff_max_s, interval_s),
                jitter=0.5, rng=self._backoff_rng,
            )
            while not self._stop.is_set():
                try:
                    n = self.process_once()
                    ladder.success()
                    if n == 0:
                        self._stop.wait(interval_s)
                except Exception:
                    logger.exception(
                        "replication pump cycle failed",
                        shard=self.shard.shard_id,
                        cluster=self.fetcher.cluster,
                    )
                    self._metrics.inc("replication_pump_backoffs")
                    self._stop.wait(ladder.failure())

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._seq is not None:
            # wait=False: a hung apply must not turn the bounded stop()
            # into an indefinite block (the pool threads are abandoned;
            # the interpreter reaps them at exit)
            self._seq.shutdown(wait=False)
