"""Worker replicator: push-model replication consumers.

Reference: service/worker/replicator/ — replicator.go:84-213 +
processor.go:85-482: per-remote-cluster Kafka consumers decode
replication tasks and apply them through the history client, with
retry + DLQ; domainReplicationMessageProcessor.go applies domain
metadata changes from the master cluster. The pull model
(runtime/replication/processor.py) is the primary path; this push
consumer covers the reference's Kafka deployment shape on the in-proc
bus.

A copy of the reference package's ``worker/replicator.py``.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..core.events import HistoryEvent
from ..messaging import MessageBus
from ..runtime.replication.messages import (
    HistoryTaskV2,
    RetryTaskV2Error,
)


def replication_topic(source_cluster: str) -> str:
    return f"replication-{source_cluster}"


class ReplicationPublisher:
    """Active-side pump: hydrate the shard's replication tasks and
    publish them to the cluster topic (replicatorQueueProcessor's Kafka
    emit path)."""

    def __init__(self, history_service, bus: MessageBus,
                 source_cluster: str) -> None:
        self.history = history_service
        self.producer = bus.new_producer(replication_topic(source_cluster))
        self._cursors = {}

    def publish_once(self) -> int:
        published = 0
        for shard_id in self.history.controller.owned_shards():
            last = self._cursors.get(shard_id, 0)
            msgs = self.history.get_replication_messages(
                shard_id, last, cluster="<bus>"
            )
            for task in msgs.tasks:
                self.producer.publish(
                    f"{task.workflow_id}:{task.run_id}",
                    _task_to_dict(task),
                )
                published += 1
            self._cursors[shard_id] = msgs.last_retrieved_id
        return published


class HistoryReplicationConsumer:
    """Passive-side consumer: bus topic → ReplicateEventsV2 with retry,
    re-replication on gaps, and the bus's DLQ on poison messages."""

    def __init__(
        self,
        bus: MessageBus,
        source_cluster: str,
        history_service,
        rereplicator=None,
        group: str = "",
    ) -> None:
        self.consumer = bus.new_consumer(
            replication_topic(source_cluster),
            group or f"replicator-{source_cluster}",
        )
        self.history = history_service
        self.rereplicator = rereplicator
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _apply(self, msg) -> None:
        task = _task_from_dict(msg.value)
        try:
            self.history.replicate_events_v2(task)
        except RetryTaskV2Error as e:
            if self.rereplicator is None:
                raise
            self.rereplicator.rereplicate(e)
            self.history.replicate_events_v2(task)

    def process_backlog(self) -> int:
        return self.consumer.drain(self._apply)

    def start(self, interval_s: float = 0.05) -> None:
        def pump() -> None:
            while not self._stop.is_set():
                msg = self.consumer.poll(timeout=interval_s)
                if msg is None:
                    continue
                try:
                    self._apply(msg)
                except Exception:
                    self.consumer.nack(msg)
                else:
                    self.consumer.ack(msg)

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class DomainReplicationProcessor:
    """Applies domain metadata changes from the master cluster
    (domainReplicationMessageProcessor.go)."""

    def __init__(self, bus: MessageBus, domain_handler,
                 group: str = "domain-replicator") -> None:
        self.consumer = bus.new_consumer("domain-replication", group)
        self.domain_handler = domain_handler
        self._stop = threading.Event()
        self._thread = None

    def process_backlog(self) -> int:
        return self.consumer.drain(
            lambda m: self.domain_handler.apply_replication_record(m.value)
        )

    def start(self, interval_s: float = 0.05) -> None:
        """Continuous pump (the worker service runs this like any other
        consumer — without it, domain registrations/failovers published
        by the master would never apply on this cluster)."""

        def pump() -> None:
            while not self._stop.is_set():
                msg = self.consumer.poll(timeout=interval_s)
                if msg is None:
                    continue
                try:
                    self.domain_handler.apply_replication_record(msg.value)
                except Exception:
                    self.consumer.nack(msg)
                else:
                    self.consumer.ack(msg)

        self._thread = threading.Thread(
            target=pump, name="domain-replication", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def _task_to_dict(task: HistoryTaskV2) -> dict:
    return {
        "task_id": task.task_id,
        "domain_id": task.domain_id,
        "workflow_id": task.workflow_id,
        "run_id": task.run_id,
        "version_history_items": task.version_history_items,
        "events": [e.to_dict() for e in task.events],
        "new_run_events": [e.to_dict() for e in task.new_run_events],
        "new_run_id": task.new_run_id,
    }


def _task_from_dict(d: dict) -> HistoryTaskV2:
    return HistoryTaskV2(
        task_id=d["task_id"],
        domain_id=d["domain_id"],
        workflow_id=d["workflow_id"],
        run_id=d["run_id"],
        version_history_items=d["version_history_items"],
        events=[HistoryEvent.from_dict(e) for e in d["events"]],
        new_run_events=[
            HistoryEvent.from_dict(e) for e in d["new_run_events"]
        ],
        new_run_id=d.get("new_run_id", ""),
    )
