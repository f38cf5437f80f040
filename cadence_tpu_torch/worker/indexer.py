"""Indexer: visibility message consumer.

Reference: service/worker/indexer/ — indexer.go:63 + esProcessor.go:
visibility writes ride a Kafka topic and a bulk processor lands them in
Elasticsearch. Here the topic is the in-proc bus and the sink is the
advanced visibility store; the producer side (BusVisibilityClient) is
the analogue of the history service writing visibility messages to
Kafka instead of the store.

A copy of the reference package's ``worker/indexer.py``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from ..messaging import MessageBus
from ..runtime.persistence.interfaces import VisibilityManager
from ..runtime.persistence.records import VisibilityRecord

VISIBILITY_TOPIC = "visibility"


class BusVisibilityClient(VisibilityManager):
    """Producer side: visibility writes become bus messages (the
    reference's visibilityQueueKafka path); reads are not served here."""

    def __init__(self, bus: MessageBus, topic: str = VISIBILITY_TOPIC) -> None:
        self._producer = bus.new_producer(topic)

    def _publish(self, kind: str, rec: VisibilityRecord) -> None:
        self._producer.publish(
            f"{rec.domain_id}:{rec.workflow_id}:{rec.run_id}",
            {"kind": kind, "record": dataclasses.asdict(rec)},
        )

    def record_workflow_execution_started(self, rec) -> None:
        self._publish("started", rec)

    def record_workflow_execution_closed(self, rec) -> None:
        self._publish("closed", rec)

    def upsert_workflow_execution(self, rec) -> None:
        self._publish("upsert", rec)

    def delete_workflow_execution(self, domain_id, workflow_id, run_id):
        self._producer.publish(
            f"{domain_id}:{workflow_id}:{run_id}",
            {
                "kind": "delete",
                "record": {
                    "domain_id": domain_id,
                    "workflow_id": workflow_id,
                    "run_id": run_id,
                },
            },
        )


class Indexer:
    """Consumer side: bus → visibility store."""

    def __init__(
        self, bus: MessageBus, store: VisibilityManager,
        topic: str = VISIBILITY_TOPIC, group: str = "indexer",
    ) -> None:
        self.consumer = bus.new_consumer(topic, group)
        self.store = store
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _handle(self, msg) -> None:
        kind = msg.value["kind"]
        raw = dict(msg.value["record"])
        if kind == "delete":
            self.store.delete_workflow_execution(
                raw["domain_id"], raw["workflow_id"], raw["run_id"]
            )
            return
        rec = VisibilityRecord(**raw)
        if kind == "started":
            self.store.record_workflow_execution_started(rec)
        elif kind == "closed":
            self.store.record_workflow_execution_closed(rec)
        else:
            self.store.upsert_workflow_execution(rec)

    def process_backlog(self) -> int:
        """Drain everything currently queued (tests/sync callers)."""
        return self.consumer.drain(self._handle)

    def start(self, interval_s: float = 0.05) -> None:
        def pump() -> None:
            while not self._stop.is_set():
                msg = self.consumer.poll(timeout=interval_s)
                if msg is None:
                    continue
                try:
                    self._handle(msg)
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
