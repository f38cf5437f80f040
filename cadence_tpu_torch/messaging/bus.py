"""In-process message broker with consumer groups, retry and DLQ.

Reference semantics (common/messaging/kafkaConsumer.go,
service/worker/replicator — retry topic + DLQ wiring in
common/messaging/kafkaClient.go NewConsumer):

- a ``Producer`` appends messages to a topic log;
- each consumer group tracks its own offset into the log;
- a delivered message must be ``ack``-ed or ``nack``-ed; nack re-enqueues
  it until ``max_redelivery`` is exhausted, after which it lands on the
  topic's DLQ (``<topic>-dlq``), matching the reference's
  retry-topic/DLQ-topic pair. Delivery is at-least-once for consumers
  that honor the ack/nack protocol; a consumer that drops a message
  without acking loses it (there is no rebalance-driven redelivery).

The broker is deliberately process-local: the runtime's host plane keeps
queue state on the host and only ships packed tensors to the device, so
"Kafka" here is a contract (at-least-once, per-group offsets, DLQ), not
a daemon.

A copy of the reference package's ``messaging/bus.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils.log import get_logger

_log = get_logger("cadence_tpu_torch.messaging")


@dataclasses.dataclass
class Message:
    topic: str
    key: str
    value: Any
    offset: int = -1
    partition: int = 0
    redelivery_count: int = 0
    # why the last handler attempt failed (set by Consumer.drain) —
    # rides into the DLQ so dead letters carry their diagnosis
    last_error: str = ""


class _TopicLog:
    def __init__(self, name: str) -> None:
        self.name = name
        self.messages: List[Message] = []
        # monotonic id source: DLQ purge/merge REMOVE entries, so
        # len(messages) would recycle ids of surviving dead letters and
        # corrupt the operator watermark verbs; main topics are
        # append-only (next_offset == len there)
        self.next_offset = 0

    def append(self, msg: Message) -> Message:
        # caller holds the bus lock
        msg = dataclasses.replace(msg, offset=self.next_offset)
        self.next_offset += 1
        self.messages.append(msg)
        return msg


class _GroupState:
    def __init__(self) -> None:
        self.offset = 0
        # nacked messages awaiting redelivery, served before the log tail
        self.redelivery: List[Message] = []


class MessageBus:
    """Topic registry + per-(topic, group) offsets."""

    DLQ_SUFFIX = "-dlq"

    def __init__(self, max_redelivery: int = 3) -> None:
        self._lock = threading.Condition()
        self._topics: Dict[str, _TopicLog] = {}
        self._groups: Dict[tuple, _GroupState] = {}
        self._max_redelivery = max_redelivery
        self._closed = False

    # -- broker internals --------------------------------------------------

    def _topic(self, name: str) -> _TopicLog:
        log = self._topics.get(name)
        if log is None:
            log = self._topics[name] = _TopicLog(name)
        return log

    def _group(self, topic: str, group: str) -> _GroupState:
        key = (topic, group)
        st = self._groups.get(key)
        if st is None:
            st = self._groups[key] = _GroupState()
        return st

    def publish(self, topic: str, key: str, value: Any) -> int:
        with self._lock:
            log = self._topic(topic)
            msg = log.append(
                Message(topic=topic, key=key, value=value, offset=0)
            )
            self._lock.notify_all()
            return msg.offset

    def topic_size(self, topic: str) -> int:
        with self._lock:
            return len(self._topic(topic).messages)

    def dlq_messages(self, topic: str) -> List[Message]:
        with self._lock:
            return list(self._topic(topic + self.DLQ_SUFFIX).messages)

    # -- DLQ operator verbs (reference tools/cli/adminDLQCommands.go:
    # GetDLQMessages / PurgeDLQMessages / MergeDLQMessages with a
    # lastMessageID watermark; offsets are this bus's message ids) -----

    def dlq_read(
        self, topic: str, last_offset: int = -1, count: int = 0,
    ) -> List[Message]:
        """Dead letters with offset <= last_offset (-1 = all), capped at
        ``count`` (0 = uncapped)."""
        with self._lock:
            msgs = [
                m for m in self._topic(topic + self.DLQ_SUFFIX).messages
                if last_offset < 0 or m.offset <= last_offset
            ]
        return msgs[:count] if count else msgs

    def dlq_purge(self, topic: str, last_offset: int = -1) -> int:
        """Drop dead letters up to the watermark; returns count dropped."""
        with self._lock:
            dlq = self._topic(topic + self.DLQ_SUFFIX)
            keep = [
                m for m in dlq.messages
                if last_offset >= 0 and m.offset > last_offset
            ]
            dropped = len(dlq.messages) - len(keep)
            dlq.messages[:] = keep
        return dropped

    def dlq_merge(self, topic: str, last_offset: int = -1) -> int:
        """Re-drive dead letters up to the watermark back onto the main
        topic (fresh offsets, redelivery count reset) and drop them from
        the DLQ; returns count merged."""
        with self._lock:
            dlq = self._topic(topic + self.DLQ_SUFFIX)
            keep: List[Message] = []
            merged: List[Message] = []
            for m in dlq.messages:
                if last_offset < 0 or m.offset <= last_offset:
                    merged.append(m)
                else:
                    keep.append(m)
            dlq.messages[:] = keep
            log = self._topic(topic)
            for m in merged:
                log.append(dataclasses.replace(
                    m, topic=topic, redelivery_count=0,
                ))
            self._lock.notify_all()
        return len(merged)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    # -- consumer protocol -------------------------------------------------

    def _poll(
        self, topic: str, group: str, timeout: Optional[float]
    ) -> Optional[Message]:
        deadline = None
        with self._lock:
            while True:
                if self._closed:
                    return None
                st = self._group(topic, group)
                if st.redelivery:
                    msg = st.redelivery.pop(0)
                else:
                    log = self._topic(topic)
                    if st.offset < len(log.messages):
                        src = log.messages[st.offset]
                        st.offset += 1
                        msg = dataclasses.replace(src)
                    else:
                        if timeout is not None and timeout <= 0:
                            return None
                        if deadline is None and timeout is not None:
                            deadline = time.monotonic() + timeout
                        if deadline is not None:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                return None
                            self._lock.wait(remaining)
                        else:
                            self._lock.wait()
                        continue
                return msg

    def _ack(self, group_key: tuple, msg: Message) -> None:
        pass  # offsets advance at delivery; ack is a protocol no-op here

    def _nack(self, group_key: tuple, msg: Message) -> None:
        topic, group = group_key
        with self._lock:
            st = self._groups[group_key]
            msg.redelivery_count += 1
            if msg.redelivery_count > self._max_redelivery:
                dlq = self._topic(topic + self.DLQ_SUFFIX)
                dlq.append(dataclasses.replace(
                    msg, topic=topic + self.DLQ_SUFFIX
                ))
            else:
                st.redelivery.append(msg)
            self._lock.notify_all()

    def new_consumer(self, topic: str, group: str) -> "Consumer":
        return Consumer(self, topic, group)

    def new_producer(self, topic: str) -> "Producer":
        return Producer(self, topic)


class Producer:
    def __init__(self, bus: MessageBus, topic: str) -> None:
        self._bus = bus
        self._topic = topic

    def publish(self, key: str, value: Any) -> int:
        return self._bus.publish(self._topic, key, value)


class Consumer:
    """Pull consumer; every message must be acked or nacked."""

    def __init__(self, bus: MessageBus, topic: str, group: str) -> None:
        self._bus = bus
        self._key = (topic, group)
        self._topic = topic
        self._group = group

    def poll(self, timeout: Optional[float] = 0.0) -> Optional[Message]:
        return self._bus._poll(self._topic, self._group, timeout)

    def ack(self, msg: Message) -> None:
        self._bus._ack(self._key, msg)

    def nack(self, msg: Message) -> None:
        self._bus._nack(self._key, msg)

    def drain(
        self,
        handler: Callable[[Message], None],
        *,
        limit: Optional[int] = None,
    ) -> int:
        """Synchronously process the current backlog; handler exceptions
        nack the message. Returns number of messages handled OK."""
        handled = 0
        seen = 0
        while limit is None or seen < limit:
            msg = self.poll(timeout=0.0)
            if msg is None:
                break
            seen += 1
            try:
                handler(msg)
            except Exception as e:
                # keep the WHY: the DLQ entry and the log both carry
                # the failure, or a poisoned message dead-letters with
                # zero diagnostics
                msg.last_error = f"{type(e).__name__}: {e}"
                _log.exception(
                    f"handler failed for {msg.topic!r} message "
                    f"{getattr(msg, 'offset', '?')}"
                )
                self.nack(msg)
            else:
                self.ack(msg)
                handled += 1
        return handled
